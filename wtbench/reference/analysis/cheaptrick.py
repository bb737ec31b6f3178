"""CheapTrick spectral envelope, batched over utterances and frames.

Port of worldtpu/analysis/cheaptrick.py (reference src/cheaptrick.cpp):
F0-adaptive Hanning window -> power spectrum -> DC correction -> linear
smoothing -> cepstral liftering -> exp, two batched real FFTs in all.
Windows are padded to the f0-floor worst case with zero weights.
float32 is the production path (seeded-and-rotated trigonometry, the
low-bin DC correction, the convolution form of the smoothing, a clamp
before the log); float64 is the parity path with the reference's literal
arithmetic and its optional randn() dither hooks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from wtbench.reference import constants as C
from wtbench.reference.ops import dft, filters, trig
from wtbench.reference.ops.fftutil import (f0_floor_for_cheaptrick,
                                        fft_size_for_cheaptrick)
from wtbench.reference.ops.numeric import matlab_round, rdiv


def frame_segments(x, origin, half):
    """Rows x[b, clip(origin_f, 0, T-1) + (-half..half)] with edge
    replication: x [B, T], origin [F] (shared by the rows) or [B, F] (one
    per row) -> [B, F, 2*half+1]."""
    T = x.shape[-1]
    xpad = Fn.pad(x[:, None, :], (half, half), mode="replicate")[:, 0]
    win = xpad.unfold(-1, 2 * half + 1, 1)
    origin = origin.clamp(0, T - 1).long()
    if origin.dim() == 1:
        return win[:, origin]
    return win[torch.arange(x.shape[0], device=x.device)[:, None], origin]


def cheaptrick_frames(x, f0, temporal_positions, *, fs, fft_size,
                      max_half_window, q1=-0.15, f0_floor=None,
                      window_dither=None, spectrum_dither=None,
                      sample_offset=None):
    """Spectral envelope for all frames.

    Args:
        x: [B, T] waveforms.
        f0: [B, F] contours (0 = unvoiced).
        temporal_positions: [F] frame times (s), or [B, F], one row of
            frame times per waveform (chunks of one long recording, each
            with its own origin).
        max_half_window: bound round(1.5*fs/effective_floor).
        f0_floor: effective floor (f0 <= floor uses kDefaultF0); defaults to
            getF0FloorForCheapTrick(fs, fft_size).
        window_dither: optional [B, F, 2*max_half_window+1] parity dither
            added to the windowed waveform (the reference's randn()*1e-15;
            ``analysis.dither.cheaptrick_dither``).
        spectrum_dither: optional [B, F, K] parity noise floor
            (|randn()| * kEps); without it a constant kEps floor is added.
        sample_offset: optional [B] int tensor: row b of x starts at sample
            sample_offset[b] of a longer recording whose frame times
            temporal_positions are.  A window origin is rounded on those
            times, then taken relative to the row (the chunks of one long
            recording round their origins as the whole recording does).

    Returns:
        [B, F, K] power envelope, K = fft_size//2 + 1.
    """
    if f0_floor is None:
        f0_floor = f0_floor_for_cheaptrick(fs, fft_size)
    dt = x.dtype
    dev = x.device
    f0 = f0.to(dt)
    B, F = f0.shape
    K = fft_size // 2 + 1
    W = 2 * max_half_window + 1

    cf0 = torch.where(f0 <= f0_floor,
                      torch.full((), C.DEFAULT_F0, dtype=dt, device=dev), f0)

    # ---- F0-adaptive windowing ----
    half = matlab_round(rdiv(1.5 * fs, cf0))                  # [B, F]
    offs = torch.arange(W, device=dev) - max_half_window
    in_win = torch.abs(offs) <= half[..., None]               # [B, F, W]
    origin = matlab_round(temporal_positions.to(dt) * fs + 0.001)
    if sample_offset is not None:
        origin = origin - sample_offset.to(origin.dtype)[:, None]
    f64 = dt == torch.float64
    if f64:      # parity path: the literal clipped gather and window
        idx = (origin[..., None] + offs).clamp(0, x.shape[-1] - 1).long()
        if idx.dim() == 2:
            seg = x[:, idx]
        else:
            seg = torch.gather(x, 1, idx.reshape(B, -1)).reshape(B, F, W)
        position = offs.to(dt) / 1.5 / fs
        win = 0.5 * torch.cos(C.PI * position * cf0[..., None]) + 0.5
    else:
        # an origin past the last sample is clamped first (a frame there
        # reads a constant segment), as the JAX float32 path does
        seg = frame_segments(x, origin, max_half_window)
        alpha = (C.PI / 1.5 / fs) * cf0
        win = 0.5 * trig.cos_affine(alpha, -alpha * max_half_window, W) + 0.5
    zero = torch.zeros((), dtype=dt, device=dev)
    win = torch.where(in_win, win, zero)
    win = win / torch.sqrt(torch.sum(win * win, -1, keepdim=True))

    wave = seg * win
    if window_dither is not None:
        wave = wave + torch.where(in_win, window_dither.to(dt), zero)
    weight = torch.sum(wave, -1, keepdim=True) / torch.sum(win, -1,
                                                           keepdim=True)
    wave = torch.where(in_win, wave - win * weight, zero)

    # ---- power spectrum + DC correction ----
    spec = dft.rfft(wave, n=fft_size)
    power = (spec.real * spec.real + spec.imag * spec.imag).reshape(-1, K)
    cf0_rows = cf0.reshape(-1)
    power = filters.dc_correction_frames(power, cf0_rows, fs, fft_size,
                                         1.2 * C.CEIL_F0)

    # ---- linear smoothing, width 2*f0/3 ----
    max_b = int(2.0 * 1.2 * C.CEIL_F0 / 3.0 * fft_size / fs) + 2
    power = filters.linear_smoothing_frames(power, cf0_rows * 2.0 / 3.0, fs,
                                            fft_size, max_b)
    if not f64:
        # f32 smoothing can leave tiny negative residuals; clamp before the
        # log (the float64 path matches the reference instead)
        power = torch.clamp(power, min=0.0)
    power = power.reshape(B, F, K)
    if spectrum_dither is not None:
        power = power + torch.abs(spectrum_dither.to(dt)) * C.EPS
    else:
        power = power + C.EPS

    # ---- cepstral liftering with recovery ----
    i = torch.arange(K, dtype=dt, device=dev)
    quef = i / fs
    pfq = C.PI * cf0[..., None] * quef
    one = torch.ones((), dtype=dt, device=dev)
    if f64:
        smoothing = torch.where(i == 0, one, torch.sin(pfq) / pfq)
        cos2 = torch.cos(2.0 * pfq)
    else:
        # sin via the cos seed shifted -pi/2; cos(2x) = 1 - 2 sin(x)^2
        alpha_q = C.PI * cf0 / fs
        sin_pf = trig.cos_affine(alpha_q,
                                 torch.full_like(alpha_q, -0.5 * C.PI), K)
        smoothing = torch.where(i == 0, one, sin_pf / pfq)
        cos2 = 1.0 - 2.0 * sin_pf * sin_pf
    compensation = (1.0 - 2.0 * q1) + 2.0 * q1 * cos2
    lifter = smoothing * compensation

    logp = torch.log(power)
    mirrored = torch.cat([logp, logp[..., 1:-1].flip(-1)], dim=-1)
    ceps = dft.rfft_real(mirrored)
    env = dft.irfft(ceps * lifter, n=fft_size)[..., :K]
    return torch.exp(env)


class CheapTrickKernel(torch.nn.Module):
    """CheapTrick for one (fs, fft_size): static geometry + forward."""

    def __init__(self, fs, fft_size=None, f0_floor=71.0, q1=-0.15):
        super().__init__()
        self.fs = fs
        self.fft_size = fft_size or fft_size_for_cheaptrick(fs, f0_floor)
        self.f0_floor = f0_floor_for_cheaptrick(fs, self.fft_size)
        self.q1 = q1
        self.max_half_window = int(1.5 * fs / self.f0_floor + 0.5)

    def forward(self, x, f0, temporal_positions, **kw):
        return cheaptrick_frames(
            x, f0, temporal_positions, fs=self.fs, fft_size=self.fft_size,
            max_half_window=self.max_half_window, q1=self.q1,
            f0_floor=self.f0_floor, **kw)
