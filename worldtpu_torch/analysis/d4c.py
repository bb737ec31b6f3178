"""D4C band aperiodicity, batched over utterances and frames.

Port of worldtpu/analysis/d4c.py (reference src/d4c.cpp): LoveTrain voicing
gate, static group delay from two +-0.25/f0 shifted centroids, smoothed
power spectrum, and the coarse 3 kHz band aperiodicity, interpolated to the
output bins.  float32 is the production branch, in ``ops/d4c_kernel.py``:
on the CPU the chain there (one shared per-frame waveform neighbourhood,
seeded-and-rotated windows, the gather-free shifted centroid, exact top-k
where the TPU used approx_max_k), on the card the CUDA kernel
``csrc/d4c.cu``, one block a frame, which raises for an fs it has no
instance for (below 15,800 Hz, where the chain's LoveTrain index fails
too, and from 96,245 Hz).  float64 is the parity branch
(``_d4c_frames_f64``): every window is the reference's
literal left-aligned getWindowedWaveform read straight from the waveform,
with the optional randn() dither hooks, literal DC correction and
smoothing, and the literal sort and ascending sum of the coarse bands.
"""

from __future__ import annotations

import math

import torch

from worldtpu_torch import constants as C
from worldtpu_torch.ops import d4c_kernel, dft, filters
from worldtpu_torch.ops.d4c_kernel import (coarse_to_bins, d4c_fft_size,
                                           d4c_max_half_c, d4c_max_half_lt,
                                           love_train_fft_size,
                                           number_of_aperiodicities)
from worldtpu_torch.ops.numeric import device_kind, matlab_round, rdiv
from worldtpu_torch.ops.seqsum import cumsum_sequential


def _windowed_waveform_f64(x, f0, position, fs, window_type, ratio,
                           max_half, dither=None, sample_offset=None):
    """D4C::getWindowedWaveform, literal: x [B, T], f0 [B, F], position
    [B, F] or [F] -> [B, F, 2*max_half+1], left-aligned (column j is window
    sample j - half) and zero past the window.  ``dither`` [B, F, W] is
    the reference's ``randn() * kMySafeGuardMinimum``, added to the windowed
    waveform before the weighting step.  ``sample_offset`` [B]: row b of x
    starts at that sample of the recording whose times ``position`` are
    (the origin is rounded on them, then taken relative to the row)."""
    dt = x.dtype
    dev = x.device
    B = x.shape[0]
    half = matlab_round(rdiv(ratio * fs, f0) / 2.0)            # [B, F]
    W = 2 * max_half + 1
    j = torch.arange(W, device=dev)
    base = j - half[..., None]
    in_win = j <= 2 * half[..., None]
    origin = matlab_round(position.to(dt) * fs + 0.001).expand(half.shape)
    if sample_offset is not None:
        origin = origin - sample_offset.to(origin.dtype)[:, None]
    safe = (origin[..., None] + base).clamp(0, x.shape[-1] - 1).long()
    seg = torch.gather(x, 1, safe.reshape(B, -1)).reshape(safe.shape)
    pf = C.PI * f0[..., None] * ((2.0 / ratio / fs) * base.to(dt))
    if window_type == C.HANNING:
        win = 0.5 * torch.cos(pf) + 0.5
    else:
        win = 0.42 + 0.5 * torch.cos(pf) + 0.08 * torch.cos(2.0 * pf)
    zero = torch.zeros((), dtype=dt, device=dev)
    win = torch.where(in_win, win, zero)
    raw = seg * win
    if dither is not None:
        raw = raw + dither.to(dt)
    wave = torch.where(in_win, raw, zero)
    weight = (torch.sum(wave, -1, keepdim=True)
              / torch.sum(win, -1, keepdim=True))
    return torch.where(in_win, wave - win * weight, zero)


def love_train_ap0(x, f0, temporal_positions, *, fs, lt_dither=None,
                   sample_offset=None):
    """The LoveTrain voicing ratio alone (float64): the cumulative power at
    4000 Hz over that at 7900 Hz of a Blackman 3-period frame, 0 where f0
    is 0; x [B, T], f0 [B, F] -> [B, F].  Equal to the gate inside
    ``d4c_frames``: the host derives the main-loop dither stream's gating
    from it (``analysis.dither.d4c_body_dither``)."""
    dt = x.dtype
    f0 = f0.to(dt)
    fft_lt = love_train_fft_size(fs)
    wave_lt = _windowed_waveform_f64(
        x, torch.clamp(f0, min=40.0), temporal_positions, fs, C.BLACKMAN,
        3.0, d4c_max_half_lt(fs), lt_dither, sample_offset)
    spec_lt = dft.rfft(wave_lt, n=fft_lt)
    ps_lt = spec_lt.real ** 2 + spec_lt.imag ** 2
    b0 = int(math.ceil(100.0 * fft_lt / fs))
    b1 = int(math.ceil(4000.0 * fft_lt / fs))
    b2 = int(math.ceil(7900.0 * fft_lt / fs))
    zero = torch.zeros((), dtype=dt, device=x.device)
    bins = torch.arange(ps_lt.shape[-1], device=x.device)
    cum = cumsum_sequential(torch.where(bins <= b0, zero, ps_lt))
    return torch.where(f0 == 0.0, zero, cum[..., b1] / cum[..., b2])


def _d4c_frames_f64(x, f0, pos, *, fs, fft_size_out, threshold,
                    f0_ceil_bound, lt_dither, c1_dither, c2_dither,
                    h_dither, sample_offset=None):
    """The float64 parity branch of ``d4c_frames``."""
    dt = x.dtype
    dev = x.device
    B, F = f0.shape
    fft_d4c = d4c_fft_size(fs)
    n_ap = number_of_aperiodicities(fs)
    Kd = fft_d4c // 2 + 1
    Ko = fft_size_out // 2 + 1
    max_half_c = d4c_max_half_c(fs)

    ap0 = love_train_ap0(x, f0, pos, fs=fs, lt_dither=lt_dither,
                         sample_offset=sample_offset)
    active = (f0 != 0.0) & (ap0 > threshold)
    f0d = torch.clamp(f0, min=C.FLOOR_F0_D4C)
    f0_rows = f0d.reshape(-1)

    ramp = torch.arange(1, 2 * max_half_c + 2, dtype=dt, device=dev)

    def centroid(at, dither):
        w = _windowed_waveform_f64(x, f0d, at, fs, C.BLACKMAN, 4.0,
                                   max_half_c, dither, sample_offset)
        w = w / torch.sqrt(torch.sum(w * w, -1, keepdim=True))
        s1 = dft.rfft(w, n=fft_d4c)
        s2 = dft.rfft(w * ramp, n=fft_d4c)
        return s1.real * s2.real + s1.imag * s2.imag

    def dc_corr(p):
        return filters.dc_correction(p.reshape(B * F, -1), f0_rows, fs,
                                     fft_d4c)

    def smooth(p, width, max_b):
        return filters.linear_smoothing(p, width.reshape(-1), fs, fft_d4c,
                                        max_b)

    quarter = rdiv(0.25, f0d)
    static_centroid = dc_corr(centroid(pos - quarter, c1_dither)
                              + centroid(pos + quarter, c2_dither))
    wave_h = _windowed_waveform_f64(x, f0d, pos, fs, C.HANNING, 4.0,
                                    max_half_c, h_dither, sample_offset)
    spec_h = dft.rfft(wave_h, n=fft_d4c)
    max_b = int(1.2 * f0_ceil_bound * fft_d4c / fs) + 2
    sps = smooth(dc_corr(spec_h.real ** 2 + spec_h.imag ** 2), f0d, max_b)
    sgd = static_centroid / sps
    max_b_half = int(0.6 * f0_ceil_bound * fft_d4c / fs) + 2
    sgd = smooth(sgd, f0d / 2.0, max_b_half)
    sgd = (sgd - smooth(sgd, f0d, max_b)).reshape(B, F, -1)

    window_length = int(C.FREQUENCY_INTERVAL * fft_d4c / fs) * 2 + 1
    half_w = window_length // 2
    nuttall = filters.nuttall_window(window_length, dt, dev)
    boundary = int(fft_d4c * 8.0 / window_length + 0.5)
    centers = [int(C.FREQUENCY_INTERVAL * (b + 1) * fft_d4c / fs)
               for b in range(n_ap)]
    seg = torch.stack(
        [sgd[..., c - half_w:c - half_w + window_length] for c in centers],
        dim=2) * nuttall
    spec_b = dft.rfft(seg, n=fft_d4c)
    ps_b = spec_b.real ** 2 + spec_b.imag ** 2
    # the reference's literal sort and ascending sum
    cum_b = cumsum_sequential(torch.sort(ps_b, dim=-1).values)
    lo, hi = cum_b[..., Kd - boundary - 2], cum_b[..., Kd - 1]
    ca = 10.0 * torch.log10(lo / hi)
    ca = torch.clamp(ca + (f0d[..., None] - 100.0) / 50.0, max=0.0)
    return coarse_to_bins(ca, active, fs, fft_size_out, n_ap, Ko)


def d4c_frames(x, f0, temporal_positions, *, fs, fft_size_out,
               threshold=0.85, f0_ceil_bound=C.CEIL_F0, lt_dither=None,
               c1_dither=None, c2_dither=None, h_dither=None,
               sample_offset=None):
    """Band aperiodicity for all frames.

    Args:
        x: [B, T] waveforms.
        f0: [B, F] contours (0 = unvoiced).
        temporal_positions: [F] frame times (s), or [B, F], one row per
            waveform.
        fft_size_out: output bin geometry (the CheapTrick fft size).
        f0_ceil_bound: bound on the largest f0, sizing smoothing pads.
        lt_dither: optional [B, F, 2*d4c_max_half_lt(fs)+1] LoveTrain window
            parity dither (``analysis.dither``), float64 only.
        c1_dither, c2_dither, h_dither: optional [B, F,
            2*d4c_max_half_c(fs)+1] main-loop window parity dithers
            (centroid -0.25/f0, centroid +0.25/f0, Hanning), float64 only.
        sample_offset: optional [B] int tensor: row b of x starts at sample
            sample_offset[b] of a longer recording whose frame times
            temporal_positions are; window origins are rounded on those
            times, then taken relative to the row (the long-audio path).

    Returns:
        [B, F, fft_size_out//2 + 1] aperiodicity in (0, 1].
    """
    dt = x.dtype
    dithers = (lt_dither, c1_dither, c2_dither, h_dither)
    if dt == torch.float64:
        return _d4c_frames_f64(
            x, f0.to(dt), temporal_positions.to(dt), fs=fs,
            fft_size_out=fft_size_out, threshold=threshold,
            f0_ceil_bound=f0_ceil_bound, lt_dither=lt_dither,
            c1_dither=c1_dither, c2_dither=c2_dither, h_dither=h_dither,
            sample_offset=sample_offset)
    if any(d is not None for d in dithers):
        raise ValueError("the parity dithers belong to the float64 path")
    run = (d4c_kernel.d4c_frames_plain if device_kind(x) == "cpu"
           else d4c_kernel.d4c_frames_cuda)
    return run(x, f0, temporal_positions, fs=fs, fft_size_out=fft_size_out,
               threshold=threshold, f0_ceil_bound=f0_ceil_bound,
               sample_offset=sample_offset)
