"""D4C's float32 band aperiodicity — wrapper of the CUDA kernel
``csrc/d4c.cu`` and its plain PyTorch version.

No TPU kernel stands behind it: the JAX package leaves D4C
(worldtpu/analysis/d4c.py ``d4c_frames``) to XLA.  As a chain of PyTorch
operations every step runs over every frame of the batch, voiced or not,
and writes [B, F, ~fft] rows to device memory: LoveTrain's spectrum, two
pairs of centroid spectra, the Hanning spectrum, three smoothings, the
``n_ap`` band spectra and their top-k, the interpolation; a frame that the
LoveTrain gate rejects is computed in full and then replaced by the
default row.  The kernel runs one block a frame from the waveform to its
aperiodicity row, the gate first, the spectra and smoothings in shared
memory, and writes the row once.

``analysis.d4c.d4c_frames`` routes: float64 to its parity branch, a CPU
tensor to the plain version (``d4c_frames_plain``, the chain as it was), a
float32 CUDA tensor to ``d4c_frames_cuda``, which launches the kernel or
raises.

D4C's geometry (its FFT sizes, half windows and band count) lives here,
beside both versions; ``analysis.d4c`` imports it, and nothing here
imports the analysis layer.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as Fn

from worldtpu_torch import _build
from worldtpu_torch import constants as C
from worldtpu_torch.ops import dft, filters, trig
from worldtpu_torch.ops.interp import interp1
from worldtpu_torch.ops.numeric import (device_cache, frame_segments,
                                        matlab_round, rdiv)

#: D4C FFT sizes the kernel is instantiated for (``csrc/d4c.cu``): 2,048 at
#: 16 and 22.05 kHz, 4,096 at 44.1 and 48 kHz, 8,192 at 96 kHz.  16,384
#: (fs from 96,245 Hz) would need more shared memory than a block has;
#: below 15,800 Hz LoveTrain's 7,900 Hz bin lies past fs / 2, where the
#: chain's index fails as well
KERNEL_FFT_SIZES = (2048, 4096, 8192)
#: the coarse bands' slots in the kernel's parameter table (D4C has at
#: most UPPER_LIMIT / FREQUENCY_INTERVAL = 5)
MAX_BANDS = 8


def d4c_fft_size(fs: int) -> int:
    return int(2 ** (1 + int(
        math.log(4.0 * fs / C.FLOOR_F0_D4C + 1) / math.log(2.0))))


def love_train_fft_size(fs: int) -> int:
    return int(2 ** (1 + int(math.log(3.0 * fs / 40.0 + 1) / math.log(2.0))))


def number_of_aperiodicities(fs: int) -> int:
    return int(min(C.UPPER_LIMIT, fs / 2.0 - C.FREQUENCY_INTERVAL)
               / C.FREQUENCY_INTERVAL)


def d4c_max_half_lt(fs: int) -> int:
    return int(1.5 * fs / 40.0 + 0.5)


def d4c_max_half_c(fs: int) -> int:
    return int(2.0 * fs / C.FLOOR_F0_D4C + 0.5)


def _centered_window(seg, f0, fs, window_type, ratio, max_half):
    """Windowed, weight-removed waveform [B, F, W] for windows centred at
    column max_half of seg [B, F, W] (the aligned production layout of
    D4C::getWindowedWaveform)."""
    dt = seg.dtype
    W = 2 * max_half + 1
    half = matlab_round(rdiv(ratio * fs, f0) / 2.0)
    j = torch.arange(W, device=seg.device)
    in_win = torch.abs(j - max_half) <= half[..., None]
    alpha = (C.PI * 2.0 / ratio / fs) * f0
    beta = -alpha * max_half
    if window_type == C.HANNING:
        win = 0.5 * trig.cos_affine(alpha, beta, W) + 0.5
    else:
        c1, c2 = trig.cos_affine(alpha, beta, W, second=True)
        win = 0.42 + 0.5 * c1 + 0.08 * c2
    zero = torch.zeros((), dtype=dt, device=seg.device)
    win = torch.where(in_win, win, zero)
    wave = torch.where(in_win, seg * win, zero)
    weight = (torch.sum(wave, -1, keepdim=True)
              / torch.sum(win, -1, keepdim=True))
    return torch.where(in_win, wave - win * weight, zero)


def coarse_to_bins(ca, active, fs, fft_size_out, n_ap, Ko):
    """Coarse band aperiodicity ca [B, F, n_ap] (dB) -> [B, F, Ko], the
    default 1 - 1e-12 for frames that are not active."""
    dt, dev = ca.dtype, ca.device
    B, F = ca.shape[:2]
    coarse_axis = torch.cat([
        C.FREQUENCY_INTERVAL * torch.arange(n_ap + 1, dtype=dt, device=dev),
        torch.full((1,), fs / 2.0, dtype=dt, device=dev)])
    coarse_vals = torch.cat([
        torch.full((B, F, 1), -60.0, dtype=dt, device=dev), ca,
        torch.full((B, F, 1), -C.MY_SAFE_GUARD_MINIMUM, dtype=dt,
                   device=dev)], dim=-1)
    freq = torch.arange(Ko, dtype=dt, device=dev) * fs / fft_size_out
    ap_db = interp1(coarse_axis, coarse_vals, freq)
    ap_full = torch.pow(10.0, ap_db / 20.0)
    default = torch.full((), 1.0 - C.MY_SAFE_GUARD_MINIMUM, dtype=dt,
                         device=dev)
    return torch.where(active[..., None], ap_full, default)


def d4c_frames_plain(x, f0, temporal_positions, *, fs, fft_size_out,
                     threshold, f0_ceil_bound, sample_offset=None):
    """The batched chain: every step over every frame of [B, F]."""
    dt = x.dtype
    dev = x.device
    f0 = f0.to(dt)
    B, F = f0.shape
    pos = temporal_positions.to(dt)
    fft_d4c = d4c_fft_size(fs)
    fft_lt = love_train_fft_size(fs)
    n_ap = number_of_aperiodicities(fs)
    Ko = fft_size_out // 2 + 1
    zero = torch.zeros((), dtype=dt, device=dev)

    # one shared per-frame waveform neighbourhood for every window
    max_half_lt = d4c_max_half_lt(fs)
    max_half_c = d4c_max_half_c(fs)
    seg_half = max(max_half_lt, max_half_c)
    seg_pad = int(0.25 * fs / C.FLOOR_F0_D4C) + 2
    seg_origin = matlab_round(pos * fs + 0.001)          # [F] or [B, F]
    P_seg = seg_half + seg_pad
    # the shifted centroids' offsets d_f are differences of origins on the
    # frame times; only the reads are relative to the row
    frame_seg = frame_segments(
        x, seg_origin if sample_offset is None
        else seg_origin - sample_offset.to(seg_origin.dtype)[:, None], P_seg)

    def seg_for(max_half):
        d = seg_half - max_half
        return frame_seg[..., d:frame_seg.shape[-1] - d]

    def centered(max_half):
        s = seg_for(max_half)
        return s[..., seg_pad:seg_pad + 2 * max_half + 1]

    def dc_corr(p):
        return filters.dc_correction_frames(
            p.reshape(B * F, -1), f0d.reshape(-1), fs, fft_d4c,
            1.2 * f0_ceil_bound)

    def smooth(p, width, max_b):
        return filters.linear_smoothing_frames(p, width.reshape(-1), fs,
                                               fft_d4c, max_b)

    # ---- LoveTrain voicing gate ----
    f0lt = torch.clamp(f0, min=40.0)
    wave_lt = _centered_window(centered(max_half_lt), f0lt, fs, C.BLACKMAN,
                               3.0, max_half_lt)
    spec_lt = dft.rfft(wave_lt, n=fft_lt)
    ps_lt = spec_lt.real ** 2 + spec_lt.imag ** 2
    b0 = int(math.ceil(100.0 * fft_lt / fs))
    b1 = int(math.ceil(4000.0 * fft_lt / fs))
    b2 = int(math.ceil(7900.0 * fft_lt / fs))
    bins = torch.arange(ps_lt.shape[-1], device=dev)
    ps_lt = torch.where(bins <= b0, zero, ps_lt)
    cum = torch.cumsum(ps_lt, dim=-1)
    ap0 = torch.where(f0 == 0.0, zero, cum[..., b1] / cum[..., b2])
    active = (f0 != 0.0) & (ap0 > threshold)
    f0d = torch.clamp(f0, min=C.FLOOR_F0_D4C)

    # ---- static centroid: the +-0.25/f0 window shift is absorbed into
    #      the window over the full segment; the position-weighted spectrum
    #      follows by linearity (FFT(w*(i+D)) = FFT(w*i) + D*FFT(w)) ----
    fseg_c = seg_for(max_half_c)
    Wc = fseg_c.shape[-1]
    i_c = torch.arange(Wc, device=dev)
    half_c = matlab_round(rdiv(4.0 * fs, f0d) / 2.0)

    def wrap(v):
        # fold a window longer than fft_d4c back circularly (the DFT phase
        # is n-periodic), instead of truncating it
        if v.shape[-1] <= fft_d4c:
            return v
        tail = v[..., fft_d4c:]
        return v[..., :fft_d4c] + Fn.pad(tail,
                                         (0, fft_d4c - tail.shape[-1]))

    def centroid_shifted(at):
        d_f = matlab_round(at * fs + 0.001) - seg_origin            # [B, F]
        m = i_c - (max_half_c + seg_pad) - d_f[..., None]
        in_w = torch.abs(m) <= half_c[..., None]
        alpha = (C.PI * 2.0 / 4.0 / fs) * f0d
        beta = -alpha * (max_half_c + seg_pad + d_f).to(dt)
        cw1, cw2 = trig.cos_affine(alpha, beta, Wc, second=True)
        win = torch.where(in_w, 0.42 + 0.5 * cw1 + 0.08 * cw2, zero)
        wave = torch.where(in_w, fseg_c * win, zero)
        weight = (torch.sum(wave, -1, keepdim=True)
                  / torch.sum(win, -1, keepdim=True))
        w = torch.where(in_w, wave - win * weight, zero)
        w = w / torch.sqrt(torch.sum(w * w, -1, keepdim=True))
        s1 = dft.rfft(wrap(w), n=fft_d4c)
        s2 = dft.rfft(wrap(w * i_c.to(dt)), n=fft_d4c)
        base = s1.real * s2.real + s1.imag * s2.imag
        delta = (half_c - d_f - max_half_c - seg_pad + 1).to(dt)
        p1 = s1.real * s1.real + s1.imag * s1.imag
        return base + delta[..., None] * p1

    quarter = rdiv(0.25, f0d)
    static_centroid = (centroid_shifted(pos - quarter)
                       + centroid_shifted(pos + quarter))
    static_centroid = dc_corr(static_centroid)

    # ---- smoothed power spectrum ----
    wave_h = _centered_window(centered(max_half_c), f0d, fs, C.HANNING, 4.0,
                              max_half_c)
    spec_h = dft.rfft(wave_h, n=fft_d4c)
    sps = dc_corr(spec_h.real ** 2 + spec_h.imag ** 2)
    max_b = int(1.2 * f0_ceil_bound * fft_d4c / fs) + 2
    sps = smooth(sps, f0d, max_b)
    # f32: smoothing can underflow a bin to 0 -> inf group delay; floor it
    sps = torch.clamp(sps, min=torch.finfo(dt).tiny)

    # ---- static group delay ----
    sgd = torch.clamp(static_centroid / sps, -1e12, 1e12)
    max_b_half = int(0.6 * f0_ceil_bound * fft_d4c / fs) + 2
    sgd = smooth(sgd, f0d / 2.0, max_b_half)
    sgd = sgd - smooth(sgd, f0d, max_b)
    sgd = sgd.reshape(B, F, -1)

    # ---- coarse aperiodicity per 3 kHz band ----
    window_length = int(C.FREQUENCY_INTERVAL * fft_d4c / fs) * 2 + 1
    half_w = window_length // 2
    nuttall = filters.nuttall_window(window_length, dt, dev)
    boundary = int(fft_d4c * 8.0 / window_length + 0.5)
    centers = [int(C.FREQUENCY_INTERVAL * (b + 1) * fft_d4c / fs)
               for b in range(n_ap)]
    seg = torch.stack(
        [sgd[..., c - half_w:c - half_w + window_length] for c in centers],
        dim=2) * nuttall                                        # [B,F,n,Wl]
    spec_b = dft.rfft(seg, n=fft_d4c)
    ps_b = spec_b.real ** 2 + spec_b.imag ** 2
    # cum[Kd-b-2] of the ascending sort == total minus the top b+1 values
    hi = torch.sum(ps_b, dim=-1)
    lo = hi - torch.sum(torch.topk(ps_b, boundary + 1, dim=-1).values, -1)
    ca = 10.0 * torch.log10(lo / hi)
    ca = torch.clamp(ca + (f0d[..., None] - 100.0) / 50.0, max=0.0)

    return coarse_to_bins(ca, active, fs, fft_size_out, n_ap, Ko)


@device_cache(maxsize=8)
def _twiddles(fft_size, device):
    """[fft_size, 2] exp(-2 pi i m / fft_size) as (cos, sin) pairs, computed
    in float64 and rounded once to float32; made once per size and
    device."""
    a = (2.0 * C.PI / fft_size) * torch.arange(fft_size, dtype=torch.float64,
                                               device=device)
    return torch.stack([torch.cos(a), -torch.sin(a)], -1).to(
        torch.float32).contiguous()


@device_cache(maxsize=8)
def _nuttall(length, device):
    """The coarse bands' Nuttall window, the chain's bits on this
    device."""
    return filters.nuttall_window(length, torch.float32, device).contiguous()


@functools.lru_cache(maxsize=16)
def kernel_params(fs, fft_size_out, threshold, f0_ceil_bound):
    """The kernel's host tables (int32, float32), as ``csrc/d4c.cu``'s
    ``Params`` reads them.  Each float is the float32 that the chain's
    tensor operation forms from its Python number (``tensor / scalar`` on
    the card multiplies by the scalar's float32 reciprocal).  Raises
    ValueError for an fs the kernel has no instance for."""
    fft_d4c = d4c_fft_size(fs)
    fft_lt = love_train_fft_size(fs)
    # LoveTrain's window fits fft_lt, and fft_lt is fft_d4c or its half
    b2 = int(math.ceil(7900.0 * fft_lt / fs))
    if fft_d4c not in KERNEL_FFT_SIZES or b2 > fft_lt // 2:
        raise ValueError(f"fs {fs}: D4C's fft {fft_d4c}, LoveTrain's 7,900 "
                         f"Hz bin {b2} of {fft_lt // 2}; the kernel takes "
                         f"ffts {KERNEL_FFT_SIZES} with that bin at or "
                         f"below fs / 2 (fs 15,800 ... 96,244 Hz)")
    if fft_lt not in (fft_d4c, fft_d4c // 2):
        raise ValueError(f"fs {fs}: LoveTrain's fft {fft_lt} is neither "
                         f"D4C's {fft_d4c} nor its half")
    n_ap = number_of_aperiodicities(fs)
    # the chain's band geometry and DC correction length
    window_length = int(C.FREQUENCY_INTERVAL * fft_d4c / fs) * 2 + 1
    boundary = int(fft_d4c * 8.0 / window_length + 0.5)
    centers = [int(C.FREQUENCY_INTERVAL * (b + 1) * fft_d4c / fs)
               for b in range(n_ap)]
    K = fft_d4c // 2 + 1
    dc_len = min(K, int(1.2 * f0_ceil_bound * fft_d4c / fs) + 4)
    ints = [fft_d4c, fft_size_out // 2 + 1, d4c_max_half_lt(fs),
            d4c_max_half_c(fs), int(0.25 * fs / C.FLOOR_F0_D4C) + 2,
            int(math.ceil(100.0 * fft_lt / fs)),
            int(math.ceil(4000.0 * fft_lt / fs)), b2, n_ap, window_length,
            window_length // 2, boundary, dc_len, fft_lt]
    ints += centers + [0] * (MAX_BANDS - n_ap)
    f32 = np.float32
    floats = [fs, f32(1.0) / f32(fs), 3.0 * fs, 4.0 * fs,
              C.PI * 2.0 / 3.0 / fs, C.PI * 2.0 / 4.0 / fs, fs / fft_d4c,
              threshold, C.FLOOR_F0_D4C, fft_d4c,
              f32(1.0) / f32(fft_size_out), fs / 2.0,
              1.0 - C.MY_SAFE_GUARD_MINIMUM, -C.MY_SAFE_GUARD_MINIMUM]
    return (torch.tensor(ints, dtype=torch.int32),
            torch.tensor(np.array(floats, dtype=np.float32)))


def d4c_frames_cuda(x, f0, temporal_positions, *, fs, fft_size_out,
                    threshold, f0_ceil_bound, sample_offset=None):
    """Launch ``wt_d4c``: one block a frame; a frame that is unvoiced or
    that the LoveTrain gate rejects writes its default row and ends."""
    ip, fp = kernel_params(int(fs), int(fft_size_out), float(threshold),
                           float(f0_ceil_bound))
    fft_d4c = int(ip[0])
    x = x.contiguous()
    _build.check_tensor(x, "x", torch.float32)
    if x.dim() != 2:
        raise ValueError(f"x: expected [B, T], got {tuple(x.shape)}")
    dev = x.device
    B, T = x.shape
    if f0.dim() != 2 or f0.shape[0] != B:
        raise ValueError(f"f0: expected [{B}, F], got {tuple(f0.shape)}")
    F = f0.shape[1]
    f0 = f0.to(torch.float32).contiguous()
    pos = temporal_positions.to(torch.float32).contiguous()
    _build.check_tensor(f0, "f0", torch.float32, (B, F), dev)
    if pos.dim() == 1:
        _build.check_tensor(pos, "temporal_positions", torch.float32, (F,),
                            dev)
    else:
        _build.check_tensor(pos, "temporal_positions", torch.float32,
                            (B, F), dev)
    off = None
    if sample_offset is not None:
        off = sample_offset.to(torch.int64).contiguous()
        _build.check_tensor(off, "sample_offset", torch.int64, (B,), dev)
    out = torch.empty((B, F, fft_size_out // 2 + 1), dtype=torch.float32,
                      device=dev)
    _build.launch("wt_d4c", dev, x, f0, pos, off,
                  _nuttall(int(ip[9]), dev), _twiddles(fft_d4c, dev), out,
                  ip, fp, B, F, T, int(pos.dim() == 2))
    return out
