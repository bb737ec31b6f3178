"""D4C band aperiodicity, batched over utterances and frames.

Port of worldtpu/analysis/d4c.py (reference src/d4c.cpp): LoveTrain voicing
gate, static group delay from two +-0.25/f0 shifted centroids, smoothed
power spectrum, and the coarse 3 kHz band aperiodicity, interpolated to the
output bins.  float32 is the production branch: one shared per-frame
waveform neighbourhood, seeded-and-rotated windows, the gather-free shifted
centroid, exact top-k where the TPU used approx_max_k.  float64 is the
parity branch (``_d4c_frames_f64``): every window is the reference's
literal left-aligned getWindowedWaveform read straight from the waveform,
with the optional randn() dither hooks, literal DC correction and
smoothing, and the literal sort and ascending sum of the coarse bands.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from worldtpu_torch import constants as C
from worldtpu_torch.analysis.cheaptrick import frame_segments
from worldtpu_torch.ops import dft, filters, trig
from worldtpu_torch.ops.interp import interp1
from worldtpu_torch.ops.numeric import matlab_round, rdiv
from worldtpu_torch.ops.seqsum import cumsum_sequential


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
    return _coarse_to_bins(ca, active, fs, fft_size_out, n_ap, Ko)


def _coarse_to_bins(ca, active, fs, fft_size_out, n_ap, Ko):
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

    return _coarse_to_bins(ca, active, fs, fft_size_out, n_ap, Ko)
