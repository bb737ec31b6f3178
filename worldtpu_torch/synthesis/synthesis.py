"""WORLD synthesis, batched over utterances: pulse + noise excitation of
minimum-phase filters, overlap-added by the OLA kernel.

Port of worldtpu/synthesis/synthesis.py (reference src/synthesis.cpp).
In float32, the production path, pulse timing is Q32 fixed-point phase
accumulation: the per-sample phase step in 1/2^32 cycles is summed exactly
(int64 cumsum, masked to 32 bits — the JAX version's int32 wraparound), and
a pulse falls where the phase wraps.  In float64, the parity path, it is
the reference's double accumulation, strictly left to right
(``cumsum_sequential``), with ``fmod``: a reassociated sum flips a pulse
boundary when a wrap lands within rounding of pi.  The pulse axis is padded
to a static ``max_pulses`` with masked tail pulses at sample T-1.  The
overlap-add sums each output sample in pulse order in either dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from worldtpu_torch import constants as C
from worldtpu_torch.ops import dft, trig
from worldtpu_torch.ops.fftutil import minimum_phase
from worldtpu_torch.ops.interp import interp1
from worldtpu_torch.ops.ola_kernel import overlap_add
from worldtpu_torch.ops.seqsum import cumsum_sequential
from worldtpu_torch.tracing import stage

_Q32 = 4294967296.0


def dc_remover(fft_size, dtype=torch.float32, device=None):
    """Half raised-cosine DC remover normalized so the mirrored kernel sums
    to 1 (reference getDCRemover); returns the first half."""
    half = fft_size // 2
    i = torch.arange(half, dtype=dtype, device=device)
    v = 0.5 - 0.5 * torch.cos(2.0 * C.PI / (1.0 + fft_size) * (i + 1.0))
    return v / (torch.sum(v) * 2.0)


def _time_base(f0, fs, frame_period_s, out_length, lowest_f0, max_pulses):
    """Sample-grid F0/voicing and pulse locations for f0 [B, F].

    Returns (idx [B, P] int64, shift [B, P], n_pulses [B], vuv_at [B, P],
    valid [B, P], overflowed [B]); P = max_pulses, pulses in time order and
    padded with sample T-1."""
    dt = f0.dtype
    dev = f0.device
    B, F = f0.shape
    T = out_length
    zero = torch.zeros((), dtype=dt, device=dev)
    coarse_f0 = torch.where(f0 < lowest_f0, zero, f0)
    coarse_vuv = (coarse_f0 != 0.0).to(dt)
    # appended extrapolation knot (reference :240-242)
    coarse_f0 = torch.cat(
        [coarse_f0, coarse_f0[:, -1:] * 2 - coarse_f0[:, -2:-1]], dim=1)
    coarse_vuv = torch.cat(
        [coarse_vuv, coarse_vuv[:, -1:] * 2 - coarse_vuv[:, -2:-1]], dim=1)

    t = torch.arange(T, dtype=dt, device=dev) / fs
    f64 = dt == torch.float64
    if f64:      # parity path: the literal histc search over the knots
        coarse_t = torch.arange(F + 1, dtype=dt, device=dev) * frame_period_s
        f0i = interp1(coarse_t, coarse_f0, t)
        vuvi = interp1(coarse_t, coarse_vuv, t)
    else:
        # uniform knots: the histc search collapses to direct indexing
        k = torch.clamp((t / frame_period_s).to(torch.int32) + 1, 1,
                        F).long()
        x0 = k.to(dt) * frame_period_s - frame_period_s
        s = (t - x0) / frame_period_s
        f0_lo, f0_hi = coarse_f0[:, k - 1], coarse_f0[:, k]
        v_lo, v_hi = coarse_vuv[:, k - 1], coarse_vuv[:, k]
        f0i = f0_lo + s * (f0_hi - f0_lo)
        vuvi = v_lo + s * (v_hi - v_lo)
    vuvi = (vuvi > 0.5).to(dt)
    f0i = torch.where(vuvi == 0.0, torch.full((), C.DEFAULT_F0, dtype=dt,
                                              device=dev), f0i)

    if f64:
        # double accumulation in order + fmod, as the reference's loop
        total = cumsum_sequential(f0i * (2.0 * C.PI / fs))
        wrap = torch.fmod(total, 2.0 * C.PI)
        frac = wrap / (2.0 * C.PI)
        carry = torch.abs(wrap[:, 1:] - wrap[:, :-1]) > C.PI
    else:
        # Q32 fixed point: f0/fs cycles per sample in 1/2^32 units
        step = (f0i / fs * _Q32 + 0.5).to(torch.int64)
        fbits = torch.cumsum(step, dim=1) & 0xFFFFFFFF
        frac = fbits.to(dt) / _Q32
        carry = fbits[:, 1:] < fbits[:, :-1]                   # [B, T-1]

    # static-size nonzero: rank by cumsum, scatter the sample index to its
    # rank (no host sync); the extra slot takes pulses past max_pulses
    rank = torch.cumsum(carry, dim=1) - 1
    dest = torch.where(carry & (rank < max_pulses), rank, max_pulses)
    idx = torch.full((B, max_pulses + 1), T - 1, dtype=torch.int64,
                     device=dev)
    pos = torch.arange(T - 1, device=dev).expand(B, T - 1)
    idx.scatter_(1, dest, pos)
    idx = idx[:, :max_pulses]
    n_true = carry.sum(1)
    n_pulses = torch.clamp(n_true, max=max_pulses)
    overflowed = n_true > max_pulses
    valid = torch.arange(max_pulses, device=dev) < n_pulses[:, None]

    f_lo = frac.gather(1, idx)
    f_hi = frac.gather(1, (idx + 1).clamp(max=T - 1))
    # x = -y1/(y2-y1) with y1 = wrap[i]-2pi, y2 = wrap[i+1] (in cycles)
    shift = (1.0 - f_lo) / (f_hi + 1.0 - f_lo) / fs
    vuv_at = vuvi.gather(1, idx)
    return idx, shift, n_pulses, vuv_at, valid, overflowed


def pulse_responses(pt, shift, ns, vuv_at, valid, spectrogram,
                    aperiodicity, noise, *, fs, fft_size, frame_offset=0):
    """Per-pulse impulse responses [B, P, fft_size] (reference :308-344).

    pt: [B, P] fractional frame position of each pulse; shift: [B, P]
    sub-sample time shift (s); ns: [B, P] noise size; vuv_at, valid: [B, P];
    spectrogram, aperiodicity: [B, F, K]; noise: [B, P, fft_size].
    frame_offset: [B] int tensor (or 0), the global frame index of each
    row's first spectrogram frame.  Chunked callers (``longaudio``) pass
    the GLOBAL pt and their block offsets, so floor and ceil are taken on
    the same float values as the unchunked path's before the offset is
    subtracted: a locally rebased pt can floor to the neighbouring frame at
    knife edges."""
    dt = spectrogram.dtype
    dev = spectrogram.device
    K = fft_size // 2 + 1
    half = fft_size // 2
    B, F, _ = spectrogram.shape
    P = pt.shape[1]
    off = (frame_offset[:, None] if isinstance(frame_offset, torch.Tensor)
           else frame_offset)

    # ---- per-pulse envelope / aperiodic ratio (reference :346-393) ----
    fl = (torch.floor(pt).to(torch.int32) - off).clamp(0, F - 1).long()
    ce = (torch.ceil(pt).to(torch.int32) - off).clamp(0, F - 1).long()
    w = (pt - torch.floor(pt))[..., None]
    same = (fl == ce)[..., None]

    def rows(a, i):
        return a.gather(1, i[..., None].expand(B, P, K))

    sp = torch.abs(spectrogram)
    spec = torch.where(same, rows(sp, fl),
                       (1.0 - w) * rows(sp, fl) + w * rows(sp, ce))
    apc = torch.clamp(aperiodicity, 0.001, 0.999999999999)
    ap = torch.where(same, rows(apc, fl),
                     (1.0 - w) * rows(apc, fl) + w * rows(apc, ce)) ** 2

    # ---- periodic + aperiodic responses, one batched minimum phase ----
    per_on = (vuv_at > 0.5) & (ap[..., 0] <= 0.999)
    log_per = torch.log(spec * (1.0 - ap) + C.MY_SAFE_GUARD_MINIMUM) / 2.0
    log_ap = torch.where((vuv_at != 0.0)[..., None],
                         torch.log(spec * ap) / 2.0, torch.log(spec) / 2.0)
    mp_both = minimum_phase(torch.cat([log_per, log_ap], dim=1))
    mp_per, mp_ap = mp_both[:, :P], mp_both[:, P:]

    coeff = (2.0 * C.PI * fs / fft_size) * shift
    if dt == torch.float64:      # parity path: the literal cosine grid
        re2 = torch.cos(coeff[..., None]
                        * torch.arange(K, dtype=dt, device=dev))
    else:
        # seed-and-rotate cos; the 2-term combine can overshoot |1| by an ulp
        re2 = torch.clamp(trig.cos_affine(coeff, torch.zeros_like(coeff), K),
                          -1.0, 1.0)
    im2 = torch.sqrt(1.0 - re2 * re2)  # |sin|: the reference's :452 quirk
    phase = torch.complex(re2, -im2)

    j = torch.arange(fft_size, device=dev)
    nmask = j < ns[..., None]
    nz = noise.to(dt) * nmask
    nmean = torch.sum(nz, -1, keepdim=True) / ns.clamp(min=1)[..., None]
    nz = torch.where(nmask, nz - nmean, torch.zeros((), dtype=dt, device=dev))
    nspec = dft.rfft(nz)

    both = dft.irfft(torch.cat([mp_per * phase, mp_ap * nspec], dim=1),
                     n=fft_size) * fft_size
    both = torch.roll(both, half, dims=-1)  # fftshift
    per, aper = both[:, :P], both[:, P:]
    dc = torch.sum(per[..., half:], dim=-1, keepdim=True)
    dcr = dc_remover(fft_size, dt, dev)
    per = torch.cat([-dc * dcr, per[..., half:] - dc * dcr], dim=-1)
    per = torch.where(per_on[..., None], per, torch.zeros((), dtype=dt,
                                                          device=dev))

    resp = (per * torch.sqrt(ns.to(dt))[..., None] + aper) / fft_size
    return torch.where(valid[..., None], resp, torch.zeros((), dtype=dt,
                                                           device=dev))


def synthesis_frames_impl(f0, spectrogram, aperiodicity, noise, *, fs,
                          fft_size, frame_period_s, out_length, max_pulses,
                          return_overflow=False):
    """Synthesize waveforms from (f0, spectrogram, aperiodicity).

    Args:
        f0: [B, F] contours (0 = unvoiced).
        spectrogram, aperiodicity: [B, F, K], K = fft_size//2 + 1.
        noise: [B, max_pulses, fft_size] standard-normal rows (masked to
            each pulse's noise size).
        frame_period_s: frame period in seconds.

    Returns:
        [B, out_length], or (that, overflowed [B]) with ``return_overflow``
        — overflowed marks a true pulse count above max_pulses (tail pulses
        dropped; regrow max_pulses and rerun).
    """
    with stage("pulse_train", f0.device):
        resp, starts, n_pulses, overflowed = pulse_train(
            f0, spectrogram, aperiodicity, noise, fs=fs, fft_size=fft_size,
            frame_period_s=frame_period_s, out_length=out_length,
            max_pulses=max_pulses)
    with stage("ola", f0.device):
        y = overlap_add(resp, starts, out_length, n_pulses)
    return (y, overflowed) if return_overflow else y


def synthesis_frames(f0, spectrogram, aperiodicity, noise, *, fs, fft_size,
                     frame_period_s, out_length, max_pulses,
                     return_overflow=False):
    """One utterance: f0 [F], spectrogram and aperiodicity [F, K], noise
    [max_pulses, fft_size] -> y [out_length] (and its overflow flag, a
    0-dim bool tensor, with ``return_overflow``)."""
    y, ovf = synthesis_frames_impl(
        f0[None], spectrogram[None], aperiodicity[None], noise[None], fs=fs,
        fft_size=fft_size, frame_period_s=frame_period_s,
        out_length=out_length, max_pulses=max_pulses, return_overflow=True)
    return (y[0], ovf[0]) if return_overflow else y[0]


def pulse_train(f0, spectrogram, aperiodicity, noise, *, fs, fft_size,
                frame_period_s, out_length, max_pulses):
    """Everything before the overlap-add: (resp [B, P, fft_size],
    starts [B, P] int32 non-decreasing, n_pulses [B] int64 real pulses
    (the rest are padding with zero responses), overflowed [B])."""
    dt = spectrogram.dtype
    f0 = f0.to(dt)
    half = fft_size // 2
    lowest_f0 = fs / fft_size + 1.0

    idx, shift, n_pulses, vuv_at, valid, overflowed = _time_base(
        f0, fs, frame_period_s, out_length, lowest_f0, max_pulses)

    # noise_size[i] = idx[min(n-1, i+1)] - idx[i]  (reference :106)
    nxt = torch.minimum(torch.arange(max_pulses, device=f0.device) + 1,
                        (n_pulses - 1)[:, None]).clamp(min=0)
    ns = torch.where(valid, idx.gather(1, nxt) - idx, 0)

    pt = idx.to(dt) / fs / frame_period_s
    resp = pulse_responses(pt, shift, ns, vuv_at, valid, spectrogram,
                           aperiodicity, noise, fs=fs, fft_size=fft_size)
    return (resp.contiguous(), (idx - half + 1).to(torch.int32), n_pulses,
            overflowed)


def make_noise(generator, batch, max_pulses, fft_size, dtype=torch.float32,
               device=None):
    """Production noise input [batch, max_pulses, fft_size] (standard
    normal) from a torch.Generator."""
    return torch.randn((batch, max_pulses, fft_size), generator=generator,
                       dtype=dtype, device=device)


def xorshift_noise(ns, fft_size, gen=None):
    """The reference's synthesis noise for one utterance, from its
    sequential ``randn()`` stream: pulse i draws ns[i] values (its noise
    size) into row i of a [len(ns), fft_size] float64 numpy array, the rest
    zero.  Returns (noise, the generator); a new generator starts at the
    seed of a fresh process, as the reference's synthesis run does."""
    from worldtpu_torch.native import XorshiftRandn
    if gen is None:
        gen = XorshiftRandn()
    noise = np.zeros((len(ns), fft_size), np.float64)
    for i, m in enumerate(np.asarray(ns).tolist()):
        if m > 0:
            noise[i, :m] = gen.draw(m)
    return noise, gen


def parity_noise(f0, *, fs, fft_size, frame_period_s, out_length,
                 max_pulses, gen=None):
    """The [max_pulses, fft_size] float64 noise (numpy) with which the
    float64 synthesis of contour f0 [F] reproduces the reference's output:
    the float64 time base gives each pulse's noise size, and
    ``xorshift_noise`` draws the stream in pulse order, from ``gen`` (a
    generator that the analysis dithers have advanced, as in the
    reference's whole pipeline) or from a fresh one (synthesis alone)."""
    f0 = torch.as_tensor(np.asarray(f0), dtype=torch.float64)[None]
    idx, _, n_pulses, _, valid, _ = _time_base(
        f0, fs, frame_period_s, out_length, fs / fft_size + 1.0, max_pulses)
    nxt = torch.minimum(torch.arange(max_pulses) + 1,
                        (n_pulses - 1)[:, None]).clamp(min=0)
    ns = torch.where(valid, idx.gather(1, nxt) - idx, 0)[0].numpy()
    return xorshift_noise(ns, fft_size, gen)[0]


def estimate_max_pulses(f0, fs, fft_size, out_length, margin=1.15,
                        pitch_scale=1.0):
    """Pulse-count bound from a known F0 contour [F] or [B, F] (numpy):
    the number of whole phase cycles, the mean of the F0 with the 500 Hz
    unvoiced rate times the duration, with a margin, rounded up to 256 and
    capped by default_max_pulses.  ``pitch_scale`` scales the voiced F0
    only, as the main path does before its unvoiced substitution."""
    f0 = np.atleast_2d(np.asarray(f0, np.float64)) * pitch_scale
    lowest = fs / fft_size + 1.0
    fhat = np.where(f0 < lowest, C.DEFAULT_F0, f0)
    cycles = float(np.mean(fhat, axis=-1).max()) * (out_length / fs)
    est = int(cycles * margin) + 32
    return min(default_max_pulses(out_length, fs), -(-est // 256) * 256)


def capacity_max_pulses(out_length, fs, f0_cap=C.DEFAULT_F0, margin=1.15):
    """Static pulse-count bound for unseen audio: the time base pulses at
    the voiced F0 and at the 500 Hz default rate where unvoiced, so the
    mean rate is bounded by max(f0_cap, DEFAULT_F0); quantized to 256."""
    rate = max(float(f0_cap), C.DEFAULT_F0)
    est = int(out_length / fs * rate * margin) + 32
    hard = default_max_pulses(out_length, fs)
    return min(hard, -(-est // 256) * 256)


def default_max_pulses(out_length, fs, f0_ceil=C.CEIL_F0):
    """Reference pulse bound out_length/(fs/max_f0) with max_f0 the Harvest
    ceiling (or the unvoiced 500 Hz default)."""
    max_f0 = max(float(f0_ceil), C.DEFAULT_F0)
    return int(out_length / int(fs / max_f0)) + 2
