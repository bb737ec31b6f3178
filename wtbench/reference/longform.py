"""The plain reference of long-audio copy-synthesis: what
``worldtpu_torch.longaudio.LongPipeline.copy_synthesis`` computes in
float32, computed without its chunks wherever the program claims that its
chunks change nothing.

``longaudio.py``'s docstring states the semantics:

  - F0: LongHarvest.  The recording, zero-padded, is cut into windows of
    chunk + a halo each side on the grid where samples and the decimation
    align; each window runs Harvest's device stages (decimation, band
    candidates, refinement, pruning: here the reference's plain stages,
    ``analysis.harvest.harvest_device_stages``); each window's rows are
    kept on the 1 ms grid over its chunk (its first chunk from 0) and
    stitched; the host contour (``analysis.contour``: fix, then smooth)
    runs once over the whole grid; F0 is picked at the frame period and
    scaled by the pitch.  The windows are part of the semantics (Harvest
    of the whole recording at once is another computation), so the
    reference cuts them as the program does.
  - Envelope and aperiodicity: CheapTrick and D4C at the recording's own
    frame times over the whole, unchunked signal (its edge samples
    replicated), at the pitch-scaled F0: ``cheaptrick_frames`` and
    ``d4c_frames`` of ``wtbench.reference`` in blocks of ``FRAME_BLOCK``
    frames, each reading the whole signal.
  - Synthesis: the unchunked float32 time base over the whole output
    (``synthesis._time_base``: global sample times, the Q32 steps summed
    over the whole output), its pulses in time order, noise row n of the
    n-th pulse drawn by its global ordinal (``noise.normal_rows``), the
    plain pulse chain (``synthesis.pulse_responses``) in blocks of
    ``PULSE_BLOCK`` pulses, and the overlap-add of every response in
    pulse order (``overlap_add_in_order``).

Departures: the noise's normals take ``torch.erfinv`` (``noise.py``); the
contour's smoothing holds each section's edges for ``contour.HOLD``
frames (``analysis/contour.py``); the overlap-add sums each output sample
in float32 in pulse order over the whole output, where the program sums
a chunk's pulses in float32 into the chunk's buffer and adds the buffers
on the host in float64.  Everything runs on the device of the input
(float32 without TF32: the harness's setting) except the contour, on the
host in float64.

``harvest_f0`` and ``resynthesis`` are the two halves: the check of the
long cell holds the program's F0 to the first and its y to the second at
the program's own F0 (``wtbench/entries/long.py``, ``reference_y``).

The ap3db fault of ``wtbench/control.py`` replaces
``wtbench.reference.d4c_frames``; this module calls it through the
package so that the fault reaches it.
"""

from __future__ import annotations

import numpy as np
import torch

from wtbench import reference as R
from wtbench.reference import constants as C
from wtbench.reference import noise as N
from wtbench.reference.analysis import contour as CT
from wtbench.reference.analysis import harvest as H
from wtbench.reference.ops.fftutil import fft_size_for_cheaptrick
from wtbench.reference.synthesis import synthesis as S

#: LongHarvest windows a call of the plain device stages takes
WINDOW_BATCH = 8
#: analysis frames a call of CheapTrick or D4C takes
FRAME_BLOCK = 8192
#: pulses a call of the pulse chain takes
PULSE_BLOCK = 16384
#: output samples an overlap-add pass gathers
SAMPLE_BLOCK = 1 << 20


def grid_unit_ms(fs, ratio):
    """The least whole number of ms that is a whole number of samples
    divisible by the decimation ratio: LongHarvest's window grid."""
    for u in (1, 2, 4, 5, 8, 10, 20, 25, 40, 50, 100, 125, 200, 250, 500,
              1000):
        s = fs * u
        if s % 1000 == 0 and (s // 1000) % ratio == 0:
            return u
    raise ValueError(f"no window grid for fs={fs}, ratio={ratio}")


def harvest_f0(x, *, fs, frame_period_ms, f0_floor, f0_ceil, chunk_ms,
               halo_ms):
    """LongHarvest's F0 of x [n] (a float32 tensor on the device): float64
    numpy [1 + int(1000 n / fs / frame_period_ms)]."""
    ratio = max(1, min(12, int(fs / 8000.0 + 0.5)))
    u = grid_unit_ms(fs, ratio)
    chunk_ms = -(-chunk_ms // u) * u
    halo_ms = -(-halo_ms // u) * u
    Tc = (chunk_ms + 2 * halo_ms) * fs // 1000
    stride, halo = chunk_ms * fs // 1000, halo_ms * fs // 1000
    n = int(x.shape[0])
    n_win = max(1, -(-n // stride))
    xp = torch.zeros(max(Tc, n_win * stride + halo), dtype=torch.float32,
                     device=x.device)
    xp[:n] = x
    starts = [0] + [k * stride - halo for k in range(1, n_win)]
    geo = H.HarvestGeometry(fs, Tc, f0_floor=f0_floor, f0_ceil=f0_ceil,
                            frame_period=frame_period_ms)
    F = n_win * chunk_ms + 1
    cand = np.zeros((F, geo.max_candidates))
    score = np.zeros((F, geo.max_candidates))
    for b0 in range(0, n_win, WINDOW_BATCH):
        rows = starts[b0:b0 + WINDOW_BATCH]
        xb = torch.stack([xp[s:s + Tc] for s in rows])
        mean = torch.zeros(len(rows), dtype=torch.float32, device=x.device)
        c, s = (t.cpu().numpy() for t in H.harvest_device_stages(
            xb, mean, geo=geo))
        for i in range(len(rows)):
            k = b0 + i
            # window 0 keeps [0, chunk + halo), window k the 1 ms frames
            # of its chunk, [k chunk + halo, (k + 1) chunk + halo)
            lo, llo = (0, 0) if k == 0 else (k * chunk_ms + halo_ms,
                                             2 * halo_ms)
            hi = min((k + 1) * chunk_ms + halo_ms, F)
            cand[lo:hi] = c[i, llo:llo + hi - lo]
            score[lo:hi] = s[i, llo:llo + hi - lo]
    f0_1ms = CT.smooth_f0_contour(CT.fix_f0_contour(cand, score))
    n_out = 1 + int(1000.0 * n / fs / frame_period_ms)
    t_ms = np.arange(n_out) * frame_period_ms / 1000.0 * 1000.0
    pick = np.minimum(F - 1, np.where(t_ms > 0, np.floor(t_ms + 0.5),
                                      np.ceil(t_ms - 0.5)).astype(int))
    return f0_1ms[pick]


def analysis(x, f0, *, fs, frame_period_ms, fft_size):
    """CheapTrick's envelope and D4C's aperiodicity [F, fft/2 + 1] of x [n]
    at F0 f0 [F] (float32 tensors on one device), at the frame times
    arange(F) * frame period."""
    F = int(f0.shape[0])
    tpos = torch.arange(F, dtype=torch.float32, device=x.device) \
        * (frame_period_ms / 1000.0)
    ct_floor = 3.0 * fs / (fft_size - 3.0)
    half = int(1.5 * fs / ct_floor + 0.5)
    spec, ap = [], []
    for f in range(0, F, FRAME_BLOCK):
        blk = slice(f, f + FRAME_BLOCK)
        spec.append(R.cheaptrick_frames(x[None], f0[None, blk], tpos[blk],
                                        fs=fs, fft_size=fft_size,
                                        max_half_window=half)[0])
        ap.append(R.d4c_frames(x[None], f0[None, blk], tpos[blk], fs=fs,
                               fft_size_out=fft_size)[0])
    return torch.cat(spec), torch.cat(ap)


def overlap_add_in_order(resp, starts, out_length):
    """y [out_length] float32: y[s] is the sum over pulses p in time order
    of resp[p, s - starts[p]] (resp [P, fft], starts [P] non-decreasing),
    each sample's sum taken from 0 pulse by pulse."""
    P, fft = resp.shape
    dev = resp.device
    st = starts.to(torch.int64).contiguous()
    flat = resp.reshape(-1)
    y = torch.zeros(out_length, dtype=resp.dtype, device=dev)
    for s0 in range(0, out_length, SAMPLE_BLOCK):
        s = torch.arange(s0, min(s0 + SAMPLE_BLOCK, out_length), device=dev)
        # the pulses that cover s: starts in (s - fft, s]
        lo = torch.searchsorted(st, s - fft, right=True)
        hi = torch.searchsorted(st, s, right=True)
        acc = torch.zeros(len(s), dtype=resp.dtype, device=dev)
        for i in range(int((hi - lo).max()) if P else 0):
            p = lo + i
            on = p < hi
            pc = torch.where(on, p, 0)
            v = flat[pc * fft + torch.where(on, s - st[pc], 0)]
            acc = acc + torch.where(on, v, torch.zeros((), dtype=v.dtype,
                                                       device=dev))
        y[s0:s0 + len(s)] = acc
    return y


def synthesis(f0, spec, ap, *, seed, fs, fft_size, frame_period_s):
    """y [(F - 1) frame_period_s fs + 1] float32 of F0 f0 [F], spec and ap
    [F, fft/2 + 1] (on one device) with the noise of ``seed``."""
    F = int(f0.shape[0])
    out_length = int((F - 1) * frame_period_s * fs) + 1
    # a bound on the pulses: the time base pulses at the voiced F0 and at
    # 500 Hz where unvoiced; twice the highest leaves room for the
    # extrapolated last knot
    f0_cap = 2.0 * max(float(f0.max()), C.DEFAULT_F0)
    cap = int(out_length / int(fs / f0_cap)) + 2
    idx, shift, n_p, vuv_at, valid, ovf = S._time_base(
        f0[None], fs, frame_period_s, out_length, fs / fft_size + 1.0, cap)
    if bool(ovf.any()):
        raise RuntimeError("the reference's pulse capacity was exceeded")
    P = int(n_p[0])
    idx, shift, vuv_at = idx[0, :P], shift[0, :P], vuv_at[0, :P]
    # noise size: samples to the next pulse, 0 for the last (reference
    # :106)
    ns = torch.cat([idx[1:] - idx[:-1], idx.new_zeros(min(P, 1))])
    pt = idx.to(torch.float32) / fs / frame_period_s
    resp = torch.empty((P, fft_size), dtype=torch.float32, device=f0.device)
    for p0 in range(0, P, PULSE_BLOCK):
        blk = slice(p0, min(p0 + PULSE_BLOCK, P))
        m = blk.stop - p0
        noise = N.normal_rows(seed, p0, m, fft_size, f0.device)
        resp[blk] = S.pulse_responses(
            pt[None, blk], shift[None, blk], ns[None, blk],
            vuv_at[None, blk], torch.ones((1, m), dtype=torch.bool,
                                          device=f0.device),
            spec[None], ap[None], noise[None], fs=fs,
            fft_size=fft_size)[0]
    return overlap_add_in_order(resp, idx - fft_size // 2 + 1, out_length)


@torch.no_grad()
def resynthesis(x, f0, *, seed, fs, duration_scale, frame_period_ms=5.0):
    """y [out_length] float32 numpy of the recording x [n] (a float32
    tensor) at the (pitch-scaled) F0 f0 [F] (float64 numpy, as
    ``harvest_f0`` gives it times the pitch): the envelope, the
    aperiodicity and the synthesis on x's device."""
    f0_t = torch.as_tensor(np.asarray(f0, np.float64).astype(np.float32),
                           device=x.device)
    fft = fft_size_for_cheaptrick(fs, C.FLOOR_F0)
    spec, ap = analysis(x, f0_t, fs=fs, frame_period_ms=frame_period_ms,
                        fft_size=fft)
    y = synthesis(f0_t, spec, ap, seed=seed, fs=fs, fft_size=fft,
                  frame_period_s=frame_period_ms / 1000.0 * duration_scale)
    return y.cpu().numpy()


@torch.no_grad()
def copy_synthesis(x, *, seed, fs, pitch_scale, duration_scale,
                   frame_period_ms=5.0, f0_floor=40.0, f0_ceil=800.0,
                   chunk_ms=8000, halo_ms=1000):
    """(y [out_length] float32 numpy, F0 [F] float64 numpy) of the
    recording x [n] (a float32 tensor; everything runs on its device but
    the contour): LongPipeline(fs, frame_period, f0_floor, f0_ceil,
    harvest_chunk_ms=chunk_ms, harvest_halo_ms=halo_ms).copy_synthesis(x,
    seed=seed, pitch_scale=, duration_scale=)."""
    f0 = harvest_f0(x, fs=fs, frame_period_ms=frame_period_ms,
                    f0_floor=f0_floor, f0_ceil=f0_ceil, chunk_ms=chunk_ms,
                    halo_ms=halo_ms) * pitch_scale
    return resynthesis(x, f0, seed=seed, fs=fs,
                       duration_scale=duration_scale,
                       frame_period_ms=frame_period_ms), f0
