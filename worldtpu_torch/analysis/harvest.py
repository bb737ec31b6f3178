"""Harvest F0 estimation, batched over utterances.

Port of worldtpu/analysis/harvest.py (reference src/harvest.cpp): decimate
-> band filter bank (blocked-Toeplitz matmul) -> zero-crossing candidates
(zc kernel) -> per-frame run detection -> +-3-frame overlap -> refinement
(refine kernel) -> neighbour-consistency pruning -> device contour chain.
Every stage takes a leading batch axis B where the JAX package vmapped.
The internal candidate grid is the reference's 1 ms grid; float32 callers
may pass ``grid`` (``grid_ms`` on the classes) = k > 1 for a k ms grid, the
JAX package's ``WORLDTPU_GRID_MS`` fast mode as an argument: every
per-frame stage and the contour chain then run on 1/k of the frames.  Each
stage of the main path runs inside ``tracing.stage``: a host range named
``wt.<stage>`` and, on the card, device marks that a replayed graph keeps,
so one profiled call gives the time of every stage.
``harvest_device_stages`` is the one float32 stage sequence: a single
device runs it with ``WHOLE``, ``parallel.batch`` with the ``Split`` of a
mesh's time ranks.

float32 is the production path above.  float64 is the parity path, with the
reference's literal semantics and no hand-written kernel (the JAX package's
float64 path runs none either): the circular-FFT band filter, dense
zero-crossing events with histc interpolation, per-pair refine windows
with full FFTs, pruning over every slot, and the host contour
(``analysis.contour``) after an int-truncated mean.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as Fn

from worldtpu_torch import constants as C
from worldtpu_torch.ops import filters
from worldtpu_torch.ops import refine_kernel as _refine
from worldtpu_torch.ops import zc_kernel as _zc
from worldtpu_torch.ops.fftutil import get_suitable_fft_size
from worldtpu_torch.ops.interp import interp1
from worldtpu_torch.ops.numeric import (device_cache, download,
                                       matlab_round, rdiv)
from worldtpu_torch.parallel import graphs as _graphs
from worldtpu_torch.tracing import stage

#: near-duplicate candidate tolerance of the production refine
#: (worldtpu.analysis.harvest.REFINE_DEDUP_TOL)
REFINE_DEDUP_TOL = 0.004


def _matlab_round_py(x):
    return int(x + 0.5) if x > 0 else int(x - 0.5)


class HarvestGeometry:
    """Static geometry shared by all stages (the reference ctor's
    preallocation math), re-derived in numpy; field for field equal to
    ``worldtpu.analysis.harvest.HarvestGeometry``.  The port computes the
    refine windows directly, so ``use_cos_table`` (the JAX package's
    table-lookup mode) is always False."""

    def __init__(self, fs, x_length, f0_floor=C.FLOOR_F0, f0_ceil=C.CEIL_F0,
                 frame_period=5.0, target_fs=8000.0, channels_in_octave=40.0):
        self.fs = fs
        self.x_length = x_length
        self.f0_floor = f0_floor
        self.f0_ceil = f0_ceil
        self.frame_period = frame_period
        self.channels_in_octave = channels_in_octave
        self.use_cos_table = False
        self.target_fs = target_fs

        self.ratio = max(1, min(12, _matlab_round_py(fs / target_fs)))
        self.actual_fs = fs / self.ratio

        adj_floor = f0_floor * 0.9
        adj_ceil = f0_ceil * 1.1
        self.n_channels = 1 + int(
            math.log(adj_ceil / adj_floor) / C.LOG2 * channels_in_octave)
        self.boundary_f0 = adj_floor * 2.0 ** (
            (np.arange(self.n_channels) + 1) / channels_in_octave)

        self.y_length = 1 + int(x_length / self.ratio)
        self.fft_size = get_suitable_fft_size(
            self.y_length
            + 4 * int(1.0 + self.actual_fs / self.boundary_f0[0] / 2.0))

        self.f0_length = 1 + int(1000.0 * x_length / fs)  # 1 ms grid
        self.cb = int(self.n_channels / 10)
        self.max_candidates = self.cb * 7

        self.max_filter_half = _matlab_round_py(
            self.actual_fs / self.boundary_f0[0] * 2.0)
        self.max_half_window = int(1.5 * self.actual_fs / f0_floor + 1.0)
        self.max_fft_index = 2 + int(
            math.log(self.max_half_window * 2 + 1.0) / C.LOG2)
        self.refine_fft = 2 ** self.max_fft_index
        dur = x_length / fs
        self.e_max = int(min(self.y_length // 2 + 2,
                             dur * adj_ceil * 1.8 + 64))
        #: internal candidate-grid period (ms): 1, the reference's grid;
        #: with_grid(k) derives the geometry of a k ms grid
        self.grid_ms = 1
        self._grid_cache = {}

    def with_grid(self, k):
        """This geometry on a k ms candidate grid (the reference's
        getSamples at frame_period k for f0_length), memoized: the same
        object comes back for the same k, so the per-geometry caches
        (filter banks, zc bounds and plans, refine twiddles) build once."""
        if k == self.grid_ms:
            return self
        if k not in self._grid_cache:
            g = HarvestGeometry(
                self.fs, self.x_length, f0_floor=self.f0_floor,
                f0_ceil=self.f0_ceil, frame_period=self.frame_period,
                target_fs=self.target_fs,
                channels_in_octave=self.channels_in_octave)
            g.f0_length = 1 + int(1000.0 * self.x_length / self.fs / k)
            g.grid_ms = k
            self._grid_cache[k] = g
        return self._grid_cache[k]

    def n_grid(self):
        """Output frames at frame_period (reference getSamples)."""
        return 1 + int(1000.0 * self.x_length / self.fs / self.frame_period)


@dataclasses.dataclass(frozen=True)
class Split:
    """How one call's Harvest work is divided: this is part ``index`` of
    ``parts``, and ``join(t, axis)`` concatenates every part's ``t`` along
    ``axis`` in part order (``parallel.batch`` gathers over a mesh's time
    ranks).  ``WHOLE``, one part, adds no operation to the stages."""
    parts: int
    index: int
    join: Callable

    def pad(self, t, axis):
        """t zero-padded along ``axis`` to a multiple of the parts (t
        itself when it is one)."""
        n = (-t.shape[axis]) % self.parts
        if not n:
            return t
        return Fn.pad(t, (0, 0) * (t.dim() - 1 - axis) + (0, n))

    def slab(self, t, axis):
        """This part's slab of ``pad(t, axis)`` along ``axis`` (t itself
        with one part)."""
        if self.parts == 1:
            return t
        t = self.pad(t, axis)
        n = t.shape[axis] // self.parts
        return t.narrow(axis, self.index * n, n).contiguous()

    def join_all(self, ts, axis):
        """Each tensor of ts (one shape) joined along ``axis``, in one
        join (ts itself with one part)."""
        if self.parts == 1:
            return ts
        return tuple(self.join(torch.stack(ts), axis + 1))


WHOLE = Split(1, 0, lambda t, axis: t)


# ---------------------------------------------------------------------------
# stage A: decimation
# ---------------------------------------------------------------------------

def decimate_stage(x, *, ratio, y_length):
    """Downsample x [B, T] to ~8 kHz -> [B, y_length] (no mean removal)."""
    if ratio == 1:
        return Fn.pad(x, (0, y_length - x.shape[-1]))
    lag = int(math.ceil(140.0 / ratio)) * ratio
    xx = torch.cat([x[:, :1].expand(-1, lag), x,
                    x[:, -1:].expand(-1, lag)], dim=1)
    yy = filters.decimate(xx, ratio)
    return yy[:, lag // ratio:lag // ratio + y_length]


# ---------------------------------------------------------------------------
# stage B: band filter bank + candidates
# ---------------------------------------------------------------------------

def _conv_groups(geo):
    """Contiguous band groups whose kernel half-widths share a power-of-two
    bucket (taps per group instead of the widest band's)."""
    halves = [_matlab_round_py(geo.actual_fs / b * 2.0)
              for b in geo.boundary_f0]
    Lmax = geo.max_filter_half
    groups = []
    lo = 0
    while lo < geo.n_channels:
        cap = max(16, Lmax // 8)
        while cap < halves[lo]:
            cap *= 2
        hi = lo
        while hi < geo.n_channels and halves[hi] <= cap:
            hi += 1
        groups.append((lo, hi, min(cap, Lmax)))
        lo = hi
    return groups


def _bandpass_kernels_np(geo, lo=0, hi=None, Lk=None):
    """Centered Nuttall*cos bandpass kernels [hi-lo, 2*Lk+1] in f32
    (reference getFilteredSignal), numpy."""
    if hi is None:
        hi = geo.n_channels
    Lk = geo.max_filter_half if Lk is None else Lk
    j = np.arange(2 * Lk + 1)
    halves = np.asarray([_matlab_round_py(geo.actual_fs / b * 2.0)
                         for b in geo.boundary_f0[lo:hi]],
                        np.int64)[:, None]
    bounds = np.asarray(geo.boundary_f0[lo:hi], np.float32)[:, None]
    m = j[None, :] - Lk
    in_f = np.abs(m) <= halves
    tpos_w = ((m + halves) / (2.0 * halves)).astype(np.float32)
    win = (0.355768
           - 0.487396 * np.cos(2.0 * np.float32(C.PI) * tpos_w)
           + 0.144232 * np.cos(4.0 * np.float32(C.PI) * tpos_w)
           - 0.012604 * np.cos(6.0 * np.float32(C.PI) * tpos_w))
    t_s = (m / geo.actual_fs).astype(np.float32)
    return np.where(
        in_f, (win * np.cos(2.0 * np.float32(C.PI) * bounds * t_s)
               ).astype(np.float32), np.float32(0.0))


def _bank_from_kern_np(kern):
    """Shifted-kernel bank K'[c1, q*nbg + b] = kern[b, c1 - q] for the
    blocked-Toeplitz form of the filter bank: with blocks
    Bm[p, c1] = ypad[128p + c1], Bm @ K' gives every output sample
    out[128p + q, b] = sum_t ypad[128p + q + t] kern[b, t].
    Returns (W, K' [128W, 128*nbg])."""
    nbg, T = kern.shape
    W = -(-(T + 127) // 128)
    c1 = np.arange(128 * W)[:, None]
    q = np.arange(128)[None, :]
    t = c1 - q
    valid = (t >= 0) & (t < T)
    kp = np.concatenate([kern, np.zeros((nbg, 1), np.float32)], axis=1)
    kb = kp[:, np.where(valid, t, T)]
    kb = np.ascontiguousarray(kb.transpose(1, 2, 0)).reshape(
        128 * W, 128 * nbg)
    return W, kb


@device_cache(maxsize=16)
def _filter_banks(geo, device, bands=None):
    """[(Lg, W, K' tensor)] per band group that holds one of ``bands``
    (sorted global band indices; None: every band), on device.  A group's
    bank holds only those of its bands, each with the group's taps Lg and
    width W, so each band's column is the one of the whole bank."""
    out = []
    for lo, hi, Lg in _conv_groups(geo):
        kern = _bandpass_kernels_np(geo, lo, hi, Lg)
        if bands is not None:
            kern = kern[[b - lo for b in bands if lo <= b < hi]]
            if not len(kern):
                continue
        W, kb = _bank_from_kern_np(kern)
        out.append((Lg, W, torch.as_tensor(kb, device=device)))
    return out


def band_filter(ym, geo, bands=None):
    """Band filter bank: ym [B, y_length] -> [B, n_channels, y_length], as
    one f32 matmul per band group (the same correlation as the reference's
    circular-FFT filtering, whose zero padding makes it linear).  With
    ``bands`` (a sorted tuple of band indices) only those rows, in that
    order: [B, len(bands), y_length]."""
    B, y_len = ym.shape
    P = -(-y_len // 128)
    parts = []
    for Lg, W, kb in _filter_banks(geo, ym.device, bands):
        nbg = kb.shape[1] // 128
        ypad = Fn.pad(ym, (Lg - 1, 128 * (P + W) - y_len - Lg + 1))
        blocks = ypad.reshape(B, P + W, 128)
        bm = torch.cat([blocks[:, j:j + P] for j in range(W)], dim=2)
        o = bm @ kb                                         # [B, P, 128*nbg]
        parts.append(o.reshape(B, P * 128, nbg)[:, :y_len].transpose(1, 2))
    return torch.cat(parts, dim=1).contiguous()


def _detect_candidates(raw, geo):
    """Per-frame voiced-run averaging across bands (reference
    detectOfficialF0Candidates): raw [B, Nb, F] -> base [B, F, cb].
    Runs of >= 10 consecutive positive bands (the end bands excluded)
    contribute their mean, in band order, to the first cb slots."""
    B, Nb, F = raw.shape
    dev = raw.device
    r = raw.transpose(1, 2)                                 # [B, F, Nb]
    v = r > 0.0
    v[..., 0] = False
    v[..., -1] = False
    zcol = torch.zeros_like(v[..., :1])
    st = v & ~torch.cat([zcol, v[..., :-1]], dim=-1)
    ed = v & ~torch.cat([v[..., 1:], zcol], dim=-1)
    smax = Nb // 2 + 2
    band = torch.arange(Nb, device=dev).expand(B, F, Nb)
    sid = torch.cumsum(st, dim=-1) - 1
    # run start/end bands by run index (unique targets; slot smax is a dump)
    st_pos = torch.zeros((B, F, smax + 1), dtype=torch.int64, device=dev)
    st_pos.scatter_(-1, torch.where(st, sid, smax), band)
    ed_pos = torch.zeros_like(st_pos)
    ed_pos.scatter_(-1, torch.where(ed, sid, smax), band)
    st_pos, ed_pos = st_pos[..., :smax], ed_pos[..., :smax]
    n_runs = st.sum(-1, keepdim=True)
    live = torch.arange(smax, device=dev) < n_runs
    lens = torch.where(live, ed_pos - st_pos + 1, 0)
    # run sums as differences of an f64 prefix sum (deterministic; exact
    # to well below f32 rounding)
    cs = torch.cumsum(torch.where(v, r, 0.0).to(torch.float64), dim=-1)
    cs = Fn.pad(cs, (1, 0))
    sums = (cs.gather(-1, ed_pos + 1) - cs.gather(-1, st_pos)).to(r.dtype)
    valid = lens >= 10
    means = sums / lens.clamp(min=1).to(r.dtype)
    rank = torch.cumsum(valid, dim=-1) - 1
    keep = valid & (rank < geo.cb)
    base = torch.zeros((B, F, geo.cb + 1), dtype=r.dtype, device=dev)
    base.scatter_(-1, torch.where(keep, rank, geo.cb), means)
    return base[..., :geo.cb]


def _overlap_candidates(base):
    """Spread candidates +-3 frames (reference overlapF0Candidates):
    [B, F, cb] -> [B, F, 7*cb] as layers (0, -1, -2, -3, +1, +2, +3)."""
    B, F, cb = base.shape
    layers = [base]
    for i in (1, 2, 3):
        layers.append(Fn.pad(base[:, :F - i], (0, 0, i, 0)))
    for i in (1, 2, 3):
        layers.append(Fn.pad(base[:, i:], (0, 0, 0, i)))
    return torch.stack(layers, dim=2).reshape(B, F, 7 * cb)


#: bands filtered together by the float64 circular-FFT route (bounds the
#: [B, bands, fft_size] spectra)
_F64_BAND_CHUNK = 16


def _band_filter_fft(y_spectrum, bounds, halves, geo):
    """Bands' filtered signals by the reference's circular-FFT route:
    y_spectrum [B, fft_size/2+1], bounds and halves [n] (boundary
    frequencies, filter half lengths) -> [B, n, y_length]."""
    dt = bounds.dtype
    dev = bounds.device
    Lmax = geo.max_filter_half
    j = torch.arange(2 * Lmax + 1, device=dev)
    win = filters.nuttall_window_ragged(2 * halves + 1, 2 * Lmax + 1, dt,
                                        dev)
    t = (j[None, :] - halves[:, None]).to(dt) / geo.actual_fs
    bpf = torch.where(j[None, :] <= 2 * halves[:, None],
                      win * torch.cos(2.0 * C.PI * bounds[:, None] * t),
                      torch.zeros((), dtype=dt, device=dev))
    H = torch.fft.rfft(bpf, n=geo.fft_size)
    filtered = torch.fft.irfft(y_spectrum[:, None, :] * H[None],
                               n=geo.fft_size) * geo.fft_size
    idx = (torch.arange(geo.y_length, device=dev)[None, :]
           + halves[:, None] + 1) % geo.fft_size        # roll by -(half+1)
    return torch.gather(filtered, 2, idx[None].expand(
        filtered.shape[0], -1, -1))


def _zero_crossings_f64(sig, n_eff, e_max, fs_a, tpos):
    """Events and interval interpolation of signals sig [N, L] of one
    crossing type (reference zeroCrossingEngine + interp1 to the frames),
    the float64 parity form: dense events, literal histc segment search.
    Returns (interp [N, F], n_events [N]); interp has no meaning for rows
    with fewer than 4 events (the caller gates)."""
    N, L = sig.shape
    dev = sig.device
    i = torch.arange(L - 1, device=dev)
    s0, s1 = sig[:, :-1], sig[:, 1:]
    mask = (s0 > 0.0) & (s1 <= 0.0) & (i < n_eff - 1)
    fine = (i + 1).to(sig.dtype) - s0 / (s1 - s0)
    cum = torch.cumsum(mask, dim=1)
    count = cum[:, -1]
    # events to their rank (clamped at e_max - 1), non-events to a dump slot
    slot = torch.where(mask, (cum - 1).clamp(max=e_max - 1), e_max + 1)
    dense = torch.full((N, e_max + 2), math.inf, dtype=sig.dtype, device=dev)
    dense.scatter_(1, slot, fine)
    f_lo, f_hi = dense[:, :e_max], dense[:, 1:e_max + 1]
    locations = (f_lo + f_hi) / 2.0 / fs_a
    intervals = rdiv(fs_a, f_hi - f_lo)
    n_int = count - 1
    k = torch.arange(e_max, device=dev)
    locations = torch.where(k < n_int[:, None], locations,
                            torch.full((), math.inf, dtype=sig.dtype,
                                       device=dev))
    return interp1(locations, intervals, tpos, n_valid=n_int), count


def _band_candidates_f64(f, bounds, geo, tpos):
    """Candidate contours [N, F] of band signals f [N, L] with boundary
    frequencies bounds [N] (reference getFourZeroCrossingIntervals +
    getF0CandidateContour), float64 parity form."""
    y_len = geo.y_length
    g = Fn.pad(f[:, 1:] - f[:, :-1], (0, 1))
    total = None
    usable = None
    for sig, n_eff in ((f, y_len), (-f, y_len), (g, y_len - 1),
                       (-g, y_len - 1)):
        c, n = _zero_crossings_f64(sig, n_eff, geo.e_max, geo.actual_fs, tpos)
        total = c if total is None else total + c
        ok_n = n - 1 > 2
        usable = ok_n if usable is None else usable & ok_n
    cand = total / 4.0
    b = bounds[:, None]
    ok = ((cand <= b * 1.1) & (cand >= b * 0.9)
          & (cand <= geo.f0_ceil) & (cand >= geo.f0_floor))
    return torch.where(usable[:, None] & ok, cand,
                       torch.zeros((), dtype=f.dtype, device=f.device))


@device_cache(maxsize=16)
def _band_tables(geo, dtype, device):
    """The bands' boundary frequencies [Nb] (dtype) and filter half
    lengths [Nb] (int64) on device."""
    halves = [_matlab_round_py(geo.actual_fs / b * 2.0)
              for b in geo.boundary_f0]
    return (torch.as_tensor(geo.boundary_f0, dtype=dtype, device=device),
            torch.as_tensor(halves, device=device))


def _raw_candidates_f64(ym, geo, tpos):
    """Raw band candidates [B, Nb, F] of the mean-removed decimated signal
    ym [B, L] by the circular-FFT route, bands in chunks."""
    B = ym.shape[0]
    dt, dev = ym.dtype, ym.device
    y_spectrum = torch.fft.rfft(Fn.pad(ym, (0, geo.fft_size - geo.y_length)))
    bounds, halves = _band_tables(geo, dt, dev)
    parts = []
    for lo in range(0, geo.n_channels, _F64_BAND_CHUNK):
        bc, hc = (v[lo:lo + _F64_BAND_CHUNK] for v in (bounds, halves))
        filt = _band_filter_fft(y_spectrum, bc, hc, geo)   # [B, n, L]
        n = filt.shape[1]
        raw = _band_candidates_f64(filt.reshape(B * n, -1), bc.repeat(B),
                                   geo, tpos)
        parts.append(raw.reshape(B, n, -1))
    return torch.cat(parts, dim=1)


@device_cache(maxsize=16)
def _band_shard(geo, t, nt, device):
    """Part t's stratified band subset of the geometry (nt parts): (its
    real bands as a tuple, or None for all of them; the number of zero
    rows padding it; the bounds [rows] float32 on device, 1.0 on the
    padding, or None for all bands)."""
    Nb = geo.n_channels
    if nt == 1:
        return None, 0, None
    nbl = -(-Nb // nt)
    bands = tuple(range(t, Nb, nt))
    bounds = np.ones(nbl, np.float32)
    bounds[:len(bands)] = np.asarray(geo.boundary_f0, np.float32)[
        list(bands)]
    return bands, nbl - len(bands), torch.as_tensor(bounds, device=device)


def _bands_to_candidates(y, geo, split):
    """Stages B+C of decimated float32 signals y [B, L]: the split's part
    of the bands (band g in part g % parts; the band axis padded to
    parts * ceil(Nb / parts) with zero rows of bound 1.0, which give no
    candidate) through the filter bank and the zc kernel, every part's raw
    candidates joined in global band order, then detection and overlap on
    the whole band axis -> (overlapped [B, F, S], raw [B, Nb, F], base
    [B, F, cb]).  Every band keeps the taps and bank width of its filter
    group in the whole bank."""
    bands, n_pad, bounds = _band_shard(geo, split.index, split.parts,
                                       y.device)
    with stage("band_filter", y.device):
        filt = band_filter(y, geo, bands)
        if n_pad:
            filt = torch.cat([filt, filt.new_zeros(
                (filt.shape[0], n_pad, filt.shape[2]))], dim=1)
    with stage("zc", y.device):
        raw = _zc.band_candidates(filt, geo, bounds)
    with stage("detect_overlap", y.device):
        if split.parts > 1:
            # joined rows are (part p, row j) <-> global band p + j*parts
            raw = split.join(raw[:, :, None], 2)
            raw = raw.reshape(raw.shape[0], -1, raw.shape[-1])[
                :, :geo.n_channels]
        base = _detect_candidates(raw, geo)
        return _overlap_candidates(base), raw, base


def candidates_stage(y, mean_y, geo):
    """Stages B+C: decimated y [B, L] less its means mean_y [B] ->
    (overlapped candidates [B, F, S], raw band candidates [B, Nb, F], base
    candidates [B, F, cb])."""
    ym = y - mean_y[:, None]
    if y.dtype == torch.float64:
        tpos = torch.arange(geo.f0_length, dtype=y.dtype,
                            device=y.device) * (geo.grid_ms / 1000.0)
        raw = _raw_candidates_f64(ym, geo, tpos)
        base = _detect_candidates(raw, geo)
        return _overlap_candidates(base), raw, base
    return _bands_to_candidates(ym, geo, WHOLE)


# ---------------------------------------------------------------------------
# stage D, float64: the dense refine twin
# ---------------------------------------------------------------------------

def _refine_pairs_f64(y, rows, f0, pp, geo):
    """Refine (frame, candidate) pairs: y [B, L], each pair's utterance
    rows [P], candidate frequencies f0 [P] at frame times pp [P] ->
    (refined [P], score [P]), zeros where the result is out of range or
    scores under 2.5, and where f0 is 0 (an empty lane: it is refined at a
    stand-in 100 Hz, as the JAX twin does, and dropped).  Reference
    refineF0Candidates / getMeanF0 / fixF0, the literal per-pair layout:
    each pair's own windows and two full FFTs of geo.refine_fft."""
    dt, dev = y.dtype, y.device
    fs_a = geo.actual_fs
    live = f0 > 0.0
    f0 = torch.where(live, f0, torch.full((), 100.0, dtype=dt, device=dev))
    hw = (rdiv(1.5 * fs_a, f0) + 1.0).to(torch.int32)
    w_len = 2 * hw + 1
    fft_index = 2 + (torch.log(w_len.to(dt)) / C.LOG2).to(torch.int32)
    fft_p = torch.bitwise_left_shift(torch.ones_like(fft_index), fft_index)
    ratio = geo.refine_fft // fft_p
    Wmax = 2 * geo.max_half_window + 1
    wlt = w_len.to(dt) / fs_a
    n_harm = rdiv(fs_a / 2.0, f0).to(torch.int32).clamp(max=6)
    h = torch.arange(6, device=dev)
    idx_h = matlab_round(f0[:, None] * fft_p[:, None].to(dt) / fs_a
                         * (h[None, :] + 1.0))
    gbin = (idx_h * ratio[:, None]).clamp(0, geo.refine_fft // 2).long()

    j = torch.arange(Wmax, device=dev)
    in_w = j[None, :] < w_len[:, None]
    base_time0 = -hw.to(dt) / fs_a
    basic_index = matlab_round((pp + base_time0) * fs_a + 0.001)
    base_index = basic_index[:, None] + j[None, :]
    tmp = (base_index.to(dt) - 1.0) / fs_a - pp[:, None]
    t2 = 2.0 * C.PI * tmp / wlt[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    mw = 0.42 + 0.5 * torch.cos(t2) + 0.08 * torch.cos(2.0 * t2)
    mw = torch.where(in_w, mw, zero)
    mw_m1 = Fn.pad(mw[:, :-1], (1, 0))
    mw_p1 = Fn.pad(mw[:, 1:], (0, 1))
    dw = torch.where(in_w, -(mw_p1 - mw_m1) / 2.0, zero)
    seg = y[rows[:, None], (base_index - 1).clamp(0, geo.y_length - 1).long()]
    Sm = torch.fft.rfft(seg * mw, n=geo.refine_fft)
    Sd = torch.fft.rfft(seg * dw, n=geo.refine_fft)
    Sm_re, Sm_im = Sm.real.gather(1, gbin), Sm.imag.gather(1, gbin)
    Sd_re, Sd_im = Sd.real.gather(1, gbin), Sd.imag.gather(1, gbin)
    power = Sm_re ** 2 + Sm_im ** 2
    num_i = Sm_re * Sd_im - Sm_im * Sd_re

    base_freq = idx_h.to(dt) * fs_a / fft_p[:, None].to(dt)
    instf = torch.where(power == 0.0, zero,
                        base_freq + num_i / power * fs_a / (2.0 * C.PI))
    amp = torch.sqrt(power)
    hmask = (h[None, :] < n_harm[:, None]).to(dt)
    numer = torch.sum(amp * instf * hmask, dim=1)
    denom = torch.sum(amp * (h[None, :] + 1.0) * hmask, dim=1)
    refined = numer / (denom + C.MY_SAFE_GUARD_MINIMUM)
    dev_ = torch.sum(torch.abs(instf / (h[None, :] + 1.0) - f0[:, None])
                     / f0[:, None] * hmask, dim=1)
    score = rdiv(1.0, dev_ / n_harm.clamp(min=1) + C.MY_SAFE_GUARD_MINIMUM)
    bad = ((refined < geo.f0_floor) | (refined > geo.f0_ceil)
           | (score < 2.5) | ~live)
    return torch.where(bad, zero, refined), torch.where(bad, zero, score)


#: (frame, candidate) pairs that one call of the float64 refine takes
#: (frames per call: this over the capacity).  At geo.refine_fft = 2048
#: (f0_floor 40 Hz) a call holds two spectra [pairs, 1,025] complex128,
#: 2 x 2^15 x 1,025 x 16 B = 1.07 GB, and some ten [pairs, Wmax = 603]
#: windows of 8 B, ~158 MB each
REFINE_F64_PAIRS = 2 ** 15


def refine_stage_f64(y, cand, tpos, *, geo, chunk=None):
    """Stage D, float64 parity form: y [B, L], cand [B, F, S], tpos [F] ->
    (refined, score) [B, F, S] in the candidates' own slots.

    The JAX twin's static compaction (worldtpu/analysis/harvest.py
    refine_stage): each frame's nonzero candidates are ranked by a cumsum
    and their slots scattered into cap = min(S, max(32, S // 2)) lanes (a
    frame has ~20; the rest give zero), every lane of ``chunk`` frames at a
    time is refined (an empty lane is the identity (0, 0)), and the lanes
    are scattered back with a max from -1.  The number of calls follows
    the shapes alone: no host read.  ``chunk`` (frames per call) defaults
    to REFINE_F64_PAIRS pairs a call."""
    B, F, S = cand.shape
    dev = cand.device
    cap = min(S, max(32, S // 2))
    active = cand > 0.0
    n_seen = torch.cumsum(active, dim=2)
    cols = torch.arange(S, device=dev).expand(B, F, S)
    # unique scatter slots: active -> rank (< S), inactive -> S + rank
    # among the inactive; only the first cap lanes are read
    slot = torch.where(active, n_seen - 1, S + cols - n_seen)
    sel = torch.zeros((B, F, 2 * S), dtype=torch.int64, device=dev)
    sel = sel.scatter_(2, slot, cols)[..., :cap]
    valid = (torch.arange(cap, device=dev)
             < n_seen[..., -1:].clamp(max=cap))
    zero = torch.zeros((), dtype=cand.dtype, device=dev)
    lanes = torch.where(valid, cand.gather(2, sel), zero).reshape(B * F, cap)
    pos = tpos.expand(B, F).reshape(B * F)
    utt = torch.arange(B, device=dev).repeat_interleave(F)
    chunk = max(1, REFINE_F64_PAIRS // cap) if chunk is None else chunk
    ref, sc = [], []
    for lo in range(0, B * F, chunk):
        c = lanes[lo:lo + chunk]
        n = c.shape[0]
        r, s_ = _refine_pairs_f64(
            y, utt[lo:lo + n].repeat_interleave(cap), c.reshape(-1),
            pos[lo:lo + n].repeat_interleave(cap), geo)
        ref.append(r)
        sc.append(s_)

    def back(v):
        v = torch.where(valid, torch.cat(v).reshape(B, F, cap), -1.0)
        return torch.zeros_like(cand).scatter_reduce_(
            2, sel, v, "amax").clamp_(min=0.0)
    return back(ref), back(sc)


# ---------------------------------------------------------------------------
# stage E: neighbor-consistency pruning
# ---------------------------------------------------------------------------

def remove_unreliable_stage(cand, score):
    """Drop interior candidates with no neighbour-frame candidate within
    5% (reference removeUnreliableCandidates; the edge rows compare
    against zero rows).  cand, score [B, F, S]."""
    B, F, S = cand.shape
    z = torch.zeros_like(cand[:, :1])
    prev = torch.cat([z, cand[:, :-1]], dim=1)
    nxt = torch.cat([cand[:, 1:], z], dim=1)
    ref = torch.where(cand > 0, cand, torch.ones((), dtype=cand.dtype,
                                                 device=cand.device))

    def min_err(others):
        e = torch.abs(ref[..., None] - others[:, :, None, :]) / ref[..., None]
        return torch.clamp(torch.amin(e, dim=-1), max=1.0)

    err = torch.minimum(min_err(nxt), min_err(prev))
    f = torch.arange(F, device=cand.device)
    interior = ((f >= 1) & (f <= F - 2))[None, :, None]
    drop = (err > 0.05) & (cand > 0) & interior
    zero = torch.zeros((), dtype=cand.dtype, device=cand.device)
    return torch.where(drop, zero, cand), torch.where(drop, zero, score)


# ---------------------------------------------------------------------------
# fused pipeline
# ---------------------------------------------------------------------------

def _stages_f64(y, mean_y, geo):
    """candidates -> refine -> prune of decimated float64 signals y [B, L]
    less their means mean_y [B]."""
    tpos = torch.arange(geo.f0_length, dtype=y.dtype,
                        device=y.device) * (geo.grid_ms / 1000.0)
    cand, _, _ = candidates_stage(y, mean_y, geo)
    cand, score = refine_stage_f64(y - mean_y[:, None], cand, tpos, geo=geo)
    return remove_unreliable_stage(cand, score)


def check_grid(dtype, grid):
    """Raise ValueError unless the candidate-grid period ``grid`` (ms) is a
    positive int, and 1 for float64 (the parity path runs the reference's
    1 ms grid; the JAX package pins it there)."""
    if isinstance(grid, bool) or not isinstance(grid, (int, np.integer)) \
            or grid < 1:
        raise ValueError(f"grid_ms must be a positive int, got {grid!r}")
    if dtype == torch.float64 and grid != 1:
        raise ValueError(f"grid_ms={grid}: the float64 parity path runs the "
                         f"reference's 1 ms grid only")


def harvest_device_stages(x, *, geo, grid=1, split=WHOLE):
    """decimate -> candidates -> refine -> prune for x [B, T] on the
    ``grid`` ms candidate grid (float32; float64 takes 1 only).
    Returns (candidates, scores) [B, F, S], F = geo.with_grid(grid)
    .f0_length: refined slots compacted for float32, in the candidates' own
    slots for float64.

    float32 divides the work by ``split``: the part's bands through the
    filter bank and the zc kernel, the joined raw candidates detected and
    overlapped on the whole band axis, the refine kernel on the part's
    slab of ceil(F / parts) frames (compaction is per frame, so a slab
    compacts as the whole does), the joined refined candidates and scores
    pruned on every frame (the prune reads neighbouring frames).  float64
    runs the parity stages on the whole axis, whatever the split."""
    check_grid(x.dtype, grid)
    geo_k = geo.with_grid(grid)
    with stage("decimate", x.device):
        y = decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    if x.dtype == torch.float64:
        return _stages_f64(y, y.new_zeros(y.shape[0]), geo)
    F = geo_k.f0_length
    tpos = torch.arange(F, dtype=x.dtype, device=x.device) \
        * (geo_k.grid_ms / 1000.0)
    cand, _, _ = _bands_to_candidates(y, geo_k, split)
    cand, score = _refine.refine_stage(
        y, split.slab(cand, 1), split.slab(tpos, 0), geo=geo_k,
        dedup_tol=REFINE_DEDUP_TOL)
    cand, score = split.join_all((cand, score), 1)
    return prune_compacted(cand[:, :F], score[:, :F])


def prune_compacted(cand, score):
    """remove_unreliable_stage of the refine stage's compacted [B, F, S]
    candidates and scores: refined candidates fill the first CAP slots and
    the rest are zero; a zero neighbour gives relative error exactly 1.0,
    the clamp value, so pruning over the leading slots is exact."""
    with stage("prune", cand.device):
        S = cand.shape[-1]
        w = min(S, _refine.CAP)
        c, s = remove_unreliable_stage(cand[..., :w].contiguous(),
                                       score[..., :w].contiguous())
        return Fn.pad(c, (0, S - w)), Fn.pad(s, (0, S - w))


def harvest_device_full(x, *, geo, n_out, grid=1, split=WHOLE):
    """Full Harvest wav -> F0 at frame_period: x [B, T] -> [B, n_out].
    float32 runs the stages (divided by ``split``) and the device contour
    chain on the ``grid`` ms candidate grid with mean 0; float64 takes
    ``harvest_parity`` (its own int-truncated mean, the host contour, the
    1 ms grid, n_out = geo.n_grid() only)."""
    check_grid(x.dtype, grid)
    if x.dtype == torch.float64:
        if n_out != geo.n_grid():
            raise ValueError(f"float64 Harvest gives geo.n_grid() = "
                             f"{geo.n_grid()} frames, not {n_out}")
        return harvest_parity(x, geo=geo)
    from worldtpu_torch.analysis import contour_device as CDV
    cand, score = harvest_device_stages(x, geo=geo, grid=grid, split=split)
    with stage("contour", x.device):
        return CDV.fix_and_smooth(cand, score, n_out, geo.frame_period,
                                  grid_ms=grid)


def int_trunc_mean(y):
    """The reference Harvest's mean of the decimated signals y [B, L]
    (float64): its int-initialized accumulate truncates the running sum
    toward zero at every step (``native.int_trunc_sum``, on the host), so
    the mean is exactly 0 for |y| < 1.  [B] on y's device."""
    from worldtpu_torch.native import int_trunc_sum
    rows = y.detach().cpu().numpy()
    return torch.tensor([int_trunc_sum(r) / y.shape[1] for r in rows],
                        dtype=y.dtype, device=y.device)


def host_contour(cand, score, geo, grid=1):
    """The reference's contour fixing and smoothing of one utterance's
    [F, S] candidates and scores on the ``grid`` ms candidate grid (float64
    numpy, ``analysis.contour``) and the nearest-frame pick of that grid at
    the frame period -> f0 [n_out] numpy."""
    from worldtpu_torch.analysis import contour
    best = contour.fix_f0_contour(cand, score, grid_ms=grid)
    f0_grid = contour.smooth_f0_contour(best)
    tpos = np.arange(geo.n_grid()) * geo.frame_period / 1000.0
    x = tpos * (1000.0 / grid)  # grid frames, rounded half away from 0
    pick = np.where(x > 0, np.floor(x + 0.5), np.ceil(x - 0.5))
    return f0_grid[np.minimum(geo.with_grid(grid).f0_length - 1,
                              pick.astype(np.int64))]


def harvest_parity(x, *, geo):
    """Harvest in float64 with the reference's literal semantics: x [B, T]
    float64 -> F0 [B, n_out] float64 on x's device.  The int-truncated mean
    and the contour run on the host (two transfers per call)."""
    y = decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    cand, score = _stages_f64(y, int_trunc_mean(y), geo)
    cand, score = cand.cpu().numpy(), score.cpu().numpy()
    f0 = np.stack([host_contour(c, s, geo) for c, s in zip(cand, score)])
    return torch.as_tensor(f0, dtype=x.dtype, device=x.device)


class ZcCapacityError(RuntimeError):
    """A band signal has more zero-crossing events of one type than the zc
    kernel's event buffer holds (``geo.e_max``); past it that band's
    candidates are wrong.  See ``ops.zc_kernel.event_overflows``."""


def zc_capacity_violations_batch(x, *, geo, grid=1):
    """[B] counts of the (band, crossing type) pairs of each utterance of
    x [B, T] whose events overflow the zc kernel's event buffer: the
    decimation, the filter bank and dense mask reductions (the buffer,
    e_max, is the same on every candidate grid)."""
    geo_k = geo.with_grid(grid)
    y = decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    return _zc.event_overflows(band_filter(y, geo_k), geo_k)


def check_dtype(dtype):
    """Raise ValueError unless dtype is torch.float32 (the production path)
    or torch.float64 (the parity path)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}; use torch.float32 or "
                         f"torch.float64")


def as_tensor(x, device, dtype=torch.float32):
    """x (numpy or tensor) as a tensor of dtype on device; with device None
    x must already be a tensor and stays where it is."""
    if device is None:
        if not isinstance(x, torch.Tensor):
            raise ValueError("pass a torch.Tensor or name a device")
        device = x.device
    return torch.as_tensor(x, dtype=dtype, device=device)


#: 1 ms frames beyond which HarvestKernel.compute_batch runs the contour
#: chain of float32 CPU input in numpy float64
HOST_CONTOUR_FRAMES = 8192


class HarvestKernel(torch.nn.Module):
    """Harvest for one (fs, x_length) geometry: batches -> F0 at the frame
    period, on the device of ``device`` (or of the input tensor when
    ``device`` is None).

    ``forward`` keeps everything on the device; ``compute``,
    ``compute_batch`` and ``compute_corpus`` mirror
    ``worldtpu.analysis.harvest.HarvestKernel`` (without ``chunk`` and
    ``contour_on``: see ``compute_batch``) and return numpy.  float32 (the
    default here; the JAX class defaults to float64) is the production
    path: input on the card always takes the device contour chain (its
    kernels' memory is linear in F; ``LongHarvest`` runs the same chain
    over whole recordings), CPU input longer than HOST_CONTOUR_FRAMES
    frames of the 1 ms grid the numpy float64 chain (``analysis.contour``)
    instead, since the chain's plain versions lay their sections out
    densely, [sections, F], and so grow as F^2.  float64
    is the parity path (``harvest_parity``), on the card too: the
    reference's literal stages there, its int-truncated mean and contour on
    the host.

    ``grid_ms`` (default 1, the reference's grid) is the float32 path's
    candidate-grid period: k > 1 runs every per-frame stage and the contour
    on a k ms grid (``worldtpu``'s ``WORLDTPU_GRID_MS``, a fast mode that
    loses voicing-boundary resolution).  float64 with k > 1 raises
    ValueError."""

    def __init__(self, fs, x_length, f0_floor=C.FLOOR_F0, f0_ceil=C.CEIL_F0,
                 frame_period=5.0, target_fs=8000.0, channels_in_octave=40.0,
                 device=None, grid_ms=1):
        super().__init__()
        check_grid(torch.float32, grid_ms)
        self.geo = HarvestGeometry(
            fs, x_length, f0_floor=f0_floor, f0_ceil=f0_ceil,
            frame_period=frame_period, target_fs=target_fs,
            channels_in_octave=channels_in_octave)
        self.grid_ms = grid_ms
        self.device = None if device is None else torch.device(device)

    def forward(self, x):
        """x [B, x_length] -> (f0 [B, n_out], tpos [n_out]), in x's dtype.
        float32 on the card runs as a captured CUDA graph from the second
        call of a shape on (``parallel.graphs``, keyed on the geometry by
        identity and ``grid_ms``)."""
        return _graphs.call(_forward, (x,), geo=self.geo, grid=self.grid_ms)

    def get_samples(self):
        return self.geo.n_grid()

    def _tpos(self):
        return np.arange(self.get_samples()) * self.geo.frame_period / 1000.0

    def compute(self, x, dtype=torch.float32):
        """One utterance x [x_length] -> (f0 [n_out], tpos [n_out]) as
        float64 numpy."""
        return self.compute_batch(as_tensor(x, self.device, dtype)[None],
                                  dtype)[0]

    def compute_batch(self, x_batch, dtype=torch.float32,
                      transfer_dtype=None, check_capacity=False):
        """Harvest over [B, x_length] utterances -> [(f0, tpos)] per
        utterance (float64 numpy).

        ``transfer_dtype`` (e.g. torch.float16) narrows the candidates and
        scores that the host contour branch (CPU input past
        HOST_CONTOUR_FRAMES) hands to numpy, as the JAX package narrows
        its host download: clipped to [0, the type's max], cast, then read
        as float64 (~5e-4 relative F0 quantization; scores past the
        type's range saturate, which only reorders near-ties).  The device
        contour chain downloads only F0 and ignores it.
        ``check_capacity`` (float32: float64 runs no zc kernel) first
        counts the zc event-buffer overflows and raises ZcCapacityError if
        any utterance has one.

        Against ``worldtpu``'s signature, ``chunk`` and ``contour_on`` are
        absent: ``chunk`` sized the JAX package's ``lax.map`` over frame
        chunks, and every stage here runs over all frames at once;
        ``contour_on`` is decided by where the input lies (the card always
        takes the device chain, the CPU the numpy chain past
        HOST_CONTOUR_FRAMES), so no caller can send a batch on the card
        through the host by hand."""
        check_dtype(dtype)
        check_grid(dtype, self.grid_ms)
        x = as_tensor(x_batch, self.device, dtype)
        if dtype == torch.float64:
            return self._parity(x)
        if check_capacity:
            with torch.no_grad():
                v = zc_capacity_violations_batch(
                    x, geo=self.geo, grid=self.grid_ms).cpu()
            if bool(v.any()):
                bad = torch.nonzero(v)[:, 0].tolist()
                raise ZcCapacityError(
                    f"zc event buffer ({self.geo.e_max} events per band "
                    f"and crossing type) overflowed for utterances "
                    f"{bad}, in {v[bad].tolist()} (band, type) pairs; "
                    f"the input's band-limited crossing rate is outside "
                    f"Harvest's model (a full-band chirp or a noise "
                    f"burst?)")
        return self._enqueue(x, transfer_dtype)()

    def compute_corpus(self, batches, dtype=torch.float32,
                       transfer_dtype=None):
        """Harvest over an iterable of [B, x_length] batches (numpy or
        tensors): a generator of (f0, tpos) per utterance, in input order,
        each as ``compute_batch`` gives it.

        Batch k+1's Harvest is enqueued before batch k's results are
        handed out, and the iterable is read one batch ahead, never more.
        On the card, batch k's F0 goes to pinned host memory by a
        non-blocking copy behind an event recorded right after its work,
        and only that event is waited on before k is read, so k's download
        and unpacking overlap k+1's queued work (each batch a replay of
        ``forward``'s captured program from the second on).  float64
        batches take ``harvest_parity`` one batch at a time, as
        ``compute_batch`` does.  ``chunk`` and ``contour_on`` are absent,
        as in ``compute_batch``."""
        check_dtype(dtype)
        check_grid(dtype, self.grid_ms)
        pending = None
        for xb in batches:
            x = as_tensor(xb, self.device, dtype)
            if dtype == torch.float64:
                yield from self._parity(x)
                continue
            queued = self._enqueue(x, transfer_dtype)
            if pending is not None:
                yield from pending()
            pending = queued
        if pending is not None:
            yield from pending()

    def _parity(self, x):
        with torch.no_grad():
            f0 = harvest_parity(x, geo=self.geo).cpu().numpy()
        return [(f0[i], self._tpos()) for i in range(len(f0))]

    def _enqueue(self, x, transfer_dtype):
        """Start the float32 Harvest of x [B, x_length]; returns a function
        that waits for it and gives [(f0, tpos)] per utterance."""
        tpos = self._tpos()
        with torch.no_grad():
            if (x.device.type == "cpu"
                    and self.geo.f0_length > HOST_CONTOUR_FRAMES):
                cand, score = (
                    _narrow(t, transfer_dtype).to(torch.float64).numpy()
                    for t in harvest_device_stages(x, geo=self.geo,
                                                   grid=self.grid_ms))
                return lambda: [(host_contour(c, s, self.geo, self.grid_ms),
                                 tpos) for c, s in zip(cand, score)]
            f0, _ = self(x)
        wait = download(f0)

        def finish():
            f0s = wait().numpy().astype(np.float64)
            return [(f0s[i], tpos) for i in range(len(f0s))]
        return finish


def _forward(x, *, geo, grid):
    """HarvestKernel.forward's program: x [B, x_length] -> (f0, tpos)."""
    n_out = geo.n_grid()
    f0 = harvest_device_full(x, geo=geo, n_out=n_out, grid=grid)
    tpos = torch.arange(n_out, dtype=x.dtype, device=x.device) \
        * (geo.frame_period / 1000.0)
    return f0, tpos


def _narrow(t, transfer_dtype):
    """t clipped to [0, the largest finite value of transfer_dtype] and
    cast to it (t itself when transfer_dtype is None): the JAX package's
    narrowing of the host contour's download."""
    if transfer_dtype is None:
        return t
    return t.clamp(0.0, torch.finfo(transfer_dtype).max).to(transfer_dtype)
