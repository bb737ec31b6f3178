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
stage of the main path runs inside a ``torch.profiler.record_function``
range named ``wt.<stage>``, so one profiled call gives the time of every
stage.

float32 is the production path above.  float64 is the parity path, with the
reference's literal semantics and no hand-written kernel (the JAX package's
float64 path runs none either): the circular-FFT band filter, dense
zero-crossing events with histc interpolation, per-pair refine windows
with full FFTs, pruning over every slot, and the host contour
(``analysis.contour``) after an int-truncated mean.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as Fn
from torch.profiler import record_function

from wtbench.reference import constants as C
from wtbench.reference.ops import filters
from wtbench.reference.ops import refine_kernel as _refine
from wtbench.reference.ops import zc_kernel as _zc
from wtbench.reference.ops.fftutil import get_suitable_fft_size
from wtbench.reference.ops.interp import interp1
from wtbench.reference.ops.numeric import device_cache, matlab_round, rdiv

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


@device_cache(maxsize=16)
def _band_tables(geo, dtype, device):
    """The bands' boundary frequencies [Nb] (dtype) and filter half
    lengths [Nb] (int64) on device."""
    halves = [_matlab_round_py(geo.actual_fs / b * 2.0)
              for b in geo.boundary_f0]
    return (torch.as_tensor(geo.boundary_f0, dtype=dtype, device=device),
            torch.as_tensor(halves, device=device))


def candidates_stage(y, mean_y, geo):
    """Stages B+C: decimated y [B, L] -> (overlapped candidates [B, F, S],
    raw band candidates [B, Nb, F], base candidates [B, F, cb])."""
    if y.dtype == torch.float64:
        raise ValueError("the reference copy computes float32 only")
    with record_function("wt.band_filter"):
        filt = band_filter(y - mean_y[:, None], geo)
    with record_function("wt.zc"):
        raw = _zc.band_candidates(filt, geo)
    with record_function("wt.detect_overlap"):
        base = _detect_candidates(raw, geo)
        return _overlap_candidates(base), raw, base


# ---------------------------------------------------------------------------
# stage D, float64: the dense refine twin
# ---------------------------------------------------------------------------


#: (frame, candidate) pairs that one call of the float64 refine takes
#: (frames per call: this over the capacity).  At geo.refine_fft = 2048
#: (f0_floor 40 Hz) a call holds two spectra [pairs, 1,025] complex128,
#: 2 x 2^15 x 1,025 x 16 B = 1.07 GB, and some ten [pairs, Wmax = 603]
#: windows of 8 B, ~158 MB each
REFINE_F64_PAIRS = 2 ** 15


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


def harvest_device_stages(x, mean_y, *, geo, grid=1):
    """decimate -> candidates -> refine -> prune for x [B, T] on the
    ``grid`` ms candidate grid (float32; float64 takes 1 only).
    Returns (candidates, scores) [B, F, S], F = geo.with_grid(grid)
    .f0_length: refined slots compacted for float32, in the candidates' own
    slots for float64."""
    check_grid(x.dtype, grid)
    geo_k = geo.with_grid(grid)
    with record_function("wt.decimate"):
        y = decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    if x.dtype == torch.float64:
        raise ValueError("the reference copy computes float32 only")
    tpos = torch.arange(geo_k.f0_length, dtype=x.dtype,
                        device=x.device) * (geo_k.grid_ms / 1000.0)
    cand, _, _ = candidates_stage(y, mean_y, geo_k)
    cand, score = _refine.refine_stage(
        y - mean_y[:, None], cand, tpos, geo=geo_k,
        dedup_tol=REFINE_DEDUP_TOL)
    return prune_compacted(cand, score)


def prune_compacted(cand, score):
    """remove_unreliable_stage of the refine stage's compacted [B, F, S]
    candidates and scores: refined candidates fill the first CAP slots and
    the rest are zero; a zero neighbour gives relative error exactly 1.0,
    the clamp value, so pruning over the leading slots is exact."""
    with record_function("wt.prune"):
        S = cand.shape[-1]
        w = min(S, _refine.CAP)
        c, s = remove_unreliable_stage(cand[..., :w].contiguous(),
                                       score[..., :w].contiguous())
        return Fn.pad(c, (0, S - w)), Fn.pad(s, (0, S - w))


def harvest_device_full(x, mean_y, *, geo, n_out, grid=1):
    """Full Harvest wav -> F0 at frame_period: x [B, T] -> [B, n_out].
    float32 runs the stages and the device contour chain on the ``grid``
    ms candidate grid with the mean ``mean_y`` [B]; float64 takes
    ``harvest_parity`` (its own int-truncated mean, the host contour, the
    1 ms grid)."""
    check_grid(x.dtype, grid)
    if x.dtype == torch.float64:
        raise ValueError("the reference copy computes float32 only")
    from wtbench.reference.analysis import contour_device as CDV
    cand, score = harvest_device_stages(x, mean_y, geo=geo, grid=grid)
    with record_function("wt.contour"):
        return CDV.fix_and_smooth(cand, score, n_out, geo.frame_period,
                                  grid_ms=grid)


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


