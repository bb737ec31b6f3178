"""Harvest F0 estimation, f32 production path, batched over utterances.

Port of worldtpu/analysis/harvest.py (reference src/harvest.cpp): decimate
-> band filter bank (blocked-Toeplitz matmul) -> zero-crossing candidates
(zc kernel) -> per-frame run detection -> +-3-frame overlap -> refinement
(refine kernel) -> neighbour-consistency pruning -> device contour chain.
Every stage takes a leading batch axis B where the JAX package vmapped.
The internal candidate grid is the reference's 1 ms grid.  Each stage of
the main path runs inside a ``torch.profiler.record_function`` range named
``wt.<stage>``, so one profiled call gives the time of every stage.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as Fn
from torch.profiler import record_function

from worldtpu_torch import constants as C
from worldtpu_torch.ops import filters
from worldtpu_torch.ops import refine_kernel as _refine
from worldtpu_torch.ops import zc_kernel as _zc
from worldtpu_torch.ops.fftutil import get_suitable_fft_size

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
        self.grid_ms = 1

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


@functools.lru_cache(maxsize=8)
def _filter_banks(geo, device):
    """[(lo, hi, Lg, W, K' tensor)] per band group, on device."""
    out = []
    for lo, hi, Lg in _conv_groups(geo):
        W, kb = _bank_from_kern_np(_bandpass_kernels_np(geo, lo, hi, Lg))
        out.append((lo, hi, Lg, W, torch.as_tensor(kb, device=device)))
    return out


def band_filter(ym, geo):
    """Band filter bank: ym [B, y_length] -> [B, n_channels, y_length], as
    one f32 matmul per band group (the same correlation as the reference's
    circular-FFT filtering, whose zero padding makes it linear)."""
    B, y_len = ym.shape
    P = -(-y_len // 128)
    parts = []
    for _, _, Lg, W, kb in _filter_banks(geo, ym.device):
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


def candidates_stage(y, mean_y, geo):
    """Stages B+C: decimated y [B, L] -> (overlapped candidates [B, F, S],
    raw band candidates [B, Nb, F], base candidates [B, F, cb])."""
    with record_function("wt.band_filter"):
        filt = band_filter(y - mean_y[:, None], geo)
    with record_function("wt.zc"):
        raw = _zc.band_candidates(filt, geo)
    with record_function("wt.detect_overlap"):
        base = _detect_candidates(raw, geo)
        return _overlap_candidates(base), raw, base


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

def harvest_device_stages(x, mean_y, *, geo):
    """decimate -> candidates -> refine -> prune for x [B, T].
    Returns (candidates, scores) [B, F, S] (refined slots compacted)."""
    with record_function("wt.decimate"):
        y = decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    tpos = torch.arange(geo.f0_length, dtype=x.dtype,
                        device=x.device) * (geo.grid_ms / 1000.0)
    cand, _, _ = candidates_stage(y, mean_y, geo)
    cand, score = _refine.refine_stage(
        y - mean_y[:, None], cand, tpos, geo=geo,
        dedup_tol=REFINE_DEDUP_TOL)
    # refined candidates are compacted into the first CAP slots and the
    # rest are zero; a zero neighbour gives relative error exactly 1.0,
    # the clamp value, so pruning over the leading slots is exact
    with record_function("wt.prune"):
        S = cand.shape[-1]
        w = min(S, _refine.CAP)
        c, s = remove_unreliable_stage(cand[..., :w].contiguous(),
                                       score[..., :w].contiguous())
        return Fn.pad(c, (0, S - w)), Fn.pad(s, (0, S - w))


def harvest_device_full(x, mean_y, *, geo, n_out):
    """Full Harvest wav -> F0 at frame_period: x [B, T] -> [B, n_out]."""
    from worldtpu_torch.analysis import contour_device as CDV
    cand, score = harvest_device_stages(x, mean_y, geo=geo)
    with record_function("wt.contour"):
        return CDV.fix_and_smooth(cand, score, n_out, geo.frame_period,
                                  grid_ms=geo.grid_ms)


class ZcCapacityError(RuntimeError):
    """A band signal has more zero-crossing events of one type than the zc
    kernel's event buffer holds (``geo.e_max``); past it that band's
    candidates are wrong.  See ``ops.zc_kernel.event_overflows``."""


def zc_capacity_violations_batch(x, *, geo):
    """[B] counts of the (band, crossing type) pairs of each utterance of
    x [B, T] whose events overflow the zc kernel's event buffer: the
    decimation, the filter bank and dense mask reductions."""
    y = decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    return _zc.event_overflows(band_filter(y, geo), geo)


#: the f64 parity paths are not ported yet
F64_NOT_PORTED = ("float64 is not ported to worldtpu_torch yet (ROADMAP "
                  "Queue 1 item 2, f64 parity paths); use float32")


def check_f32(dtype):
    """Raise NotImplementedError for float64, ValueError for any dtype
    other than float32."""
    if dtype == torch.float64:
        raise NotImplementedError(F64_NOT_PORTED)
    if dtype != torch.float32:
        raise ValueError(f"unsupported dtype {dtype}; use torch.float32")


def as_f32(x, device):
    """x (numpy or tensor) as a float32 tensor on device; with device None
    x must already be a tensor and stays where it is."""
    if device is None:
        if not isinstance(x, torch.Tensor):
            raise ValueError("pass a torch.Tensor or name a device")
        device = x.device
    return torch.as_tensor(x, dtype=torch.float32, device=device)


#: 1 ms frames beyond which HarvestKernel.compute_batch runs the contour
#: chain of CPU input in numpy float64
HOST_CONTOUR_FRAMES = 8192


class HarvestKernel(torch.nn.Module):
    """Harvest for one (fs, x_length) geometry: f32 batches -> F0 at the
    frame period, on the device of ``device`` (or of the input tensor when
    ``device`` is None).

    ``forward`` keeps everything on the device; ``compute`` and
    ``compute_batch`` mirror ``worldtpu.analysis.harvest.HarvestKernel``
    and return numpy.  Input on the card always takes the device contour
    chain.  CPU input longer than HOST_CONTOUR_FRAMES frames of the 1 ms
    grid takes the numpy float64 chain (``analysis.contour``)
    instead, since the dense chain's section layout grows as F^2."""

    def __init__(self, fs, x_length, f0_floor=C.FLOOR_F0, f0_ceil=C.CEIL_F0,
                 frame_period=5.0, target_fs=8000.0, channels_in_octave=40.0,
                 device=None):
        super().__init__()
        self.geo = HarvestGeometry(
            fs, x_length, f0_floor=f0_floor, f0_ceil=f0_ceil,
            frame_period=frame_period, target_fs=target_fs,
            channels_in_octave=channels_in_octave)
        self.device = None if device is None else torch.device(device)

    def forward(self, x):
        """x [B, x_length] float32 -> (f0 [B, n_out], tpos [n_out])."""
        n_out = self.geo.n_grid()
        mean = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        f0 = harvest_device_full(x, mean, geo=self.geo, n_out=n_out)
        tpos = torch.arange(n_out, dtype=x.dtype, device=x.device) \
            * (self.geo.frame_period / 1000.0)
        return f0, tpos

    def get_samples(self):
        return self.geo.n_grid()

    def _tpos(self):
        return np.arange(self.get_samples()) * self.geo.frame_period / 1000.0

    def _finish(self, cand, score):
        """Host contour of one utterance's [F, S] candidates/scores
        (float64 numpy) -> (f0 [n_out], tpos [n_out])."""
        from worldtpu_torch.analysis import contour
        best = contour.fix_f0_contour(cand, score)
        f0_grid = contour.smooth_f0_contour(best)
        tpos = self._tpos()
        x = tpos * 1000.0
        pick = np.where(x > 0, np.floor(x + 0.5), np.ceil(x - 0.5))
        pick = np.minimum(self.geo.f0_length - 1, pick.astype(np.int64))
        return f0_grid[pick], tpos

    def compute(self, x, dtype=torch.float32):
        """One utterance x [x_length] -> (f0 [n_out], tpos [n_out]) as
        float64 numpy."""
        return self.compute_batch(as_f32(x, self.device)[None], dtype)[0]

    def compute_batch(self, x_batch, dtype=torch.float32,
                      check_capacity=False):
        """Harvest over [B, x_length] utterances -> [(f0, tpos)] per
        utterance (float64 numpy).  ``check_capacity`` first counts the zc
        event-buffer overflows and raises ZcCapacityError if any utterance
        has one."""
        check_f32(dtype)
        x = as_f32(x_batch, self.device)
        with torch.no_grad():
            if check_capacity:
                v = zc_capacity_violations_batch(x, geo=self.geo).cpu()
                if bool(v.any()):
                    bad = torch.nonzero(v)[:, 0].tolist()
                    raise ZcCapacityError(
                        f"zc event buffer ({self.geo.e_max} events per band "
                        f"and crossing type) overflowed for utterances "
                        f"{bad}, in {v[bad].tolist()} (band, type) pairs; "
                        f"the input's band-limited crossing rate is outside "
                        f"Harvest's model (a full-band chirp or a noise "
                        f"burst?)")
            if (x.device.type != "cpu"
                    or self.geo.f0_length <= HOST_CONTOUR_FRAMES):
                f0, _ = self(x)
                f0 = f0.cpu().numpy().astype(np.float64)
                return [(f0[i], self._tpos()) for i in range(len(f0))]
            mean = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            cand, score = harvest_device_stages(x, mean, geo=self.geo)
            cand = cand.numpy().astype(np.float64)
            score = score.numpy().astype(np.float64)
        return [self._finish(cand[i], score[i]) for i in range(len(cand))]
