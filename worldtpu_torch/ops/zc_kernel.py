"""Harvest zero-crossing band candidates — wrappers of the CUDA kernels
``csrc/zc.cu`` (the zc stage) and ``csrc/zc_events.cu`` (its phase 1
alone), their plain PyTorch versions, the event-buffer check of
``wt_zc``, and the capacity model of the TPU kernel's static buffers.

Port of worldtpu/ops/zc_kernel.py (Pallas ``_zc_group_kernel`` and
``_zc_events_kernel``, ``make_groups``, ``capacity_violations``).  Both
versions follow the jnp twin ``worldtpu.analysis.harvest._band_candidates``
(f32 production path): see ``csrc/zc.cu`` for the exact semantics.  One
deliberate difference from that twin: when a band has more than ``e_max``
events (outside the crossing-rate model that sizes ``e_max``), the twin
reads a non-event scratch value past the last slot; here that slot reads
+inf.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as Fn

from worldtpu_torch import _build
from worldtpu_torch.ops.numeric import device_kind

#: rows of the [B*nb, L] signal processed together by the plain version
#: (bounds its int64 rank/cumsum temporaries)
_PLAIN_ROWS = 64


def band_candidates(filt, geo):
    """Raw band candidates [B, nb, F] from band signals filt [B, nb, L]
    (nb = geo.n_channels, L = geo.y_length, F = geo.f0_length)."""
    args = geometry_args(geo)
    bounds = _bounds(geo, filt.device)
    if device_kind(filt) == "cpu":
        return band_candidates_plain(filt, bounds, **args)
    return band_candidates_cuda(filt, bounds, **args)


@functools.lru_cache(maxsize=8)
def _bounds(geo, device):
    """Band boundary frequencies [nb] f32 on device, copied there once per
    geometry (the copy from host memory blocks the host)."""
    return torch.as_tensor(geo.boundary_f0, dtype=torch.float32,
                           device=device)


def geometry_args(geo):
    """The scalar arguments of both versions, from a HarvestGeometry."""
    return dict(F=geo.f0_length, e_max=geo.e_max, fs_a=float(geo.actual_fs),
                grid_hz=1000.0 / geo.grid_ms, tstep=geo.grid_ms / 1000.0,
                f0_floor=float(geo.f0_floor), f0_ceil=float(geo.f0_ceil))


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def band_candidates_plain(filt, bounds, *, F, e_max, fs_a, grid_hz, tstep,
                          f0_floor, f0_ceil):
    """Vectorized torch version of the kernel (rows in chunks)."""
    B, nb, L = filt.shape
    rows = filt.reshape(B * nb, L)
    bnd = bounds.repeat(B)
    out = [_plain_rows(rows[i:i + _PLAIN_ROWS], bnd[i:i + _PLAIN_ROWS],
                       F, e_max, fs_a, grid_hz, tstep, f0_floor, f0_ceil)
           for i in range(0, B * nb, _PLAIN_ROWS)]
    return torch.cat(out, dim=0).reshape(B, nb, F)


def _plain_rows(f, bnd, F, e_max, fs_a, grid_hz, tstep, f0_floor, f0_ceil):
    N, L = f.shape
    dev = f.device
    fs_t = _f32(fs_a, dev)
    g = torch.cat([f[:, 1:] - f[:, :-1],
                   torch.zeros((N, 1), dtype=f.dtype, device=dev)], dim=1)
    i = torch.arange(L - 1, device=dev)
    k = torch.arange(e_max, device=dev)
    frames = torch.arange(F, device=dev)
    tpos = frames.to(torch.float32) * tstep
    nan = _f32(math.nan, dev)
    inf = _f32(math.inf, dev)
    total = torch.zeros((N, F), dtype=torch.float32, device=dev)
    usable = torch.ones(N, dtype=torch.bool, device=dev)
    for sig, n_eff in ((f, L), (-f, L), (g, L - 1), (-g, L - 1)):
        s0, s1 = sig[:, :-1], sig[:, 1:]
        mask = (s0 > 0.0) & (s1 <= 0.0) & (i < n_eff - 1)
        fine = (i + 1).to(torch.float32) - s0 / (s1 - s0)
        cum = torch.cumsum(mask, dim=1)
        count = cum[:, -1]
        rank = cum - 1
        # rank clamp at e_max-1 (the last event wins); slot e_max is a
        # dump for non-events, reset to +inf below
        last = mask & (rank == (count - 1)[:, None]) & (rank >= e_max - 1)
        slot = torch.where(mask & (rank < e_max - 1), rank,
                           torch.where(last, e_max - 1, e_max))
        dense = torch.full((N, e_max + 1), math.inf, dtype=torch.float32,
                           device=dev)
        dense.scatter_(1, slot, fine)
        dense[:, e_max] = math.inf
        ev_lo, ev_hi = dense[:, :e_max], dense[:, 1:]
        n_int = count - 1
        loc = torch.where(k < n_int[:, None], (ev_lo + ev_hi) / 2.0 / fs_t,
                          inf)
        itv = torch.div(fs_t, ev_hi - ev_lo)
        first = torch.where(k < n_int[:, None],
                            torch.ceil(loc * grid_hz).clamp(0, F),
                            _f32(F, dev))
        nle = torch.searchsorted(first, frames.to(torch.float32).expand(
            N, F).contiguous(), right=True)
        top = torch.clamp(n_int - 1, min=1)[:, None]
        seg = torch.minimum(nle.clamp(min=1), top)
        oob = seg >= e_max          # the twin's out-of-range take reads NaN
        sl = seg.clamp(max=e_max - 1)
        x0 = loc.gather(1, sl - 1)
        x1 = torch.where(oob, nan, loc.gather(1, sl))
        y0 = itv.gather(1, sl - 1)
        y1 = torch.where(oob, nan, itv.gather(1, sl))
        total = total + (y0 + (tpos - x0) / (x1 - x0) * (y1 - y0))
        usable = usable & (count - 1 > 2)
    cand = total / 4.0
    b = bnd[:, None]
    ok = ((cand <= b * 1.1) & (cand >= b * 0.9)
          & (cand <= f0_ceil) & (cand >= f0_floor))
    return torch.where(usable[:, None] & ok, cand,
                       torch.zeros((), dtype=torch.float32, device=dev))


def band_candidates_cuda(filt, bounds, *, F, e_max, fs_a, grid_hz, tstep,
                         f0_floor, f0_ceil):
    """Launch ``wt_zc``: one block per (utterance, band)."""
    B, nb, L = filt.shape
    _build.check_tensor(filt, "filt", torch.float32)
    _build.check_tensor(bounds, "bounds", torch.float32, (nb,), filt.device)
    n_rows = B * nb
    ev = torch.empty((n_rows, 4, e_max), dtype=torch.float32,
                     device=filt.device)
    out = torch.empty((B, nb, F), dtype=torch.float32, device=filt.device)
    _build.launch("wt_zc", filt.device, filt.data_ptr(), bounds.data_ptr(),
                  ev.data_ptr(), out.data_ptr(), n_rows, nb, L, F, e_max,
                  fs_a, grid_hz, tstep, f0_floor, f0_ceil)
    return out


# ---------------------------------------------------------------------------
# phase 1 alone (zc events) and the capacity model of the TPU kernel's
# static buffers
# ---------------------------------------------------------------------------

#: band groups of the TPU zc kernel (worldtpu.flags zc_groups default)
N_GROUPS = 10
#: samples per compaction column
_COL = 128


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class _GroupGeom:
    """Static capacities of one band group (rows lo..hi, largest boundary
    frequency bound_top): the event buffer e_cap, the events kept per
    128-sample column c_row, the sweep window win over frame tiles of
    ft*128 frames.  Field for field ``worldtpu.ops.zc_kernel._GroupGeom``:
    a crossing-rate model with a 1.8 margin for e_cap, 1.5 x bound_top for
    c_row and 1.65 x bound_top for the window."""

    def __init__(self, geo, lo, hi, bound_top):
        self.lo = lo
        self.hi = hi
        self.n_bands = hi - lo
        dur = geo.x_length / geo.fs
        self.e_cap = int(min(geo.y_length // 2 + 2,
                             dur * bound_top * 1.8 + 64))
        rate = 1.5 * bound_top / geo.actual_fs          # events per sample
        self.c_row = _round_up(int(128.0 * rate) + 4, 8)
        base = max(1, int(0.128 * geo.grid_ms * bound_top * 1.65))
        self.ft = max(1, min(4, 224 // base)) if geo.f0_length <= 8000 else 1
        self.win = _round_up(base * self.ft + 24, 8)
        self.e_cap = _round_up(max(self.e_cap, self.win + 16), 128)
        self.win = min(self.win, self.e_cap - 8)


def make_groups(geo):
    """Split the band axis into N_GROUPS contiguous groups with shared
    capacities (``worldtpu.ops.zc_kernel.make_groups`` with its defaults
    and the production group count)."""
    nb = geo.n_channels
    edges = np.linspace(0, nb, max(1, min(N_GROUPS, nb)) + 1).astype(int)
    return tuple(_GroupGeom(geo, int(a), int(b),
                            float(geo.boundary_f0[int(b) - 1]))
                 for a, b in zip(edges[:-1], edges[1:]) if b > a)


def zc_events(filt, geo):
    """Phase 1 of the zc stage alone, per band group: [(ev [B, nb_g, 4,
    e_cap] float32, ccol [B, nb_g, 4, n_cols] int32)] from band signals
    filt [B, nb, L], n_cols = ceil(L / 128).

    For each crossing type (f, -f, diff f, -diff f), ev holds the event
    positions column by column: each 128-sample column keeps its first
    c_row events (ccol counts them) at the running offset, clamped to
    e_cap - c_row, later columns over earlier ones; +inf elsewhere.  With
    no clamp that is every kept event, sorted, then +inf."""
    fn = zc_events_plain if device_kind(filt) == "cpu" else zc_events_cuda
    return [fn(filt, g.lo, g.hi, e_cap=g.e_cap, c_row=g.c_row)
            for g in make_groups(geo)]


def _type_signals(f):
    """The four crossing types of rows f [N, L]: (s0, s1, n) with event
    i <-> s0[:, i] > 0 >= s1[:, i], i < n."""
    L = f.shape[1]
    g = f[:, 1:] - f[:, :-1]
    return ((f[:, :-1], f[:, 1:], L - 1), (-f[:, :-1], -f[:, 1:], L - 1),
            (g[:, :-1], g[:, 1:], L - 2), (-g[:, :-1], -g[:, 1:], L - 2))


def zc_events_plain(filt, lo, hi, *, e_cap, c_row):
    """Dense torch version of ``wt_zc_events`` for bands lo..hi."""
    B, _, L = filt.shape
    f = filt[:, lo:hi].reshape(-1, L)
    N = f.shape[0]
    dev = f.device
    n_cols = -(-L // _COL)
    n_store = _round_up(n_cols, 8)
    pad = n_cols * _COL
    o_max = e_cap - c_row
    evs, ccols = [], []
    for s0, s1, n in _type_signals(f):
        i = torch.arange(n, device=dev)
        mask = (s0 > 0.0) & (s1 <= 0.0)
        fine = (i + 1).to(torch.float32) - s0 / (s1 - s0)
        mask = Fn.pad(mask, (0, pad - n)).reshape(N, n_cols, _COL)
        fine = Fn.pad(fine, (0, pad - n)).reshape(N, n_cols, _COL)
        rank = torch.cumsum(mask, dim=-1) - 1
        kept = mask.sum(-1).clamp(max=c_row)                 # [N, n_cols]
        off = torch.cumsum(kept, dim=-1) - kept
        o = off.clamp(max=o_max)
        o_next = (off + kept).clamp(max=o_max)
        if n_store == n_cols:                # no store column after the last
            o_next[:, -1] = e_cap
        keep = (mask & (rank < kept[..., None])
                & (o[..., None] + rank < o_next[..., None]))
        slot = torch.where(keep, o[..., None] + rank, e_cap)
        ev = torch.full((N, e_cap + 1), math.inf, dtype=torch.float32,
                        device=dev)
        ev.scatter_(1, slot.reshape(N, -1), fine.reshape(N, -1))
        evs.append(ev[:, :e_cap])
        ccols.append(kept.to(torch.int32))
    nb_g = hi - lo
    return (torch.stack(evs, dim=1).reshape(B, nb_g, 4, e_cap),
            torch.stack(ccols, dim=1).reshape(B, nb_g, 4, n_cols))


def zc_events_cuda(filt, lo, hi, *, e_cap, c_row):
    """Launch ``wt_zc_events``: one block per (utterance, band)."""
    B, nb, L = filt.shape
    _build.check_tensor(filt, "filt", torch.float32)
    if not 0 <= lo < hi <= nb:
        raise ValueError(f"band range {lo}..{hi} outside 0..{nb}")
    nb_g = hi - lo
    n_cols = -(-L // _COL)
    ev = torch.empty((B, nb_g, 4, e_cap), dtype=torch.float32,
                     device=filt.device)
    ccol = torch.empty((B, nb_g, 4, n_cols), dtype=torch.int32,
                       device=filt.device)
    _build.launch("wt_zc_events", filt.device, filt.data_ptr(),
                  ev.data_ptr(), ccol.data_ptr(), B * nb_g, nb, lo, nb_g, L,
                  e_cap, c_row, n_cols, _round_up(n_cols, 8))
    return ev, ccol


def event_overflows(filt, geo):
    """[B] int64 counts of the (band, crossing type) pairs of band signals
    filt [B, nb, L] with more events than ``geo.e_max``: the one capacity
    of ``wt_zc`` and its plain version, past which a band's intervals and
    candidates are wrong."""
    B, nb, L = filt.shape
    f = filt.reshape(B * nb, L)
    counts = torch.stack([((s0 > 0.0) & (s1 <= 0.0)).sum(-1)
                          for s0, s1, _ in _type_signals(f)], dim=1)
    return (counts > geo.e_max).reshape(B, nb * 4).sum(-1)


def capacity_violations(filt, geo):
    """Violations of the TPU zc kernel's crossing-rate capacity model for
    band signals filt [B, nb, L]: [B, 3] int64 counts of (event-buffer
    overflows, per-column overflows, sweep-window overruns), all zero iff
    its static buffers hold every event.  Dense torch over the crossing
    masks, as ``worldtpu.ops.zc_kernel.capacity_violations`` (per
    utterance there).  The port's kernels have none of these buffers; their
    capacity is ``event_overflows``."""
    B, nb, L = filt.shape
    dev = filt.device
    n_cols = -(-L // _COL)
    grid_hz = 1000.0 / geo.grid_ms
    n_tiles = _round_up(geo.f0_length, 128) // 128
    # frame tile of each crossing position (between samples i and i+1);
    # non-decreasing in i, so a tile's count is a difference of a prefix
    # sum at the tile's first sample
    pos = np.arange(L - 1) + 1.0
    tile_of = np.minimum(np.ceil(pos / float(geo.actual_fs) * grid_hz)
                         // 128, n_tiles - 1).astype(np.int64)
    first = np.searchsorted(tile_of, np.arange(n_tiles + 1), side="left")
    first = torch.as_tensor(first, device=dev)
    f = filt.reshape(B * nb, L)
    masks = []
    for s0, s1, n in _type_signals(f):
        masks.append(Fn.pad((s0 > 0.0) & (s1 <= 0.0), (0, L - 1 - n)))
    m = torch.stack(masks, dim=1).reshape(B, nb, 4, L - 1)
    tot = m.sum(-1)                                          # [B, nb, 4]
    colcnt = Fn.pad(m, (0, n_cols * _COL - (L - 1))).reshape(
        B, nb, 4, n_cols, _COL).sum(-1)
    cs = Fn.pad(torch.cumsum(m, dim=-1), (1, 0))
    tilecnt = cs[..., first[1:]] - cs[..., first[:-1]]       # [B, nb, 4, nt]
    ev_v = torch.zeros(B, dtype=torch.int64, device=dev)
    col_v = torch.zeros_like(ev_v)
    win_v = torch.zeros_like(ev_v)
    for g in make_groups(geo):
        t = tot[:, g.lo:g.hi]
        ev_v += (t > g.e_cap - g.c_row).sum((1, 2))
        col_v += (colcnt[:, g.lo:g.hi] > g.c_row).sum((1, 2, 3))
        w = tilecnt[:, g.lo:g.hi]
        if g.ft > 1:       # fold the per-128 counts to the group's tile
            n_p = _round_up(n_tiles, g.ft)
            w = Fn.pad(w, (0, n_p - n_tiles)).reshape(
                *w.shape[:3], n_p // g.ft, g.ft).sum(-1)
        win_v += (w > g.win - 8).sum((1, 2, 3))
    return torch.stack([ev_v, col_v, win_v], dim=1)
