"""Harvest zero-crossing band candidates — wrapper of the CUDA kernel
``csrc/zc.cu`` and its plain PyTorch version.

Port of worldtpu/ops/zc_kernel.py (Pallas ``_zc_group_kernel``).  Both
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

import torch

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
