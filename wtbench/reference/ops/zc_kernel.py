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

import math

import numpy as np
import torch
import torch.nn.functional as Fn

from wtbench.reference.ops.numeric import device_cache

#: rows of the [B*nb, L] signal processed together by the plain version
#: (bounds its int64 rank/cumsum temporaries)
_PLAIN_ROWS = 64


def band_candidates(filt, geo, bounds=None):
    """Raw band candidates [B, nb, F] from band signals filt [B, nb, L]
    (L = geo.y_length, F = geo.f0_length) of the bands whose boundary
    frequencies are ``bounds`` [nb] float32 on filt's device (None: every
    band of the geometry, nb = geo.n_channels)."""
    args = geometry_args(geo)
    if bounds is None:
        bounds = _bounds(geo, filt.device)
    return band_candidates_plain(filt, bounds, **args)


@device_cache(maxsize=8)
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


# ---------------------------------------------------------------------------
# phase 1 alone (zc events) and the capacity model of the TPU kernel's
# static buffers
# ---------------------------------------------------------------------------


