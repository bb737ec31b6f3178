"""Harvest F0-contour fixing and smoothing on the device, batched over
utterances (f32).

Port of worldtpu/analysis/contour_device.py (reference fixF0Contour +
smoothF0Contour, src/harvest.cpp:254-703).  The JAX version is per
utterance under vmap with data-dependent while_loops; here the batch axis
is explicit and the sections sit in static slots, as in JAX: s_max =
(F + 1) // 7 + 1 in fix_step3, (n + 1) // 2 of the padded contour in
smooth_f0_contour.  The data-dependent loops are kernels that read the
section counts on the device:

  - fix_step3: the extend walk over 2 s_max walks (ops/extend_kernel.py;
    a dead slot's walks exit at once), then the section filter and the
    merge (``contour_kernel.contour_merge``);
  - smooth_f0_contour: the per-section smoothing
    (``contour_kernel.contour_smooth``).

On the card the chain makes no host synchronisation, so the main path can
be captured as a CUDA graph (parallel/graphs.py); constants reach the
device by ``torch.full`` or a per-device cache, never by a blocking copy
per call.  On the CPU the kernels' plain versions run (they read the live
section count on the host and loop over it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from wtbench.reference.ops import contour_kernel as _ck
from wtbench.reference.ops import extend_kernel as _ext


def _runs(v):
    """(st_mask, ed_mask) of voiced runs in v [B, F]."""
    z = torch.zeros_like(v[:, :1])
    st_mask = v & ~torch.cat([z, v[:, :-1]], dim=1)
    ed_mask = v & ~torch.cat([v[:, 1:], z], dim=1)
    return st_mask, ed_mask


def _positions(mask, s_max, fill):
    """Indices where mask [B, F] holds, compacted into [B, s_max] slots;
    empty slots get ``fill``."""
    B, F = mask.shape
    idx = torch.arange(F, device=mask.device)
    pos = torch.sort(torch.where(mask, idx, F), dim=1).values
    if pos.shape[1] < s_max:
        pos = Fn.pad(pos, (0, s_max - pos.shape[1]), value=F)
    pos = pos[:, :s_max]
    have = torch.arange(s_max, device=mask.device) < mask.sum(1,
                                                               keepdim=True)
    return torch.where(have, pos, fill)


def _vmask(f0):
    v = f0 > 0.0
    v[:, 0] = False
    v[:, -1] = False
    return v


def search_f0_base(candidates, scores):
    """Best-scoring candidate per frame: [B, F, S] -> [B, F]."""
    best = torch.argmax(scores, dim=-1, keepdim=True)
    f0 = candidates.gather(-1, best)[..., 0]
    sc = scores.gather(-1, best)[..., 0]
    return torch.where(sc > 0.0, f0, torch.zeros_like(f0))


def fix_step1(f0, allowed_range=0.008):
    """Rapid F0 changes -> 0."""
    out = torch.zeros_like(f0)
    if f0.shape[1] < 3:
        return out
    ref = f0[:, 1:-1] * 2 - f0[:, :-2]
    cur = f0[:, 2:]
    prev = f0[:, 1:-1]
    bad = (torch.abs((cur - ref) / ref) > allowed_range) \
        & (torch.abs(cur - prev) / prev > allowed_range)
    out[:, 2:] = torch.where((cur == 0.0) | bad, torch.zeros_like(cur), cur)
    return out


def fix_step2(f0, voice_range_minimum=6):
    """Remove voiced sections shorter than voice_range_minimum."""
    v = _vmask(f0)
    st_mask, ed_mask = _runs(v)
    F = f0.shape[1]
    idx = torch.arange(F, device=f0.device).expand_as(f0)
    st_of = torch.cummax(torch.where(st_mask, idx, -1), dim=1).values
    ed_of = -torch.cummax(torch.where(ed_mask, -idx, -F).flip(1),
                          dim=1).values.flip(1)
    short = (ed_of - st_of) < voice_range_minimum
    return torch.where(v & short, torch.zeros_like(f0), f0)


def _extend(f0, st, ed, n_sec, candidates, scores, allowed_range, grid_ms):
    """Extend every section slot outward, both directions at once
    (reference extendF0): walk k runs forward from ed[k], walk S + k
    backward from st[k]; each accepts the nearest candidate within
    allowed_range of its running reference F0 and stops after miss_lim
    consecutive misses or ext_lim frames (the extend kernel; a dead slot's
    walks exit at once).  Returns the walk outputs (vals, scs, n_on, so)."""
    B, F, S = candidates.shape
    dev = candidates.device
    s_max = st.shape[1]
    ext_lim = max(1, round(100 / grid_ms))
    miss_lim = max(1, round(4 / grid_ms))
    origin = torch.cat([ed, st], dim=1)                         # [B, 2S]
    shift = torch.cat([torch.ones_like(ed), -torch.ones_like(st)], dim=1)
    limit = torch.cat([torch.clamp(ed + ext_lim, max=F - 2),
                       torch.clamp(st - ext_lim, min=1)], dim=1)
    distance = torch.abs(limit - origin)
    live = (torch.arange(s_max, device=dev) < n_sec[:, None]).repeat(1, 2)
    tmp0 = torch.where(live, f0.gather(1, origin.clamp(0, F - 1)),
                       torch.zeros((), dtype=f0.dtype, device=dev))
    return _ext.extend_walk(
        candidates, scores, origin, shift, live, distance, tmp0,
        ext_lim=ext_lim, miss_lim=miss_lim, allowed_range=allowed_range)


def fix_step3(f0, candidates, scores, allowed_range=0.18, grid_ms=1):
    """Extend voiced sections by contour continuity, filter them by their
    mean, then merge overlapping extensions by score (reference
    extendF0/mergeF0): the extend walk over static section slots, then the
    merge kernel (ops/contour_kernel.py).  No value reaches the host."""
    B, F = f0.shape
    s_max = (F + 1) // 7 + 1
    v = _vmask(f0)
    st_mask, ed_mask = _runs(v)
    n_sec = st_mask.sum(1)                                      # [B]
    st = _positions(st_mask, s_max, F - 2)
    ed = _positions(ed_mask, s_max, 1)
    walks = _extend(f0, st, ed, n_sec, candidates, scores, allowed_range,
                    grid_ms)
    ss_zero = _ext.score_of(torch.zeros_like(f0), candidates, scores)
    ss_run = _ext.score_of(f0, candidates, scores)
    return _ck.contour_merge(f0, ss_run, ss_zero, st, ed, n_sec, *walks,
                             grid_ms=grid_ms)


def fix_step4(f0, threshold=9):
    """Fill unvoiced gaps shorter than threshold frames linearly."""
    B, F = f0.shape
    dev = f0.device
    v = _vmask(f0)
    st_mask, ed_mask = _runs(v)
    s_max = (F + 1) // 2 + 1
    st = _positions(st_mask, s_max, F + 10)
    ed = _positions(ed_mask, s_max, -10)
    n_sec = st_mask.sum(1, keepdim=True)
    fidx = torch.arange(F, device=dev)
    gprev = torch.cumsum(ed_mask, 1) - 1                        # gap index
    g = gprev.clamp(0, s_max - 2)
    ed_g = ed.gather(1, g)
    st_g1 = st.gather(1, (g + 1).clamp(0, s_max - 1))
    in_gap = (~v) & (gprev >= 0) & (gprev <= n_sec - 2) \
        & (fidx > ed_g) & (fidx < st_g1)
    distance = st_g1 - ed_g - 1
    tmp0 = f0.gather(1, ed_g.clamp(0, F - 1)) + 1.0
    tmp1 = f0.gather(1, st_g1.clamp(0, F - 1)) - 1.0
    coeff = (tmp1 - tmp0) / (distance + 1.0).to(f0.dtype)
    fill = tmp0 + coeff * (fidx - ed_g).to(f0.dtype)
    return torch.where(in_gap & (distance < threshold), fill, f0)


def smooth_f0_contour(f0):
    """Per-section zero-lag Butterworth smoothing (reference
    smoothF0Contour): f0 [B, F] -> [B, F], the runs of the contour padded
    with LAG zero frames in (n + 1) // 2 static slots, smoothed by the
    smoothing kernel (ops/contour_kernel.py)."""
    n = f0.shape[1] + 2 * _ck.LAG
    v = _vmask(Fn.pad(f0, (_ck.LAG, _ck.LAG)))
    st_mask, ed_mask = _runs(v)
    slots = (n + 1) // 2
    st = _positions(st_mask, slots, n - 1)
    ed = _positions(ed_mask, slots, 0)
    return _ck.contour_smooth(f0, st, ed, st_mask.sum(1))


def fix_and_smooth(candidates, scores, n_out, frame_period_ms, grid_ms=1):
    """Full contour chain: candidates/scores [B, F, S] -> F0 at the output
    frame grid [B, n_out] (fixF0Contour + smoothF0Contour + nearest-frame
    subsampling of the internal grid)."""
    F = candidates.shape[1]
    k = grid_ms
    c1 = search_f0_base(candidates, scores)
    c2 = fix_step1(c1, 0.008 * k)
    c1 = fix_step2(c2, max(1, round(6 / k)))
    c2 = fix_step3(c1, candidates, scores, 0.18 * k, grid_ms=k)
    best = fix_step4(c2, max(1, round(9 / k)))
    f0_grid = smooth_f0_contour(best)
    tpos = torch.arange(n_out, dtype=candidates.dtype,
                        device=candidates.device) * (frame_period_ms / 1000.0)
    x = tpos * (1000.0 / grid_ms)
    pick = torch.clamp(torch.where(x > 0, torch.floor(x + 0.5),
                                   torch.ceil(x - 0.5)).long(), max=F - 1)
    return f0_grid[:, pick]
