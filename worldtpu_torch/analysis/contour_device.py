"""Harvest F0-contour fixing and smoothing on the device, batched over
utterances (f32).

Port of worldtpu/analysis/contour_device.py (reference fixF0Contour +
smoothF0Contour, src/harvest.cpp:254-703).  The JAX version is per
utterance under vmap with data-dependent while_loops; here the batch axis
is explicit and each data-dependent bound becomes one host read of its
batch maximum, then a loop of that many masked steps:

  - fix_step3: the number of voiced sections (extend walk rows, section
    means) and the number of kept sections (merge loop) — 2 reads;
  - smooth_f0_contour: the number of voiced sections — 1 read.

Those 3 reads are the chain's only host synchronisations; constants reach
the device by ``torch.full`` or a per-device cache, never by a blocking
copy per call.  The extend walk is the extend kernel (ops/extend_kernel.py:
one CUDA launch on the card, where each walk exits when it stops; on the
CPU its plain version, ext_lim+1 = 101 masked steps).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn

from worldtpu_torch.ops import extend_kernel as _ext
from worldtpu_torch.ops.numeric import rdiv


def _runs(v):
    """(st_mask, ed_mask, rank) of voiced runs in v [B, F]."""
    z = torch.zeros_like(v[:, :1])
    st_mask = v & ~torch.cat([z, v[:, :-1]], dim=1)
    ed_mask = v & ~torch.cat([v[:, 1:], z], dim=1)
    rank = torch.cumsum(st_mask, dim=1) - 1
    return st_mask, ed_mask, rank


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
    st_mask, ed_mask, _ = _runs(v)
    F = f0.shape[1]
    idx = torch.arange(F, device=f0.device).expand_as(f0)
    st_of = torch.cummax(torch.where(st_mask, idx, -1), dim=1).values
    ed_of = -torch.cummax(torch.where(ed_mask, -idx, -F).flip(1),
                          dim=1).values.flip(1)
    short = (ed_of - st_of) < voice_range_minimum
    return torch.where(v & short, torch.zeros_like(f0), f0)


def _extend(ch, ss, st, ed, n_sec, R, candidates, scores, allowed_range,
            grid_ms):
    """Extend the first R sections outward, both directions at once
    (reference extendF0): each walk accepts the nearest candidate within
    allowed_range of its running reference F0 and stops after miss_lim
    consecutive misses or ext_lim frames (the extend kernel).  Writes the
    walked values into ch/ss in place; returns the shifted origins
    (st2, ed2)."""
    B, F, S = candidates.shape
    dev = candidates.device
    ext_lim = max(1, round(100 / grid_ms))
    miss_lim = max(1, round(4 / grid_ms))
    ed_c, st_c = ed[:, :R], st[:, :R]
    origin = torch.cat([ed_c, st_c], dim=1)                     # [B, 2R]
    shift = torch.cat([torch.ones((B, R), dtype=torch.int64, device=dev),
                       -torch.ones((B, R), dtype=torch.int64, device=dev)],
                      dim=1)
    limit = torch.cat([torch.clamp(ed_c + ext_lim, max=F - 2),
                       torch.clamp(st_c - ext_lim, min=1)], dim=1)
    distance = torch.abs(limit - origin)
    sec = torch.arange(R, device=dev).repeat(2)                 # row -> section
    live = (sec < n_sec[:, None])
    bidx = torch.arange(B, device=dev)[:, None]
    tmp0 = ch[bidx, sec, origin.clamp(0, F - 1)]
    vals, scs, n_on, so = _ext.extend_walk(
        candidates, scores, origin, shift, live, distance, tmp0,
        ext_lim=ext_lim, miss_lim=miss_lim, allowed_range=allowed_range)
    # the ON steps form a prefix of each walk; each walk visits fresh
    # columns and the two directions of a section never meet, so the
    # accepted steps write unique (row, column) cells; the other steps write
    # to the dump column F
    step = torch.arange(ext_lim + 1, device=dev)
    j = (origin[..., None] + shift[..., None] * (step + 1)).clamp(0, F - 1)
    col = torch.where(step < n_on[..., None], j, F)             # [B, 2R, E]
    rsec = sec[None, :, None]
    ch[bidx[..., None], rsec, col] = vals
    ss[bidx[..., None], rsec, col] = scs
    ed2 = ed.clone()
    st2 = st.clone()
    ed2[:, :R] = so[:, :R]
    st2[:, :R] = so[:, R:]
    return st2, ed2


def fix_step3(f0, candidates, scores, allowed_range=0.18, grid_ms=1):
    """Extend voiced sections by contour continuity, filter them by their
    mean, then merge overlapping extensions by score (reference
    extendF0/mergeF0)."""
    B, F = f0.shape
    dev = f0.device
    dt = f0.dtype
    s_max = (F + 1) // 7 + 1
    v = _vmask(f0)
    st_mask, ed_mask, rank = _runs(v)
    n_sec = st_mask.sum(1)                                      # [B]
    R = min(int(n_sec.max()), s_max)                            # host sync 1
    if R == 0:
        return f0
    st = _positions(st_mask, s_max, F - 2)
    ed = _positions(ed_mask, s_max, 1)
    rows = torch.arange(R, device=dev)

    # base channels [B, R, F+1] (extra dump column; only the first R = max
    # n_sec sections can be live) + score shadows: a zero
    # value's score is the frame's max score over zero candidates, a run
    # value's is that value's own match score
    in_own = (torch.where(v, rank, s_max)[:, None, :] == rows[:, None])
    zero_c = torch.zeros((), dtype=dt, device=dev)
    ch = Fn.pad(torch.where(in_own, f0[:, None, :], zero_c), (0, 1))
    ss_zero = _ext.score_of(torch.zeros_like(f0), candidates, scores)
    ss_run = _ext.score_of(f0, candidates, scores)
    ss = Fn.pad(torch.where(in_own, ss_run[:, None, :], ss_zero[:, None, :]),
                (0, 1))

    st2, ed2 = _extend(ch, ss, st, ed, n_sec, R, candidates, scores,
                       allowed_range, grid_ms)
    st2, ed2 = st2[:, :R], ed2[:, :R]

    # ---- section filter by mean F0; the mean accumulates WITHOUT reset
    #      between sections (harvest.cpp:446-452) ----
    csum = Fn.pad(torch.cumsum(ch[..., :F], dim=-1), (1, 0))
    ssum = (csum.gather(-1, ed2.clamp(0, F)[..., None])
            - csum.gather(-1, st2.clamp(0, F)[..., None]))[..., 0]
    length = (ed2 - st2).to(dt)
    means = []
    m = torch.zeros(B, dtype=dt, device=dev)
    for k in range(R):
        m = (m + ssum[:, k]) / length[:, k]
        means.append(m)
    means = torch.stack(means, dim=1)
    keep = (rdiv(2200.0 / grid_ms, means) < length) & (rows < n_sec[:, None])
    n_ch = keep.sum(1)

    # survivors to the front, in order
    krank = torch.where(keep, torch.cumsum(keep, 1) - 1, R)
    sel = torch.zeros((B, R + 1), dtype=torch.int64, device=dev)
    sel.scatter_(1, krank, rows.expand(B, R))
    sel = torch.where(rows < n_ch[:, None], sel[:, :R], 0)
    bidx = torch.arange(B, device=dev)[:, None]
    st3 = st2.gather(1, sel)
    ed3 = ed2.gather(1, sel)
    ch3 = ch[bidx, sel, :F]                                     # [B, R, F]
    ss3 = ss[bidx, sel, :F]

    # ---- merge in order of start ----
    order = torch.argsort(torch.where(rows < n_ch[:, None], st3, F + rows),
                          dim=1, stable=True)
    fidx = torch.arange(F, device=dev)
    merged, mss = ch3[:, 0].clone(), ss3[:, 0].clone()
    b0, b1 = st3[:, :1].clone(), ed3[:, :1].clone()             # [B, 1]
    n_merge = int(n_ch.max())                                   # host sync 2
    for i in range(1, n_merge):
        act = (i < n_ch)[:, None]
        k = order[:, i:i + 1]
        i1, i2 = st3.gather(1, k), ed3.gather(1, k)
        chk = ch3[bidx, k][:, 0]
        ssk = ss3[bidx, k][:, 0]
        in_sec = (fidx >= i1) & (fidx <= i2)
        new_section = i1 - b1 > 0
        covered = (b0 <= i1) & (b1 >= i2)
        r = (fidx >= i1) & (fidx <= b1)
        s1 = torch.sum(torch.where(r, mss, zero_c), 1, keepdim=True)
        s2 = torch.sum(torch.where(r, ssk, zero_c), 1, keepdim=True)
        take_hi = (fidx >= b1) & (fidx <= i2)
        take = torch.where(s1 > s2, take_hi, in_sec)
        upd = torch.where(new_section, in_sec,
                          torch.where(covered, torch.zeros_like(take), take))
        upd = upd & act
        merged = torch.where(upd, chk, merged)
        mss = torch.where(upd, ssk, mss)
        b0 = torch.where(act & new_section, i1, b0)
        b1 = torch.where(act & (new_section | ~covered), i2, b1)

    out = torch.where((n_ch == 0)[:, None], ch[:, 0, :F], merged)
    return torch.where((n_sec == 0)[:, None], f0, out)


def fix_step4(f0, threshold=9):
    """Fill unvoiced gaps shorter than threshold frames linearly."""
    B, F = f0.shape
    dev = f0.device
    v = _vmask(f0)
    st_mask, ed_mask, _ = _runs(v)
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


_SMOOTH_B = (0.0078202080334971724, 0.015640416066994345)
_SMOOTH_A = (1.7347257688092754, -0.76600660094326412)
_LAG = 300
_BIQUAD_BLOCK = 128


@functools.lru_cache(maxsize=8)
def _biquad_tables(L, nb, dtype, device):
    """Blocked-matmul tables for the smoothing biquad (state (w0, w1)),
    derived in float64 and copied to device once: G [L, 2] state read,
    HT [L, L] within-block response, W [L, 2] block input weights, and the
    [nb, nb, 2, 2] table of block transitions AL^(k-1-j) (j < k) giving
    every block-start state at once."""
    a0, a1 = _SMOOTH_A
    b0, b1 = _SMOOTH_B
    A = np.array([[a0, a1], [1.0, 0.0]])
    e0 = np.array([1.0, 0.0])
    c = np.array([b0 * a0 + b1, b0 * a1 + b0])
    P = np.zeros((L + 1, 2, 2))
    P[0] = np.eye(2)
    for i in range(L):
        P[i + 1] = A @ P[i]
    G = np.stack([c @ P[i] for i in range(L)])
    H = np.zeros((L, L))
    for i in range(L):
        H[i, i] = b0
        for j in range(i):
            H[i, j] = c @ P[i - 1 - j] @ e0
    W = np.stack([P[L - 1 - j] @ e0 for j in range(L)])
    AL = P[L]
    Ap = np.zeros((nb, 2, 2))
    Ap[0] = np.eye(2)
    for d in range(1, nb):
        Ap[d] = AL @ Ap[d - 1]
    T = np.zeros((nb, nb, 2, 2))
    for k in range(1, nb):
        for j in range(k):
            T[k, j] = Ap[k - 1 - j]
    return tuple(torch.as_tensor(t, dtype=dtype, device=device)
                 for t in (G, H.T, W, T))


def _biquad_batch(x):
    """One forward biquad pass over rows of x [M, T], output reversed like
    the reference (filteringF0)."""
    M, T = x.shape
    L = _BIQUAD_BLOCK
    nb = -(-T // L)
    G, HT, W, Tb = _biquad_tables(L, nb, x.dtype, x.device)
    xb = Fn.pad(x, (0, nb * L - T)).reshape(M, nb, L)
    c = xb @ W                                                  # [M, nb, 2]
    s0 = torch.einsum("kjst,mjt->mks", Tb, c)                   # [M, nb, 2]
    y = s0 @ G.T + xb @ HT
    return y.reshape(M, nb * L)[:, :T].flip(-1)


def smooth_f0_contour(f0):
    """Per-section zero-lag Butterworth smoothing (reference
    smoothF0Contour): f0 [B, F] -> [B, F]."""
    B, F = f0.shape
    dev = f0.device
    n = F + 2 * _LAG
    padded = Fn.pad(f0, (_LAG, _LAG))
    v = _vmask(padded)
    st_mask, ed_mask, rank = _runs(v)
    n_sec = st_mask.sum(1)
    R = int(n_sec.max())                                        # host sync 3
    if R == 0:
        return torch.zeros_like(f0)
    st = _positions(st_mask, R, n - 1)
    ed = _positions(ed_mask, R, 0)
    live = torch.arange(R, device=dev) < n_sec[:, None]          # [B, R]
    j = torch.arange(n, device=dev)
    edge_lo = padded.gather(1, st.clamp(0, n - 1))
    edge_hi = padded.gather(1, ed.clamp(0, n - 1))
    chs = torch.where(j < st[..., None], edge_lo[..., None],
                      torch.where(j > ed[..., None], edge_hi[..., None],
                                  padded[:, None, :]))          # [B, R, n]
    chs = torch.where(live[..., None], chs, torch.zeros((), dtype=f0.dtype,
                                                        device=dev))
    sm = _biquad_batch(_biquad_batch(chs.reshape(B * R, n))).reshape(B, R, n)
    sid = torch.where(v, rank, -1)
    hit = sid[:, None, :] == torch.arange(R, device=dev)[:, None]
    out = torch.sum(torch.where(hit, sm, torch.zeros((), dtype=f0.dtype,
                                                     device=dev)), dim=1)
    return torch.where(v[:, _LAG:_LAG + F], out[:, _LAG:_LAG + F],
                       torch.zeros((), dtype=f0.dtype, device=dev))


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
