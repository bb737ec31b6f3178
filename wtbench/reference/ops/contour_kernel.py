"""The contour chain's data-dependent loops — wrappers of the CUDA kernels
``csrc/contour.cu`` and their plain PyTorch versions.

No TPU kernel stands behind them: each replaces a JAX loop of
worldtpu/analysis/contour_device.py, so that the chain reads nothing back
to the host and the main path can be captured as a CUDA graph.

  - ``contour_merge`` (``wt_contour_merge``): fix_step3 after the extend
    walk — the section filter by the running mean (the ``lax.scan`` at
    :356-360) and the merge of overlapping extensions by score (the
    ``lax.while_loop`` at :379-405), reference extendF0 / mergeF0
    (src/harvest.cpp:427-536);
  - ``contour_smooth`` (``wt_contour_smooth``): smooth_f0_contour's
    per-section zero-lag Butterworth filter (the ``lax.while_loop`` at
    :497-547), reference smoothF0Contour (src/harvest.cpp:639-703):
    the host float64 filter's bits, its chain cut short on the held edges,
    where the biquad's state runs into an exact periodic orbit.

Both take static section slots (their positions compacted with
``contour_device._positions``; a slot past the utterance's section count is
dead).  The plain versions are the chain's earlier batched code: they bound
their rows and Python loops by the live section count (a host read, on
either device), build dense [B, R, F] channels, and smooth with a blocked
matmul.  A CPU tensor takes the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn

from wtbench.reference.ops.numeric import device_cache, rdiv

#: frames of zero padding on each side of the smoothed contour
LAG = 300
_SMOOTH_B = (0.0078202080334971724, 0.015640416066994345)
_SMOOTH_A = (1.7347257688092754, -0.76600660094326412)
_BIQUAD_BLOCK = 128

#: the largest F whose merged row's sources (4 F bytes) kernel A keeps in
#: shared memory (227 KB a block, less 1 KB of its static shared memory);
#: longer contours take the global-memory variant
MERGE_SHARED_MAX_F = (227 * 1024 - 1024) // 4
#: kernel B's checkpoint spacing in a tail it runs in full: at least this
#: many samples, and at most SMOOTH_CHECKPOINTS checkpoints
SMOOTH_CHUNK = 128
SMOOTH_CHECKPOINTS = 2048
SMOOTH_MAX_CHUNK = 2048
#: kernel B seeks the biquad's orbit on a held edge (and the backward
#: pass's cycle) for this many steps, in blocks of 16, and keeps that many
#: tail outputs in shared memory (beside 2 ceil(n / chunk) + chunk doubles
#: of checkpoints and a chunk); past it (or with 0) the stretch runs in
#: full
SMOOTH_ORBIT_CAP = 1024
#: kernel B's trace flags (contour_smooth_cuda(trace=True)[1][..., 1])
SMOOTH_FLAGS = dict(prefix_orbit=1, tail_orbit=2, back_cycle=4,
                    prefix_full=8, tail_full=16, back_full=32)


def _trace(B, S, device):
    nan = torch.full((B, S), float("nan"), device=device)
    return dict(ssum=torch.zeros((B, S), device=device),
                keep=torch.zeros((B, S), dtype=torch.bool, device=device),
                s1=nan, s2=nan.clone(),
                ordered=torch.zeros((B, S), dtype=torch.bool, device=device))


def contour_merge(f0, ss_run, ss_zero, st, ed, n_sec, vals, scs, n_on, so,
                  *, grid_ms=1, trace=False):
    """fix_step3's section filter and merge, from its extend walks.

    Args:
        f0: [B, F] float32, fix_step2's output.
        ss_run, ss_zero: [B, F] float32, the score of f0[j] among frame j's
            candidates and the best score of a zero candidate (0 if none).
        st, ed: [B, S] int64 voiced-run starts and ends in S slots
            (S = (F + 1) // 7 + 1); n_sec: [B] int64 runs of each row
            (slots k >= n_sec are dead).
        vals, scs: [B, 2S, E] float32, n_on, so: [B, 2S] int64 —
            ``extend_kernel.extend_walk``'s outputs for the forward walk of
            run k (walk k, from ed) and its backward walk (walk S + k,
            from st).

    Returns:
        [B, F] float32; with ``trace`` also a dict of [B, S] rows: the
        section sums ``ssum`` and ``keep`` of each slot, and for merge
        step i the score sums ``s1``, ``s2`` that decided it (NaN where the
        step was not contested), and ``ordered``: the sections the kernel
        summed in frame order (its exactness condition failed; all False
        in the plain version, whose cumulative sum is in frame order
        throughout).
    """
    args = (f0, ss_run, ss_zero, st, ed, n_sec, vals, scs, n_on, so)
    return contour_merge_plain(*args, grid_ms=grid_ms, trace=trace)


def contour_merge_plain(f0, ss_run, ss_zero, st, ed, n_sec, vals, scs, n_on,
                        so, *, grid_ms=1, trace=False):
    """The batched torch version over the first R = max n_sec slots: dense
    channels [B, R, F+1] with the walks written in, the means as a loop of
    R masked steps, the merge as a loop of max n_ch masked steps (two host
    reads)."""
    B, F = f0.shape
    S = st.shape[1]
    E = vals.shape[2]
    dev = f0.device
    dt = f0.dtype
    tr = _trace(B, S, dev) if trace else None
    R = min(int(n_sec.max()), S)                                # host read
    if R == 0:
        return (f0, tr) if trace else f0
    rows = torch.arange(R, device=dev)
    fidx = torch.arange(F, device=dev)
    live = rows < n_sec[:, None]                                # [B, R]
    in_own = live[..., None] & (fidx >= st[:, :R, None]) \
        & (fidx <= ed[:, :R, None])                             # [B, R, F]
    zero_c = torch.zeros((), dtype=dt, device=dev)
    # channels with an extra dump column F
    ch = Fn.pad(torch.where(in_own, f0[:, None, :], zero_c), (0, 1))
    ss = Fn.pad(torch.where(in_own, ss_run[:, None, :], ss_zero[:, None, :]),
                (0, 1))
    # the ON steps form a prefix of each walk; each walk visits fresh
    # columns and the two directions of a section never meet, so the
    # accepted steps write unique (row, column) cells; the other steps write
    # to the dump column F
    walk = torch.cat([rows, S + rows])                          # [2R]
    origin = torch.cat([ed[:, :R], st[:, :R]], dim=1)
    shift = torch.cat([torch.ones_like(rows), -torch.ones_like(rows)])
    step = torch.arange(E, device=dev)
    j = (origin[..., None] + shift[:, None] * (step + 1)).clamp(0, F - 1)
    col = torch.where(step < n_on[:, walk, None], j, F)         # [B, 2R, E]
    bidx = torch.arange(B, device=dev)[:, None, None]
    rsec = rows.repeat(2)[None, :, None]
    ch[bidx, rsec, col] = vals[:, walk]
    ss[bidx, rsec, col] = scs[:, walk]
    st2, ed2 = so[:, S:S + R], so[:, :R]

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
    keep = (rdiv(2200.0 / grid_ms, means) < length) & live
    n_ch = keep.sum(1)
    if trace:
        tr["ssum"][:, :R] = torch.where(live, ssum, zero_c)
        tr["keep"][:, :R] = keep

    # survivors to the front, in order
    krank = torch.where(keep, torch.cumsum(keep, 1) - 1, R)
    sel = torch.zeros((B, R + 1), dtype=torch.int64, device=dev)
    sel.scatter_(1, krank, rows.expand(B, R))
    sel = torch.where(rows < n_ch[:, None], sel[:, :R], 0)
    bidx = bidx[..., 0]
    st3 = st2.gather(1, sel)
    ed3 = ed2.gather(1, sel)
    ch3 = ch[bidx, sel, :F]                                     # [B, R, F]
    ss3 = ss[bidx, sel, :F]

    # ---- merge in order of start; the first kept section (in section
    #      order) starts the merged row ----
    order = torch.argsort(torch.where(rows < n_ch[:, None], st3, F + rows),
                          dim=1, stable=True)
    merged, mss = ch3[:, 0].clone(), ss3[:, 0].clone()
    b0, b1 = st3[:, :1].clone(), ed3[:, :1].clone()             # [B, 1]
    n_merge = int(n_ch.max())                                   # host read
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
        if trace:
            hot = (act & ~new_section & ~covered)[:, 0]
            tr["s1"][:, i] = torch.where(hot, s1[:, 0], tr["s1"][:, i])
            tr["s2"][:, i] = torch.where(hot, s2[:, 0], tr["s2"][:, i])
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
    out = torch.where((n_sec == 0)[:, None], f0, out)
    return (out, tr) if trace else out


def contour_smooth(f0, st, ed, n_sec):
    """smooth_f0_contour's per-section zero-lag smoothing.

    Args:
        f0: [B, F] float32 contour (fix_step4's output).
        st, ed: [B, NS] int64 starts and ends of the voiced runs of the
            contour padded with LAG zero frames on each side, in NS slots;
            n_sec: [B] int64 runs of each row.

    Returns:
        [B, F] float32: each run's frames of its edge-held signal filtered
        forward and backward; 0 off the runs.
    """
    return contour_smooth_plain(f0, st, ed, n_sec)


@device_cache(maxsize=8)
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


def contour_smooth_plain(f0, st, ed, n_sec):
    """The batched torch version over the first R = max n_sec slots (a host
    read): the R edge-held signals [B, R, n] filtered as blocked matmuls."""
    B, F = f0.shape
    dev = f0.device
    n = F + 2 * LAG
    R = int(n_sec.max())                                        # host read
    if R == 0:
        return torch.zeros_like(f0)
    st, ed = st[:, :R], ed[:, :R]
    padded = Fn.pad(f0, (LAG, LAG))
    live = torch.arange(R, device=dev) < n_sec[:, None]         # [B, R]
    j = torch.arange(n, device=dev)
    edge_lo = padded.gather(1, st.clamp(0, n - 1))
    edge_hi = padded.gather(1, ed.clamp(0, n - 1))
    zero_c = torch.zeros((), dtype=f0.dtype, device=dev)
    chs = torch.where(j < st[..., None], edge_lo[..., None],
                      torch.where(j > ed[..., None], edge_hi[..., None],
                                  padded[:, None, :]))          # [B, R, n]
    chs = torch.where(live[..., None], chs, zero_c)
    sm = _biquad_batch(_biquad_batch(chs.reshape(B * R, n))).reshape(B, R, n)
    hit = live[..., None] & (j >= st[..., None]) & (j <= ed[..., None])
    out = torch.sum(torch.where(hit, sm, zero_c), dim=1)
    return out[:, LAG:LAG + F]


def smooth_chunk(n):
    """Kernel B's checkpoint spacing for a padded contour of n frames."""
    chunk = max(SMOOTH_CHUNK, -(-n // SMOOTH_CHECKPOINTS))
    if chunk > SMOOTH_MAX_CHUNK:
        raise ValueError(f"a padded contour of {n} frames is past the "
                         f"smoothing kernel's {SMOOTH_CHECKPOINTS} x "
                         f"{SMOOTH_MAX_CHUNK} frames")
    return chunk


