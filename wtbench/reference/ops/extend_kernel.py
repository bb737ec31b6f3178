"""The extendF0 walk of the contour chain — wrapper of the CUDA kernel
``csrc/extend.cu`` and its plain PyTorch version.

Port of worldtpu/ops/extend_kernel.py (Pallas ``_walk_kernel``), reference
extendF0/selectBestF0 (src/harvest.cpp:347-403): each walk steps outward
from its origin frame by frame, accepting the nearest candidate within
``allowed_range`` of a running reference F0 (ties toward the LAST equal
slot; the reference F0 updates on every accept) and stopping after
``miss_lim`` consecutive misses or after step ``distance``
(``<= ext_lim``).

Both versions walk the S real candidate slots of [B, F, S] tables.  The TPU
kernel pads the slots to 128 lanes with zero candidates of score 0, which
can take part in a miss's score; here they do not exist.
"""

from __future__ import annotations

import torch


#: candidate slots the CUDA kernel takes (8 chunks of 32 lanes; the main
#: path's Harvest geometry at f0_floor 40 has 126)
MAX_SLOTS = 256


def select_best(ref_f0, cand_rows, allowed_range):
    """Nearest candidate within allowed_range of each ref (ties keep the
    LAST equal-error candidate).  ref_f0 [..., K], cand_rows [..., K, S]."""
    err = torch.abs(ref_f0[..., None] - cand_rows) / ref_f0[..., None]
    m = torch.amin(err, dim=-1, keepdim=True)
    S = cand_rows.shape[-1]
    idx = S - 1 - torch.argmax((err == m).flip(-1).to(torch.uint8), dim=-1,
                               keepdim=True)
    best = cand_rows.gather(-1, idx)[..., 0]
    return torch.where(m[..., 0] <= allowed_range, best,
                       torch.zeros_like(best))


def score_of(vals, cand_rows, score_rows):
    """Max score over candidates equal to vals (0 if none)."""
    m = cand_rows == vals[..., None]
    s = torch.amax(torch.where(m, score_rows, -torch.inf), dim=-1)
    return torch.where(m.any(-1), s, torch.zeros_like(s))


def extend_walk(candidates, scores, origin, shift, live, distance, tmp0, *,
                ext_lim, miss_lim, allowed_range):
    """Run B x W extend walks over per-utterance candidate tables.

    Args:
        candidates, scores: [B, F, S] float32.
        origin: [B, W] int64 walk origins (walk w visits origin + shift *
            (i + 1) at step i).
        shift: [B, W] int64, +1 or -1.
        live: [B, W] bool.
        distance: [B, W] int64 >= 0, the last step the walk may take.
        tmp0: [B, W] float32 starting reference F0.

    Returns:
        (vals [B, W, E], scs [B, W, E] float32, n_on [B, W] int64,
        so [B, W] int64) with E = ext_lim + 1: the accepted value (0 for a
        miss) and its score at each step the walk ran — the ON steps form
        the prefix of length n_on, zeros follow — and the last accepted
        frame (origin when nothing was accepted).
    """
    kw = dict(ext_lim=ext_lim, miss_lim=miss_lim,
              allowed_range=allowed_range)
    args = (candidates, scores, origin, shift, live, distance, tmp0)
    return extend_walk_plain(*args, **kw)


def extend_walk_plain(candidates, scores, origin, shift, live, distance,
                      tmp0, *, ext_lim, miss_lim, allowed_range):
    """The walk as ext_lim + 1 masked torch steps over all walks at once (a
    stopped walk's remaining steps are no-ops)."""
    B, F, S = candidates.shape
    dev = candidates.device
    bidx = torch.arange(B, device=dev)[:, None]
    one = torch.ones((), dtype=candidates.dtype, device=dev)
    zero = torch.zeros((), dtype=candidates.dtype, device=dev)
    tmp = tmp0
    cnt = torch.zeros_like(origin)
    so = origin.clone()
    stopped = torch.zeros_like(live)
    n_on = torch.zeros_like(origin)
    hist_val, hist_sc = [], []
    for i in range(ext_lim + 1):
        j = origin + shift * (i + 1)
        on = live & (i <= distance) & ~stopped
        jc = j.clamp(0, F - 1)
        cand_rows = candidates[bidx, jc]                        # [B, W, S]
        score_rows = scores[bidx, jc]
        val = select_best(torch.where(tmp > 0, tmp, one), cand_rows,
                          allowed_range)
        val = torch.where(on, val, zero)
        sc = torch.where(on, score_of(val, cand_rows, score_rows), zero)
        zero_val = val == 0.0
        cnt = torch.where(on, torch.where(zero_val, cnt + 1, 0), cnt)
        tmp = torch.where(on & ~zero_val, val, tmp)
        so = torch.where(on & ~zero_val, j, so)
        stopped = stopped | (on & (cnt == miss_lim))
        n_on = n_on + on
        hist_val.append(val)
        hist_sc.append(sc)
    return (torch.stack(hist_val, dim=-1), torch.stack(hist_sc, dim=-1),
            n_on, so)


