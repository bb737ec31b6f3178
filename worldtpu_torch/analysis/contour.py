"""Harvest F0-contour fixing and smoothing (host-side numpy, float64).

The port's own copy of ``worldtpu/analysis/contour.py`` (numpy, and the
smoothing recurrence in the port's C helper ``worldtpu_torch.native`` as in
the original's; the same operations in the same order;
``tests/test_torch_io.py`` holds the two equal bit for bit).  ``HarvestKernel.compute_batch`` runs it on CPU input
past ``HOST_CONTOUR_FRAMES``; the card runs ``contour_device`` instead.

Reference: fixF0Contour + smoothF0Contour (src/harvest.cpp:254-703).
These stages are sequential, data-dependent and O(f0_length) cheap.

All magic constants follow the reference: fixStep params 0.008/6/0.18/9
(:627-630), extend thresholds 4/100/2200 (:375,431,444), biquad coefficients
(:672-675), smoothing lag 300 (:676).
"""

from __future__ import annotations

import numpy as np

from worldtpu_torch import native


def search_f0_base(candidates, scores):
    """Best-scoring candidate per frame (reference :254-272)."""
    best = np.argmax(scores, axis=1)
    f0 = candidates[np.arange(len(best)), best]
    return np.where(scores[np.arange(len(best)), best] > 0.0, f0, 0.0)


def fix_step1(f0_base, allowed_range=0.008):
    """Rapid F0 changes -> 0 (reference :277-291)."""
    f0 = np.asarray(f0_base)
    out = np.zeros_like(f0)
    if len(f0) < 3:
        return out
    ref = f0[1:-1] * 2 - f0[:-2]
    cur = f0[2:]
    prev = f0[1:-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        bad = (np.abs((cur - ref) / ref) > allowed_range) \
            & (np.abs(cur - prev) / prev > allowed_range)
    out[2:] = np.where(cur == 0.0, 0.0, np.where(bad, 0.0, cur))
    return out


def get_boundary_list(f0):
    """V/UV boundaries (reference :296-314): returns flat [st0, ed0, st1,...]
    where st is the first voiced frame of a section and ed the last."""
    v = np.zeros(len(f0), dtype=int)
    v[1:-1] = (np.asarray(f0[1:-1]) > 0).astype(int)
    d = np.diff(v)
    starts = np.where(d == 1)[0] + 1
    ends = np.where(d == -1)[0] + 1 - 1  # i - number_of_boundaries % 2
    out = np.empty(2 * len(starts), dtype=int)
    out[0::2] = starts
    out[1::2] = ends
    return out


def fix_step2(f0_step1, voice_range_minimum=6):
    """Remove too-short voiced sections (reference :319-334)."""
    out = np.asarray(f0_step1).copy()
    b = get_boundary_list(out)
    for i in range(len(b) // 2):
        if b[2 * i + 1] - b[2 * i] >= voice_range_minimum:
            continue
        out[b[2 * i]:b[2 * i + 1] + 1] = 0.0
    return out


def _select_best_f0(reference_f0, candidates, allowed_range):
    """Reference selectBestF0 (:347-365): nearest candidate within
    allowed_range; ties keep the LAST equal-error candidate.  Vectorized:
    the sequential loop accepts err[i] <= current best, so the final pick
    is the last index attaining the overall minimum (if within range)."""
    err = np.abs(reference_f0 - candidates) / reference_f0
    m = err.min()
    if m > allowed_range:
        return 0.0, allowed_range
    idx = len(err) - 1 - int(np.argmax(err[::-1] == m))
    return candidates[idx], err[idx]


def _extend_f0(ext, origin, last_point, shift, candidates, allowed_range,
               miss_limit=4):
    """Reference extendF0 (:371-403).  miss_limit is the 4-consecutive-miss
    stop rule — 4 ms of missing candidates on the 1 ms grid; a coarser
    grid scales it down to keep the same time semantics."""
    threshold = miss_limit
    tmp_f0 = ext[origin]
    shifted_origin = origin
    distance = abs(last_point - origin)
    count = 0
    for i in range(distance + 1):
        j = origin + shift * i + shift
        ext[j], _ = _select_best_f0(tmp_f0, candidates[j], allowed_range)
        if ext[j] == 0.0:
            count += 1
        else:
            tmp_f0 = ext[j]
            count = 0
            shifted_origin = j
        if count == threshold:
            break
    return shifted_origin


def _extend(multi_f0, boundary, f0_length, candidates, allowed_range,
            grid_ms=1):
    """Reference extend (:427-458): grow each section outward, then move
    long-enough sections to the front (extendSub).

    The 100-frame growth limit and the 2200/meanF0-frame keep gate are
    TIME semantics on the reference's 1 ms grid; a coarser grid scales
    both by 1/grid_ms."""
    threshold = max(1, round(100 / grid_ms))
    miss_limit = max(1, round(4 / grid_ms))
    n_sections = len(multi_f0)
    for i in range(n_sections):
        boundary[i * 2 + 1] = _extend_f0(
            multi_f0[i], boundary[i * 2 + 1],
            min(f0_length - 2, boundary[i * 2 + 1] + threshold), 1,
            candidates, allowed_range, miss_limit)
        boundary[i * 2] = _extend_f0(
            multi_f0[i], boundary[i * 2],
            max(1, boundary[i * 2] - threshold), -1,
            candidates, allowed_range, miss_limit)

    threshold2 = 2200.0 / grid_ms
    count = 0
    mean_f0 = np.float64(0.0)
    for i in range(n_sections):
        st, ed = boundary[i * 2], boundary[i * 2 + 1]
        # NOTE: the reference accumulates into mean_f0 WITHOUT resetting it
        # between sections (harvest.cpp:446-452); replicated faithfully,
        # including IEEE inf on an empty section (numpy float division).
        for j in range(st, ed):
            mean_f0 += multi_f0[i][j]
        with np.errstate(divide="ignore", invalid="ignore"):
            mean_f0 = mean_f0 / np.float64(ed - st)
        if threshold2 / mean_f0 < ed - st:
            # swapArray(count, i)
            multi_f0[count], multi_f0[i] = multi_f0[i], multi_f0[count]
            for k in (0, 1):
                boundary[count * 2 + k], boundary[i * 2 + k] = (
                    boundary[i * 2 + k], boundary[count * 2 + k])
            count += 1
    return count


def _search_score(f0, candidates, scores):
    """Reference searchScore (:463-470)."""
    m = (candidates == f0)
    return scores[m].max() if m.any() else 0.0


def _search_score_range(f0s, candidates, scores):
    """Per-frame searchScore over a range, vectorized (exact per element)."""
    m = candidates == f0s[:, None]
    any_ = m.any(axis=1)
    vals = np.where(m, scores, -np.inf).max(axis=1)
    return np.where(any_, vals, 0.0)


def _merge_f0_sub(merged, st1, ed1, f0_2, st2, ed2, candidates, scores):
    """Reference mergeF0Sub (:475-497)."""
    if st1 <= st2 and ed1 >= ed2:
        return ed1
    r = slice(st2, ed1 + 1)
    s1 = _search_score_range(merged[r], candidates[r], scores[r])
    s2 = _search_score_range(f0_2[r], candidates[r], scores[r])
    # accumulate left-to-right like the reference's sequential += (pairwise
    # np.sum would round differently and can flip the tie comparison)
    score1 = score2 = 0.0
    for a, b_ in zip(s1, s2):
        score1 += a
        score2 += b_
    if score1 > score2:
        merged[ed1:ed2 + 1] = f0_2[ed1:ed2 + 1]
    else:
        merged[st2:ed2 + 1] = f0_2[st2:ed2 + 1]
    return ed2


def _merge_f0(multi_f0, boundary, n_channels, f0_length, candidates, scores):
    """Reference mergeF0 (:502-536)."""
    order = sorted(range(n_channels), key=lambda i: boundary[i * 2])
    merged = multi_f0[0].copy()
    for i in range(1, n_channels):
        i1 = boundary[order[i] * 2]
        i2 = boundary[order[i] * 2 + 1]
        if i1 - boundary[1] > 0:
            merged[i1:i2 + 1] = multi_f0[order[i]][i1:i2 + 1]
            boundary[0] = i1
            boundary[1] = i2
        else:
            boundary[1] = _merge_f0_sub(
                merged, boundary[0], boundary[1], multi_f0[order[i]],
                i1, i2, candidates, scores)
    return merged


def fix_step3(f0_step2, candidates, scores, allowed_range=0.18, grid_ms=1):
    """Extend voiced sections by contour continuity (reference :560-585)."""
    f0_step2 = np.asarray(f0_step2)
    out = f0_step2.copy()
    b = get_boundary_list(f0_step2)
    n_sections = len(b) // 2
    if n_sections == 0:
        return out
    boundary = list(b)
    multi = []
    for i in range(n_sections):
        ch = np.zeros_like(f0_step2)
        ch[b[2 * i]:b[2 * i + 1] + 1] = f0_step2[b[2 * i]:b[2 * i + 1] + 1]
        multi.append(ch)
    n_channels = _extend(multi, boundary, len(f0_step2), candidates,
                         allowed_range, grid_ms)
    if n_channels == 0:
        # the reference's mergeF0 still copies multi_channel_f0[0] wholesale
        # when no section survived extendSub (harvest.cpp:515)
        return multi[0].copy()
    return _merge_f0(multi, boundary, n_channels, len(f0_step2),
                     candidates, scores)


def fix_step4(f0_step3, threshold=9):
    """Fill short unvoiced gaps linearly (reference :590-614)."""
    out = np.asarray(f0_step3).copy()
    b = get_boundary_list(out)
    for i in range(len(b) // 2 - 1):
        distance = b[(i + 1) * 2] - b[i * 2 + 1] - 1
        if distance >= threshold:
            continue
        tmp0 = f0_step3[b[i * 2 + 1]] + 1
        tmp1 = f0_step3[b[(i + 1) * 2]] - 1
        coeff = (tmp1 - tmp0) / (distance + 1.0)
        count = 1
        for j in range(b[i * 2 + 1] + 1, b[(i + 1) * 2]):
            out[j] = tmp0 + coeff * count
            count += 1
    return out


_SMOOTH_B = (0.0078202080334971724, 0.015640416066994345)
_SMOOTH_A = (1.7347257688092754, -0.76600660094326412)


def _biquad_pass(sig):
    """One forward biquad pass writing its output time-reversed."""
    a, b = _SMOOTH_A, _SMOOTH_B
    w0 = w1 = 0.0
    out = np.empty_like(sig)
    n = len(sig)
    for i in range(n):
        wt = sig[i] + a[0] * w0 + a[1] * w1
        out[n - i - 1] = b[0] * wt + b[1] * w0 + b[0] * w1
        w1 = w0
        w0 = wt
    return out


def _filtering_f0(x, st, ed):
    """Zero-lag biquad with edge-hold (reference filteringF0 :639-665).

    The recurrence is inherently sequential; the port's C helper
    (``worldtpu_torch.native``) runs it with the same operation order, and
    this module's Python loop where the helper cannot be built."""
    x = x.copy()
    x[:st] = x[st]
    x[ed + 1:] = x[ed]
    out = native.filter_f0(x, _SMOOTH_B, _SMOOTH_A)
    if out is not None:
        return out
    return _biquad_pass(_biquad_pass(x))


def smooth_f0_contour(f0):
    """Per-section zero-lag Butterworth smoothing (reference :670-703)."""
    lag = 300
    f0 = np.asarray(f0)
    n = len(f0)
    padded = np.zeros(n + 2 * lag)
    padded[lag:lag + n] = f0
    b = get_boundary_list(padded)
    out = np.zeros(n)
    for i in range(len(b) // 2):
        st, ed = b[2 * i], b[2 * i + 1]
        ch = np.zeros_like(padded)
        ch[st:ed + 1] = padded[st:ed + 1]
        sm = _filtering_f0(ch, st, ed)
        lo = max(st, lag)
        hi = min(ed, lag + n - 1)
        out[lo - lag:hi - lag + 1] = sm[lo:hi + 1]
    return out


def fix_f0_contour(candidates, scores, grid_ms=1):
    """Full contour fixing chain (reference fixF0Contour :619-634).

    grid_ms > 1 scales the TIME-semantic constants (per-step change
    gates by grid_ms; frame-count windows by 1/grid_ms) so the chain
    behaves consistently on a coarser candidate grid."""
    k = grid_ms
    c1 = search_f0_base(candidates, scores)
    c2 = fix_step1(c1, 0.008 * k)
    c1 = fix_step2(c2, max(1, round(6 / k)))
    c2 = fix_step3(c1, candidates, scores, 0.18 * k, grid_ms=k)
    return fix_step4(c2, max(1, round(9 / k)))
