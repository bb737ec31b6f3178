"""The contour chain's kernels (ops/contour_kernel.py, csrc/contour.cu) and
the captured main path (parallel/graphs.py).

On the CPU: the plain versions through the static-slot plumbing against
worldtpu's device chain (tests/test_torch_contour.py holds the batches),
and the kernels' rules written out in numpy (``merge_rule``: the section
sums in any order where they are exact, else in frame order;
``smooth_rule``: the host filter's recursion with its orbit and cycle
jumps over the held edges, or each stretch in full; what csrc/contour.cu
computes) against the plain versions and the host filter; the graph
cache's key, eviction and the device constants a capture pins.  Marked
``cuda``: the kernels against their plain versions and the host filter on
the card (at F = 60,001, with the orbit search cut short), and graph
replay against the eager call.  Inputs are made with numpy from seeds.
JAX is imported inside the tests that use it, so that the ``cuda`` tests
run where JAX is not installed (``python -m pytest
tests/test_torch_contour_kernel.py -m cuda --noconftest``)."""

import numpy as np
import pytest
import torch

from worldtpu_torch import _build
from worldtpu_torch.analysis import contour as THC
from worldtpu_torch.analysis import contour_device as TCD
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.ops import contour_kernel as TCK
from worldtpu_torch.parallel import batch as TB
from worldtpu_torch.parallel import graphs as TG

torch.set_num_threads(1)


def _track_batch(F, S, rows, seed=0):
    """[B, F] contours and [B, F, S] candidate tables, one row per entry
    of ``rows``: (list of voiced runs (start, end), gap candidates) — the
    candidates follow one slowly moving F0 track with high scores inside
    the runs, and, with gap candidates, across the unvoiced frames too (so
    an extend walk runs over the next run)."""
    r = np.random.RandomState(seed)
    B = len(rows)
    f0 = np.zeros((B, F), np.float32)
    cand = np.zeros((B, F, S), np.float32)
    score = np.zeros((B, F, S), np.float32)
    t = np.arange(F)
    for b, (runs, gaps) in enumerate(rows):
        track = (140 + 30 * np.sin(2 * np.pi * t / 90 + b)).astype(np.float32)
        voiced = np.zeros(F, bool)
        for a, e in runs:
            voiced[a:e + 1] = True
        on = voiced | gaps
        cand[b, on, 0] = track[on]
        score[b, on, 0] = r.uniform(20, 60, on.sum())
        k = r.randint(1, S, F)
        for f in np.nonzero(on)[0]:
            cand[b, f, 1:k[f]] = track[f] * np.exp(0.3 * r.randn(k[f] - 1))
            score[b, f, 1:k[f]] = r.uniform(0.1, 30, k[f] - 1)
        f0[b, voiced] = track[voiced]
    return f0, cand, score


def _edge_rows(F):
    """Rows with 0 sections, 1 section, close to s_max = (F + 1) // 7 + 1
    sections (runs of 6 frames, gaps of 1, candidates across the gaps, so
    the walks overlap and most merges are contested), more runs than s_max
    (runs of 3 frames: only the first s_max have slots), and two runs close
    enough that each walk runs over the other's run."""
    s_max = (F + 1) // 7 + 1
    dense = [(a, a + 5) for a in range(1, F - 7, 7)]
    many = [(a, a + 2) for a in range(1, F - 4, 4)]
    assert len(dense) >= s_max - 3 and len(many) > s_max
    inner = (np.arange(F) > 0) & (np.arange(F) < F - 1)
    return [([], np.zeros(F, bool)),
            ([(20, 60)], np.zeros(F, bool)),
            (dense, inner),
            (many, np.zeros(F, bool)),
            ([(15, 40), (44, 70)], np.arange(F) < F - 5)]


def _merge_args(f0, cand, score, grid_ms=1):
    """The arguments fix_step3 hands contour_merge (captured)."""
    seen = []
    real = TCK.contour_merge

    def spy(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)
    TCK.contour_merge = spy
    try:
        out = TCD.fix_step3(torch.tensor(f0), torch.tensor(cand),
                            torch.tensor(score), 0.18 * grid_ms,
                            grid_ms=grid_ms)
    finally:
        TCK.contour_merge = real
    assert len(seen) == 1
    return seen[0][0], out


def _warp_sum(pieces):
    """Kernel A's warp sum of float32 values: lane l adds, in double, the
    elements l, l + 32, ... of each piece in turn, then the shuffle tree
    (lane 0's double)."""
    p = np.zeros(32)
    for v in pieces:
        for lane in range(32):
            for a in v[lane::32]:
                p[lane] += float(a)
    for o in (16, 8, 4, 2, 1):
        p[:o] = p[:o] + p[o:2 * o]
    return p[0]


def sum_is_exact(v, n):
    """Kernel A's condition for a section sum of n frames of float32 values
    v: every partial sum exact in double, so its order is free.  Each
    nonzero value is a multiple of 2^(emin - 150) and below
    2^(emax - 126) (biased exponents, subnormals as 1)."""
    ex = (np.asarray(v, np.float32).view(np.int32) >> 23) & 0xff
    ex = ex[np.asarray(v) != 0]
    if n <= 0 or ex.size == 0:
        return True
    emin, emax = max(int(ex.min()), 1), int(ex.max())
    d = emax - emin
    return emax < 255 and d <= 29 and n <= 2 ** (29 - d)


def merge_rule(f0, ss_run, ss_zero, st, ed, n_sec, vals, scs, n_on, so,
               c_len):
    """Kernel A (csrc/contour.cu, merge_kernel) on one utterance in numpy:
    (out, ssum, keep, s1, s2, ordered) as the kernel writes them."""
    F, S = f0.shape[0], st.shape[0]
    ssum = np.zeros(S, np.float32)
    keep = np.zeros(S, bool)
    ordered = np.zeros(S, bool)
    s1t = np.full(S, np.nan, np.float32)
    s2t = np.full(S, np.nan, np.float32)
    if n_sec <= 0:
        return f0.copy(), ssum, keep, s1t, s2t, ordered

    def channel(k):
        """Section k's value and score rows, frame by frame: the walks'
        accepted prefixes, its own run, else 0 (score: ss_zero)."""
        v, s = np.zeros(F, np.float32), ss_zero.copy()
        v[st[k]:ed[k] + 1] = f0[st[k]:ed[k] + 1]
        s[st[k]:ed[k] + 1] = ss_run[st[k]:ed[k] + 1]
        nf, nb = n_on[k], n_on[S + k]
        v[ed[k] + 1:ed[k] + 1 + nf] = vals[k, :nf]
        s[ed[k] + 1:ed[k] + 1 + nf] = scs[k, :nf]
        back = st[k] - 1 - np.arange(nb)
        v[back] = vals[S + k, :nb]
        s[back] = scs[S + k, :nb]
        return v, s

    nl = min(n_sec, S)
    for k in range(nl):
        v, _ = channel(k)
        st2, ed2 = so[S + k], so[k]
        run = np.arange(max(st[k], st2), min(ed[k], ed2 - 1) + 1)
        walk_b = st[k] - 1 - np.arange(n_on[S + k])
        walk_f = ed[k] + 1 + np.arange(n_on[k])
        pieces = [v[j[(j >= st2) & (j < ed2)]]
                  for j in (walk_b, run, walk_f)]
        if sum_is_exact(np.concatenate(pieces), ed2 - st2):
            ssum[k] = np.float32(_warp_sum(pieces))
        else:                                      # frame order, double
            acc = 0.0
            for j in range(st2, ed2):
                acc += float(v[j])
            ssum[k] = np.float32(acc)
            ordered[k] = True
    m = np.float32(0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(nl):
            ln = np.float32(so[k] - so[S + k])
            m = np.float32(m + ssum[k]) / ln
            keep[k] = np.float32(c_len) / m < ln
    kept = np.nonzero(keep)[0]
    if not kept.size:
        return channel(0)[0], ssum, keep, s1t, s2t, ordered
    # the stable start order as a rank
    order = [0] * kept.size
    for k in kept:
        order[sum(int(so[S + j] < so[S + k]
                      or (so[S + j] == so[S + k] and j < k))
                  for j in kept)] = k
    first = int(kept[0])
    merged, mss = channel(first)
    b0, b1 = so[S + first], so[first]
    for i in range(1, len(order)):
        k = order[i]
        v, s = channel(k)
        i1, i2 = so[S + k], so[k]
        fresh = i1 - b1 > 0
        covered = b0 <= i1 and b1 >= i2
        lo = i1
        if not fresh and not covered:
            s1 = np.float32(_warp_sum([mss[i1:b1 + 1]]))
            s2 = np.float32(_warp_sum([s[i1:b1 + 1]]))
            s1t[i], s2t[i] = s1, s2
            if s1 > s2:
                lo = b1
        if fresh or not covered:
            merged[lo:i2 + 1] = v[lo:i2 + 1]
            mss[lo:i2 + 1] = s[lo:i2 + 1]
        if fresh:
            b0 = i1
        if fresh or not covered:
            b1 = i2
    return merged, ssum, keep, s1t, s2t, ordered


_BLK = 16        # csrc/contour.cu kBlk


def _bq(x, w0, w1):
    """One biquad step in filter_f0.c's order: (w0', w1', output)."""
    a0, a1 = TCK._SMOOTH_A
    b0, b1 = TCK._SMOOTH_B
    wt = x + a0 * w0 + a1 * w1
    return wt, w0, b0 * wt + b1 * w0 + b0 * w1


def orbit(c, w0=0.0, w1=0.0, limit=TCK.SMOOTH_ORBIT_CAP):
    """Kernel B's orbit search on the constant input c from state (w0,
    w1): the state saved every _BLK steps, the next _BLK states matched
    against it bit for bit.  (steps run, period) at the first match
    within ``limit`` steps, else (steps run, 0)."""
    i = 0
    while i + _BLK <= limit:
        sv, hit = (w0, w1), 0
        for j in range(1, _BLK + 1):
            w0, w1, _ = _bq(c, w0, w1)
            if not hit and (w0, w1) == sv:
                hit = j
        i += _BLK
        if hit:
            return i, hit
    return i, 0


def smooth_rule(x, s, e, cap=TCK.SMOOTH_ORBIT_CAP, chunk=None):
    """Kernel B (csrc/contour.cu, smooth_kernel) on one section in numpy:
    the reference's filteringF0 of the edge-held padded contour x [n] in
    double, float32 at the run's frames [s, e], with the kernel's
    shortcuts: the prefix [0, s) and the tail (e, n) jump on the biquad's
    exact orbit, the backward pass over the periodic tail on its exact
    cycle; a stretch where none shows within ``cap`` steps runs in full
    (the tail from checkpoints every ``chunk`` steps).  Returns (out,
    trace): the steps run and the flags of TCK.SMOOTH_FLAGS."""
    n = len(x)
    x = np.asarray(x, np.float64)
    chunk = chunk or TCK.smooth_chunk(n)
    fl = TCK.SMOOTH_FLAGS
    tr = dict(steps=0, flags=0)
    # the prefix: the constant x[s]
    w0 = w1 = 0.0
    i = 0
    while i + _BLK <= s and i < cap:
        sv, hit = (w0, w1), 0
        for j in range(1, _BLK + 1):
            w0, w1, _ = _bq(x[s], w0, w1)
            if not hit and (w0, w1) == sv:
                hit = j
        i += _BLK
        tr["steps"] += _BLK
        if hit:
            w0, w1 = sv
            for _ in range((s - (i - _BLK)) % hit):
                w0, w1, _ = _bq(x[s], w0, w1)
                tr["steps"] += 1
            i = s
            tr["flags"] |= fl["prefix_orbit"]
    if i < s:
        tr["flags"] |= fl["prefix_full"]
    for _ in range(i, s):
        w0, w1, _ = _bq(x[s], w0, w1)
        tr["steps"] += 1
    # the section, its outputs kept
    ybuf = np.zeros(n)
    for i in range(s, e + 1):
        w0, w1, ybuf[i] = _bq(x[i], w0, w1)
    tr["steps"] += e - s + 1
    # the tail: the constant x[e], its outputs kept until the orbit shows
    tbuf = np.zeros(cap)
    i, i0 = e + 1, None
    while i + _BLK <= n and i - (e + 1) + _BLK <= cap:
        sv, hit = (w0, w1), 0
        for j in range(1, _BLK + 1):
            w0, w1, tbuf[i - (e + 1) + j - 1] = _bq(x[e], w0, w1)
            if not hit and (w0, w1) == sv:
                hit = j
        i += _BLK
        tr["steps"] += _BLK
        if hit:
            i0, lam = i - _BLK, hit
            tr["flags"] |= fl["tail_orbit"]
            break
    if i0 is None:                      # the rest in full, checkpointed
        i_f, ck = i, []
        for k in range(i_f, n):
            if (k - i_f) % chunk == 0:
                ck.append((w0, w1))
            w0, w1, _ = _bq(x[e], w0, w1)
        if i_f < n:
            tr["flags"] |= fl["tail_full"]
        tr["steps"] += n - i_f
    # backward from n - 1
    out = np.zeros(e - s + 1, np.float32)
    v0 = v1 = 0.0
    if i0 is not None:
        P = tbuf[i0 - (e + 1):]
        T, t, ph = n - i0, 0, (n - 1 - i0) % lam
        while t < cap and t + _BLK <= T:
            sv, hit = (v0, v1, ph), 0
            for j in range(1, _BLK + 1):
                v0, v1, _ = _bq(P[ph], v0, v1)
                ph = ph - 1 if ph else lam - 1
                if not hit and (v0, v1, ph) == sv:
                    hit = j
            t += _BLK
            tr["steps"] += _BLK
            if hit:
                v0, v1, ph = sv
                for _ in range((T - (t - _BLK)) % hit):
                    v0, v1, _ = _bq(P[ph], v0, v1)
                    ph = ph - 1 if ph else lam - 1
                    tr["steps"] += 1
                t = T
                tr["flags"] |= fl["back_cycle"]
        if t < T:
            tr["flags"] |= fl["back_full"]
        tr["steps"] += T - t
        for _ in range(t, T):
            v0, v1, _ = _bq(P[ph], v0, v1)
            ph = ph - 1 if ph else lam - 1
        top = i0
    else:                               # a chunk at a time, last first
        for c in range(len(ck) - 1, -1, -1):
            lo, hi = i_f + c * chunk, min(n, i_f + (c + 1) * chunk)
            w0, w1 = ck[c]
            buf = []
            for k in range(lo, hi):
                w0, w1, y = _bq(x[e], w0, w1)
                buf.append(y)
            for k in range(hi - 1, lo - 1, -1):
                v0, v1, _ = _bq(buf[k - lo], v0, v1)
            tr["steps"] += 2 * (hi - lo)
        top = i_f
    for k in range(top - 1, e, -1):
        v0, v1, _ = _bq(tbuf[k - (e + 1)], v0, v1)
        tr["steps"] += 1
    for k in range(e, s - 1, -1):
        v0, v1, out[k - s] = _bq(ybuf[k], v0, v1)
    tr["steps"] += e - s + 1
    return out, tr


def _np(args):
    return [a.numpy() if isinstance(a, torch.Tensor) else a for a in args]


# ---------------------------------------------------------------------------
# the static-slot plumbing against worldtpu's chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid_ms", [1, 2])
def test_fix_step3_edge_rows_match_jax(grid_ms):
    """fix_step3 over static slots on rows with 0, 1, close to s_max and
    more than s_max sections, and walks over the next run, at grid 1 and
    at grid 2's shorter sections: equal to worldtpu's fix_step3 (its
    extend walk in jnp), test_torch_contour.py's tolerance."""
    import jax.numpy as jnp
    from worldtpu.analysis import contour_device as CD
    F = 160
    f0, cand, score = _track_batch(F, 9, _edge_rows(F), seed=grid_ms)
    args, got = _merge_args(f0, cand, score, grid_ms)
    got = got.numpy()
    n_sec = args[5].numpy()
    assert n_sec[0] == 0 and n_sec[1] == 1
    assert n_sec[2] >= (F + 1) // 7 + 1 - 3 and n_sec[3] > (F + 1) // 7 + 1
    vals, n_on = args[6].numpy(), args[8].numpy()
    S = args[3].shape[1]
    # row 4: the first run's forward walk crosses the second run (44-70)
    assert 15 + 26 + n_on[4, 0] > 44 and n_on[4, S + 1] > 4
    for b in range(len(f0)):
        ref = np.asarray(CD.fix_step3(
            jnp.asarray(f0[b]), jnp.asarray(cand[b]), jnp.asarray(score[b]),
            0.18 * grid_ms, grid_ms=grid_ms, use_extend_kernel=False))
        np.testing.assert_allclose(got[b], ref, rtol=1e-6)
    np.testing.assert_array_equal(got[0], f0[0])
    assert vals.shape[1] == 2 * S


def test_smooth_edge_rows_match_jax():
    """smooth_f0_contour over (n + 1) // 2 static slots on rows with 0, 1
    and many sections (runs touching the contour's first and last frames)
    against worldtpu's: 1e-3 Hz, voicing identical."""
    import jax.numpy as jnp
    from worldtpu.analysis import contour_device as CD
    rng = np.random.RandomState(3)
    F = 400
    f0 = np.zeros((4, F), np.float32)
    f0[1, 100:300] = 120 + 4 * rng.randn(200)
    for a in range(0, F - 6, 9):
        f0[2, a:a + 6] = 200 + 5 * rng.randn(6)
    f0[3, :] = 90 + 2 * rng.randn(F)
    got = TCD.smooth_f0_contour(torch.tensor(f0)).numpy()
    for b in range(len(f0)):
        ref = np.asarray(CD.smooth_f0_contour(jnp.asarray(f0[b])))
        np.testing.assert_array_equal(got[b] > 0, ref > 0)
        np.testing.assert_allclose(got[b], ref, atol=1e-3)
    assert not got[0].any() and (got[2] > 0).sum() > 200


# ---------------------------------------------------------------------------
# the kernels' rules against the plain versions
# ---------------------------------------------------------------------------

def _contour_cases(jax_batch=True):
    """(f0, candidates, scores, grid_ms) batches: test_torch_contour.py's
    random slabs through fix_step2 (that module imports JAX), and the edge
    rows at grids 1 and 2."""
    if jax_batch:
        from test_torch_contour import _batch
        cand, score = _batch(900, 21, (0, 1, 2))
        f0 = TCD.fix_step2(TCD.fix_step1(TCD.search_f0_base(
            torch.tensor(cand), torch.tensor(score)), 0.008), 6).numpy()
        yield f0, cand, score, 1
    F = 160
    yield (*_track_batch(F, 9, _edge_rows(F)), 1)
    yield (*_track_batch(F, 9, _edge_rows(F), seed=2), 2)


def _channel_row(a, b, k):
    """Section k's channel of row b of contour_merge's numpy arguments."""
    f0, _, _, st, ed, _, vals, _, n_on, _ = (t[b] for t in a)
    S = st.shape[0]
    v = np.zeros(f0.shape[0], np.float32)
    v[st[k]:ed[k] + 1] = f0[st[k]:ed[k] + 1]
    nf, nb = n_on[k], n_on[S + k]
    v[ed[k] + 1:ed[k] + 1 + nf] = vals[k, :nf]
    v[st[k] - 1 - np.arange(nb)] = vals[S + k, :nb]
    return v


def test_ssum_rule_bitwise():
    """Kernel A's section sum: the channel summed over [st2, ed2) in frame
    order with a double accumulator, rounded once to float32, equals the
    plain version's cumulative-sum difference csum[ed2] - csum[st2] on the
    CPU bit for bit (torch.cumsum of float32 on the CPU accumulates in
    double, and the channel is 0 before st2).  A float32 accumulator does
    not give those bits."""
    n, f32_differs = 0, 0
    for f0, cand, score, grid in _contour_cases():
        args, _ = _merge_args(f0, cand, score, grid)
        _, tr = TCK.contour_merge_plain(*args, grid_ms=grid, trace=True)
        a = _np(args)
        S = a[3].shape[1]
        for b in range(len(f0)):
            for k in range(min(int(a[5][b]), S)):
                st2, ed2 = a[9][b, S + k], a[9][b, k]
                v = _channel_row(a, b, k)
                assert not v[:st2].any()
                acc, acc32 = 0.0, np.float32(0.0)
                for j in range(st2, ed2):
                    acc += float(v[j])
                    acc32 = np.float32(acc32 + v[j])
                want = tr["ssum"][b, k].numpy()
                assert np.float32(acc).tobytes() == want.tobytes()
                f32_differs += int(acc32 != want)
                n += 1
    assert n > 100 and f32_differs > 0


def test_merge_rule_matches_plain():
    """Kernel A's rule (merge_rule: channels read from the walks, the means
    scanned in order, the kept sections ordered stably by start, the merge
    from the first kept section) against contour_merge_plain: the output,
    section sums and keep mask bit for bit, the same merge steps contested,
    each decided the same way, with sums within 1e-6 of each other."""
    contested = 0
    for f0, cand, score, grid in _contour_cases():
        args, out = _merge_args(f0, cand, score, grid)
        _, tr = TCK.contour_merge_plain(*args, grid_ms=grid, trace=True)
        a = _np(args)
        for b in range(len(f0)):
            got, ssum, keep, s1, s2, ordered = merge_rule(
                *(t[b] for t in a), 2200.0 / grid)
            assert not ordered.any()
            np.testing.assert_array_equal(got, out[b].numpy())
            assert ssum.tobytes() == tr["ssum"][b].numpy().tobytes()
            np.testing.assert_array_equal(keep, tr["keep"][b].numpy())
            p1, p2 = tr["s1"][b].numpy(), tr["s2"][b].numpy()
            np.testing.assert_array_equal(np.isnan(s1), np.isnan(p1))
            hot = ~np.isnan(s1)
            np.testing.assert_array_equal((s1 > s2)[hot], (p1 > p2)[hot])
            np.testing.assert_allclose(s1[hot], p1[hot], rtol=1e-6)
            np.testing.assert_allclose(s2[hot], p2[hot], rtol=1e-6)
            contested += int(hot.sum())
    assert contested > 0


def _smooth_slots(f0):
    """smooth_f0_contour's arguments to contour_smooth (captured)."""
    seen = []
    real = TCK.contour_smooth

    def spy(*a):
        seen.append(a)
        return real(*a)
    TCK.contour_smooth = spy
    try:
        out = TCD.smooth_f0_contour(torch.tensor(f0))
    finally:
        TCK.contour_smooth = real
    return seen[0], out


def test_merge_sums_order_free_or_in_frame_order():
    """Kernel A's section sums (merge_rule) against the plain version's:
    where the exactness condition holds (every section of these inputs),
    the warp's order, frame order and reversed frame order give the same
    double and the plain version's float32 bits; a section with one value
    far below the others (2^-100 against F0 values) breaks it, is summed in
    frame order (``ordered``) and still gives the plain version's bits."""
    n_exact = 0
    for f0, cand, score, grid in _contour_cases(jax_batch=False):
        args, _ = _merge_args(f0, cand, score, grid)
        a = _np(args)
        S = a[3].shape[1]
        b = 2                                   # the dense row
        k = 3
        st, ed = a[3][b, k], a[4][b, k]
        assert a[5][b] > k and ed > st
        for tiny in (False, True):
            if tiny:
                args[0][b, st + 1] = 2.0 ** -100
                a = _np(args)
            _, tr = TCK.contour_merge_plain(*args, grid_ms=grid, trace=True)
            _, ssum, _, _, _, ordered = merge_rule(*(t[b] for t in a),
                                                   2200.0 / grid)
            assert ssum.tobytes() == tr["ssum"][b].numpy().tobytes()
            assert list(np.nonzero(ordered)[0]) == ([k] if tiny else [])
            for j in range(min(int(a[5][b]), S)):
                st2, ed2 = a[9][b, S + j], a[9][b, j]
                v = _channel_row(a, b, j)[st2:ed2]
                if sum_is_exact(v, ed2 - st2):
                    fwd = rev = 0.0
                    for x in v:
                        fwd += float(x)
                    for x in v[::-1]:
                        rev += float(x)
                    assert fwd == rev == _warp_sum([v])
                    n_exact += 1
                else:
                    assert tiny and j == k
    assert n_exact > 40


_SMOOTH_CASES = {
    # a run from the contour's second frame: s = LAG + 1
    "from_lag_plus_1": ([(1, 200), (260, 330)], None),
    # a run to the contour's last frame: its tail is LAG frames, too short
    # for the backward pass to find its cycle
    "to_last_frame": ([(40, 90), (300, 500)], None),
    # runs a few frames apart
    "few_frames_apart": ([(50, 80), (83, 120), (122, 125), (128, 200)],
                         None),
    # no shortcut: every stretch in full
    "cap_0": ([(0, 90), (200, 350), (420, 470)], 0),
}


@pytest.mark.parametrize("case", sorted(_SMOOTH_CASES))
def test_smooth_rule_equals_host_filter(case):
    """Kernel B's rule (smooth_rule: orbit and cycle jumps on the held
    edges, else the stretch in full) gives the bits of the host contour's
    float64 filteringF0 (analysis/contour.py, the reference's operation
    order) rounded once to float32, and is within 1e-3 Hz of the
    blocked-matmul plain version (test_torch_contour.py's tolerance), on
    each case's sections; the trace shows the case's branch."""
    runs, cap = _SMOOTH_CASES[case]
    cap = TCK.SMOOTH_ORBIT_CAP if cap is None else cap
    rng = np.random.RandomState(5)
    F = 500
    f0 = np.zeros((1, F), np.float32)
    for a, e in runs:
        f0[0, a:e] = 100 + 40 * rng.rand() + 4 * rng.randn(e - a)
    (f, st, ed, n_sec), plain = _smooth_slots(f0)
    st, ed, n_sec = st.numpy(), ed.numpy(), n_sec.numpy()
    lag = TCK.LAG
    n = F + 2 * lag
    assert n_sec[0] == len(runs) and st.shape[1] == (n + 1) // 2
    fl = TCK.SMOOTH_FLAGS
    padded = np.zeros(n)
    padded[lag:lag + F] = f0[0]
    flags = []
    for k in range(n_sec[0]):
        s, e = st[0, k], ed[0, k]
        got, tr = smooth_rule(padded, s, e, cap=cap)
        host = THC._filtering_f0(padded.copy(), s, e)[s:e + 1]
        assert got.tobytes() == host.astype(np.float32).tobytes()
        np.testing.assert_allclose(
            got, plain[0, s - lag:e - lag + 1].numpy(), atol=1e-3)
        assert tr["steps"] < (n + 2 * (n - s) if cap else 4 * n)
        flags.append(tr["flags"])
    if case == "from_lag_plus_1":
        assert st[0, 0] == lag + 1 and flags[0] & fl["prefix_orbit"]
    elif case == "to_last_frame":
        assert ed[0, 1] == n - lag - 1
        assert flags[1] & (fl["back_full"] | fl["tail_full"])
        assert flags[0] & fl["back_cycle"]
    elif case == "few_frames_apart":
        assert all(f & fl["tail_orbit"] and f & fl["back_cycle"]
                   for f in flags)
    else:
        shortcuts = fl["prefix_orbit"] | fl["tail_orbit"] | fl["back_cycle"]
        assert all(not f & shortcuts and f & fl["tail_full"]
                   for f in flags)


def test_orbits_within_cap():
    """What kernel B's shortcut rests on: from zero state, the biquad on a
    float32 constant in [40, 800] Hz (f0_floor to f0_ceil) reaches an
    exact periodic orbit of period <= 16 that the kernel's search finds
    within SMOOTH_ORBIT_CAP steps; also from the state a voiced run leaves
    behind, on the run's last value (the tail)."""
    rng = np.random.RandomState(11)
    cs = rng.uniform(40, 800, 400).astype(np.float32)
    periods = set()
    for c in cs:
        steps, p = orbit(float(c))
        assert 1 <= p <= _BLK and steps <= TCK.SMOOTH_ORBIT_CAP
        periods.add(p)
    assert {1, 4, 8} <= periods
    for _ in range(40):
        run = (rng.uniform(60, 400)
               + rng.randn(rng.randint(3, 300))).astype(np.float32)
        w0 = w1 = 0.0
        for v in run:
            w0, w1, _ = _bq(float(v), w0, w1)
        steps, p = orbit(float(run[-1]), w0, w1)
        assert 1 <= p <= _BLK and steps <= TCK.SMOOTH_ORBIT_CAP


def test_smooth_chunk_bounds():
    """Kernel B's checkpoint spacing keeps its checkpoints and a chunk (2
    doubles a checkpoint, a chunk of doubles) within 48 KB up to 2048
    checkpoints of 2048 frames, the corpus shapes at a spacing of 128;
    past that the spacing is ceil(sqrt(2 n)) and the whole shared memory
    (the orbit buffer too) stays within SMOOTH_SMEM_MAX; a contour past
    that raises."""
    for n in (600, 5_059, 24_931, 60_601, 262_144, 1_000_000, 4_194_304):
        c = TCK.smooth_chunk(n)
        assert c >= TCK.SMOOTH_CHUNK
        assert 8 * (2 * -(-n // c) + c) <= 48 * 1024
    assert TCK.smooth_chunk(5_059) == TCK.SMOOTH_CHUNK
    assert TCK.smooth_chunk(4_194_304) == TCK.SMOOTH_MAX_CHUNK
    for n in (4_194_305, 4_500_600, 20_000_600, 98_224_128):
        c = TCK.smooth_chunk(n)
        assert (c - 1) ** 2 < 2 * n <= c * c
        assert 8 * (TCK.SMOOTH_ORBIT_CAP + 2 * -(-n // c) + c) \
            <= TCK.SMOOTH_SMEM_MAX
    with pytest.raises(ValueError, match="longest"):
        TCK.smooth_chunk(98_224_129)


def test_plain_versions_on_cpu_tensors_count_no_launch():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = dict(_build.launches)
    f0, cand, score = _track_batch(160, 9, _edge_rows(160))
    TCD.fix_and_smooth(torch.tensor(cand), torch.tensor(score), 33, 5.0)
    assert dict(_build.launches) == before


# ---------------------------------------------------------------------------
# the graph cache
# ---------------------------------------------------------------------------

def test_graph_key_excludes_pitch_scale():
    """The key holds the function, the tensors' shapes, dtypes and devices
    and the static arguments (a geometry by identity, as jax.jit keys the
    JAX package's: an equal new geometry is a new key, and the key keeps
    the object); the pitch is an input of ``call``, not of the key (one
    program serves every pitch: test_graph_cache_evicts_least_recently_used)."""
    x = torch.zeros(2, 4000)
    n = torch.zeros(2, 8, 16)
    geo = TH.HarvestGeometry(16000, 4000)
    k1 = TG.make_key(TB._wav_to_wav, (x, n), dict(geo=geo, fs=16000))
    k2 = TG.make_key(TB._wav_to_wav, (x + 1, n), dict(fs=16000, geo=geo))
    assert k1 == k2 and hash(k1) == hash(k2)
    assert dict(k1[2])["geo"] is geo
    assert TG.make_key(TB._wav_to_wav, (x, n),
                       dict(fs=16000, geo=TH.HarvestGeometry(16000, 4000))) \
        != k1
    assert TG.make_key(TB._wav_to_wav, (x[:1], n), dict(geo=geo)) != \
        TG.make_key(TB._wav_to_wav, (x, n), dict(geo=geo))
    assert TG.make_key(TB._wav_to_wav, (x, n), dict(geo=geo.with_grid(2))) \
        != TG.make_key(TB._wav_to_wav, (x, n), dict(geo=geo))


def test_device_cache_pins_what_a_capture_reads():
    """A ``device_cache`` function hands each value to the enclosing
    ``pinning`` block as well: a program keeps it after the cache has
    dropped the entry.  Outside a block nothing is kept."""
    from worldtpu_torch.ops import numeric as TN
    made = []

    @TN.device_cache(maxsize=1)
    def const(n, device):
        made.append(torch.arange(n, dtype=torch.float32, device=device))
        return made[-1]

    cpu = torch.device("cpu")
    const(3, cpu)
    assert TN._pins is None
    with TN.pinning() as pins:
        a = const(3, cpu)                       # a hit
        with TN.pinning() as inner:
            b = const(4, cpu)                   # a miss; evicts n=3
        assert inner == [b]
    assert TN._pins is None
    assert pins == [a] and pins[0] is made[0] and len(made) == 2
    assert const(3, cpu) is not a               # the cache made it anew
    assert pins[0] is a and torch.equal(a, torch.arange(3.0))


def test_main_path_constants_are_pinned():
    """Every device constant the main path reads comes from a
    ``device_cache`` function: run under ``pinning`` (as capture runs it),
    the band bounds, the filter banks and the decimation's tables are all
    among the pinned values."""
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.ops import numeric as TN
    from worldtpu_torch.ops import zc_kernel as TZ
    fs = 16000
    x = torch.tensor(0.5 * np.sin(np.arange(4800) * 0.1)[None],
                     dtype=torch.float32)
    geo = TH.HarvestGeometry(fs, 4800, f0_floor=71.0)
    ck = CheapTrickKernel(fs)
    with TN.pinning() as pins:
        TB._analyze(x, TG.scale_buffer(1.0, x), geo=geo, fs=fs,
                    fft_size=ck.fft_size, max_half_window=ck.max_half_window,
                    grid_ms=1)
    ids = {id(v) for v in pins}
    cpu = torch.device("cpu")
    assert id(TZ._bounds(geo, cpu)) in ids
    assert id(TH._filter_banks(geo, cpu, None)) in ids
    assert any(isinstance(v, tuple) and len(v) == 4
               and all(isinstance(t, torch.Tensor) for t in v)
               for v in pins)          # the decimation's IIR tables


def test_graph_cache_evicts_least_recently_used(monkeypatch):
    """At most MAX_PROGRAMS programs: the first call of a key runs eagerly,
    the second captures, a later call replays; the least recently used
    program goes first.  (Capture and replay stubbed: the cache's
    bookkeeping, on the CPU.)"""
    TG.clear()
    events = []

    class Prog:
        def __init__(self, key):
            self.key = key

        def replay(self, tensors, scale):
            events.append(("replay", self.key, scale))
            return ("replayed",)

    def fn(x, scale, *, tag):
        events.append(("eager", tag, float(scale)))
        return ("eager",)

    monkeypatch.setattr(TG, "capturable", lambda tensors, dtypes: True)
    monkeypatch.setattr(TG, "_capture", lambda fn, tensors, scale, static,
                        pool: Prog(static["tag"]))
    x = torch.zeros(3)
    try:
        assert TG.call(fn, (x,), 1.0, tag=0) == ("eager",)
        assert TG.call(fn, (x,), 1.5, tag=0) == ("replayed",)
        assert TG.call(fn, (x,), 2.0, tag=0) == ("replayed",)
        assert events[-1] == ("replay", 0, 2.0)
        for tag in range(1, TG.MAX_PROGRAMS + 1):
            TG.call(fn, (x,), 1.0, tag=tag)
            TG.call(fn, (x,), 1.0, tag=tag)
        keys = TG.programs()
        assert len(keys) == TG.MAX_PROGRAMS
        assert [k[2][0][1] for k in keys] == list(
            range(1, TG.MAX_PROGRAMS + 1))
        TG.call(fn, (x,), 1.0, tag=2)          # now the most recent
        assert [k[2][0][1] for k in TG.programs()][-1] == 2
    finally:
        TG.clear()
    assert TG.programs() == []


def test_cpu_tensors_never_reach_the_graph_cache(monkeypatch):
    """batch_wav_to_wav and batch_analyze, HarvestKernel.forward and
    LongPipeline's sequential and parallel loops (their chunk and prescan
    steps, float32 and float64) on CPU tensors run eagerly every time:
    nothing is recorded in the global cache nor in the loops' own caches
    (each checked as the loop drops it)."""
    from worldtpu_torch import longaudio as TLA
    dropped = []
    real_clear = TG.Programs.clear

    def clear(self):
        dropped.append((self.keys(), list(self._warm)))
        real_clear(self)
    monkeypatch.setattr(TG.Programs, "clear", clear)
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    TG.clear()
    fs = 16000
    x = torch.tensor(0.5 * np.sin(np.arange(4800) * 0.1)[None],
                     dtype=torch.float32)
    geo = TH.HarvestGeometry(fs, 4800, f0_floor=71.0)
    ck = CheapTrickKernel(fs)
    hk = TH.HarvestKernel(fs, 4800, f0_floor=71.0, device="cpu")
    for _ in range(3):
        TB.batch_analyze(x, geo=geo, fs=fs, fft_size=ck.fft_size,
                         max_half_window=ck.max_half_window, pitch_scale=1.1)
        hk(x)
    lp = TLA.LongPipeline(fs, f0_floor=71.0, chunk_frames=20, device="cpu")
    f0 = np.full(61, 140.0)
    lp.harvest.compute = lambda x_, dtype=None: (f0, None)
    for dt in (torch.float32, torch.float64):
        for parallel in (False, True):
            y, _ = lp.copy_synthesis(x[0].to(dt), dtype=dt,
                                     parallel=parallel)
            assert np.isfinite(y).all()
    assert dropped[-4:] == [([], [])] * 4
    assert TG.programs() == [] and len(TG._warm) == 0
    assert not TG.capturable((x,))
    assert not TG.capturable((x.double(),))
    assert not TG.capturable((x.double(),), TLA._DTYPES)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _to(args, dev):
    return [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]


def _long_merge_case():
    """One batch longer than MERGE_SHARED_MAX_F frames (kernel A's
    global-memory rows): long runs, walks across the gaps between them."""
    F = TCK.MERGE_SHARED_MAX_F + 160
    runs = [(20, 60), (100, 9000), (9006, 20000), (20004, F - 12)]
    inner = (np.arange(F) > 0) & (np.arange(F) < F - 1)
    return (*_track_batch(F, 5, [(runs, inner), (runs[1:3], inner)]), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "global"])
def test_merge_kernel_matches_plain(dev, layout):
    """Kernel A in both row layouts (picked by F) against the plain version
    on the same inputs: the section sums equal the CPU plain version's bit
    for bit, the keep mask and output equal the card's plain version (these
    inputs have no knife-edge decision), one launch a call."""
    cases = (_contour_cases(jax_batch=False) if layout == "shared"
             else [_long_merge_case()])
    for f0, cand, score, grid in cases:
        assert (f0.shape[1] <= TCK.MERGE_SHARED_MAX_F) == (layout == "shared")
        args, out_cpu = _merge_args(f0, cand, score, grid)
        _, tr_cpu = TCK.contour_merge_plain(*args, grid_ms=grid, trace=True)
        g = _to(args, dev)
        n0 = _build.launches["wt_contour_merge"]
        out, tr = TCK.contour_merge_cuda(*g, grid_ms=grid, trace=True)
        assert _build.launches["wt_contour_merge"] == n0 + 1
        assert torch.equal(tr["ssum"].cpu(), tr_cpu["ssum"])
        assert torch.equal(tr["keep"].cpu(), tr_cpu["keep"])
        assert torch.equal(out.cpu(), out_cpu)
        assert torch.equal(out, TCK.contour_merge_plain(*g, grid_ms=grid))


@pytest.mark.cuda
def test_smooth_kernel_matches_plain(dev):
    """Kernel B against the blocked-matmul plain version within 1e-3 Hz,
    voicing identical, and bit for bit against the host float64 filter
    rounded once."""
    rng = np.random.RandomState(5)
    F = 3000
    f0 = np.zeros((3, F), np.float32)
    f0[0, 0:900] = 150 + 6 * rng.randn(900)
    f0[0, 1200:2999] = 110 + 3 * rng.randn(1799)
    f0[2, 5:F] = 220 + 5 * rng.randn(F - 5)
    (f, st, ed, n_sec), _ = _smooth_slots(f0)
    g = _to((f, st, ed, n_sec), dev)
    n0 = _build.launches["wt_contour_smooth"]
    k = TCK.contour_smooth_cuda(*g)
    assert _build.launches["wt_contour_smooth"] == n0 + 1
    p = TCK.contour_smooth_plain(*g)
    assert torch.equal(k > 0, p > 0)
    assert float((k - p).abs().max()) < 1e-3
    lag = TCK.LAG
    st, ed = st.numpy(), ed.numpy()
    for b in range(3):
        padded = np.zeros(F + 2 * lag)
        padded[lag:lag + F] = f0[b]
        for i in range(int(n_sec[b])):
            s, e = st[b, i], ed[b, i]
            host = THC._filtering_f0(padded.copy(), s, e)[s:e + 1]
            assert k[b, s - lag:e - lag + 1].cpu().numpy().tobytes() == \
                host.astype(np.float32).tobytes()


def _host_sections(f0, st, ed, n_sec, b):
    """Row b's live sections: (s, e, the host float64 filter's float32
    output on [s, e], the padded contour)."""
    lag = TCK.LAG
    padded = np.zeros(f0.shape[1] + 2 * lag)
    padded[lag:lag + f0.shape[1]] = f0[b]
    for i in range(int(n_sec[b])):
        s, e = int(st[b, i]), int(ed[b, i])
        host = THC._filtering_f0(padded.copy(), s, e)[s:e + 1]
        yield s, e, host.astype(np.float32), padded


@pytest.mark.cuda
def test_smooth_kernel_long_contour(dev):
    """Kernel B at F = 60,001 (phase 9's 60 s signal's length), with runs
    from the contour's first frame and to its last, long and short ones:
    bit-equal to the host float64 filter on every section, each section's
    trace (steps run, flags, tail period, orbit start) equal to
    smooth_rule's, one launch a call."""
    rng = np.random.RandomState(7)
    F = 60_001
    f0 = np.zeros((2, F), np.float32)
    for a, e in ((0, 24_000), (26_000, 26_030), (26_040, 26_300),
                 (30_000, F)):
        f0[0, a:e] = 150 + 20 * np.sin(np.arange(e - a) / 300) \
            + 2 * rng.randn(e - a)
    f0[1, 5:F - 3] = 210 + 3 * rng.randn(F - 8)
    (f, st, ed, n_sec), _ = _smooth_slots(f0)
    g = _to((f, st, ed, n_sec), dev)
    n0 = _build.launches["wt_contour_smooth"]
    k, tr = TCK.contour_smooth_cuda(*g, trace=True)
    assert _build.launches["wt_contour_smooth"] == n0 + 1
    k, tr = k.cpu().numpy(), tr.cpu().numpy()
    lag = TCK.LAG
    assert st[0, 0] == lag and ed[0, 3] == F + lag - 1
    for b in range(2):
        for i, (s, e, host, padded) in enumerate(
                _host_sections(f0, st, ed, n_sec, b)):
            assert k[b, s - lag:e - lag + 1].tobytes() == host.tobytes()
            _, want = smooth_rule(padded, s, e)
            assert (tr[b, i, 0], tr[b, i, 1]) == (want["steps"],
                                                  want["flags"])


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [0, 32])
def test_smooth_kernel_full_run(dev, cap, monkeypatch):
    """Kernel B with its orbit search cut to ``cap`` steps (0: none; 32:
    too few for any orbit): every held stretch runs in full, the tails from
    checkpoints, and the output keeps the host float64 filter's bits on
    every section; the trace flags show the full runs."""
    rng = np.random.RandomState(8)
    F = 3000
    f0 = np.zeros((2, F), np.float32)
    f0[0, 0:900] = 150 + 6 * rng.randn(900)
    f0[0, 1200:2999] = 110 + 3 * rng.randn(1799)
    f0[1, 5:F] = 220 + 5 * rng.randn(F - 5)
    (f, st, ed, n_sec), _ = _smooth_slots(f0)
    g = _to((f, st, ed, n_sec), dev)
    monkeypatch.setattr(TCK, "SMOOTH_ORBIT_CAP", cap)
    n0 = _build.launches["wt_contour_smooth"]
    k, tr = TCK.contour_smooth_cuda(*g, trace=True)
    assert _build.launches["wt_contour_smooth"] == n0 + 1
    k, tr = k.cpu().numpy(), tr.cpu().numpy()
    fl = TCK.SMOOTH_FLAGS
    lag = TCK.LAG
    for b in range(2):
        for i, (s, e, host, _) in enumerate(
                _host_sections(f0, st, ed, n_sec, b)):
            assert k[b, s - lag:e - lag + 1].tobytes() == host.tobytes()
            assert tr[b, i, 1] & fl["tail_full"]
            assert not tr[b, i, 1] & (fl["prefix_orbit"] | fl["tail_orbit"]
                                      | fl["back_cycle"])


@pytest.mark.cuda
@pytest.mark.parametrize("F, cap", [(4_500_000, TCK.SMOOTH_ORBIT_CAP),
                                    (4_500_000, 0), (20_000_000, 0)])
def test_smooth_kernel_past_2048_checkpoints(dev, F, cap, monkeypatch):
    """Kernel B on contours past 2048 checkpoints of 2048 frames (75 min
    and 5.6 h of 1 ms frames), where the spacing is ceil(sqrt(2 n)):
    with its orbit search and without it (cap 0: every tail runs in full
    from its checkpoints, the spacing's one use), runs from the first
    frame, in the middle and to the last: bit-equal to the host float64
    filter on every section, one launch."""
    rng = np.random.RandomState(9)
    f0 = np.zeros((1, F), np.float32)
    runs = ((0, 3_000), (F // 2, F // 2 + 900), (F // 2 + 1_000,
            F // 2 + 1_040), (F - 9_000, F - 6_000), (F - 2_000, F))
    for a, e in runs:
        f0[0, a:e] = 150 + 20 * np.sin(np.arange(e - a) / 300) \
            + 2 * rng.randn(e - a)
    seen = []
    monkeypatch.setattr(TCK, "contour_smooth",
                        lambda *a: seen.append(a) or a[0])
    TCD.smooth_f0_contour(torch.from_numpy(f0).to(dev))
    f, st, ed, n_sec = seen[0]
    assert TCK.smooth_chunk(F + 2 * TCK.LAG) > TCK.SMOOTH_MAX_CHUNK
    monkeypatch.setattr(TCK, "SMOOTH_ORBIT_CAP", cap)
    n0 = _build.launches["wt_contour_smooth"]
    k, tr = TCK.contour_smooth_cuda(f, st, ed, n_sec, trace=True)
    assert _build.launches["wt_contour_smooth"] == n0 + 1
    k, tr = k.cpu().numpy(), tr.cpu().numpy()
    st, ed, n_sec = st.cpu().numpy(), ed.cpu().numpy(), n_sec.cpu()
    assert int(n_sec[0]) == len(runs)
    lag = TCK.LAG
    for i, (s, e, host, _) in enumerate(
            _host_sections(f0, st, ed, n_sec, 0)):
        assert k[0, s - lag:e - lag + 1].tobytes() == host.tobytes(), i
        if cap == 0:
            assert tr[0, i, 1] & TCK.SMOOTH_FLAGS["tail_full"]


@pytest.mark.cuda
def test_merge_kernel_frame_order_section(dev):
    """Kernel A at F = 60,001 (global rows) with one run holding a value
    far below the others (2^-100), so that section's sum is not exact in
    every order: the kernel sums it in frame order (``ordered``) and the
    others in parallel; section sums bit-equal to the CPU plain version,
    keep mask and output equal, one launch a call."""
    F = 60_001
    runs = [(20, 60), (100, 25_000), (25_006, 40_000), (40_004, F - 12)]
    inner = (np.arange(F) > 0) & (np.arange(F) < F - 1)
    f0, cand, score = _track_batch(F, 5, [(runs, inner)])
    args, _ = _merge_args(f0, cand, score, 1)
    args[0][0, 30_000] = 2.0 ** -100
    out_cpu, tr_cpu = TCK.contour_merge_plain(*args, trace=True)
    g = _to(args, dev)
    n0 = _build.launches["wt_contour_merge"]
    out, tr = TCK.contour_merge_cuda(*g, trace=True)
    assert _build.launches["wt_contour_merge"] == n0 + 1
    assert torch.equal(tr["ssum"].cpu(), tr_cpu["ssum"])
    assert torch.equal(tr["keep"].cpu(), tr_cpu["keep"])
    assert torch.equal(out.cpu(), out_cpu)
    assert tr["ordered"].cpu().nonzero().tolist() == [[0, 2]]


def _main_path_batch(dev):
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.synthesis import synthesis as TS
    fs = 22050
    rng = np.random.RandomState(0)
    T = 16384
    t = np.arange(T) / fs
    x = np.stack([0.5 * np.sin(2 * np.pi * np.cumsum(
        (120 + 30 * i) * 2 ** (0.2 * np.sin(2 * np.pi * 3 * t))) / fs)
        + 0.003 * rng.randn(T) for i in range(2)]).astype(np.float32)
    x[:, 6000:7000] = 0.0
    geo = TH.HarvestGeometry(fs, T, f0_floor=40.0)
    ck = CheapTrickKernel(fs)
    out_len = int((geo.n_grid() - 1) * 0.00625 * fs) + 1
    mp = TS.capacity_max_pulses(out_len, fs, f0_cap=600.0)
    noise = torch.tensor(rng.randn(2, mp, ck.fft_size).astype(np.float32),
                         device=dev)
    kw = dict(geo=geo, fs=fs, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window, frame_period_s=0.00625,
              out_length=out_len, max_pulses=mp, return_overflow=True)
    return torch.tensor(x, device=dev), noise, kw


@pytest.mark.cuda
def test_graph_replay_equals_eager(dev):
    """batch_wav_to_wav: the first call eager, the second captured and
    replayed, later ones replayed: F0 and y bit-equal to the eager program
    at two pitches (one program serves both), each kernel of the path
    counted once a replay, 0 host syncs eagerly and on replay, and a
    returned y untouched by the next replay; batch_analyze the same."""
    TG.clear()
    x, noise, kw = _main_path_batch(dev)
    try:
        f0s = torch.rand(1000, device=dev) * 400
        assert torch.equal(f0s * 1.2, f0s * TG.scale_buffer(1.2, f0s))
        def eager_call(p):              # the eager program, outside the cache
            with torch.no_grad():
                return TB._wav_to_wav(x, noise, TG.scale_buffer(p, x),
                                      grid_ms=1, **kw)

        eager_call(1.2)          # a geometry's first call fills its caches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")   # no sync eagerly either
        try:
            eager = {p: eager_call(p) for p in (1.2, 0.9)}
        finally:
            torch.cuda.set_sync_debug_mode("default")
        first = TB.batch_wav_to_wav(x, noise, pitch_scale=1.2, **kw)
        assert TG.programs() == [] and len(TG._warm) == 1
        second = TB.batch_wav_to_wav(x, noise, pitch_scale=0.9, **kw)
        assert len(TG.programs()) == 1 and len(TG._warm) == 0
        _build.launches.clear()
        third = TB.batch_wav_to_wav(x, noise, pitch_scale=1.2, **kw)
        counts = dict(_build.launches)
        for k in ("wt_zc", "wt_refine_sums", "wt_ola", "wt_extend",
                  "wt_contour_merge", "wt_contour_smooth"):
            assert counts.get(k) == 1, (k, counts)
        for got, p in ((first, 1.2), (second, 0.9), (third, 1.2)):
            for u, v in zip(got, eager[p]):
                assert torch.equal(u, v)
        first = third
        keep = first[0].clone()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = TB.batch_wav_to_wav(x * 0.5, noise, pitch_scale=1.2,
                                        **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert torch.equal(first[0], keep)
        assert not torch.equal(again[0], keep)
        a_eager = TB.batch_analyze(x, pitch_scale=1.2, **{
            k: kw[k] for k in ("geo", "fs", "fft_size", "max_half_window")})
        for _ in range(2):
            a = TB.batch_analyze(x, pitch_scale=1.2, **{
                k: kw[k] for k in ("geo", "fs", "fft_size",
                                   "max_half_window")})
        for u, v in zip(a, a_eager):
            assert torch.equal(u, v)
        assert len(TG.programs()) == 2
    finally:
        TG.clear()


@pytest.mark.cuda
def test_graph_equal_geometry_and_evicted_constants(dev):
    """A second HarvestGeometry equal to the first is a new key: its first
    call runs eagerly, its second captures (no cache miss inside the
    capture).  Then more geometries than any device constant cache holds
    run eagerly, and a replay of each program still gives the eager bits
    (each program keeps the constants it reads)."""
    TG.clear()
    x, noise, kw = _main_path_batch(dev)
    try:
        with torch.no_grad():
            want = TB._wav_to_wav(x, noise, TG.scale_buffer(1.1, x),
                                  grid_ms=1, **kw)
        geo = kw["geo"]
        kw2 = dict(kw, geo=TH.HarvestGeometry(geo.fs, geo.x_length,
                                              f0_floor=geo.f0_floor))
        for k in (kw, kw, kw2, kw2, kw2):
            got = TB.batch_wav_to_wav(x, noise, pitch_scale=1.1, **k)
            assert all(torch.equal(u, v) for u, v in zip(got, want))
        assert len(TG.programs()) == 2
        for i in range(36):
            n = 6144 + 256 * i
            TB.batch_analyze(x[:1, :n].contiguous(),
                             geo=TH.HarvestGeometry(geo.fs, n,
                                                    f0_floor=40.0),
                             fs=geo.fs, fft_size=kw["fft_size"],
                             max_half_window=kw["max_half_window"])
        torch.cuda.synchronize()
        for k in (kw, kw2):
            got = TB.batch_wav_to_wav(x, noise, pitch_scale=1.1, **k)
            assert all(torch.equal(u, v) for u, v in zip(got, want))
    finally:
        TG.clear()
