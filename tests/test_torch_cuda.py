"""Kernel-vs-plain tests on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA inputs, and the main path's launches.

Marked ``cuda``; without a CUDA device every test skips.  Run them on a
GPU machine with ``python -m pytest tests/test_torch_cuda.py -q``."""

import warnings

import numpy as np
import pytest
import torch

from worldtpu_torch import _build, api
from worldtpu_torch import longaudio as TLA
from worldtpu_torch.analysis import cheaptrick as TCT
from worldtpu_torch.analysis import contour_device as TCD
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
from worldtpu_torch.ops import extend_kernel as TE
from worldtpu_torch.ops import ola_kernel as TO
from worldtpu_torch.ops import refine_kernel as TR
from worldtpu_torch.ops import seqsum as TQ
from worldtpu_torch.ops import zc_kernel as TZ
from worldtpu_torch.parallel import batch as TB
from worldtpu_torch.parallel import graphs as TG
from worldtpu_torch.synthesis import noise as TN
from worldtpu_torch.synthesis import synthesis as TS

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _vowels(fs, n, dur=0.8):
    rng = np.random.RandomState(0)
    T = int(fs * dur)
    t = np.arange(T) / fs
    out = []
    for i in range(n):
        f0t = (110 + 40 * i) * 2 ** (0.2 * np.sin(2 * np.pi * 3 * t))
        ph = 2 * np.pi * np.cumsum(f0t) / fs
        x = 0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph)
        x[int(0.3 * T):int(0.4 * T)] = 0.0
        out.append(x + 0.003 * rng.randn(T))
    return np.stack(out).astype(np.float32)


@pytest.fixture
def stage_inputs(dev):
    fs = 22050
    x = torch.tensor(_vowels(fs, 2), device=dev)
    geo = TH.HarvestGeometry(fs, x.shape[1], f0_floor=40.0)
    y = TH.decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    return x, geo, y


def test_zc_kernel_matches_plain(stage_inputs):
    _, geo, y = stage_inputs
    filt = TH.band_filter(y, geo)
    bounds = torch.as_tensor(geo.boundary_f0, dtype=torch.float32,
                             device=y.device)
    args = TZ.geometry_args(geo)
    n0 = _build.launches["wt_zc"]
    k = TZ.band_candidates(filt, geo)
    assert _build.launches["wt_zc"] == n0 + 1
    p = TZ.band_candidates_plain(filt, bounds, **args)
    both = (k > 0) & (p > 0)
    # same f32 operations in the same order: rel 1e-5, no gate flips
    assert int(((k > 0) != (p > 0)).sum()) == 0
    rel = ((k - p).abs() / p.abs().clamp(min=1e-3))[both]
    assert float(rel.max()) < 1e-5


def test_refine_kernel_matches_plain(stage_inputs):
    _, geo, y = stage_inputs
    mean = torch.zeros(y.shape[0], device=y.device)
    cand, _, _ = TH.candidates_stage(y, mean, geo)
    tpos = torch.arange(geo.f0_length, dtype=torch.float32,
                        device=y.device) / 1000.0
    prep = TR.prepare(y, cand, tpos, geo=geo, dedup_tol=TH.REFINE_DEDUP_TOL)
    kw = dict(hwmax=geo.max_half_window, n_fft=geo.refine_fft)
    k = TR.spectral_sums(*prep["kernel_args"], **kw)
    p = TR.spectral_sums_plain(*prep["kernel_args"], **kw)
    # sincosf + rotation vs cos, different summation order: 1e-5 of scale
    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())


def test_ola_kernel_matches_plain(dev):
    rng = np.random.RandomState(1)
    B, P, fft, T = 3, 300, 1024, 40000
    resp = torch.tensor(rng.randn(B, P, fft).astype(np.float32), device=dev)
    starts = torch.tensor(np.sort(rng.randint(-(fft - 1), T, (B, P)), 1)
                          .astype(np.int32), device=dev)
    k = TO.overlap_add(resp, starts, T)
    p = TO.overlap_add_plain(resp, starts, T)
    torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-5)


def ola_padded_tail(seed, P=600, fft=1024, T=40000, n_real=(420, 37, 0)):
    """OLA inputs laid out as the time base lays them out: per utterance
    n_real pulses in time order, then padding pulses with zero responses,
    all at one start near the end (``pulse_train``: sample T-1, so start
    T - fft/2).  Utterance 1's real pulses end early, so the tiles past
    them hold only padding; utterance 2 has none."""
    rng = np.random.RandomState(seed)
    B = len(n_real)
    resp = rng.randn(B, P, fft).astype(np.float32)
    starts = np.full((B, P), T - fft // 2, np.int32)
    for b, n in enumerate(n_real):
        hi = T - fft if b != 1 else T // 4
        starts[b, :n] = np.sort(rng.randint(-(fft - 1), hi, n))
        resp[b, n:] = 0.0
    return resp, starts, np.array(n_real, np.int64)


@pytest.mark.parametrize("with_count", [False, True])
def test_ola_kernel_padded_tail(dev, with_count):
    """The padded-tail layout, with and without the pulse count (tiles of
    padding only included): the kernel against its plain version."""
    resp, starts, n = (torch.tensor(a, device=dev)
                       for a in ola_padded_tail(2))
    T = 40000
    cnt = n if with_count else None
    n0 = _build.launches["wt_ola"]
    k = TO.overlap_add(resp, starts, T, cnt)
    assert _build.launches["wt_ola"] == n0 + 1
    p = TO.overlap_add_plain(resp, starts, T)
    torch.testing.assert_close(k, p, rtol=1e-4, atol=1e-5)
    assert bool((k[2] == 0).all()) and bool((k[1, T // 4 + 1024:] == 0).all())


def test_ola_kernel_count_cuts_pulses(dev):
    """With the count the kernel adds no pulse past it, even one whose
    response is not zero (the plain version masks the same pulses)."""
    resp, starts, n = ola_padded_tail(3)
    resp[:, -5:] = 1.0
    resp, starts, n = (torch.tensor(a, device=dev) for a in (resp, starts, n))
    T = 40000
    k = TO.overlap_add(resp, starts, T, n)
    torch.testing.assert_close(k, TO.overlap_add_plain(resp, starts, T, n),
                               rtol=1e-4, atol=1e-5)
    assert not torch.allclose(k, TO.overlap_add_plain(resp, starts, T))


def test_cuda_wrapper_checks(dev):
    resp = torch.zeros((1, 2, 128), device=dev, dtype=torch.float16)
    starts = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32 or float64"):
        TO.overlap_add(resp, starts, 100)
    with pytest.raises(ValueError, match="n_pulses"):
        TO.overlap_add(resp.float(), starts, 100,
                       torch.ones(1, dtype=torch.int32, device=dev))
    filt = torch.zeros((1, 4, 300), device=dev)
    with pytest.raises(ValueError, match="c_row"):
        TZ.zc_events_cuda(filt, 0, 2, e_cap=8, c_row=16)
    with pytest.raises(ValueError, match="band range"):
        TZ.zc_events_cuda(filt, 2, 5, e_cap=128, c_row=8)
    with pytest.raises(ValueError, match="band groups"):
        TZ.zc_events_groups(filt, [(0, 1, 128, 8)]
                            * (TZ.MAX_EVENT_GROUPS + 1))
    cand = torch.zeros((1, 4, TE.MAX_SLOTS + 1), device=dev)
    w = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="candidate slots"):
        TE.extend_walk(cand, cand, w, w + 1, w == 0, w, w.float(),
                       ext_lim=2, miss_lim=1, allowed_range=0.18)


def test_main_path_launches_kernels(dev):
    fs = 22050
    x = torch.tensor(_vowels(fs, 2), device=dev)
    geo = TH.HarvestGeometry(fs, x.shape[1], f0_floor=40.0)
    ck = CheapTrickKernel(fs)
    out_len = int((geo.n_grid() - 1) * 0.00625 * fs) + 1
    mp = TS.capacity_max_pulses(out_len, fs, f0_cap=600.0)
    noise = TS.make_noise(torch.Generator(device=dev).manual_seed(0), 2, mp,
                          ck.fft_size, device=dev)
    _build.launches.clear()
    y, f0, ovf = TB.batch_wav_to_wav(
        x, noise, geo=geo, fs=fs, fft_size=ck.fft_size,
        max_half_window=ck.max_half_window, frame_period_s=0.00625,
        out_length=out_len, max_pulses=mp, pitch_scale=1.2,
        return_overflow=True)
    torch.cuda.synchronize()
    assert {k: _build.launches[k] for k in ("wt_zc", "wt_refine_sums",
                                            "wt_ola", "wt_extend")} == \
        {"wt_zc": 1, "wt_refine_sums": 1, "wt_ola": 1, "wt_extend": 1}
    assert y.shape == (2, out_len) and bool(torch.isfinite(y).all())
    assert not bool(ovf.any())
    assert float((f0 > 0).float().mean()) > 0.3


def _walk_inputs(stage_inputs):
    """The extend walk's inputs as fix_step3 builds them, captured from a
    real contour chain on the card."""
    x, geo, _ = stage_inputs
    cand, score = TH.harvest_device_stages(x, geo=geo)
    seen = []
    real = TE.extend_walk

    def spy(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)

    TE.extend_walk = spy
    try:
        TCD.fix_and_smooth(cand, score, geo.n_grid(), geo.frame_period)
    finally:
        TE.extend_walk = real
    assert len(seen) == 1
    return seen[0]


def test_extend_kernel_matches_plain(stage_inputs):
    args, kw = _walk_inputs(stage_inputs)
    n0 = _build.launches["wt_extend"]
    k = TE.extend_walk(*args, **kw)
    assert _build.launches["wt_extend"] == n0 + 1
    p = TE.extend_walk_plain(*args, **kw)
    # the same selection and comparisons, value for value: exact
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert int(k[2].max()) > 0


def extend_edge_case(S, seed=0):
    """Extend-walk inputs (numpy; B=2 utterances of F=64 frames with S
    candidate slots, W=8 walks each) whose walks reach the walk's edge
    cases.  Utterance 0, walk by walk:
      0. a NaN candidate in a row that also holds an exact match: a miss;
      1. and 2. two candidates at the same error from the reference (180
         and 220 around 200): the later slot wins, in either order;
      3. a miss scored by its zero-candidate slots (3.0 and 7.5), a miss
         with no zero slot (score 0), an accept whose slot has a NaN
         score (score NaN), an accept of a value held by two slots (the
         larger score);
      4. three accepts, then misses until miss_lim on its last allowed
         step;
      5. distance 0 (one step); 6. not live; 7. no reference yet (tmp0 0,
         so the reference is 1).
    Utterance 1: walks both ways, some to the table's first and last
    frames.  Returns (cand, score, origin, shift, live,
    distance, tmp0) and the walk's keywords (ext_lim 12, miss_lim 3)."""
    r = np.random.RandomState(seed)
    B, F, W = 2, 64, 8
    far = r.uniform(400.0, 900.0, (B, F, S))
    cand = np.where(r.rand(B, F, S) < 0.3, 0.0, far).astype(np.float32)
    score = r.uniform(0.0, 40.0, (B, F, S)).astype(np.float32)
    for b in range(B):
        for f in range(F):
            if r.rand() < 0.8:
                cand[b, f, r.randint(S)] = 200.0 * (1 + 0.05 * r.randn())

    def clear(f, zeros=True):
        cand[0, f] = 900.0
        if zeros:
            cand[0, f, ::4] = 0.0

    clear(5)
    cand[0, 5, 0], cand[0, 5, S - 1] = 200.0, np.nan
    for f, lo_hi in ((21, (180.0, 220.0)), (39, (220.0, 180.0))):
        clear(f)
        cand[0, f, 1], cand[0, f, S - 1] = lo_hi
    clear(31, zeros=False)
    cand[0, 31, [0, 2]] = 0.0
    score[0, 31, [0, 2]] = 3.0, 7.5
    clear(32, zeros=False)
    clear(33)
    cand[0, 33, [3, 5]] = 201.0
    score[0, 33, [3, 5]] = np.nan, 4.0
    clear(34)
    cand[0, 34, [2, 6]] = 199.0
    score[0, 34, [2, 6]] = 5.0, 9.0
    for f in (51, 52, 53):
        clear(f)
        cand[0, f, S // 2] = 200.0
    for f in (54, 55, 56, 57):
        clear(f)

    origin = np.array([[2, 20, 40, 30, 50, 10, 25, 45],
                       [3, 60, 33, 12, 48, 7, 58, 20]])
    shift = np.array([[1, 1, -1, 1, 1, -1, 1, -1],
                      [-1, 1, 1, -1, -1, 1, 1, 1]])
    distance = np.array([[12, 12, 12, 12, 5, 0, 12, 12],
                         [2, 2, 12, 11, 12, 12, 4, 12]])
    live = np.ones((B, W), bool)
    live[0, 6] = False
    tmp0 = np.full((B, W), 200.0, np.float32)
    tmp0[0, 7] = 0.0
    tmp0[1] = 200.0 * (1 + 0.03 * r.randn(W))
    return ((cand, score, origin, shift, live, distance, tmp0),
            dict(ext_lim=12, miss_lim=3, allowed_range=0.18))


def check_extend_edge_case(vals, scs, n_on, so):
    """The edge cases of ``extend_edge_case`` were reached (numpy results
    of either the plain walk or a kernel)."""
    assert vals[0, 0, 2] == 0.0 and n_on[0, 0] > 2          # NaN: a miss
    assert vals[0, 1, 0] == 220.0 and vals[0, 2, 0] == 180.0
    assert vals[0, 3, 0] == 0.0 and scs[0, 3, 0] == 7.5
    assert vals[0, 3, 1] == 0.0 and scs[0, 3, 1] == 0.0
    assert vals[0, 3, 2] == 201.0 and np.isnan(scs[0, 3, 2])
    assert vals[0, 3, 3] == 199.0 and scs[0, 3, 3] == 9.0
    assert n_on[0, 4] == 6 and so[0, 4] == 53
    assert (vals[0, 4, :3] == 200.0).all() and (vals[0, 4, 3:] == 0).all()
    assert n_on[0, 5] == 1 and n_on[0, 6] == 0 and so[0, 6] == 25


#: a reference F0 and three candidates above it whose distances d1 < d2 <
#: d3 are consecutive floats: d1 / ref and d2 / ref round to the same
#: error (2.0009444), d3 / ref to the next one up
TIE_REF = 170.22259521484375
TIE_CANDS = (510.8285217285156, 510.82855224609375, 510.8285827636719)


def extend_tie_case(S):
    """Two one-step walks (allowed_range 2.5) on rows whose least error is
    reached by two candidates at different distances: the later slot wins
    whichever of the two it holds (walk 0: the farther, walk 1: the
    nearer); the third candidate's error is just above."""
    cand = np.full((1, 8, S), 900.0, np.float32)
    score = np.arange(8 * S, dtype=np.float32).reshape(1, 8, S)
    c1, c2, c3 = TIE_CANDS
    cand[0, 3, [1, S - 2, S - 1]] = c1, c2, c3
    cand[0, 4, [0, S - 1]] = c2, c1
    args = (cand, score, np.array([[2, 5]]), np.array([[1, -1]]),
            np.ones((1, 2), bool), np.zeros((1, 2), np.int64),
            np.full((1, 2), TIE_REF, np.float32))
    return args, dict(ext_lim=2, miss_lim=1, allowed_range=2.5)


@pytest.mark.parametrize("S", [13, 45, 128, 200])
def test_extend_kernel_ties_of_distinct_distances(dev, S):
    args, kw = extend_tie_case(S)
    args = [torch.tensor(a, device=dev) for a in args]
    k = TE.extend_walk(*args, **kw)
    for a, b in zip(k, TE.extend_walk_plain(*args, **kw)):
        assert torch.equal(a, b)
    assert k[0][0, :, 0].tolist() == [TIE_CANDS[1], TIE_CANDS[0]]


@pytest.mark.parametrize("S", [13, 45, 128, 200])
def test_extend_kernel_edge_cases(dev, S):
    """The kernel equals the plain walk value for value (NaN where it
    has NaN) on tables that reach each edge case."""
    args, kw = extend_edge_case(S)
    args = [torch.tensor(a, device=dev) for a in args]
    k = TE.extend_walk(*args, **kw)
    p = TE.extend_walk_plain(*args, **kw)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    check_extend_edge_case(*(t.cpu().numpy() for t in k))


def test_zc_events_kernel_matches_plain(stage_inputs):
    _, geo, y = stage_inputs
    filt = TH.band_filter(y, geo)
    groups = TZ.make_groups(geo)
    n0 = _build.launches["wt_zc_events"]
    outs = TZ.zc_events(filt, geo)
    assert _build.launches["wt_zc_events"] == n0 + 1   # all groups at once
    for g, (ev, ccol) in zip(groups, outs):
        pev, pccol = TZ.zc_events_plain(filt, g.lo, g.hi, e_cap=g.e_cap,
                                        c_row=g.c_row)
        assert torch.equal(ccol, pccol)
        assert torch.equal(ev, pev)


def _assert_events_equal_plain(filt, specs, outs):
    assert len(outs) == len(specs)
    for (lo, hi, e_cap, c_row), (ev, ccol) in zip(specs, outs):
        pev, pccol = TZ.zc_events_plain(filt, lo, hi, e_cap=e_cap,
                                        c_row=c_row)
        assert torch.equal(ccol, pccol)
        assert torch.equal(ev, pev)
    return pev, pccol


@pytest.mark.parametrize("L", [
    128 * 40,            # whole columns, n_cols a multiple of 8: no pad column
    128 * 37 + 1,        # n_cols 38 not a multiple of 8, one sample in the last
    2048 * 3 + 700,      # not a multiple of the block's 2,048-sample chunk
    70003,               # many chunks
    131,                 # shorter than one chunk
])
def test_zc_events_kernel_edges_exact(dev, L):
    """The one-launch kernel at its edges, bit-exact against the plain
    version: a group whose offsets clamp at e_cap - c_row (the fast tone
    and the noise rows overrun it), columns with more than c_row events,
    n_cols not a multiple of 8 (pad store columns), L not a multiple of
    the chunk, groups of different e_cap and c_row in one launch, and
    bands that no group covers."""
    rows = _zc_rows(L)                                   # [1, 7, L]
    filt = torch.tensor(np.concatenate([rows, 0.5 * rows[:, ::-1]], 0),
                        device=dev)                      # B=2
    specs = [(0, 2, 128, 8), (2, 5, 256, 16), (5, 6, 64, 64),
             (6, 7, 2048, 24)]
    n0 = _build.launches["wt_zc_events"]
    outs = TZ.zc_events_groups(filt, specs)
    assert _build.launches["wt_zc_events"] == n0 + 1
    _assert_events_equal_plain(filt, specs, outs)
    if L >= 128 * 37:
        # the fast tone (band 5): every column past c_row... and the clamp
        ev, ccol = TZ.zc_events_cuda(filt, 4, 6, e_cap=64, c_row=8)
        assert int(ccol.max()) == 8 and int(ccol[0, 1, 0].sum()) > 64 - 8
        pev, pccol = TZ.zc_events_plain(filt, 4, 6, e_cap=64, c_row=8)
        assert torch.equal(ev, pev) and torch.equal(ccol, pccol)


def test_zc_events_kernel_single_group_and_subset(dev, stage_inputs):
    """A single-group call and a launch over some of the groups return what
    the all-groups launch returns for them."""
    _, geo, y = stage_inputs
    filt = TH.band_filter(y, geo)
    groups = TZ.make_groups(geo)
    specs = [(g.lo, g.hi, g.e_cap, g.c_row) for g in groups]
    every = TZ.zc_events(filt, geo)
    n0 = _build.launches["wt_zc_events"]
    ev, ccol = TZ.zc_events_cuda(filt, *specs[3][:2], e_cap=specs[3][2],
                                 c_row=specs[3][3])
    some = TZ.zc_events_groups(filt, specs[7:] + specs[:2])
    assert _build.launches["wt_zc_events"] == n0 + 2
    assert torch.equal(ev, every[3][0]) and torch.equal(ccol, every[3][1])
    for got, want in zip(some, every[7:] + every[:2]):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("with_count", [False, True])
def test_ola_kernel_float64_matches_plain(dev, with_count):
    """The OLA kernel's double instantiation on the padded-tail layout: it
    adds in pulse order, index_add_ in any order, so they agree to rounding
    (1e-12 relative to the largest output), and two kernel runs are equal
    bit for bit."""
    resp, starts, n = ola_padded_tail(4)
    resp = torch.tensor(resp.astype(np.float64) * (1 + 1e-9), device=dev)
    starts, n = torch.tensor(starts, device=dev), torch.tensor(n, device=dev)
    T = 40000
    cnt = n if with_count else None
    n0 = _build.launches["wt_ola_f64"]
    k = TO.overlap_add(resp, starts, T, cnt)
    assert _build.launches["wt_ola_f64"] == n0 + 1
    assert k.dtype == torch.float64
    p = TO.overlap_add_plain(resp, starts, T, cnt)
    assert float((k - p).abs().max()) <= 1e-12 * float(p.abs().max())
    assert torch.equal(k, TO.overlap_add(resp, starts, T, cnt))
    # in pulse order: a sequential numpy sum of one output sample
    b, t = 0, 20000
    st = starts[b].cpu().numpy()
    rn = resp[b].cpu().numpy()
    acc = 0.0
    for q in range(int(n[b])):
        j = t - int(st[q])
        if 0 <= j < rn.shape[1]:
            acc += rn[q, j]
    assert float(k[b, t]) == acc


def _cumsum_data(shape, seed):
    """Wide magnitudes (a reassociated sum differs in the last bits), by
    row: a leading run of -0.0 then +0.0, subnormals only, +inf then -inf,
    a NaN, or none of these (tests/test_torch_f64_ops.py's rows)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * 10.0 ** rng.uniform(-8, 8, shape)
    rows = x.reshape(-1, shape[-1])
    n = shape[-1]
    for r in range(rows.shape[0]):
        kind = r % 5
        if kind == 0:
            rows[r, :min(n, 37)] = -0.0
            rows[r, min(n - 1, 37)] = 0.0
        elif kind == 1:
            rows[r] = rng.randint(-1000, 1000, n) * 5e-324
        elif kind == 2:
            rows[r, n // 2] = np.inf
            rows[r, (3 * n) // 4] = -np.inf
        elif kind == 3:
            rows[r, n // 3] = np.nan
    return x


def _same_bits(a, b):
    """Equal bit for bit (-0.0 apart from +0.0), NaN where NaN."""
    na, nb = np.isnan(a), np.isnan(b)
    return (a.shape == b.shape and np.array_equal(na, nb)
            and np.array_equal(a[~na].view(np.int64), b[~nb].view(np.int64)))


# each side of the kernel's regime split and chunk edges, and the float64
# path's own launches (D4C / LinearSmoothing frames, a chunk step's, the
# time base of the main batch's geometry and of a 24.33 s utterance)
SEQ_CUMSUM_SHAPES = ([(1, 50001), (141, 2169), (3, 7, 65), (70, 1)]
                     + [(r, n) for r in (1, 2, 31, 33, 140, 280)
                        for n in (1, 2, 575, 1025, 1207, 15325)]
                     + [(280, 1025), (2026, 1025), (1013, 575), (8, 122791),
                        (1, 536000)])


@pytest.mark.parametrize("shape", SEQ_CUMSUM_SHAPES)
def test_seq_cumsum_kernel_exact(dev, shape):
    """The sequential cumulative sum on the card equals numpy.cumsum (in
    order, one rounding a step) bit for bit, -0.0, +-inf, NaN and
    subnormals included, on data whose reassociated sum differs."""
    x = _cumsum_data(shape, 6)
    n0 = _build.launches["wt_seq_cumsum_f64"]
    got = TQ.cumsum_sequential(torch.tensor(x, device=dev))
    assert _build.launches["wt_seq_cumsum_f64"] == n0 + 1
    assert got.shape == x.shape and got.dtype == torch.float64
    with np.errstate(invalid="ignore"):
        want = np.cumsum(x, axis=-1)
    assert _same_bits(got.cpu().numpy(), want)
    # a strided view is summed as its contiguous copy
    xt = torch.tensor(x, device=dev)
    if xt.dim() == 2 and xt.shape[0] > 1:
        assert _same_bits(TQ.cumsum_sequential(xt[::2]).cpu().numpy(),
                          want[::2])
    with pytest.raises(ValueError, match="float64"):
        TQ.cumsum_sequential(xt.float())


@pytest.mark.parametrize("shape", [(280, 1025), (2026, 1025), (1, 15325)])
def test_seq_cumsum_graph_replay_equals_eager(dev, shape):
    """The kernel captured in a CUDA graph (one launch, no sync, no
    allocation inside it) replays to its eager launch's bits, and to
    numpy.cumsum of new data copied into the captured input."""
    x = torch.tensor(_cumsum_data(shape, 7), device=dev)
    eager = TQ.cumsum_sequential(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TQ.cumsum_sequential(x)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    n0 = _build.launches["wt_seq_cumsum_f64"]
    with torch.cuda.graph(g):
        out = TQ.cumsum_sequential(x)
    assert _build.launches["wt_seq_cumsum_f64"] == n0 + 1
    g.replay()
    torch.cuda.synchronize()
    assert _same_bits(out.cpu().numpy(), eager.cpu().numpy())
    other = _cumsum_data(shape, 8)
    x.copy_(torch.tensor(other, device=dev))
    g.replay()
    torch.cuda.synchronize()
    with np.errstate(invalid="ignore"):
        assert _same_bits(out.cpu().numpy(), np.cumsum(other, axis=-1))


def test_seq_cumsum_plan_matches_c(dev):
    """The C entry's launch plan (wt_seq_cumsum_plan) is seqsum.plan, for
    a given SM count and for the device's own."""
    import ctypes
    lib = _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    regimes = ("rows", "long")
    for r, n in [(280, 1025), (2026, 1025), (1013, 575), (140, 575),
                 (1, 15325), (8, 122791), (1, 536000), (131, 4097),
                 (132, 4097), (131, 4096), (70, 1), (5000, 3)]:
        for ask, want in ((132, TQ.plan(r, n, 132)),
                          (0, TQ.plan(r, n, sms))):
            buf = (ctypes.c_int * 5)()
            assert lib.wt_seq_cumsum_plan(r, n, ask,
                                          ctypes.addressof(buf)) == 0
            assert (regimes[buf[0]],) + tuple(buf[1:]) == tuple(want)


def test_f64_path_on_card_matches_cpu(dev):
    """The float64 parity path on the card against the same path on the
    CPU (other FFT library, the two float64 kernels in place of numpy and
    index_add_) on a vowel: voicing identical, F0 within 1e-6 Hz,
    spectrogram 1e-9 relative, aperiodicity 1e-8, and a synthesis from
    the same float64 noise within 1e-10 of full scale."""
    fs = 16000
    x = _vowels(fs, 1, dur=0.5)[0].astype(np.float64)
    out = {}
    _build.launches.clear()
    for d in ("cpu", dev):
        har = api.Harvest(fs, api.HarvestOption(f0_floor=40.0), device=d)
        tpos, f0 = har.compute(x, dtype=torch.float64)
        ct = api.CheapTrick(fs, device=d)
        sp = ct.compute(x, tpos, f0, dtype=torch.float64)
        ap = api.D4C(fs, device=d).compute(x, tpos, f0, ct.fft_size,
                                           dtype=torch.float64)
        out[str(d)] = (f0, sp.cpu().numpy(), ap.cpu().numpy())
    # both devices synthesize the CPU's parameters with the same noise
    f0, sp, ap = out["cpu"]
    T = int((len(f0) - 1) * 0.005 * fs) + 1
    mp = TS.default_max_pulses(T, fs)
    noise = np.random.RandomState(1).randn(mp, ct.fft_size)
    yc, yg = (api.Synthesis(fs, ct.fft_size, 5.0, device=d).compute(
        f0, sp, ap, T, noise=noise, dtype=torch.float64).cpu().numpy()
        for d in ("cpu", dev))
    assert _build.launches["wt_ola_f64"] == 1
    assert _build.launches["wt_seq_cumsum_f64"] >= 5
    assert not any(_build.launches[k] for k in ("wt_zc", "wt_refine_sums",
                                                 "wt_ola", "wt_extend",
                                                 "wt_pulse_resp"))
    (f0c, spc, apc), (f0g, spg, apg) = out["cpu"], out[str(dev)]
    np.testing.assert_array_equal(f0c > 0, f0g > 0)
    assert (f0c > 0).mean() > 0.3
    np.testing.assert_allclose(f0g, f0c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(spg, spc, rtol=1e-9)
    np.testing.assert_allclose(apg, apc, rtol=0, atol=1e-8)
    assert np.abs(yg - yc).max() < 1e-10 * np.abs(yc).max()


def test_world_copy_synthesis_launches_extend(dev):
    fs = 22050
    x = _vowels(fs, 1)[0]
    world = api.World(fs, f0_floor=40.0, device=dev)
    _build.launches.clear()
    y, f0 = world.copy_synthesis(x, pitch_scale=1.1)
    assert _build.launches["wt_extend"] >= 1
    assert np.isfinite(y).all() and (f0 > 0).mean() > 0.3


# ---------------------------------------------------------------------------
# the redesigned refine and zc kernels, at their edges
# ---------------------------------------------------------------------------

def test_refine_kernel_edges(dev):
    """Frames with 0 and 64 active slots, half windows at hwmax, bins at
    n_fft/2, negative window offsets: within 1e-5 of the largest sum of
    the plain version, and exact zeros at and past n_active."""
    rng = np.random.RandomState(5)
    hwmax, n_fft, cap = 276, 2048, TR.CAP
    W = 2 * hwmax + 1
    n_act = np.array([0, 64, 5, 64, 1, 37, 0, 12], np.int32)
    N = len(n_act)
    hw = rng.randint(14, hwmax + 1, (N, cap)).astype(np.int32)
    hw[:, ::7] = hwmax
    gbin = rng.randint(0, n_fft // 2 + 1, (N, cap, 6)).astype(np.int32)
    gbin[:, ::5, -1] = n_fft // 2
    args = [torch.tensor(a, device=dev) for a in (
        rng.randn(N, W).astype(np.float32),
        rng.uniform(-hwmax - 1.5, -hwmax - 0.5, N).astype(np.float32),
        hw, gbin, n_act)]
    kw = dict(hwmax=hwmax, n_fft=n_fft)
    n0 = _build.launches["wt_refine_sums"]
    k = TR.spectral_sums(*args, **kw)
    assert _build.launches["wt_refine_sums"] == n0 + 1
    p = TR.spectral_sums_plain(*args, **kw)
    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())
    off = torch.arange(cap, device=dev)[None, :] >= args[4][:, None]
    assert bool((k[off] == 0).all())
    assert bool((k[~off].abs().sum(-1) > 0).all())


def _zc_rows(L):
    """Band signal rows: silence (no events), one to three crossings of f,
    a tone at a band's rate, a fast tone (many events), noise."""
    rng = np.random.RandomState(9)
    t = np.arange(L)
    rows = [np.zeros(L)]
    for n in (1, 2, 3):
        r = np.ones(L)
        for c in range(n):
            r[(c + 1) * L // 4:] *= -1
        rows.append(r)
    rows.append(np.sin(2 * np.pi * t * 180.0 / 7350.0))
    rows.append(np.sin(2 * np.pi * t / 4.0 + 0.3))
    rows.append(rng.randn(L))
    return np.stack(rows).astype(np.float32)[None]


@pytest.mark.parametrize("L, e_max, layout", [
    (20011, 600, "shared"),       # the fast tone's 5,000 events clamp
    (20011, 300, "shared"),       # ... and the band tone's ~490 too
    (20011, 14000, "global"),
    (70003, 14000, "global"),     # ... and in the global layout
])
def test_zc_kernel_edges_exact(dev, L, e_max, layout):
    """Bit-exact against the plain version (0 to 3 events of a type, more
    than e_max, F not a multiple of the block) in both event layouts."""
    filt = torch.tensor(_zc_rows(L), device=dev)
    nb = filt.shape[1]
    bounds = torch.full((nb,), 180.0, device=dev)
    F = int(L / 7350.0 * 1000) + 1
    assert F % 1024
    args = dict(F=F, e_max=e_max, fs_a=7350.0, grid_hz=1000.0, tstep=0.001,
                f0_floor=40.0, f0_ceil=800.0)
    assert TZ.zc_layout(e_max) == layout
    TZ.layout_launches.clear()
    k = TZ.band_candidates_cuda(filt, bounds, **args)
    assert dict(TZ.layout_launches) == {layout: 1}
    p = TZ.band_candidates_plain(filt, bounds, **args)
    assert torch.equal(k, p)
    assert int((p[0, 4] > 0).sum()) > F // 2      # the tone's candidates


@pytest.mark.parametrize("dur, layout", [(0.8, "shared"), (9.0, "global")])
def test_zc_kernel_exact_on_speechlike(dev, dur, layout):
    """A real geometry in each layout: 9 s pushes e_max past the shared
    one.  Bit-exact against the plain version."""
    fs = 22050
    x = torch.tensor(_vowels(fs, 1, dur=dur), device=dev)
    geo = TH.HarvestGeometry(fs, x.shape[1], f0_floor=40.0)
    assert TZ.zc_layout(geo.e_max) == layout
    y = TH.decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    filt = TH.band_filter(y, geo)
    bounds = torch.as_tensor(geo.boundary_f0, dtype=torch.float32,
                             device=dev)
    args = TZ.geometry_args(geo)
    k = TZ.band_candidates_cuda(filt, bounds, **args)
    p = TZ.band_candidates_plain(filt, bounds, **args)
    assert torch.equal(k, p) and int((p > 0).sum()) > 0


def test_compute_corpus_on_card(dev):
    """compute_corpus on the card (pinned non-blocking downloads behind an
    event) equals compute_batch on the card bit for bit, and the corpus
    path's batches (numpy) go to the card named by the kernel's device."""
    fs = 22050
    xs = [_vowels(fs, 2), 0.5 * _vowels(fs, 2)[::-1].copy()]
    hk = TH.HarvestKernel(fs, xs[0].shape[1], f0_floor=40.0, device=dev)
    want = [r for x in xs for r in hk.compute_batch(x)]
    _build.launches.clear()
    got = list(hk.compute_corpus(iter(xs)))
    assert _build.launches["wt_zc"] == 2 and _build.launches["wt_extend"] == 2
    assert len(got) == len(want) == 4
    for (f0, tpos), (wf0, wtpos) in zip(got, want):
        np.testing.assert_array_equal(f0, wf0)
        np.testing.assert_array_equal(tpos, wtpos)
    assert (got[0][0] > 0).mean() > 0.3


def test_codec_on_card_matches_cpu(dev):
    """The codec on CUDA tensors stays on the card and agrees with the CPU
    on the same seeded inputs, at tests/test_torch_codec.py's float32
    tolerances (coded aperiodicity 2e-5 dB; decoded aperiodicity 5e-6 and
    decoded envelope 1e-3 relative; coded envelope 2e-5 of its largest
    magnitude) and at 1e-12 of the largest magnitude in float64."""
    from worldtpu_torch import codec
    rng = np.random.RandomState(4)
    kw = dict(fs=22050, fft_size=1024)
    for dt in (torch.float32, torch.float64):
        spec = torch.tensor(10.0 ** rng.uniform(-8, 0, (300, 513)), dtype=dt)
        ap = torch.tensor(10.0 ** rng.uniform(-3, 0, (300, 513)), dtype=dt)
        cases = (
            (codec.code_aperiodicity, ap, {}, "abs", 2e-5),
            (codec.decode_aperiodicity, codec.code_aperiodicity(ap, **kw),
             {}, "rel", 5e-6),
            (codec.code_spectral_envelope, spec, {"n_dims": 31}, "of max",
             2e-5),
            (codec.decode_spectral_envelope,
             codec.code_spectral_envelope(spec, n_dims=31, **kw),
             {"n_dims": 31}, "rel", 1e-3))
        for fn, arg, extra, kind, tol in cases:
            got = fn(arg.to(dev), **kw, **extra)
            want = fn(arg, **kw, **extra)
            assert got.device == dev and got.dtype == dt
            d = (got.cpu() - want).abs()
            if dt == torch.float64:
                kind, tol = "of max", 1e-12
            err = {"abs": d.max(), "rel": (d / want.abs()).max(),
                   "of max": d.max() / want.abs().max()}[kind]
            assert float(err) <= tol, (fn.__name__, dt, float(err))


# ---------------------------------------------------------------------------
# long audio on the card
# ---------------------------------------------------------------------------

def _long_utterance(fs, dur, seed=0):
    """tests/test_longform.py's long test utterance (that module imports
    JAX, which the card's machine lacks)."""
    n = int(fs * dur)
    t = np.arange(n) / fs
    f0 = 170 * 2 ** ((40 / 1200) * np.sin(2 * np.pi * 0.35 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    rng = np.random.RandomState(seed)
    x = np.zeros(n)
    for k in range(1, 12):
        x += np.sin(k * phase) / k
    x /= np.abs(x).max() * 1.4
    g0, g1 = int(0.42 * n), int(0.47 * n)
    x[g0:g1] = 0.003 * rng.randn(g1 - g0)
    x += 0.002 * rng.randn(n)
    x[-int(0.4 * fs):] = 0.0
    return x.astype(np.float32)


def _windowed_rel(yc, yu, fs):
    yc, yu = yc.astype(np.float64), yu.astype(np.float64)
    w = int(0.1 * fs)
    n = (len(yu) // w) * w
    dw = np.sqrt(((yc[:n] - yu[:n]).reshape(-1, w) ** 2).mean(axis=1))
    uw = np.sqrt((yu[:n].reshape(-1, w) ** 2).mean(axis=1))
    return dw / np.maximum(uw, np.median(uw) * 1e-3)


def _short_time_rms(y, w):
    n = (len(y) // w) * w
    return np.sqrt((y[:n].astype(np.float64).reshape(-1, w) ** 2).mean(1))


def test_long_pipeline_on_card_matches_cpu(dev):
    """LongPipeline on the card (zc, refine and OLA kernels) against the
    same pipeline on the CPU (plain versions) on an 8 s utterance.  F0:
    tests/test_longform.py's gates (voicing identical, RMSE < 0.1 Hz, max
    < 5 Hz).  The synthesis on one F0 (the card's): the card divides a
    tensor by a Python scalar as a product with its reciprocal, one
    rounding apart from the CPU's division, so a knife-edge voicing sample
    of the time base can flip and move every later pulse and noise row
    (as on the main path, phase 5 of chip_smoke.py): the 100 ms energy
    envelopes agree (p95 relative < 0.02) and so does the total energy
    (1%).  On the card the parallel mode gives the sequential mode's F0 and
    waveform (windowed relative error q99 < 1e-3)."""
    fs = 16000
    x = _long_utterance(fs, 8.0, seed=2)
    kw = dict(f0_floor=40.0, chunk_frames=400, harvest_chunk_ms=3000)
    syn = dict(seed=7, pitch_scale=1.2, duration_scale=1.25)
    lpg = TLA.LongPipeline(fs, device=dev, **kw)
    lpc = TLA.LongPipeline(fs, device="cpu", **kw)
    _build.launches.clear()
    yg, f0g = lpg.copy_synthesis(x, **syn)
    counts = dict(_build.launches)
    assert counts["wt_zc"] == counts["wt_refine_sums"] == 1
    # one launch a chunk, and one more: the eager call before the step's
    # capture (parallel/graphs.py; each call captures its own)
    assert counts["wt_ola"] == 1 + -(-len(yg) // int(round(400 * 0.00625
                                                          * fs)))
    fg, tp = lpg.harvest.compute(x)
    fc, _ = lpc.harvest.compute(x)
    np.testing.assert_array_equal(fg * 1.2, f0g)
    assert np.array_equal(fg > 0, fc > 0) and (fg > 0).mean() > 0.6
    d = np.abs(fg - fc)[fg > 0]
    assert np.sqrt(np.mean(d ** 2)) < 0.1 and d.max() < 5.0
    lpc.harvest.compute = lambda x, dtype=None: (fg, tp)
    yc, _ = lpc.copy_synthesis(x, **syn)
    assert yg.shape == yc.shape and np.isfinite(yg).all()
    eg, ec = _short_time_rms(yg, 1600), _short_time_rms(yc, 1600)
    env = np.abs(eg - ec) / np.maximum(ec, np.median(ec) * 1e-3)
    assert np.quantile(env, 0.95) < 0.02
    assert abs(np.sqrt(np.mean(eg ** 2)) / np.sqrt(np.mean(ec ** 2)) - 1) \
        < 0.01
    yp, f0p = lpg.copy_synthesis(x, parallel=True, **syn)
    np.testing.assert_array_equal(f0p, f0g)
    assert np.quantile(_windowed_rel(yp, yg, fs), 0.99) < 1e-3


def test_per_row_positions_on_card(dev):
    """cheaptrick_frames and d4c_frames with [B, F] frame times on the
    card: each row as that row alone on the card, and the card as the CPU:
    the spectrogram within 1e-3 relative and 1e-6 of its largest value
    (the FFTs of a batch of rows round apart from one row's, relative to a
    frame's energy: 1.2e-4 relative at 1e-9 absolute on the highest bin),
    the aperiodicity within 1e-4 absolute."""
    from worldtpu_torch.analysis.d4c import d4c_frames
    fs = 22050
    x = torch.tensor(_vowels(fs, 2))
    ck = CheapTrickKernel(fs)
    F = 1 + int(1000 * x.shape[1] / fs / 5.0)
    f0 = torch.full((2, F), 180.0)
    f0[:, F // 3:F // 2] = 0.0
    tp = torch.arange(F, dtype=torch.float32) * 0.005
    rows = torch.stack([tp, tp - 41.75 / fs])
    kw = dict(fs=fs, fft_size=ck.fft_size, max_half_window=ck.max_half_window)

    def run(d):
        return (TCT.cheaptrick_frames(x.to(d), f0.to(d), rows.to(d), **kw),
                d4c_frames(x.to(d), f0.to(d), rows.to(d), fs=fs,
                           fft_size_out=ck.fft_size))
    sg, ag = run(dev)
    sc, ac = run("cpu")
    for i in range(2):
        s_i = TCT.cheaptrick_frames(x[i:i + 1].to(dev), f0[i:i + 1].to(dev),
                                    rows[i].to(dev), **kw)
        a_i = d4c_frames(x[i:i + 1].to(dev), f0[i:i + 1].to(dev),
                         rows[i].to(dev), fs=fs, fft_size_out=ck.fft_size)
        torch.testing.assert_close(sg[i], s_i[0], rtol=1e-3,
                                   atol=1e-6 * float(s_i.abs().max()))
        torch.testing.assert_close(ag[i], a_i[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(sg.cpu(), sc, rtol=1e-3,
                               atol=1e-6 * float(sc.abs().max()))
    torch.testing.assert_close(ag.cpu(), ac, rtol=0, atol=1e-4)


def test_grid_2_main_path_on_card_matches_cpu(dev):
    """batch_wav_to_wav(grid_ms=2) on the card: zc, refine, OLA and extend
    each launched once, the extend walk at ext_lim 50 and miss_lim 2, and
    the card against the CPU at phase 5's gates of chip_smoke.py (voicing
    agreement >= 0.97, F0 RMSE on voiced <= 1 Hz, short-time RMS within
    0.02: the card divides by a Python scalar through its reciprocal, so
    a knife-edge sample can move a pulse and the later noise rows)."""
    fs = 22050
    x = _vowels(fs, 2)
    geo = TH.HarvestGeometry(fs, x.shape[1], f0_floor=40.0)
    ck = CheapTrickKernel(fs)
    out_len = int((geo.n_grid() - 1) * 0.00625 * fs) + 1
    mp = TS.capacity_max_pulses(out_len, fs, f0_cap=600.0)
    noise = TS.make_noise(torch.Generator().manual_seed(0), 2, mp,
                          ck.fft_size)
    kw = dict(geo=geo, fs=fs, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window, frame_period_s=0.00625,
              out_length=out_len, max_pulses=mp, pitch_scale=1.2,
              return_overflow=True, grid_ms=2)
    seen = []
    real = TE.extend_walk

    def spy(*a, **k):
        seen.append(k)
        return real(*a, **k)

    _build.launches.clear()
    TE.extend_walk = spy
    try:
        yg, fg, ovf = TB.batch_wav_to_wav(torch.tensor(x, device=dev),
                                          noise.to(dev), **kw)
        torch.cuda.synchronize()
    finally:
        TE.extend_walk = real
    assert {k: _build.launches[k] for k in ("wt_zc", "wt_refine_sums",
                                            "wt_ola", "wt_extend")} == \
        {"wt_zc": 1, "wt_refine_sums": 1, "wt_ola": 1, "wt_extend": 1}
    assert [(k["ext_lim"], k["miss_lim"]) for k in seen] == [(50, 2)]
    yc, fc, _ = TB.batch_wav_to_wav(torch.tensor(x), noise, **kw)
    fg, fc = fg.cpu().numpy(), fc.numpy()
    assert not bool(ovf.any()) and bool(torch.isfinite(yg).all())
    assert ((fg > 0) == (fc > 0)).mean() >= 0.97
    both = (fg > 0) & (fc > 0)
    assert both.mean() > 0.3
    assert np.sqrt(np.mean((fg[both] - fc[both]) ** 2)) <= 1.0
    eg = np.stack([_short_time_rms(r, 160) for r in yg.cpu().numpy()])
    ec = np.stack([_short_time_rms(r, 160) for r in yc.numpy()])
    assert np.abs(eg - ec).max() < 0.02


def test_long_pipeline_f64_on_card_matches_cpu(dev):
    """LongPipeline(dtype=torch.float64) on the card: no float32 kernel,
    the OLA kernel's double instantiation once per chunk and the
    sequential cumulative sum; LongHarvest in float64 on the card against
    the CPU (voicing identical, F0 within 1e-6 Hz: cuFFT against
    pocketfft); the synthesis on one F0 (the card's) at envelope level, as
    test_long_pipeline_on_card_matches_cpu holds float32; on the card the
    parallel mode gives the sequential mode's waveform (q99 < 1e-3)."""
    fs = 16000
    x = _long_utterance(fs, 6.0, seed=2).astype(np.float64)
    kw = dict(f0_floor=40.0, chunk_frames=400, harvest_chunk_ms=3000)
    syn = dict(seed=7, pitch_scale=1.2, duration_scale=1.25,
               dtype=torch.float64)
    lpg = TLA.LongPipeline(fs, device=dev, **kw)
    lpc = TLA.LongPipeline(fs, device="cpu", **kw)
    _build.launches.clear()
    yg, f0g = lpg.copy_synthesis(x, **syn)
    counts = dict(_build.launches)
    n_chunks = -(-len(yg) // int(round(400 * 0.00625 * fs)))
    # and the eager call before the step's capture
    assert counts["wt_ola_f64"] == n_chunks + 1
    assert counts["wt_seq_cumsum_f64"] >= n_chunks
    assert not any(k in counts for k in ("wt_zc", "wt_refine_sums",
                                         "wt_ola", "wt_extend",
                                         "wt_pulse_resp"))
    fg, tp = lpg.harvest.compute(x, dtype=torch.float64)
    fc, _ = lpc.harvest.compute(x, dtype=torch.float64)
    np.testing.assert_array_equal(fg * 1.2, f0g)
    assert np.array_equal(fg > 0, fc > 0) and (fg > 0).mean() > 0.6
    np.testing.assert_allclose(fg, fc, rtol=0, atol=1e-6)
    lpc.harvest.compute = lambda x, dtype=None: (fg, tp)
    yc, _ = lpc.copy_synthesis(x, **syn)
    assert yg.dtype == np.float64 and yg.shape == yc.shape
    assert np.isfinite(yg).all()
    eg, ec = _short_time_rms(yg, 1600), _short_time_rms(yc, 1600)
    env = np.abs(eg - ec) / np.maximum(ec, np.median(ec) * 1e-3)
    assert np.quantile(env, 0.95) < 0.02
    assert abs(np.sqrt(np.mean(eg ** 2)) / np.sqrt(np.mean(ec ** 2)) - 1) \
        < 0.01
    yp, f0p = lpg.copy_synthesis(x, parallel=True, **syn)
    np.testing.assert_array_equal(f0p, f0g)
    assert np.quantile(_windowed_rel(yp, yg, fs), 0.99) < 1e-3


# ---------------------------------------------------------------------------
# the captured programs: replays against eager calls
# ---------------------------------------------------------------------------

def test_harvest_forward_replays_equal_eager(dev):
    """HarvestKernel.forward on float32 CUDA input: the first call eager,
    the second captured and replayed, later calls replayed; every F0 equal
    to the eager program's bit for bit, and a replay's launches equal to
    an eager call's.  compute_batch and compute_corpus go through it."""
    fs = 22050
    x = torch.tensor(_vowels(fs, 2), device=dev)
    hk = TH.HarvestKernel(fs, x.shape[1], f0_floor=40.0, device=dev)
    TG.clear()
    want, tpos = TG.eager(TH._forward, (x,), geo=hk.geo, grid=1)
    for i in range(4):
        _build.launches.clear()
        f0, tp = hk(x)
        if i == 0:
            eager_counts = dict(_build.launches)
        if i >= 2:
            assert dict(_build.launches) == eager_counts
        assert torch.equal(f0, want) and torch.equal(tp, tpos)
    assert len(TG.programs()) == 1
    got = hk.compute_batch(x.cpu().numpy())
    np.testing.assert_array_equal(np.stack([r[0] for r in got]),
                                  want.cpu().numpy().astype(np.float64))
    TG.clear()


def _plan_on(dev, dtype, seconds=4.0):
    fs = 16000
    x = _long_utterance(fs, seconds, seed=3)
    if dtype == torch.float64:
        x = x.astype(np.float64)
    lp = TLA.LongPipeline(fs, f0_floor=40.0, chunk_frames=200, device=dev)
    t = np.arange(1 + int(1000 * len(x) / fs / 5.0)) * 0.005
    f0 = 170 * 2 ** ((40 / 1200) * np.sin(2 * np.pi * 0.35 * t))
    f0[(t > 1.5) & (t < 1.8)] = 0.0
    return lp, lp.plan(x, f0 * 1.2, 1.25, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("parallel", [False, True], ids=["seq", "par"])
def test_long_pipeline_replays_equal_eager(dev, dtype, parallel,
                                           monkeypatch):
    """LongPipeline's synthesis loops with the chunk step (and the
    prescan step) replayed equal the same loops run eagerly bit for bit,
    in both dtypes, the parallel mode's padded last group included, with
    a loop's own cache (dropped at its end) and with a cache kept across
    loops (then every step of the later loops replays); such a loop makes
    no host sync between its first replay and its last; a replay's
    launches are an eager step's."""
    monkeypatch.setattr(TLA, "PARALLEL_GROUP", 3)
    lp, p = _plan_on(dev, dtype)
    assert p.n_chunks % 3 != 0 and p.n_chunks > 3
    key = TN.as_key(5)
    loop = lp._parallel if parallel else lp._sequential
    TG.clear()
    _build.launches.clear()
    y_e, ovf_e = loop(p, key, call=TG.eager)
    eager_counts = dict(_build.launches)
    y_o, ovf_o = loop(p, key)
    assert np.array_equal(y_o, y_e) and torch.equal(ovf_o, ovf_e)
    progs = TG.Programs(shared_pool=True)
    for i in range(3):
        _build.launches.clear()
        y_r, ovf_r = loop(p, key, call=progs.call)
        if i == 2:
            assert dict(_build.launches) == eager_counts
        assert np.array_equal(y_r, y_e) and torch.equal(ovf_r, ovf_e)
    assert len(progs.keys()) == (2 if parallel else 1)
    assert TG.programs() == []
    # every program captured: the loop syncs once, after its last replay,
    # to read its overflow flags
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop(p, key, call=progs.call)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert sum("synchronizing CUDA operation" in str(w.message)
               for w in caught) == 1
    progs.clear()


def test_f64_stages_on_card_make_no_sync(dev):
    """The float64 Harvest stages (candidates, refine, prune) on the card
    under CUDA sync debug mode 'error': no synchronising call; their
    refined candidates against the CPU's within 1e-9 relative."""
    from worldtpu_torch.io import wav
    import pathlib
    x, fs, _ = wav.wavread(pathlib.Path(__file__).parent / "fixtures"
                           / "t22.wav")
    x = np.asarray(x[:int(0.36 * fs)], np.float64)
    geo = TH.HarvestGeometry(fs, len(x), f0_floor=40.0)
    out = {}
    for d in ("cpu", dev):
        y = TH.decimate_stage(torch.tensor(x, device=d)[None],
                              ratio=geo.ratio, y_length=geo.y_length)
        mean = torch.zeros(1, dtype=torch.float64, device=d)
        TH._stages_f64(y, mean, geo)                # warms the caches
        if d != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            cand, score = TH._stages_f64(y, mean, geo)
        finally:
            if d != "cpu":
                torch.cuda.set_sync_debug_mode("default")
        out[str(d)] = cand.cpu().numpy()
    c, g = out["cpu"], out[str(dev)]
    np.testing.assert_array_equal(c > 0, g > 0)
    assert (c > 0).sum() > 100
    np.testing.assert_allclose(g, c, rtol=1e-9)
