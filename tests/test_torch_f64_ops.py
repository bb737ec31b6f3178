"""The float64 parity path's primitives on the CPU: the port's own copies of
the JAX package's host helpers (xorshift randn, int-truncating sum, the
dither streams) bit for bit against the originals, and the float64 forms of
the DSP primitives against the JAX package in float64 (x64, CPU) and the
C++ op-level golden dump (tests/fixtures/probe_ops.bin.gz), on identical
numpy inputs.  Each tolerance is stated where it is used."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from test_ops import ProbeOps, _probe_power_spectrum
from worldtpu import native as jnative
from worldtpu.analysis import dither as jdither
from worldtpu.ops import filters as JF
from worldtpu.ops import interp as JI
from worldtpu.ops import misc as JM
from worldtpu_torch import native as tnative
from worldtpu_torch.analysis import dither as tdither
from worldtpu_torch.ops import filters as TF
from worldtpu_torch.ops import interp as TI
from worldtpu_torch.ops import misc as TM
from worldtpu_torch.ops import numeric
from worldtpu_torch.ops import seqsum

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _jstate(gen):
    return (gen._st.x, gen._st.y, gen._st.z, gen._st.w)


# ---------------------------------------------------------------------------
# native helpers and dither streams: bit-equal to the originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_c", [True, False])
def test_xorshift_randn_equals_original(use_c):
    """The C helper and the Python fallback give the original's stream and
    leave the same generator state, across several draws."""
    a, b = tnative.XorshiftRandn(), jnative.XorshiftRandn()
    assert a._lib is not None        # the helper built
    if not use_c:
        a._lib = None
    for n in (1, 7, 1000, 0, 13):
        np.testing.assert_array_equal(a.draw(n), b.draw(n))
    assert a.state == _jstate(b)
    # first values of the reference's stream (recorded from the C++)
    want = np.array([-1.06071551, 0.73608657, -0.40908084, 0.59019394])
    np.testing.assert_allclose(tnative.XorshiftRandn().draw(4), want,
                               atol=2e-8)


def test_int_trunc_sum_equals_original(monkeypatch):
    rng = np.random.RandomState(0)
    for x in (rng.randn(1000) * 3, rng.randn(50) * 0.3, -np.abs(rng.randn(9)),
              np.array([0.6, 0.6, -1.7, 2.5])):
        want = jnative.int_trunc_sum(x)
        assert tnative.int_trunc_sum(x) == want
        monkeypatch.setattr(tnative, "_LIB", None)
        monkeypatch.setattr(tnative, "_TRIED", True)
        assert tnative.int_trunc_sum(x) == want     # the Python loop
        monkeypatch.undo()
    # the running sum truncates toward zero at every step
    assert tnative.int_trunc_sum(np.array([0.6, 0.6, 0.6])) == 0.0
    assert tnative.int_trunc_sum(np.array([-0.6, -0.6, 1.9])) == 1.0


@pytest.mark.parametrize("name", ["t22", "t16"])
def test_dither_streams_equal_original(name):
    """cheaptrick_dither, d4c_love_train_dither and d4c_body_dither in
    stream order: equal arrays and equal generator state after each."""
    f = load_fixture(name)
    mhw = int(1.5 * f.fs / (3.0 * f.fs / (f.fft_size - 3.0)) + 0.5)
    tw, ts, tg = tdither.cheaptrick_dither(f.f0, f.fs, f.fft_size, mhw)
    jw, js, jg = jdither.cheaptrick_dither(f.f0, f.fs, f.fft_size, mhw)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(ts, js)
    assert tg.state == _jstate(jg)
    mlt = int(1.5 * f.fs / 40.0 + 0.5)
    tl, tg = tdither.d4c_love_train_dither(f.f0, f.fs, mlt, tg)
    jl, jg = jdither.d4c_love_train_dither(f.f0, f.fs, mlt, jg)
    np.testing.assert_array_equal(tl, jl)
    assert tg.state == _jstate(jg)
    active = (f.f0 != 0) & (np.arange(len(f.f0)) % 3 != 0)
    mc = int(2.0 * f.fs / 47.0 + 0.5)
    t3 = tdither.d4c_body_dither(f.f0, active, f.fs, mc, tg)
    j3 = jdither.d4c_body_dither(f.f0, active, f.fs, mc, jg)
    for a, b in zip(t3[:3], j3[:3]):
        np.testing.assert_array_equal(a, b)
    assert t3[3].state == _jstate(j3[3])
    assert np.count_nonzero(tw) and np.count_nonzero(t3[0])


# ---------------------------------------------------------------------------
# rounding, truncation, fmod: the half-way and negative cases
# ---------------------------------------------------------------------------

def test_matlab_round_half_away_from_zero():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999, -0.49999, 0.0,
                  3.0, 1e6 + 0.5])
    want = [1, 2, 3, -1, -2, -3, 0, 0, 0, 3, 1000001]
    assert numeric.matlab_round(_t(x)).tolist() == want
    assert TM.matlab_round(_t(x)).tolist() == want
    np.testing.assert_array_equal(np.asarray(JM.matlab_round(jnp.asarray(x))),
                                  want)
    # torch.round rounds half to even: not the reference's rounding
    assert torch.round(_t([0.5, 2.5])).tolist() == [0.0, 2.0]


def test_int_truncation_and_fmod_signs():
    """``.to(int32)`` truncates toward zero like the C cast (interp1Q's
    base); ``torch.fmod`` keeps the dividend's sign like C fmod, where
    ``torch.remainder`` / ``jnp.mod`` take the divisor's: they agree on
    the time base's phase sums, which are never negative."""
    x = _t([-1.7, -0.2, 0.2, 1.7])
    assert x.to(torch.int32).tolist() == [-1, 0, 0, 1]
    two_pi = 2.0 * math.pi
    assert float(torch.fmod(_t(-1.0), two_pi)) == -1.0
    assert float(torch.remainder(_t(-1.0), two_pi)) == two_pi - 1.0
    tot = np.cumsum(np.random.RandomState(1).uniform(0.01, 0.4, 5000))
    np.testing.assert_array_equal(
        torch.fmod(_t(tot), two_pi).numpy(),
        np.asarray(jnp.mod(jnp.asarray(tot), two_pi)))
    np.testing.assert_array_equal(torch.fmod(_t(tot), two_pi).numpy(),
                                  np.fmod(tot, two_pi))


# the shapes on each side of the kernel's regime split (seqsum.plan: 132
# rows, LONG_N columns) and of its chunk edges (128 and 1,024 columns after
# the first)
CUMSUM_ROWS = (1, 2, 31, 33, 140, 280)
CUMSUM_LENGTHS = (1, 2, 575, 1025, 1207, 15325)


def _cumsum_data(rows, n, seed):
    """Rows of wide magnitudes (a reassociated sum differs in the last
    bits), by row: a leading run of -0.0 then +0.0 (the sums stay -0.0, then
    turn +0.0), subnormals only (exact sums), +inf then -inf (NaN after), a
    NaN, or none of these."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, n) * 10.0 ** rng.uniform(-8, 8, (rows, n))
    for r in range(rows):
        kind = r % 5
        if kind == 0:
            x[r, :min(n, 37)] = -0.0
            x[r, min(n - 1, 37)] = 0.0
        elif kind == 1:
            x[r] = rng.randint(-1000, 1000, n) * 5e-324
        elif kind == 2:
            x[r, n // 2] = np.inf
            x[r, (3 * n) // 4] = -np.inf
        elif kind == 3:
            x[r, n // 3] = np.nan
    return x


def _left_to_right(x):
    """Each row summed left to right, one rounding a step (a loop over the
    columns, every row at once)."""
    out = np.empty_like(x)
    acc = x[:, 0].copy()
    out[:, 0] = acc
    with np.errstate(invalid="ignore"):
        for i in range(1, x.shape[1]):
            acc = acc + x[:, i]
            out[:, i] = acc
    return out


def _same_bits(a, b):
    """Equal bit for bit (-0.0 apart from +0.0), NaN where NaN (any
    payload)."""
    na, nb = np.isnan(a), np.isnan(b)
    return (a.shape == b.shape and np.array_equal(na, nb)
            and np.array_equal(a[~na].view(np.int64), b[~nb].view(np.int64)))


@pytest.mark.parametrize("n", CUMSUM_LENGTHS)
@pytest.mark.parametrize("rows", CUMSUM_ROWS)
def test_cumsum_sequential_is_left_to_right(rows, n):
    """Bit-equal to a loop with one rounding per step, -0.0, +-inf, NaN and
    subnormals included, on data where a pairwise (reassociated) sum
    differs in the last bits."""
    x = _cumsum_data(rows, n, 1000 * rows + n)
    want = _left_to_right(x)
    got = seqsum.cumsum_sequential(_t(x)).numpy()
    assert _same_bits(got, want)
    if rows >= 31 and n >= 575:
        wide = [r for r in range(rows) if r % 5 in (0, 4)]
        assert not np.array_equal(got[wide, -1],
                                  np.sum(x[wide], axis=1))   # pairwise
    with pytest.raises(ValueError, match="float64"):
        seqsum.cumsum_sequential(torch.zeros(3, 4))
    one = seqsum.cumsum_sequential(_t(x[-1]))
    assert _same_bits(one.numpy(), want[-1])


# the path's launches (D4C and LinearSmoothing frames, a float64 chunk
# step's, the time base of t22, of the main batch and of 24.33 s)
PATH_CUMSUM_SHAPES = ((140, 575), (280, 1025), (2026, 1025), (1013, 575),
                      (1013, 1025), (1013, 1117), (1013, 1207), (1, 15325),
                      (8, 122791), (1, 536000))


def test_seq_cumsum_plan():
    """The kernel's launch plan: every row in exactly one block; in the
    rows regime a grid of at least min(n_rows, SMs) blocks; shared memory
    within the 227 KB a block can have and the 48 KB it takes without an
    attribute (so a CUDA graph can capture the launch); the long regime for
    fewer rows than SMs past LONG_N columns."""
    rng = np.random.RandomState(3)
    shapes = (PATH_CUMSUM_SHAPES
              + tuple((r, n) for r in CUMSUM_ROWS for n in CUMSUM_LENGTHS)
              + tuple(zip(rng.randint(1, 100_000, 40),
                          rng.randint(1, 600_000, 40))))
    for sms in (seqsum.SMS, 114, 8):
        for r, n in shapes:
            p = seqsum.plan(int(r), int(n), sms)
            blocks = [range(b * p.rows, min((b + 1) * p.rows, r))
                      for b in range(p.blocks)]
            assert sorted(i for blk in blocks for i in blk) == list(range(r))
            assert all(len(blk) > 0 for blk in blocks)
            assert p.regime == ("long" if r < sms and n > seqsum.LONG_N
                                else "rows")
            if p.regime == "rows":
                assert p.blocks >= min(r, sms)
                assert 1 <= p.rows <= seqsum.ROWS_MAX
            else:
                assert p.rows == 1 and p.blocks == r
            # what a block takes without a function attribute (of 227 KB)
            assert p.smem <= 48 * 1024
            assert p.chunk % 32 == 0          # a warp stays on one row
    got = {s: seqsum.plan(*s)[:4] for s in PATH_CUMSUM_SHAPES}
    assert got[(280, 1025)] == ("rows", 2, 128, 140)
    assert got[(2026, 1025)] == ("rows", 4, 128, 507)
    assert got[(140, 575)] == ("rows", 1, 128, 140)
    assert got[(1, 15325)] == ("long", 1, 1024, 1)
    assert got[(8, 122791)] == ("long", 1, 1024, 8)


def _kernel_model(x, sms):
    """csrc/seq_cumsum.cu's schedule in numpy, from seqsum.plan: blocks of
    ``rows`` rows; column 0 copied by the chain lane; columns 1..n-1 in
    chunks through a ring of S = STAGES stages of pitch chunk + PAD, loaded
    and stored by the producers' mapping (element e of a chunk: row e //
    chunk, column e % chunk); chunks 0..S-2 loaded first; the chain over
    chunk k in stage k % S while chunk k-1 is stored from, and chunk k+S-1
    loaded into, stage (k - 1) % S.  Returns (out, how many times each
    output was written); a stage starts as NaN, so a read of a value never
    loaded shows."""
    n_rows, n = x.shape
    p = seqsum.plan(n_rows, n, sms)
    C, P, S = p.chunk, p.chunk + seqsum.PAD, seqsum.STAGES
    out = np.full_like(x, np.nan)
    writes = np.zeros(x.shape, np.int64)
    m = n - 1
    n_chunks = -(-m // C)
    for b in range(p.blocks):
        r0 = b * p.rows
        nr = min(p.rows, n_rows - r0)
        smem = np.full((S, p.rows * P), np.nan)
        e = np.arange(nr * C)
        row, col = e // C, e % C

        def moved(k):
            ok = 1 + k * C + col < n
            return row[ok], col[ok], 1 + k * C + col[ok]

        def load(k, s):
            rw, cl, j = moved(k)
            smem[s, rw * P + cl] = x[r0 + rw, j]

        def store(k, s):
            rw, cl, j = moved(k)
            out[r0 + rw, j] = smem[s, rw * P + cl]
            np.add.at(writes, (r0 + rw, j), 1)

        acc = x[r0:r0 + nr, 0].copy()
        out[r0:r0 + nr, 0] = acc
        writes[r0:r0 + nr, 0] += 1
        for k in range(min(S - 1, n_chunks)):
            load(k, k)
        for k in range(n_chunks):
            s, free = k % S, (k - 1) % S
            # the stage refilled is neither the chain's nor one in flight
            assert free not in {(k + i) % S for i in range(S - 1)}
            lanes = np.arange(nr) * P
            for c in range(min(C, m - k * C)):
                acc = acc + smem[s, lanes + c]
                smem[s, lanes + c] = acc
            if k > 0:
                store(k - 1, free)
            if k + S - 1 < n_chunks:
                load(k + S - 1, free)
        if n_chunks:
            store(n_chunks - 1, (n_chunks - 1) % S)
    return out, writes


@pytest.mark.parametrize("rows,n,sms", [
    (40, 300, 4),      # rows regime, 10 rows a block, a partial last chunk
    (9, 257, 4),       # 2 rows a block, a last block of one, full chunks
    (3, 5000, 4),      # long regime, a partial fifth chunk
    (5, 1, 4),         # no chunk: column 0 alone
    (2, 129, 132),     # one full chunk
    (1, 2, 132)])
def test_seq_cumsum_kernel_model(rows, n, sms):
    """The kernel's schedule (stages, chunks, the producers' mapping)
    writes every output once and equals numpy.cumsum bit for bit."""
    x = np.random.RandomState(rows + n).randn(rows, n) * 10.0 ** 4
    out, writes = _kernel_model(x, sms)
    assert (writes == 1).all()
    assert _same_bits(out, np.cumsum(x, axis=-1))


# ---------------------------------------------------------------------------
# interp, misc
# ---------------------------------------------------------------------------

def test_interp1_n_valid_matches_jax_and_cpp():
    """histc edge semantics with a valid-knot count, shared and per-row
    knots: equal to JAX float64 (same operations in the same order: exact),
    and to the C++ probe at its tolerance (rtol 1e-10)."""
    d = ProbeOps.load()
    got = TI.interp1(_t(d["xk"]), _t(d["yk"]), _t(d["xq"]))
    np.testing.assert_allclose(got.numpy(), d["yq"], rtol=1e-10, atol=1e-13)
    rng = np.random.RandomState(3)
    x = np.sort(rng.uniform(0, 10, (4, 15)), axis=1)
    x[:, 11:] = np.inf                       # padded past the valid knots
    y = rng.randn(4, 15)
    xi = np.concatenate([[-1.0, 12.0], x[0, 2:5], rng.uniform(0, 10, 40)])
    n_valid = np.array([11, 7, 2, 9])
    got = TI.interp1(_t(x), _t(y), _t(xi), n_valid=torch.tensor(n_valid))
    for r in range(4):
        ref = JI.interp1(jnp.asarray(x[r]), jnp.asarray(y[r]),
                         jnp.asarray(xi), n_valid=int(n_valid[r]))
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(ref))
    one = TI.interp1(_t(x[0]), _t(y[:1]), _t(xi), n_valid=11)
    np.testing.assert_array_equal(one[0].numpy(), got[0].numpy())
    # rows without a segment give values without meaning, never an error
    TI.interp1(_t(x), _t(y), _t(xi), n_valid=torch.tensor([1, 0, 11, 11]))


def test_interp1q_matches_jax_and_cpp():
    d = ProbeOps.load()
    got = TI.interp1q(-1.0, 0.37, _t(d["yk"]), _t(d["xq"])).numpy()
    ref = np.asarray(JI.interp1q(-1.0, 0.37, jnp.asarray(d["yk"]),
                                 jnp.asarray(d["xq"])))
    np.testing.assert_array_equal(got, ref)
    ok = ((d["xq"] + 1.0) / 0.37).astype(int) <= len(d["yk"]) - 1
    np.testing.assert_allclose(got[ok], d["yi_q"][ok], rtol=1e-10,
                               atol=1e-13)
    # a negative step (as DCCorrection uses it) and truncation toward zero
    xq = np.linspace(-3.0, 3.0, 41)
    got = TI.interp1q(2.0, -0.37, _t(d["yk"]), _t(xq)).numpy()
    ref = np.asarray(JI.interp1q(2.0, -0.37, jnp.asarray(d["yk"]),
                                 jnp.asarray(xq)))
    np.testing.assert_array_equal(got, ref)


def test_misc_matches_jax():
    rng = np.random.RandomState(4)
    x, h = rng.randn(100), rng.randn(17)
    # two FFT libraries: 1e-12 of the output's scale
    got = TM.fast_fftfilt(_t(x), _t(h), 256).numpy()
    ref = np.asarray(JM.fast_fftfilt(jnp.asarray(x), jnp.asarray(h), 256))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    full = np.convolve(x, h)
    np.testing.assert_allclose(got[:len(full)] * 256, full, atol=1e-10)
    # one reduction in another order: 1e-14 relative
    np.testing.assert_allclose(float(TM.matlab_std(_t(x))),
                               float(JM.matlab_std(jnp.asarray(x))),
                               rtol=1e-14)
    np.testing.assert_allclose(float(TM.matlab_std(_t(x))),
                               np.std(x, ddof=1), rtol=1e-13)
    y = rng.randn(3, 8)
    np.testing.assert_array_equal(TM.fftshift(_t(y)).numpy(),
                                  np.asarray(JM.fftshift(jnp.asarray(y))))
    np.testing.assert_array_equal(TM.diff(_t(y)).numpy(),
                                  np.asarray(JM.diff(jnp.asarray(y))))
    edges = np.sort(rng.uniform(0, 10, 12))
    q = np.concatenate([[-1.0, 11.0], edges[3:6], rng.uniform(0, 10, 20)])
    np.testing.assert_array_equal(
        TM.histc(_t(edges), _t(q)).numpy(),
        np.asarray(JM.histc(jnp.asarray(edges), jnp.asarray(q))))


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def test_nuttall_window_ragged():
    d = ProbeOps.load()
    got = TF.nuttall_window_ragged(129, 200).numpy()
    np.testing.assert_allclose(got[:129], d["nuttall"], rtol=1e-12,
                               atol=1e-15)
    assert np.all(got[129:] == 0.0)
    lens = np.array([129, 5, 200, 33])
    rows = TF.nuttall_window_ragged(torch.tensor(lens), 200).numpy()
    for r, n in enumerate(lens):
        ref = np.asarray(JF.nuttall_window_ragged(int(n), 200))
        # the same cosines of the same arguments: 2 ulp
        np.testing.assert_allclose(rows[r], ref, rtol=0, atol=5e-16)


def test_biquad_zero_lag_matches_direct_and_jax(monkeypatch):
    """The port runs the recurrence in order (C helper or Python loop, the
    same bits): exact against a direct loop; JAX's associative scan
    reassociates, so 1e-9 relative against it (its own test's tolerance)."""
    rng = np.random.RandomState(2)
    x = rng.randn(400)
    b = (0.0078202080334971724, 0.015640416066994345)
    a = (1.7347257688092754, -0.76600660094326412)

    def fwd(sig):
        w = [0.0, 0.0]
        out = np.empty_like(sig)
        for i in range(len(sig)):
            wt = sig[i] + a[0] * w[0] + a[1] * w[1]
            out[len(sig) - i - 1] = b[0] * wt + b[1] * w[0] + b[0] * w[1]
            w = [wt, w[0]]
        return out

    want = fwd(fwd(x.copy()))
    got = TF.biquad_zero_lag(_t(x), a, b).numpy()
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(tnative, "filter_f0", lambda *args: None)
    np.testing.assert_array_equal(TF.biquad_zero_lag(_t(x), a, b).numpy(),
                                  want)
    ref = np.asarray(JF.biquad_zero_lag(jnp.asarray(x), a, b))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)


def test_decimate_f64_all_ratios():
    """The blocked-matmul IIR in float64 against the C++ probe (its
    sequential loop: rtol 1e-9, worldtpu's own tolerance) and JAX float64
    (the same matmuls by another BLAS: 1e-13 of the signal's scale)."""
    d = ProbeOps.load()
    for r in range(2, 13):
        got = TF.decimate(_t(d["x"])[None], r)[0].numpy()
        want = d["decimate"][r]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                                   err_msg=f"ratio {r}")
        ref = np.asarray(JF.decimate(jnp.asarray(d["x"]), r))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-13 * np.abs(ref).max())


def test_dc_correction_and_linear_smoothing_f64_cpp_probe():
    """The literal float64 forms against the C++ probe, at worldtpu's own
    tolerances (test_ops.py): dc 1e-12, smoothing and the chain 1e-10."""
    d = ProbeOps.load()
    ps = _t(_probe_power_spectrum(257))[None]
    got = TF.dc_correction(ps, _t([160.0]), 16000, 512)[0].numpy()
    upper = 2 + int(160.0 * 512 / 16000)
    np.testing.assert_allclose(got[:upper - 1], d["dc_corr"][:upper - 1],
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(got[upper - 1:], ps[0, upper - 1:].numpy())
    width = 160.0 * 2.0 / 3.0
    max_b = int(width * 512 / 16000) + 1
    got = TF.linear_smoothing(ps, _t([width]), 16000, 512, max_b)[0].numpy()
    np.testing.assert_allclose(got, d["lin_smooth"], rtol=1e-10, atol=1e-13)
    c = TF.dc_correction_frames(ps, _t([123.4]), 16000, 512, 1000.0)
    width = 123.4 * 2.0 / 3.0
    c = TF.linear_smoothing_frames(c, _t([width]), 16000, 512,
                                   int(width * 512 / 16000) + 1)
    np.testing.assert_allclose(c[0].numpy(), d["chain"], rtol=1e-10,
                               atol=1e-13)


@pytest.mark.parametrize("fs, fft_size", [(22050, 2048), (16000, 1024)])
def test_dc_correction_and_linear_smoothing_f64_match_jax(fs, fft_size):
    """Per-frame f0 and widths against JAX's vmapped literal forms: the
    same operations in the same order, and a strictly sequential
    integration on both sides: exact."""
    rng = np.random.RandomState(5)
    N, K = 9, fft_size // 2 + 1
    ps = np.abs(rng.randn(N, K)) * 10.0 ** rng.uniform(-6, 0, (N, K)) + 1e-9
    f0 = 60 + 700 * rng.rand(N)
    ref = jax.vmap(lambda p, f: JF.dc_correction(p, f, fs, fft_size))(
        jnp.asarray(ps), jnp.asarray(f0))
    got = TF.dc_correction_frames(_t(ps), _t(f0), fs, fft_size, 960.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    w = f0 * 2.0 / 3.0
    mb = int(w.max() * fft_size / fs) + 2
    ref = JF.linear_smoothing_frames(jnp.asarray(ps), jnp.asarray(w), fs,
                                     fft_size, mb)
    got = TF.linear_smoothing_frames(_t(ps), _t(w), fs, fft_size, mb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
