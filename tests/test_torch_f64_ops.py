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


def test_cumsum_sequential_is_left_to_right():
    """Bit-equal to a Python loop with one rounding per step, on data where
    a pairwise (reassociated) sum differs in the last bits."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4001) * 10.0 ** rng.uniform(-8, 8, (3, 4001))
    want = np.empty_like(x)
    for r in range(3):
        acc = 0.0
        for i, v in enumerate(x[r]):
            acc = v if i == 0 else v + acc
            want[r, i] = acc
    got = seqsum.cumsum_sequential(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == x.shape
    assert not np.array_equal(got[:, -1], np.sum(x, axis=1))   # pairwise
    with pytest.raises(ValueError, match="float64"):
        seqsum.cumsum_sequential(torch.zeros(3, 4))
    one = seqsum.cumsum_sequential(_t(x[0]))
    np.testing.assert_array_equal(one.numpy(), want[0])


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
