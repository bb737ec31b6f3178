"""The port's DSP primitives against the JAX package's, f32, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are f32 round-off scaled to each quantity (stated per test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldtpu.ops import dft as JD
from worldtpu.ops import fftutil as JU
from worldtpu.ops import filters as JF
from worldtpu.ops import interp as JI
from worldtpu.ops import trig as JT
from worldtpu_torch.ops import dft as TD
from worldtpu_torch.ops import fftutil as TU
from worldtpu_torch.ops import filters as TF
from worldtpu_torch.ops import interp as TI
from worldtpu_torch.ops import trig as TT
from worldtpu_torch.ops.numeric import matlab_round, rdiv

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_interp1_histc_edges():
    rng = np.random.RandomState(0)
    x = np.sort(rng.uniform(0, 10, 12)).astype(np.float32)
    y = rng.randn(3, 12).astype(np.float32)
    # queries outside, on interior knots and between
    xi = np.concatenate([[-1.0, 11.0], x[3:6], rng.uniform(0, 10, 20)]
                        ).astype(np.float32)
    ref = np.stack([np.asarray(JI.interp1(jnp.asarray(x), jnp.asarray(r),
                                          jnp.asarray(xi))) for r in y])
    out = TI.interp1(_t(x), _t(y), _t(xi)).numpy()
    # one f32 division and two products: a few ulp of |y|
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("second", [False, True])
def test_cos_affine(second):
    rng = np.random.RandomState(1)
    alpha = rng.uniform(1e-4, 0.05, 7).astype(np.float32)
    beta = rng.uniform(-3, 3, 7).astype(np.float32)
    ref = JT.cos_affine(jnp.asarray(alpha), jnp.asarray(beta), 300,
                        second=second)
    out = TT.cos_affine(_t(alpha), _t(beta), 300, second=second)
    if not second:
        ref, out = (ref,), (out,)
    for r, o in zip(ref, out):
        # seeds from f32 cos/sin of the same arguments: ~1e-6 absolute
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-6)


def test_dft_roundtrip_and_real():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 100).astype(np.float32)
    for n in (128, 256):
        ref = np.asarray(JD.rfft(jnp.asarray(x), n=n))
        out = TD.rfft(_t(x), n=n).numpy()
        # f32 FFTs of O(10)-magnitude sums: 1e-5 absolute
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(TD.rfft_real(_t(x), n=n).numpy(),
                                   ref.real, atol=1e-4, rtol=1e-5)
        back = TD.irfft(TD.rfft(_t(x), n=n), n=n).numpy()[:, :100]
        np.testing.assert_allclose(back, x, atol=1e-5)


def test_minimum_phase():
    rng = np.random.RandomState(3)
    logamp = (0.3 * rng.randn(5, 129)).astype(np.float32)
    ref = np.asarray(JU.minimum_phase(jnp.asarray(logamp)))
    out = TU.minimum_phase(_t(logamp)).numpy()
    # exp of f32 FFT round-trips of O(1) values
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert TU.get_suitable_fft_size(1000) == JU.get_suitable_fft_size(1000)
    assert TU.fft_size_for_cheaptrick(22050, 71.0) == \
        JU.fft_size_for_cheaptrick(22050, 71.0)


def test_nuttall_window():
    ref = np.asarray(JF.nuttall_window(557, jnp.float32))
    out = TF.nuttall_window(557).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("ratio", [2, 3, 6])
def test_decimate(ratio):
    rng = np.random.RandomState(4)
    x = (0.5 * np.sin(np.arange(3001) * 0.03)
         + 0.05 * rng.randn(3001)).astype(np.float32)
    ref = np.asarray(JF.decimate(jnp.asarray(x), ratio))
    out = TF.decimate(_t(x)[None], ratio)[0].numpy()
    assert out.shape == ref.shape
    # blocked f32 matmuls in another summation order: 1e-6 of |x| ~ 1
    np.testing.assert_allclose(out, ref, atol=2e-6)


def test_iir_affine_scan_matches_recurrence():
    """The blocked-matmul IIR equals the sequential recurrence (f64 loop)."""
    a, b = TF._DECIMATE_COEFFS[3]
    x = np.random.RandomState(5).randn(700)
    w = [0.0, 0.0, 0.0]
    ref = []
    for v in x:
        wt = v + a[0] * w[0] + a[1] * w[1] + a[2] * w[2]
        ref.append(b[0] * wt + b[1] * w[0] + b[1] * w[1] + b[0] * w[2])
        w = [wt, w[0], w[1]]
    out = TF.iir_affine_scan(_t(x.astype(np.float32))[None], a, b)[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_dc_correction_and_linear_smoothing():
    rng = np.random.RandomState(6)
    fs, fft = 16000, 1024
    K = fft // 2 + 1
    p = np.exp(rng.randn(6, K)).astype(np.float32)
    f0 = rng.uniform(80, 400, 6).astype(np.float32)
    ref = np.asarray(JF.dc_correction_frames(jnp.asarray(p), jnp.asarray(f0),
                                             fs, fft, 960.0))
    out = TF.dc_correction_frames(_t(p), _t(f0), fs, fft, 960.0).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    mb = int(2.0 * 1.2 * 800.0 / 3.0 * fft / fs) + 2
    w = f0 * 2.0 / 3.0
    ref = np.asarray(JF.linear_smoothing_frames(jnp.asarray(p),
                                                jnp.asarray(w), fs, fft, mb))
    out = TF.linear_smoothing_frames(_t(p), _t(w), fs, fft, mb).numpy()
    # positive accumulation of ~20 f32 terms: relative 1e-5
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_numeric_helpers():
    t = torch.tensor([3.0, 7.0, 11.0])
    np.testing.assert_array_equal(
        rdiv(1.0, t).numpy(),
        (np.float32(1.0) / np.array([3, 7, 11], np.float32)))
    x = torch.tensor([-1.5, -0.5, 0.5, 1.5, 2.4])
    assert matlab_round(x).tolist() == [-2, -1, 1, 2, 2]
