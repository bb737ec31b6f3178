"""The port's parameter codec (worldtpu_torch.codec) against the JAX
package's (worldtpu.codec, x64 on the CPU) on identical numpy inputs, and in
float64 against the C++ codec dumps t{16,22,48}.codec.gz at the tolerances
of tests/test_codec.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from worldtpu import codec as J
from worldtpu_torch import codec as T

torch.set_num_threads(1)

FIXTURES = ("t16", "t22", "t48")

# float64, port against JAX: the largest absolute difference over the
# largest magnitude of the JAX result (coded values cross zero, so an
# elementwise relative measure has no meaning there); decoded spectra are
# positive and held elementwise
F64_REL = 1e-12
# float32, port against JAX (measured on these inputs: coded aperiodicity
# 7.6e-6 dB, decoded aperiodicity 6.6e-7 relative, coded envelope 5e-6 of
# its largest magnitude, decoded envelope 2.8e-5 relative on the fixtures
# and 2.8e-4 on random cepstra of magnitude 5): the two sides differ in
# their float32 log/exp/pow and in their FFT libraries (pocketfft and
# ducc), whose roundings the decoded envelope's exponent env / max_dim
# carries from terms as large as |coded| * sqrt(fft_size * max_dim)
F32_AP_DB_ATOL = 2e-5      # dB
F32_DEC_AP_RTOL = 5e-6
F32_CODED_SPEC_REL = 2e-5  # of the largest magnitude
F32_DEC_SPEC_RTOL = 1e-3


def _t(a):
    return torch.tensor(a, device="cpu")


def _rel_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _unvoiced(coded):
    return np.asarray(coded).mean(axis=-1) > -0.5


@pytest.mark.parametrize("name", FIXTURES)
def test_codec_f64_against_cpp_dumps(name):
    """The four functions on the C++ analysis of each fixture against the
    C++ codec's output, at tests/test_codec.py's tolerances."""
    f = load_fixture(name)
    kw = dict(fs=f.fs, fft_size=f.fft_size)
    assert T.get_number_of_aperiodicities(f.fs) == f.n_ap
    coded = T.code_aperiodicity(_t(f.ap), **kw).numpy()
    np.testing.assert_allclose(coded, f.coded_ap, rtol=1e-10, atol=1e-10)
    dec = T.decode_aperiodicity(_t(f.coded_ap), **kw).numpy()
    np.testing.assert_allclose(dec, f.decoded_ap, rtol=1e-10, atol=1e-12)
    cs = T.code_spectral_envelope(_t(f.spec), n_dims=f.ndim_se, **kw)
    np.testing.assert_allclose(cs.numpy(), f.coded_spec, rtol=1e-9,
                               atol=1e-10)
    ds = T.decode_spectral_envelope(_t(f.coded_spec), n_dims=f.ndim_se,
                                    **kw).numpy()
    rel = np.abs(ds - f.decoded_spec) / (np.abs(f.decoded_spec) + 1e-20)
    assert rel.max() < 1e-8, f"max rel err {rel.max()}"
    assert cs.dtype == torch.float64 and cs.device.type == "cpu"


@pytest.mark.parametrize("name", FIXTURES)
def test_codec_f64_matches_jax(name):
    """float64 on the fixtures' spectra and aperiodicity: each function
    against worldtpu.codec at 1e-12 relative, the unvoiced rule on the
    same rows."""
    f = load_fixture(name)
    kw = dict(fs=f.fs, fft_size=f.fft_size)
    n = f.ndim_se
    ca = T.code_aperiodicity(_t(f.ap), **kw).numpy()
    cj = np.asarray(J.code_aperiodicity(jnp.asarray(f.ap), **kw))
    assert _rel_max(ca, cj) <= F64_REL
    da = T.decode_aperiodicity(_t(cj), **kw).numpy()
    dj = np.asarray(J.decode_aperiodicity(jnp.asarray(cj), **kw))
    np.testing.assert_allclose(da, dj, rtol=F64_REL, atol=0)
    cs = T.code_spectral_envelope(_t(f.spec), n_dims=n, **kw).numpy()
    csj = np.asarray(J.code_spectral_envelope(jnp.asarray(f.spec),
                                              n_dims=n, **kw))
    assert _rel_max(cs, csj) <= F64_REL
    ds = T.decode_spectral_envelope(_t(csj), n_dims=n, **kw).numpy()
    dsj = np.asarray(J.decode_spectral_envelope(jnp.asarray(csj),
                                                n_dims=n, **kw))
    np.testing.assert_allclose(ds, dsj, rtol=F64_REL, atol=0)


@pytest.mark.parametrize("name", FIXTURES)
def test_codec_f32_matches_jax(name):
    """float32 on the fixtures' spectra and aperiodicity (cast from the
    dumps): each function against worldtpu.codec in float32 at the stated
    tolerances, and 0 rows where the two disagree on the unvoiced rule."""
    f = load_fixture(name)
    kw = dict(fs=f.fs, fft_size=f.fft_size)
    n = f.ndim_se
    ap, spec = f.ap.astype(np.float32), f.spec.astype(np.float32)
    ca = T.code_aperiodicity(_t(ap), **kw)
    assert ca.dtype == torch.float32
    cj = np.asarray(J.code_aperiodicity(jnp.asarray(ap), **kw))
    np.testing.assert_allclose(ca.numpy(), cj, rtol=0, atol=F32_AP_DB_ATOL)
    da = T.decode_aperiodicity(_t(cj), **kw).numpy()
    dj = np.asarray(J.decode_aperiodicity(jnp.asarray(cj), **kw))
    flips = int((_unvoiced(ca.numpy()) != _unvoiced(cj)).sum())
    assert flips == 0
    np.testing.assert_allclose(da, dj, rtol=F32_DEC_AP_RTOL, atol=0)
    cs = T.code_spectral_envelope(_t(spec), n_dims=n, **kw).numpy()
    csj = np.asarray(J.code_spectral_envelope(jnp.asarray(spec), n_dims=n,
                                              **kw))
    assert _rel_max(cs, csj) <= F32_CODED_SPEC_REL
    ds = T.decode_spectral_envelope(_t(csj), n_dims=n, **kw).numpy()
    dsj = np.asarray(J.decode_spectral_envelope(jnp.asarray(csj), n_dims=n,
                                                **kw))
    np.testing.assert_allclose(ds, dsj, rtol=F32_DEC_SPEC_RTOL, atol=0)


def _random_case(seed, F=240, fs=22050, fft_size=1024):
    """Seeded [F, K] aperiodicity and spectrum; coded aperiodicity whose
    first 60 rows have means within 1e-3 dB of the -0.5 dB unvoiced
    threshold (on both sides) and the rest spread over [-40, 0] dB."""
    rng = np.random.RandomState(seed)
    K = fft_size // 2 + 1
    n_ap = T.get_number_of_aperiodicities(fs)
    ap = (10.0 ** rng.uniform(-3.0, 0.0, (F, K))).astype(np.float32)
    spec = (10.0 ** rng.uniform(-8.0, 0.0, (F, K))).astype(np.float32)
    coded = rng.uniform(-40.0, 0.0, (F, n_ap))
    coded[:60] = -0.5 + rng.uniform(-1e-3, 1e-3, (60, 1))
    return dict(fs=fs, fft_size=fft_size), ap, spec, coded.astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_codec_random_matches_jax(dtype):
    """A seeded random [F, K] through both packages: coded and decoded
    aperiodicity (with rows at the unvoiced rule's edge: 0 disagreements)
    and the coded envelope at n_dims 1, 31 (odd) and max_dim / 2 + 1 (the
    widest the rfft gives)."""
    kw, ap, spec, coded = _random_case(5)
    ap, spec, coded = ap.astype(dtype), spec.astype(dtype), \
        coded.astype(dtype)
    f32 = dtype == np.float32
    ca = T.code_aperiodicity(_t(ap), **kw).numpy()
    cj = np.asarray(J.code_aperiodicity(jnp.asarray(ap), **kw))
    if f32:
        np.testing.assert_allclose(ca, cj, rtol=0, atol=F32_AP_DB_ATOL)
    else:
        assert _rel_max(ca, cj) <= F64_REL
    da = T.decode_aperiodicity(_t(coded), **kw).numpy()
    dj = np.asarray(J.decode_aperiodicity(jnp.asarray(coded), **kw))
    uv_t, uv_j = (da == dtype(1.0 - 1e-12)).all(1), \
        (dj == dtype(1.0 - 1e-12)).all(1)
    assert 10 < int(uv_j[:60].sum()) < 50       # both sides of the edge
    assert int((uv_t != uv_j).sum()) == 0
    np.testing.assert_allclose(da, dj, rtol=F32_DEC_AP_RTOL if f32
                               else F64_REL, atol=0)
    for n in (1, 31, kw["fft_size"] // 4 + 1):
        cs = T.code_spectral_envelope(_t(spec), n_dims=n, **kw).numpy()
        csj = np.asarray(J.code_spectral_envelope(jnp.asarray(spec),
                                                  n_dims=n, **kw))
        assert cs.shape == (spec.shape[0], n)
        assert _rel_max(cs, csj) <= (F32_CODED_SPEC_REL if f32 else F64_REL)


@pytest.mark.parametrize("n_dims", [31, 511, 512])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decode_envelope_widths_match_jax(n_dims, dtype):
    """decode_spectral_envelope at an odd n_dims and at n_dims up to
    max_dim (the whole complex input filled): the unpacking of the FFT's
    second half, reversed (torch.flip in the port, a negative-step slice
    in JAX), on seeded random cepstra."""
    rng = np.random.RandomState(n_dims)
    kw = dict(fs=22050, fft_size=1024)
    c = (5.0 * rng.uniform(-1.0, 1.0, (64, n_dims))
         * np.exp(-np.arange(n_dims) / 20.0)).astype(dtype)
    ds = T.decode_spectral_envelope(_t(c), n_dims=n_dims, **kw).numpy()
    dsj = np.asarray(J.decode_spectral_envelope(jnp.asarray(c),
                                                n_dims=n_dims, **kw))
    assert ds.shape == (64, 513) and ds.dtype == dtype
    np.testing.assert_allclose(
        ds, dsj, rtol=F32_DEC_SPEC_RTOL if dtype == np.float32 else F64_REL,
        atol=0)


def test_codec_batch_flattens_and_stays_on_its_device():
    """A [B, F, K] batch flattened to [B*F, K] codes row for row as its
    utterances do one by one; outputs stay on the input's device and in
    its dtype; numpy input raises (the codec computes where its tensor
    lies and picks no device)."""
    f = load_fixture("t22")
    kw = dict(fs=f.fs, fft_size=f.fft_size)
    spec = np.stack([f.spec, 0.5 * f.spec]).astype(np.float32)
    flat = T.code_spectral_envelope(_t(spec.reshape(-1, spec.shape[-1])),
                                    n_dims=f.ndim_se, **kw)
    one = T.code_spectral_envelope(_t(spec[1]), n_dims=f.ndim_se, **kw)
    np.testing.assert_array_equal(flat.numpy()[len(f.spec):], one.numpy())
    assert flat.device.type == "cpu" and flat.dtype == torch.float32
    dec = T.decode_aperiodicity(
        T.code_aperiodicity(_t(f.ap), **kw), **kw)
    assert dec.device.type == "cpu" and dec.dtype == torch.float64
    with pytest.raises(TypeError, match="torch.Tensor"):
        T.code_aperiodicity(f.ap, **kw)
    with pytest.raises(TypeError, match="torch.Tensor"):
        T.decode_spectral_envelope(f.coded_spec, n_dims=f.ndim_se, **kw)
