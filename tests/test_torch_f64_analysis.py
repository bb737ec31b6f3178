"""The port's float64 CheapTrick and D4C on the CPU against the C++ golden
dumps (tests/fixtures/t*.spec.gz, t*.ap.gz), without dither and with the
port's own xorshift dither streams, at the tolerances of
tests/test_cheaptrick.py and tests/test_d4c.py; and against the JAX package
in float64 on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from worldtpu.analysis import cheaptrick as JC
from worldtpu.analysis import d4c as JD
from worldtpu_torch import api
from worldtpu_torch.analysis import d4c as TD
from worldtpu_torch.analysis import dither as D
from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel

torch.set_num_threads(1)


def _inputs(f):
    return (torch.tensor(f.x)[None], torch.tensor(f.f0)[None],
            torch.tensor(f.tpos))


def _b(a):
    return torch.tensor(a)[None]


@pytest.mark.parametrize("name", ["t16", "t48", "t22"])
def test_f64_cheaptrick_vs_cpp(name):
    """Without dither the agreement is limited by the reference's ~1e-15
    randn dither (q99.9 < 1e-6, max < 1e-3 relative); with the exact
    stream it is limited by the FFT library (q99.9 < 5e-12, max < 2e-8)."""
    f = load_fixture(name)
    kern = CheapTrickKernel(f.fs, f0_floor=71.0)
    assert kern.fft_size == f.fft_size
    x, f0, tpos = _inputs(f)
    got = kern(x, f0, tpos)[0].numpy()
    assert got.dtype == np.float64
    rel = np.abs(got - f.spec) / (np.abs(f.spec) + 1e-20)
    assert np.quantile(rel, 0.999) < 1e-6 and rel.max() < 1e-3, rel.max()
    wd, sd, _ = D.cheaptrick_dither(f.f0, f.fs, kern.fft_size,
                                    kern.max_half_window)
    got = kern(x, f0, tpos, window_dither=_b(wd),
               spectrum_dither=_b(sd))[0].numpy()
    rel = np.abs(got - f.spec) / (np.abs(f.spec) + 1e-300)
    assert np.quantile(rel, 0.999) < 5e-12, np.quantile(rel, 0.999)
    assert rel.max() < 2e-8, rel.max()
    if name == "t22":      # the facade passes the dithers through
        got2 = api.CheapTrick(f.fs, device="cpu").compute(
            f.x, f.tpos, f.f0, dtype=torch.float64, window_dither=wd,
            spectrum_dither=sd).numpy()
        np.testing.assert_array_equal(got2, got)


@pytest.mark.parametrize("name", ["t16", "t48", "t22"])
def test_f64_d4c_vs_cpp(name):
    """Aperiodicity lies in (0, 1]: absolute error.  Without dither q99.9 <
    1e-6, max < 1e-3; with the exact stream, continued from CheapTrick's
    draws and gated by the LoveTrain ratio as the reference's call order
    has it, max < 1e-10."""
    f = load_fixture(name)
    x, f0, tpos = _inputs(f)
    got = TD.d4c_frames(x, f0, tpos, fs=f.fs,
                        fft_size_out=f.fft_size)[0].numpy()
    err = np.abs(got - f.ap)
    assert np.quantile(err, 0.999) < 1e-6 and err.max() < 1e-3, err.max()

    kern = CheapTrickKernel(f.fs, f0_floor=71.0)
    _, _, gen = D.cheaptrick_dither(f.f0, f.fs, kern.fft_size,
                                    kern.max_half_window)
    lt, gen = D.d4c_love_train_dither(f.f0, f.fs, TD.d4c_max_half_lt(f.fs),
                                      gen)
    ap0 = TD.love_train_ap0(x, f0, tpos, fs=f.fs, lt_dither=_b(lt))[0].numpy()
    active = (f.f0 != 0) & (ap0 > 0.85)
    c1, c2, h, gen = D.d4c_body_dither(f.f0, active, f.fs,
                                       TD.d4c_max_half_c(f.fs), gen)
    kw = dict(lt_dither=lt, c1_dither=c1, c2_dither=c2, h_dither=h)
    got = TD.d4c_frames(x, f0, tpos, fs=f.fs, fft_size_out=f.fft_size,
                        **{k: _b(v) for k, v in kw.items()})[0].numpy()
    err = np.abs(got - f.ap)
    assert err.max() < 1e-10, f"max abs err {err.max()}"
    if name == "t22":
        got2 = api.D4C(f.fs, device="cpu").compute(
            f.x, f.tpos, f.f0, f.fft_size, dtype=torch.float64, **kw).numpy()
        np.testing.assert_array_equal(got2, got)


def test_f64_analysis_matches_jax():
    """CheapTrick, the LoveTrain ratio and D4C in float64 against JAX
    float64 on t22.  CheapTrick: the same literal operations around two
    FFT libraries, 1e-9 relative.  D4C: JAX's float64 path without dither
    takes its gather-free centroid with rotated cosines where the port
    stays literal, 1e-7 absolute (both within 1e-8 of the C++)."""
    f = load_fixture("t22")
    x, f0, tpos = _inputs(f)
    jx, jf0, jt = jnp.asarray(f.x), jnp.asarray(f.f0), jnp.asarray(f.tpos)
    kern = CheapTrickKernel(f.fs, f0_floor=71.0)
    got = kern(x, f0, tpos)[0].numpy()
    ref = np.asarray(JC.CheapTrickKernel(f.fs, f0_floor=71.0)(jx, jf0, jt))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    ap0 = TD.love_train_ap0(x, f0, tpos, fs=f.fs)[0].numpy()
    jap0 = np.asarray(JD.love_train_ap0(jx, jf0, jt, fs=f.fs))
    np.testing.assert_allclose(ap0, jap0, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(ap0 > 0.85, jap0 > 0.85)
    got = TD.d4c_frames(x, f0, tpos, fs=f.fs,
                        fft_size_out=f.fft_size)[0].numpy()
    ref = np.asarray(JD.d4c_frames(jx, jf0, jt, fs=f.fs,
                                   fft_size_out=f.fft_size))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    assert ((got > 0) & (got <= 1.0)).all()


def test_f64_cheaptrick_frame_past_the_signal():
    """A frame whose origin lies at or past the last sample reads the
    literal clipped gather in float64 (x[clip(origin + offset)]), as JAX's
    float64 path does: t16's last frame sits exactly on sample T."""
    f = load_fixture("t16")
    assert round(f.tpos[-1] * f.fs) >= len(f.x)
    kern = CheapTrickKernel(f.fs, f0_floor=71.0)
    sel = slice(len(f.f0) - 3, len(f.f0))
    f0 = np.full(3, 220.0)
    got = kern(torch.tensor(f.x)[None], torch.tensor(f0)[None],
               torch.tensor(f.tpos[sel]))[0].numpy()
    ref = np.asarray(JC.CheapTrickKernel(f.fs, f0_floor=71.0)(
        jnp.asarray(f.x), jnp.asarray(f0), jnp.asarray(f.tpos[sel])))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)


def test_dithers_are_float64_only():
    f = load_fixture("t22")
    x = torch.tensor(f.x, dtype=torch.float32)[None]
    f0 = torch.tensor(f.f0, dtype=torch.float32)[None]
    with pytest.raises(ValueError, match="float64"):
        TD.d4c_frames(x, f0, torch.tensor(f.tpos), fs=f.fs,
                      fft_size_out=f.fft_size,
                      lt_dither=torch.zeros(1, len(f.f0), 3))
