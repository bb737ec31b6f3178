"""The port's CheapTrick, D4C and synthesis (with the OLA wrapper's plain
version) against the JAX package on the t16 fixture, f32, given the
fixture's F0.  Noise is made with numpy from a seed and given to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from worldtpu.analysis.cheaptrick import CheapTrickKernel
from worldtpu.analysis.d4c import d4c_frames
from worldtpu.parallel import batch as JB
from worldtpu.synthesis import synthesis as S
from worldtpu_torch import convert
from worldtpu_torch.analysis import cheaptrick as TC
from worldtpu_torch.analysis import d4c as TD
from worldtpu_torch.parallel import batch as TB
from worldtpu_torch.synthesis import synthesis as TS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def t16():
    f = load_fixture("t16")
    x = np.asarray(f.x, np.float32)
    f0 = np.asarray(f.f0, np.float32)
    tpos = np.asarray(f.tpos, np.float32)
    ck = CheapTrickKernel(f.fs)
    spec = np.asarray(ck(jnp.asarray(x), jnp.asarray(f0), jnp.asarray(tpos)))
    ap = np.asarray(d4c_frames(jnp.asarray(x), jnp.asarray(f0),
                               jnp.asarray(tpos), fs=f.fs,
                               fft_size_out=ck.fft_size))
    return f, x, f0, tpos, ck, spec, ap


def test_cheaptrick_frames(t16):
    f, x, f0, tpos, ck, spec, _ = t16
    kern = TC.CheapTrickKernel(f.fs)
    assert (kern.fft_size, kern.max_half_window) == (ck.fft_size,
                                                     ck.max_half_window)
    out = kern(torch.tensor(x)[None], torch.tensor(f0)[None],
               torch.tensor(tpos))[0].numpy()
    assert out.shape == spec.shape
    # log-envelope of f32 FFT/smoothing/cepstrum chains: 1e-3 (0.004 dB)
    np.testing.assert_allclose(np.log(out), np.log(spec), atol=1e-3)


def test_d4c_frames(t16):
    f, x, f0, tpos, ck, _, ap = t16
    out = TD.d4c_frames(torch.tensor(x)[None], torch.tensor(f0)[None],
                        torch.tensor(tpos), fs=f.fs,
                        fft_size_out=ck.fft_size)[0].numpy()
    assert out.shape == ap.shape
    # aperiodicity in (0, 1]: f32 group-delay chains, 1e-4 absolute
    np.testing.assert_allclose(out, ap, atol=1e-4)


def test_synthesis_frames(t16):
    f, _, f0, _, ck, spec, ap = t16
    fp = f.frame_period / 1000.0
    out_len = int((len(f0) - 1) * fp * f.fs) + 1
    mp = S.default_max_pulses(out_len, f.fs)
    noise = np.random.RandomState(0).randn(mp, ck.fft_size).astype(
        np.float32)
    kw = dict(fs=f.fs, fft_size=ck.fft_size, frame_period_s=fp,
              out_length=out_len, max_pulses=mp)
    # un-jitted, like the JAX package's golden tests: XLA fusion can move a
    # knife-edge V/UV pulse by a sample, which shifts every later noise row
    ref = np.asarray(S.synthesis_frames_impl(
        jnp.asarray(f0), jnp.asarray(spec), jnp.asarray(ap),
        jnp.asarray(noise), use_ola=False, **kw))
    out, ovf = TS.synthesis_frames_impl(
        torch.tensor(f0)[None], torch.tensor(spec)[None],
        torch.tensor(ap)[None], convert.noise_from_numpy(noise[None], "cpu"),
        return_overflow=True, **kw)
    assert not bool(ovf[0])
    out = out[0].numpy()
    assert out.shape == ref.shape
    # same pulses, f32 FFT round-off: 1e-4 of a ~0.3-RMS waveform
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_time_base_pulses(t16):
    """Q32 pulse times (int64 cumsum masked to 32 bits) equal the JAX
    int32-wraparound ones, and padding pulses sit at T-1."""
    f, _, f0, _, ck, _, _ = t16
    fp = f.frame_period / 1000.0
    out_len = int((len(f0) - 1) * fp * f.fs) + 1
    mp = S.default_max_pulses(out_len, f.fs)
    lowest = f.fs / ck.fft_size + 1.0
    ref = S._time_base(jnp.asarray(f0), f.fs, fp, out_len, lowest, mp)
    out = TS._time_base(torch.tensor(f0)[None], f.fs, fp, out_len, lowest, mp)
    n = int(ref[2])
    assert int(out[2][0]) == n
    np.testing.assert_array_equal(out[0][0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(out[1][0].numpy()[:n], np.asarray(ref[1])[:n],
                               rtol=1e-5)
    assert torch.all(out[0][0, n:] == out_len - 1)


def test_pulse_capacity_helpers():
    for out_len, fs in ((122791, 22050), (48001, 16000)):
        assert TS.capacity_max_pulses(out_len, fs, 600.0) == \
            S.capacity_max_pulses(out_len, fs, 600.0)
        assert TS.default_max_pulses(out_len, fs) == \
            S.default_max_pulses(out_len, fs)


def test_make_noise_is_seeded():
    a = TS.make_noise(torch.Generator().manual_seed(3), 2, 4, 16)
    b = TS.make_noise(torch.Generator().manual_seed(3), 2, 4, 16)
    assert a.shape == (2, 4, 16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_batch_copy_synthesis_and_pad_batch():
    """Copy-synthesis of a padded 2-utterance t22 batch from fixture F0."""
    f = load_fixture("t22")
    waves = [np.asarray(f.x, np.float32),
             0.5 * np.asarray(f.x[:12000], np.float32)]
    x, lengths, n_frames, F, out_len = TB.pad_batch(waves, f.fs)
    jx = JB.pad_batch(waves, f.fs)
    np.testing.assert_array_equal(x, jx[0])
    assert (F, out_len) == (jx[3], jx[4])
    f0 = np.zeros((2, F), np.float32)
    f0[0, :len(f.f0)] = f.f0
    f0[1, :n_frames[1]] = f.f0[:n_frames[1]]
    tpos = (np.arange(F) * 0.005).astype(np.float32)
    ck = CheapTrickKernel(f.fs)
    mp = S.default_max_pulses(out_len, f.fs)
    noise = np.random.RandomState(1).randn(2, mp, ck.fft_size).astype(
        np.float32)
    kw = dict(fs=f.fs, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window, frame_period_s=0.005,
              out_length=out_len, max_pulses=mp)
    yj, sj, aj = (np.asarray(a) for a in JB.batch_copy_synthesis(
        jnp.asarray(x), jnp.asarray(f0), jnp.asarray(tpos),
        jnp.asarray(noise), mesh=None, **kw))
    yt, st, at, ovf = TB.batch_copy_synthesis(
        torch.tensor(x), torch.tensor(f0), torch.tensor(tpos),
        torch.tensor(noise), return_overflow=True, **kw)
    assert not bool(ovf.any())
    np.testing.assert_allclose(np.log(st.numpy()), np.log(sj), atol=1e-3)
    np.testing.assert_allclose(at.numpy(), aj, atol=1e-4)
    np.testing.assert_allclose(yt.numpy(), yj, atol=2e-4)
