"""The whole slice: the port's batch_wav_to_wav against the JAX package's
on a t22 batch of two utterances, both on the CPU.

JAX runs its production refine semantics through the Pallas refine kernel
in interpret mode (on the CPU it would otherwise take the dense refine,
which has no dedup and a different slot cap); its zc runs the jnp twin,
which the TPU kernel matches to rel 1e-4.  A fresh geometry keeps the
monkeypatched selector out of any cached program."""

import jax.numpy as jnp
import numpy as np
import torch

from conftest import load_fixture
from worldtpu.analysis import harvest as H
from worldtpu.analysis.cheaptrick import CheapTrickKernel
from worldtpu.parallel import batch as JB
from worldtpu.synthesis import synthesis as S
from worldtpu_torch import convert
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.parallel import batch as TB

torch.set_num_threads(1)


def _short_time_rms(y, w=160):
    n = (y.shape[-1] // w) * w
    return np.sqrt(np.mean(y[..., :n].reshape(*y.shape[:-1], -1, w) ** 2,
                           -1))


def test_batch_wav_to_wav_matches_jax(monkeypatch):
    f = load_fixture("t22")
    fs = f.fs
    x = np.tile(np.asarray(f.x, np.float32), (2, 1))
    x[1] *= 0.6
    T = x.shape[1]
    geo = H.HarvestGeometry(fs, T, f0_floor=40.0)   # fresh: no cached jit
    ck = CheapTrickKernel(fs)
    n_grid = 1 + int(1000.0 * T / fs / geo.frame_period)
    out_len = int((n_grid - 1) * 0.00625 * fs) + 1
    mp = S.capacity_max_pulses(out_len, fs, f0_cap=600.0)
    noise = np.random.RandomState(0).randn(2, mp, ck.fft_size).astype(
        np.float32)
    kw = dict(fs=fs, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window, frame_period_s=0.00625,
              out_length=out_len, max_pulses=mp, pitch_scale=1.2,
              return_overflow=True)

    monkeypatch.setattr(H, "_use_refine_kernel_default",
                        lambda: "interpret")
    yj, f0j, ovj = JB.batch_wav_to_wav(jnp.asarray(x), jnp.asarray(noise),
                                       geo=geo, mesh=None, **kw)
    yj, f0j = np.asarray(yj), np.asarray(f0j)

    tgeo = convert.geometry_from_worldtpu(vars(geo))
    yt, f0t, ovt = TB.batch_wav_to_wav(
        torch.tensor(x), convert.noise_from_numpy(noise, "cpu"), geo=tgeo,
        **kw)
    yt, f0t = yt.numpy(), f0t.numpy()

    assert yt.shape == yj.shape == (2, out_len)
    assert f0t.shape == f0j.shape == (2, n_grid)
    assert not np.asarray(ovj).any() and not bool(ovt.any())
    assert np.isfinite(yt).all()
    # F0: the same voicing decisions (knife-edge flips allowed for 1% of
    # frames) and f32 agreement on frames voiced in both
    vj, vt = f0j > 0, f0t > 0
    assert (vj == vt).mean() >= 0.99
    assert vj.sum() > 0.3 * vj.size
    np.testing.assert_allclose(f0t[vj & vt], f0j[vj & vt], atol=0.05)
    # waveforms: a knife-edge pulse may move by a sample, shifting later
    # noise rows; compare 160-sample short-time RMS profiles
    np.testing.assert_allclose(_short_time_rms(yt), _short_time_rms(yj),
                               atol=0.02)
    assert np.sqrt(np.mean(yt ** 2)) > 0.01

    # the HarvestKernel module is the same Harvest as the main path's
    hk = TH.HarvestKernel(fs, T, f0_floor=40.0)
    f0_hk, tpos = hk(torch.tensor(x))
    assert tpos.shape == (n_grid,)
    np.testing.assert_array_equal((f0_hk * 1.2).numpy(), f0t)


def test_harvest_48k_matches_jax(monkeypatch):
    """Full Harvest (decimation ratio 6, default f0 floor) on t48 against
    JAX's f32 device Harvest with the Pallas refine in interpret mode."""
    f = load_fixture("t48")
    x = np.asarray(f.x, np.float32)
    geo = H.HarvestGeometry(f.fs, len(x))
    n_out = 1 + int(1000.0 * len(x) / f.fs / geo.frame_period)
    ref = np.asarray(H.harvest_device_full(
        jnp.asarray(x), jnp.float32(0), geo=geo, n_out=n_out,
        use_refine="interpret"))
    out, _ = TH.HarvestKernel(f.fs, len(x))(torch.tensor(x)[None])
    out = out[0].numpy()
    np.testing.assert_array_equal(out > 0, ref > 0)
    # f32 sums in another order, through refinement and smoothing
    np.testing.assert_allclose(out, ref, atol=0.01)


def test_harvest_t16_near_reference_contour():
    """The port's f32 Harvest stays within 1 Hz RMSE of the C++ golden
    contour on voiced frames (the bound the JAX package's f32 tests use)."""
    f = load_fixture("t16")
    out, _ = TH.HarvestKernel(f.fs, len(f.x))(
        torch.tensor(np.asarray(f.x, np.float32))[None])
    out = out[0].numpy()
    v = f.f0 > 0
    assert np.sqrt(np.mean((out[v] - f.f0[v]) ** 2)) < 1.0
    assert ((out > 0) == v).mean() >= 0.99
