"""The port's user entry points on the CPU: HarvestKernel.compute_batch
(device and host contour, capacity check), the api facades (Harvest,
CheapTrick, D4C, Synthesis, World, with the overflow regrow), and the CLI
in a subprocess, against the port's own stages and the JAX package."""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from worldtpu import api as japi
from worldtpu.analysis import harvest as H
from worldtpu.io import params, wav
from worldtpu_torch import api
from worldtpu_torch import cli as tcli
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.analysis.cheaptrick import cheaptrick_frames
from worldtpu_torch.analysis.d4c import d4c_frames
from worldtpu_torch.parallel import batch as TB
from worldtpu_torch.synthesis import synthesis as TS

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).parent.parent
FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def _short_time_rms(y, w=160):
    n = (y.shape[-1] // w) * w
    return np.sqrt(np.mean(y[..., :n].reshape(*y.shape[:-1], -1, w) ** 2,
                           -1))


def _t22(n=None):
    f = load_fixture("t22")
    return np.asarray(f.x[:n], np.float32), f.fs


@pytest.mark.parametrize("contour_on", ["device", "host"])
def test_harvest_kernel_compute_batch(contour_on, monkeypatch):
    """compute_batch with either contour against the port's
    harvest_device_full (same candidates) and JAX's compute_batch (with
    the production Pallas refine in interpret mode).  CPU input takes the
    host chain past HOST_CONTOUR_FRAMES; the host case lowers that bound
    below this short signal's frame count."""
    if contour_on == "host":
        monkeypatch.setattr(TH, "HOST_CONTOUR_FRAMES", 0)
    x, fs = _t22(8000)
    xb = np.stack([x, 0.6 * x])
    hk = TH.HarvestKernel(fs, len(x), f0_floor=40.0, device="cpu")
    out = hk.compute_batch(xb, check_capacity=True)
    n_out = hk.get_samples()
    ref = TH.harvest_device_full(torch.tensor(xb), torch.zeros(2),
                                 geo=hk.geo, n_out=n_out).numpy()
    monkeypatch.setattr(H, "_use_refine_kernel_default",
                        lambda: "interpret")
    jk = H.HarvestKernel(fs, len(x), f0_floor=40.0)
    jf0, jtpos = jk.compute_batch(x[None], contour_on=contour_on)[0]
    for i, (f0, tpos) in enumerate(out):
        assert f0.dtype == np.float64 and f0.shape == (n_out,)
        np.testing.assert_array_equal(tpos, jtpos)
        if contour_on == "device":
            np.testing.assert_array_equal(f0, ref[i])
        else:
            # f64 host chain vs the f32 device chain: same voicing, f32
            # smoothing error
            np.testing.assert_array_equal(f0 > 0, ref[i] > 0)
            np.testing.assert_allclose(f0, ref[i], atol=1e-3)
            assert not np.array_equal(f0, ref[i])    # the host chain ran
    # candidates agree with JAX's to f32 rounding (PERF.md: 2.4e-4 Hz)
    f0 = out[0][0]
    assert (f0 > 0).sum() > 0.3 * f0.size
    np.testing.assert_array_equal(f0 > 0, jf0 > 0)
    np.testing.assert_allclose(f0, jf0, atol=0.01)
    np.testing.assert_array_equal(hk.compute(x)[0], f0)


def test_harvest_kernel_capacity_check():
    """A bare 3 kHz tone overflows the zc event buffer (every band's
    stopband leak crosses at 3 kHz, above e_max over the signal's
    length): compute_batch(check_capacity=True) raises; the t22 speech has
    no overflow."""
    x, fs = _t22()
    hk = TH.HarvestKernel(fs, len(x), device="cpu")
    t = np.arange(len(x)) / fs
    tone = np.sin(2 * np.pi * 3000.0 * t).astype(np.float32)
    v = TH.zc_capacity_violations_batch(torch.tensor(np.stack([x, tone])),
                                        geo=hk.geo)
    assert v.shape == (2,)
    assert int(v[0]) == 0 and int(v[1]) > 0
    with pytest.raises(TH.ZcCapacityError, match=r"utterances \[0\]"):
        hk.compute_batch(tone[None], check_capacity=True)
    hk.compute_batch(x[None], check_capacity=True)


def test_world_analyze_matches_stages():
    x, fs = _t22(8000)
    world = api.World(fs, f0_floor=40.0, device="cpu")
    tpos, f0, spec, ap = world.analyze(x, pitch_scale=1.1)
    geo = TH.HarvestGeometry(fs, len(x), f0_floor=40.0)
    xt = torch.tensor(x)[None]
    f0_ref = TH.harvest_device_full(xt, torch.zeros(1), geo=geo,
                                    n_out=geo.n_grid()) * 1.1
    tp = torch.arange(geo.n_grid(), dtype=torch.float32) * 0.005
    ck = world._cheaptrick._kernel
    spec_ref = cheaptrick_frames(xt, f0_ref, tp, fs=fs,
                                 fft_size=world.fft_size,
                                 max_half_window=ck.max_half_window)
    ap_ref = d4c_frames(xt, f0_ref, tp, fs=fs, fft_size_out=world.fft_size)
    np.testing.assert_allclose(tpos, tp.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(f0, f0_ref[0].numpy())
    np.testing.assert_array_equal(spec, spec_ref[0].numpy())
    np.testing.assert_array_equal(ap, ap_ref[0].numpy())
    # the per-stage facades compute the same stages
    tpos_h, f0_h = api.Harvest(fs, api.HarvestOption(f0_floor=40.0),
                               device="cpu").compute(x)
    np.testing.assert_allclose(f0_h * 1.1, f0, rtol=1e-6)
    sp = api.CheapTrick(fs, device="cpu").compute(x, tpos_h, f0_h)
    apc = api.D4C(fs, device="cpu").compute(x, tpos_h, f0_h,
                                            world.fft_size)
    assert sp.shape == apc.shape == (len(f0), world.fft_size // 2 + 1)
    assert bool(torch.isfinite(sp).all()) and bool((apc > 0).all())


def test_synthesis_matches_jax():
    """Synthesis.compute with explicit numpy noise against JAX's
    Synthesis.compute(noise=...) in f32 on the t22 fixture parameters.  A
    knife-edge pulse may land a sample apart between the two compilations
    (the Q32 wobble), shifting later noise rows: compare short-time RMS."""
    f = load_fixture("t22")
    out_len = int((len(f.f0) - 1) * 0.005 * f.fs) + 1
    mp = TS.estimate_max_pulses(f.f0, f.fs, f.fft_size, out_len)
    noise = np.random.RandomState(3).randn(mp, f.fft_size).astype(
        np.float32)
    y = api.Synthesis(f.fs, f.fft_size, 5.0, device="cpu").compute(
        f.f0, f.spec, f.ap, out_len, noise=noise).numpy()
    yj = np.asarray(japi.Synthesis(f.fs, f.fft_size, 5.0).compute(
        f.f0, f.spec, f.ap, out_len, noise=noise, dtype=jnp.float32,
        max_pulses=mp))
    assert y.shape == yj.shape == (out_len,)
    np.testing.assert_allclose(_short_time_rms(y), _short_time_rms(yj),
                               atol=0.02)
    assert np.sqrt(np.mean(y ** 2)) > 0.01


def test_synthesis_overflow_regrow():
    """Too small a capacity regrows (doubling) with the noise generator
    restored, so the result equals a run at the final capacity; with
    explicit noise it raises instead."""
    f = load_fixture("t22")
    out_len = int((len(f.f0) - 1) * 0.005 * f.fs) + 1
    syn = api.Synthesis(f.fs, f.fft_size, 5.0, device="cpu")
    y = syn.compute(f.f0, f.spec, f.ap, out_len, seed=5, max_pulses=64)
    for mp in (64, 128, 256, 512):
        _, ovf = TS.synthesis_frames(
            torch.tensor(f.f0, dtype=torch.float32),
            torch.tensor(f.spec, dtype=torch.float32),
            torch.tensor(f.ap, dtype=torch.float32),
            torch.zeros(mp, f.fft_size), fs=f.fs, fft_size=f.fft_size,
            frame_period_s=0.005, out_length=out_len, max_pulses=mp,
            return_overflow=True)
        if not bool(ovf):
            break
    assert mp > 64
    ref = syn.compute(f.f0, f.spec, f.ap, out_len, seed=5, max_pulses=mp)
    np.testing.assert_array_equal(y.numpy(), ref.numpy())
    with pytest.raises(OverflowError):
        syn.compute(f.f0, f.spec, f.ap, out_len,
                    noise=np.zeros((64, f.fft_size), np.float32))


def test_world_copy_synthesis_regrow(monkeypatch):
    """World.copy_synthesis from a too-small static capacity: it doubles
    until no pulse overflows; the result equals a run that starts at the
    final capacity (the generator restored on every try)."""
    x, fs = _t22(8000)
    world = api.World(fs, f0_floor=40.0, device="cpu")
    tries = []
    real = TB.batch_wav_to_wav

    def spy(*a, **kw):
        tries.append(kw["max_pulses"])
        return real(*a, **kw)

    monkeypatch.setattr(TB, "batch_wav_to_wav", spy)
    monkeypatch.setattr(TS, "capacity_max_pulses", lambda *a, **k: 64)
    y, f0 = world.copy_synthesis(x, pitch_scale=1.2, seed=2)
    assert len(tries) >= 2 and tries[0] == 64
    assert tries[1:] == [2 * t for t in tries[:-1]]
    final = tries[-1]
    monkeypatch.setattr(TS, "capacity_max_pulses", lambda *a, **k: final)
    y2, f02 = world.copy_synthesis(x, pitch_scale=1.2, seed=2)
    np.testing.assert_array_equal(y, y2)
    np.testing.assert_array_equal(f0, f02)
    assert np.isfinite(y).all() and np.sqrt(np.mean(y ** 2)) > 0.01


def test_f64_raises():
    x, fs = _t22()
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        api.Harvest(fs, device="cpu").compute(x, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        api.World(fs, device="cpu").copy_synthesis(x, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        tcli.main(["analyze", str(FIXTURES / "t22.wav"), "unused",
                   "--device", "cpu"])


def _run(args, code=None):
    cmd = [sys.executable]
    cmd += ["-c", code] if code else ["-m", "worldtpu_torch.cli"] + args
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600,
                          env={"PATH": "/usr/bin:/bin:/usr/local/bin",
                               "PYTHONPATH": str(REPO),
                               "OMP_NUM_THREADS": "1"})


def test_cli_roundtrip_and_fused(tmp_path):
    """analyze -> synthesize and copy-syn --fused, --device cpu."""
    pre = str(tmp_path / "p")
    r = _run(["analyze", str(FIXTURES / "t22.wav"), pre, "--f32",
              "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    f0, _, fp = params.read_f0(pre + ".f0")
    spec, meta = params.read_spectral_envelope(pre + ".spec")
    assert fp == 5.0 and meta["fs"] == 22050
    assert spec.shape == (len(f0), meta["fft_size"] // 2 + 1)
    out = str(tmp_path / "out.wav")
    r = _run(["synthesize", pre, out, "--f32", "--device", "cpu",
              "--f0-scale", "1.2"])
    assert r.returncode == 0, r.stderr[-2000:]
    y, fs, _ = wav.wavread(out)
    assert fs == 22050 and np.isfinite(y).all()
    assert 0.01 < np.sqrt(np.mean(y ** 2)) < 1.0

    out2 = str(tmp_path / "fused.wav")
    r = _run(["copy-syn", str(FIXTURES / "t22.wav"), out2, "--fused",
              "--device", "cpu", "--f0-scale", "1.1"])
    assert r.returncode == 0, r.stderr[-2000:]
    y2, fs2, _ = wav.wavread(out2)
    assert fs2 == 22050 and np.isfinite(y2).all()
    assert len(y2) == len(y) and np.sqrt(np.mean(y2 ** 2)) > 0.01


def test_entry_points_import_without_jax():
    r = _run(None, code=(
        "import sys; sys.modules['jax'] = None\n"
        "import worldtpu_torch, worldtpu_torch.api, worldtpu_torch.cli\n"
        "from worldtpu_torch import World, Harvest\n"
        "from worldtpu_torch.analysis import harvest\n"
        "from worldtpu.analysis import contour\n"
        "print(sorted(m for m in sys.modules if m.startswith('jax')))"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "['jax']"
