"""The port's ``grid_ms > 1`` mode (Harvest's candidate grid coarsened to
k ms, an argument here, the ``WORLDTPU_GRID_MS`` environment knob in
``worldtpu``) against the JAX package at k = 2, both on the CPU.

JAX runs its production refine semantics through the Pallas refine kernel
in interpret mode, as tests/test_torch_slice.py does; its zc is the jnp
twin, which the port's zc is held to at the tolerance of the TPU kernel's
own test against it (tests/test_torch_kernels.py).  Where the whole
Harvest is compared, the tolerances are the slice's: voicing agreement
>= 0.99, F0 within 0.05 Hz on frames voiced in both."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from worldtpu.analysis import contour_device as CD
from worldtpu.analysis import harvest as H
from worldtpu_torch import api, convert
from worldtpu_torch.analysis import contour_device as TCD
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
from worldtpu_torch.ops import zc_kernel as TZ
from worldtpu_torch.parallel import batch as TB
from worldtpu_torch.synthesis import synthesis as TS

torch.set_num_threads(1)

GRID = 2


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fs", [16000, 22050, 48000])
def test_with_grid_matches_jax(fs):
    """with_grid(k) equals JAX's field for field for k = 2, 3; the same
    object comes back for the same k, and k = 1 is the geometry itself."""
    x_length = int(fs * 2.3)
    jg = H.HarvestGeometry(fs, x_length, f0_floor=40.0)
    tg = TH.HarvestGeometry(fs, x_length, f0_floor=40.0)
    assert tg.with_grid(1) is tg
    for k in (2, 3):
        jk, tk = jg.with_grid(k), tg.with_grid(k)
        assert tg.with_grid(k) is tk
        assert tk.grid_ms == k
        assert tk.f0_length == jk.f0_length < tg.f0_length
        fields = {n: v for n, v in vars(jk).items() if n != "_grid_cache"}
        assert set(fields) == set(vars(tk)) - {"_grid_cache"}
        for n, v in fields.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(tk, n), v, err_msg=n)
            else:
                assert getattr(tk, n) == v, n
    assert tg.with_grid(2) is not tg.with_grid(3)


# ---------------------------------------------------------------------------
# stages at k = 2
# ---------------------------------------------------------------------------

def _vowels(fs, dur=0.6):
    rng = np.random.RandomState(4)
    T = int(fs * dur)
    t = np.arange(T) / fs
    out = []
    for i, base in enumerate((130.0, 210.0)):
        f0t = base * 2 ** (0.2 * np.sin(2 * np.pi * 3 * t + i))
        ph = 2 * np.pi * np.cumsum(f0t) / fs
        x = 0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph)
        x[int(0.35 * T):int(0.45 * T)] = 0.0
        out.append(x + 0.003 * rng.randn(T))
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def stages():
    """(x, JAX geometry, port geometry, JAX flat stages per utterance,
    port (candidates, scores)) at k = 2, 16 kHz."""
    fs = 16000
    x = _vowels(fs)
    geo = H.HarvestGeometry(fs, x.shape[1], f0_floor=71.0)
    flat = [np.asarray(H.harvest_device_stages(
        jnp.asarray(xi), jnp.float32(0), geo=geo, use_refine="interpret",
        grid=GRID)) for xi in x]
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    cand, score = TH.harvest_device_stages(
        torch.tensor(x), geo=tgeo, grid=GRID)
    return x, geo, tgeo, flat, cand.numpy(), score.numpy()


def test_zc_at_grid_2_matches_jnp_twin(stages):
    """zc on the 2 ms grid (grid_hz 500, tstep 2 ms, half the frames) from
    JAX's own band signals, against the jnp twin on geo.with_grid(2)."""
    x, geo, tgeo, *_ = stages
    gk = geo.with_grid(GRID)
    y = H.decimate_stage(jnp.asarray(x[0]), ratio=geo.ratio,
                         y_length=geo.y_length)
    filt = jnp.concatenate([H._band_filter_matmul(y, gk, jnp.float32, lo,
                                                  hi, Lg)
                            for lo, hi, Lg in H._conv_groups(gk)], axis=0)
    tpos = jnp.arange(gk.f0_length, dtype=jnp.float32) * (GRID / 1000.0)
    ref = np.asarray(jax.vmap(
        lambda fi, b: H._band_candidates(fi, b, gk, tpos))(
            filt, jnp.asarray(gk.boundary_f0, jnp.float32)))
    tk = tgeo.with_grid(GRID)
    assert TZ.geometry_args(tk)["grid_hz"] == 500.0
    out = TZ.band_candidates(torch.tensor(np.asarray(filt))[None], tk)[0]
    out = out.numpy()
    assert out.shape == ref.shape == (geo.n_channels, gk.f0_length)
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-3)
    assert rel.max() < 1e-4
    assert (out > 0).sum() == (ref > 0).sum() > 1000


def _partnered(a, b, rtol=2e-4):
    """Share of the nonzero candidates of a [F, S] that have a nonzero
    candidate of b in the same frame within rtol (relative)."""
    d = np.abs(a[:, :, None] - b[:, None, :]) / np.maximum(
        np.abs(a[:, :, None]), 1e-3)
    d = np.where(b[:, None, :] > 0, d, np.inf).min(2)
    return float((d[a > 0] <= rtol).mean())


def test_harvest_stages_at_grid_2_match_jax(stages):
    """harvest_device_stages(grid=2) against JAX's: [B, F/2, S], F/2 the
    2 ms grid's frames.  Of each side's refined candidates, 99% have a
    partner on the other side in the same frame within the refine
    tolerance (2e-4 relative), and the counts agree to 1%: the filter
    bank's f32 sums (1e-4 absolute) move knife-edge refine gates, as at
    1 ms (the same comparison there: 99.6% on the same input)."""
    x, geo, tgeo, flat, cand, score = stages
    F, S = geo.with_grid(GRID).f0_length, geo.max_candidates
    assert cand.shape == score.shape == (len(x), F, S)
    for b in range(len(x)):
        jc = flat[b][:F * S].reshape(F, S)
        assert _partnered(jc, cand[b]) >= 0.99
        assert _partnered(cand[b], jc) >= 0.99
        n_j, n_t = int((jc > 0).sum()), int((cand[b] > 0).sum())
        assert abs(n_t - n_j) <= 0.01 * n_j and n_j > F


def test_host_contour_at_grid_2_matches_jax(stages):
    """The host contour (fix_f0_contour with grid_ms=2, the pick of the
    2 ms grid at the frame period) on JAX's own stages: bit for bit the
    JAX HarvestKernel._finish(flat, 2); on the port's stages, the slice's
    F0 tolerances."""
    x, geo, tgeo, flat, cand, score = stages
    F, S = geo.with_grid(GRID).f0_length, geo.max_candidates
    jk = H.HarvestKernel(geo.fs, geo.x_length, f0_floor=71.0)
    for b in range(len(x)):
        ref, _ = jk._finish(flat[b], GRID)
        c = flat[b][:F * S].reshape(F, S).astype(np.float64)
        s = flat[b][F * S:].reshape(F, S).astype(np.float64)
        got = TH.host_contour(c, s, tgeo, GRID)
        np.testing.assert_array_equal(got, ref)
        mine = TH.host_contour(cand[b].astype(np.float64),
                               score[b].astype(np.float64), tgeo, GRID)
        assert mine.shape == (tgeo.n_grid(),)
        assert ((mine > 0) == (ref > 0)).mean() >= 0.99
        both = (mine > 0) & (ref > 0)
        assert both.mean() > 0.3
        np.testing.assert_allclose(mine[both], ref[both], atol=0.05)


@pytest.mark.parametrize("seeds", [(0, 1, 2)])
def test_fix_and_smooth_at_grid_2_matches_jax(seeds):
    """The device contour chain on a 2 ms grid (allowed ranges x2, frame
    windows /2, the extend walk with ext_lim 50 and miss_lim 2, the pick
    at 2 ms) against JAX's on synthetic slabs: voicing identical, 1e-3 Hz
    (test_torch_contour.py's tolerance)."""
    from test_torch_contour import _batch
    F = 700
    cand, score = _batch(F, 21, seeds)
    n_out = 1 + (F - 1) * GRID // 5
    out = TCD.fix_and_smooth(torch.tensor(cand), torch.tensor(score), n_out,
                             5.0, grid_ms=GRID).numpy()
    for b in range(len(seeds)):
        ref = np.asarray(CD.fix_and_smooth(jnp.asarray(cand[b]),
                                           jnp.asarray(score[b]), n_out, 5.0,
                                           grid_ms=GRID))
        np.testing.assert_array_equal(out[b] > 0, ref > 0)
        assert (ref > 0).mean() > 0.3
        np.testing.assert_allclose(out[b], ref, atol=1e-3)


def test_extend_walk_limits_at_grid_2(monkeypatch):
    """At k = 2 the contour chain calls the extend walk with ext_lim 50
    (E = 51 steps) and miss_lim 2."""
    from test_torch_contour import _batch
    from worldtpu_torch.ops import extend_kernel as TE
    seen = []
    real = TE.extend_walk

    def spy(*a, **k):
        seen.append(k)
        return real(*a, **k)
    monkeypatch.setattr(TE, "extend_walk", spy)
    cand, score = _batch(400, 14, (5,))
    TCD.fix_and_smooth(torch.tensor(cand), torch.tensor(score), 161, 5.0,
                       grid_ms=GRID)
    assert len(seen) == 1
    assert (seen[0]["ext_lim"], seen[0]["miss_lim"]) == (50, 2)


# ---------------------------------------------------------------------------
# zc's frame-start guard at grid_hz 500
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid_hz", [1000.0, 500.0])
@pytest.mark.parametrize("fs_a", [8000.0, 7350.0])
def test_zc_starts_by_guard_exact(grid_hz, fs_a):
    """csrc/zc.cu decides ceil(s / fs_a * grid_hz) <= ff through the
    product est = s * (grid_hz / fs_a) unless est lies within 1e-5 * ff +
    1e-5 of ff, where it takes the twin's division.  In float32 without
    contraction (zc.cu builds with --fmad=false), numpy's float32
    arithmetic is the card's: at both grids the guard gives the twin's
    answer for every event midpoint s of a 60 s band signal, and for the
    float32 neighbours of every frame boundary."""
    f32 = np.float32
    rng = np.random.RandomState(0)
    g, fa = f32(grid_hz), f32(fs_a)
    per = g / fa
    n = int(60 * fs_a)
    s = np.concatenate([
        (rng.uniform(0, n, 400000)).astype(f32),
        np.arange(0, n, 0.5, dtype=f32)[::7]])
    # the float32 neighbours of s where s / fs_a * grid_hz is an integer
    ff_b = np.arange(0, int(n / fs_a * grid_hz), dtype=f32)
    exact = (ff_b.astype(np.float64) * fs_a / grid_hz).astype(f32)
    near = [exact]
    up, down = exact.copy(), exact.copy()
    for _ in range(4):
        up = np.nextafter(up, f32(np.inf))
        down = np.nextafter(down, f32(0))
        near += [up, down]
    s = np.concatenate([s] + near)
    twin = np.ceil((s / fa) * g)
    est = s * per
    for d in (-1, 0, 1):
        ff = (twin + f32(d)).astype(f32)
        margin = f32(1e-5) * ff + f32(1e-5)
        guard = np.where(est < ff - margin, True,
                         np.where(est > ff + margin, False,
                                  np.ceil((s / fa) * g) <= ff))
        np.testing.assert_array_equal(guard, twin <= ff)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _clear_jax_caches():
    for f in (H.candidates_stage, H.harvest_device_stages,
              H.harvest_device_full):
        f.clear_cache()


def test_harvest_kernel_grid_2_on_t16_matches_jax(monkeypatch):
    """HarvestKernel(grid_ms=2).compute on t16 against JAX at GRID_MS = 2,
    its refine in interpret mode.  (a) JAX's stages and device contour
    chain, each its own program (harvest_device_stages(grid=2), then
    contour_device.fix_and_smooth(grid_ms=2)): voicing identical, F0 within
    0.05 Hz (the slice's tolerance).  (b) JAX's HarvestKernel.compute under
    GRID_MS = 2 with its caches cleared, as tests/test_harvest.py runs it:
    that one fused program rounds its float32 stages apart from (a) and
    moves a knife-edge contour choice (1 voicing flip of 601 frames, 71
    frames up to 2.7 Hz apart from (a) on this input), so against it
    voicing agreement >= 0.99 (the slice's) and the median |dF0| < 0.05
    Hz.  Both meet tests/test_harvest.py's gates against the C++ F0
    (vuv > 0.96, RMSE < 5 Hz, median < 0.2 Hz)."""
    f = load_fixture("t16")
    x = np.asarray(f.x, np.float32)
    geo = H.HarvestGeometry(f.fs, len(x))
    n_out = H.HarvestKernel(f.fs, len(x)).get_samples()
    F, S = geo.with_grid(GRID).f0_length, geo.max_candidates
    flat = np.asarray(H.harvest_device_stages(
        jnp.asarray(x), jnp.float32(0), geo=geo, use_refine="interpret",
        grid=GRID))
    composed = np.asarray(CD.fix_and_smooth(
        jnp.asarray(flat[:F * S].reshape(F, S)),
        jnp.asarray(flat[F * S:].reshape(F, S)), n_out, geo.frame_period,
        grid_ms=GRID))
    monkeypatch.setattr(H, "_use_refine_kernel_default", lambda: "interpret")
    monkeypatch.setattr(H, "GRID_MS", GRID)
    _clear_jax_caches()
    try:
        fused, _ = H.HarvestKernel(f.fs, len(x)).compute(jnp.asarray(x),
                                                         dtype=jnp.float32)
    finally:
        monkeypatch.undo()
        _clear_jax_caches()
    fused = np.asarray(fused)
    hk = TH.HarvestKernel(f.fs, len(x), device="cpu", grid_ms=GRID)
    assert hk.grid_ms == GRID
    f0, tpos = hk.compute(x)
    assert f0.shape == composed.shape == fused.shape == tpos.shape
    np.testing.assert_array_equal(f0 > 0, composed > 0)
    both = (f0 > 0) & (composed > 0)
    np.testing.assert_allclose(f0[both], composed[both], atol=0.05)
    assert ((f0 > 0) == (fused > 0)).mean() >= 0.99
    both = (f0 > 0) & (fused > 0)
    assert float(np.median(np.abs(f0[both] - fused[both]))) < 0.05
    gold = np.asarray(f.f0)[:len(f0)]
    for v in (f0, fused):
        vb = (v > 0) & (gold > 0)
        assert float(np.mean((v > 0) == (gold > 0))) > 0.96
        assert float(np.sqrt(np.mean((v[vb] - gold[vb]) ** 2))) < 5.0
        assert float(np.median(np.abs(v[vb] - gold[vb]))) < 0.2
    # the facade, compute_batch and the capacity check take the same grid
    _, f0h = api.Harvest(f.fs, device="cpu", grid_ms=GRID).compute(x)
    np.testing.assert_array_equal(f0h, f0)
    (f0b, _), = hk.compute_batch(x[None], check_capacity=True)
    np.testing.assert_array_equal(f0b, f0)


def test_batch_wav_to_wav_grid_2_runs():
    """batch_wav_to_wav and batch_analyze with grid_ms=2: the F0 is
    HarvestKernel(grid_ms=2)'s, scaled; the output finite and audible;
    World takes the same grid."""
    f = load_fixture("t22")
    fs = f.fs
    x = np.stack([f.x, 0.6 * f.x]).astype(np.float32)[:, :9000]
    T = x.shape[1]
    geo = TH.HarvestGeometry(fs, T, f0_floor=40.0)
    ck = CheapTrickKernel(fs)
    n_grid = geo.n_grid()
    out_len = int((n_grid - 1) * 0.00625 * fs) + 1
    mp = TS.capacity_max_pulses(out_len, fs, f0_cap=600.0)
    noise = TS.make_noise(torch.Generator().manual_seed(0), 2, mp,
                          ck.fft_size)
    kw = dict(geo=geo, fs=fs, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window)
    y, f0, ovf = TB.batch_wav_to_wav(
        torch.tensor(x), noise, frame_period_s=0.00625, out_length=out_len,
        max_pulses=mp, pitch_scale=1.2, return_overflow=True, grid_ms=GRID,
        **kw)
    f0_hk, _ = TH.HarvestKernel(fs, T, f0_floor=40.0,
                                grid_ms=GRID)(torch.tensor(x))
    np.testing.assert_array_equal(f0.numpy(), (f0_hk * 1.2).numpy())
    assert y.shape == (2, out_len) and not bool(ovf.any())
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) > 0.01
    assert float((f0 > 0).float().mean()) > 0.3
    f0a, spec, ap = TB.batch_analyze(torch.tensor(x), grid_ms=GRID, **kw)
    np.testing.assert_array_equal(f0a.numpy(), f0_hk.numpy())
    assert spec.shape == ap.shape == (2, n_grid, ck.fft_size // 2 + 1)
    _, f0w = api.World(fs, f0_floor=40.0, device="cpu",
                       grid_ms=GRID).copy_synthesis(x[0])
    np.testing.assert_array_equal(f0w, f0_hk[0].numpy())


@pytest.mark.parametrize("entry", ["kernel", "facade", "world", "stages",
                                   "batch", "cli"])
def test_float64_with_grid_2_raises(entry, tmp_path):
    """The float64 parity path runs the reference's 1 ms grid only: every
    entry point refuses grid_ms = 2 with it, before any work."""
    f = load_fixture("t22")
    x = np.asarray(f.x[:4000], np.float64)
    f64 = torch.float64
    if entry == "cli":
        cmd = [sys.executable, "-m", "worldtpu_torch.cli", "analyze",
               "tests/fixtures/t22.wav", str(tmp_path / "p"), "--device",
               "cpu", "--grid-ms", "2"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        assert r.returncode == 2 and "--grid-ms" in r.stderr
        assert not (tmp_path / "p.f0").exists()
        return
    with pytest.raises(ValueError, match="grid"):
        if entry == "kernel":
            TH.HarvestKernel(f.fs, len(x), device="cpu",
                             grid_ms=GRID).compute(x, dtype=f64)
        elif entry == "facade":
            api.Harvest(f.fs, device="cpu", grid_ms=GRID).compute(
                x, dtype=f64)
        elif entry == "world":
            api.World(f.fs, device="cpu", grid_ms=GRID).analyze(
                x, dtype=f64)
        elif entry == "stages":
            geo = TH.HarvestGeometry(f.fs, len(x))
            TH.harvest_device_stages(torch.tensor(x)[None], geo=geo,
                                     grid=GRID)
        else:
            geo = TH.HarvestGeometry(f.fs, len(x))
            TB.batch_analyze(torch.tensor(x)[None], geo=geo, fs=f.fs,
                             fft_size=1024, max_half_window=500,
                             grid_ms=GRID)
    with pytest.raises(ValueError, match="positive int"):
        TH.HarvestKernel(f.fs, len(x), grid_ms=0)
