"""Kernel-vs-plain tests on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA inputs, and the main path's launches.

Marked ``cuda``; without a CUDA device every test skips.  Run them on a
GPU machine with ``python -m pytest tests/test_torch_cuda.py -q``."""

import numpy as np
import pytest
import torch

from worldtpu_torch import _build, api
from worldtpu_torch.analysis import contour_device as TCD
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
from worldtpu_torch.ops import extend_kernel as TE
from worldtpu_torch.ops import ola_kernel as TO
from worldtpu_torch.ops import refine_kernel as TR
from worldtpu_torch.ops import zc_kernel as TZ
from worldtpu_torch.parallel import batch as TB
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


def test_cuda_wrapper_checks(dev):
    resp = torch.zeros((1, 2, 128), device=dev, dtype=torch.float64)
    starts = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        TO.overlap_add(resp, starts, 100)


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
    cand, score = TH.harvest_device_stages(
        x, torch.zeros(x.shape[0], device=x.device), geo=geo)
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


def test_zc_events_kernel_matches_plain(stage_inputs):
    _, geo, y = stage_inputs
    filt = TH.band_filter(y, geo)
    groups = TZ.make_groups(geo)
    n0 = _build.launches["wt_zc_events"]
    outs = TZ.zc_events(filt, geo)
    assert _build.launches["wt_zc_events"] == n0 + len(groups)
    for g, (ev, ccol) in zip(groups, outs):
        pev, pccol = TZ.zc_events_plain(filt, g.lo, g.hi, e_cap=g.e_cap,
                                        c_row=g.c_row)
        assert torch.equal(ccol, pccol)
        assert torch.equal(ev, pev)


def test_world_copy_synthesis_launches_extend(dev):
    fs = 22050
    x = _vowels(fs, 1)[0]
    world = api.World(fs, f0_floor=40.0, device=dev)
    _build.launches.clear()
    y, f0 = world.copy_synthesis(x, pitch_scale=1.1)
    assert _build.launches["wt_extend"] >= 1
    assert np.isfinite(y).all() and (f0 > 0).mean() > 0.3
