"""The port's float64 Harvest on the CPU: stage by stage against the
instrumented C++ dumps (tests/fixtures/t*.harvest.gz) with the tolerances
of tests/test_harvest.py, stage by stage against the JAX package in float64
on the same input, and end to end against the C++ F0 dumps (F0 RMSE < 1e-6
Hz, max < 1e-4 Hz) on t16, t22 and t48."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from test_harvest import HarvestDump, _remap_to_ref
from worldtpu.analysis import harvest as H
from worldtpu_torch import api, convert
from worldtpu_torch.analysis import harvest as TH

torch.set_num_threads(1)


def _geo_and_y(name):
    d = HarvestDump.load(name)
    f = load_fixture(name)
    geo = TH.HarvestGeometry(d.fs, d.x_length, f0_floor=40.0)
    for k in ("ratio", "y_length", "fft_size", "n_channels", "f0_length",
              "max_candidates"):
        assert getattr(geo, k) == getattr(d, k), k
    y = TH.decimate_stage(torch.tensor(f.x)[None], ratio=geo.ratio,
                          y_length=geo.y_length)
    return d, f, geo, y


def _stages(name):
    """(dump, geo, candidates, raw, refined, scores, pruned) of a fixture,
    computed once per process."""
    if name not in _stages.cache:
        d, f, geo, y = _geo_and_y(name)
        mean = TH.int_trunc_mean(y)
        assert float(mean[0]) == 0.0        # |y| < 1: the truncated sum is 0
        cand, raw, _ = TH.candidates_stage(y, mean, geo)
        tpos = torch.arange(geo.f0_length, dtype=torch.float64) / 1000.0
        ref, sc = TH.refine_stage_f64(y, cand, tpos, geo=geo)
        pr, _ = TH.remove_unreliable_stage(ref, sc)
        _stages.cache[name] = (d, geo, y, cand, raw, ref, sc, pr)
    return _stages.cache[name]


_stages.cache = {}


@pytest.mark.parametrize("name", ["t22", "t16"])
def test_f64_decimation_stage_vs_cpp(name):
    d, f, geo, y = _geo_and_y(name)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y[0].numpy(), d.y[:geo.y_length], rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["t22", "t16"])
def test_f64_candidates_stage_vs_cpp(name):
    """The circular-FFT band filter, dense zero crossings with the histc
    interpolation, run detection and overlap: rtol 1e-6, atol 1e-8."""
    d, geo, _, cand, raw, *_ = _stages(name)
    np.testing.assert_allclose(raw[0].numpy(), d.raw, rtol=1e-6, atol=1e-8)
    got = _remap_to_ref(cand[0].numpy(), geo.cb, d.noc, d.max_candidates)
    np.testing.assert_allclose(got, d.cand_overlap, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", ["t22", "t16"])
def test_f64_refine_and_prune_stages_vs_cpp(name):
    """The dense refine twin (literal per-pair windows, full FFTs) in the
    candidates' own slots, and the pruning over every slot."""
    d, geo, _, _, _, ref, sc, pr = _stages(name)

    def remap(a):
        return _remap_to_ref(a[0].numpy(), geo.cb, d.noc, d.max_candidates)

    np.testing.assert_allclose(remap(ref), d.cand_refine, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(remap(sc), d.score_refine, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(remap(pr), d.cand_prune, rtol=1e-9, atol=1e-9)


def test_f64_stages_match_jax():
    """Every float64 stage against its JAX float64 counterpart on t22's
    first 0.36 s.  Decimation: the same matmuls by another BLAS, 1e-13 of
    the scale.  Raw candidates and refined values: two FFT libraries and
    other reduction orders, 1e-9 relative where both are nonzero, with the
    same gates passed (no candidate present on one side only).  Pruning on
    the port's own refined values: exact."""
    f = load_fixture("t22")
    x = f.x[:8000]
    geo = H.HarvestGeometry(f.fs, len(x), f0_floor=40.0)
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    jy = H.decimate_stage(jnp.asarray(x), ratio=geo.ratio,
                          y_length=geo.y_length)
    ty = TH.decimate_stage(torch.tensor(x)[None], ratio=geo.ratio,
                           y_length=geo.y_length)
    np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy), rtol=0,
                               atol=1e-13 * float(np.abs(jy).max()))
    jt = jnp.arange(geo.f0_length, dtype=jnp.float64) / 1000.0
    tt = torch.arange(geo.f0_length, dtype=torch.float64) / 1000.0
    jc, jraw, _ = H.candidates_stage(jy, 0.0, jt, geo=geo)
    tc, traw, _ = TH.candidates_stage(ty, torch.zeros(1, dtype=torch.float64),
                                      tgeo)
    for got, ref in ((traw[0].numpy(), np.asarray(jraw)),
                     (tc[0].numpy(), np.asarray(jc))):
        np.testing.assert_array_equal(got > 0, ref > 0)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    assert (np.asarray(jc) > 0).sum() > 1000
    jr, js = H.refine_stage(jy, jc, jt, geo=geo)
    tr, ts = TH.refine_stage_f64(ty, tc, tt, geo=tgeo)
    np.testing.assert_array_equal(tr[0].numpy() > 0, np.asarray(jr) > 0)
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr), rtol=1e-9)
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js), rtol=1e-6)
    jp, jps = H.remove_unreliable_stage(jnp.asarray(tr[0].numpy()),
                                        jnp.asarray(ts[0].numpy()))
    tp, tps = TH.remove_unreliable_stage(tr, ts)
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tps[0].numpy(), np.asarray(jps))


def test_f64_refine_compaction_cap():
    """A frame with more nonzero candidates than the twin's capacity
    min(S, max(32, S // 2)) refines only the first of them, in their own
    slots; zero candidates stay zero."""
    f = load_fixture("t22")
    geo = TH.HarvestGeometry(f.fs, 4000, f0_floor=40.0)
    y = TH.decimate_stage(torch.tensor(f.x[3000:7000])[None],
                          ratio=geo.ratio, y_length=geo.y_length)
    S = geo.max_candidates
    cap = min(S, max(32, S // 2))
    assert cap < S
    cand = torch.zeros((1, geo.f0_length, S), dtype=torch.float64)
    cand[0, 60, :] = torch.linspace(90.0, 400.0, S, dtype=torch.float64)
    cand[0, 61, 5::9] = 150.0
    tpos = torch.arange(geo.f0_length, dtype=torch.float64) / 1000.0
    ref, sc = TH.refine_stage_f64(y, cand, tpos, geo=geo, chunk=7)
    assert bool((ref[0, 60, cap:] == 0).all())
    assert bool((sc[0, 60, cap:] == 0).all())
    assert bool((ref[cand == 0] == 0).all())
    ref2, sc2 = TH.refine_stage_f64(y, cand, tpos, geo=geo, chunk=16)
    assert torch.equal(ref, ref2) and torch.equal(sc, sc2)   # any chunking


@pytest.mark.parametrize("name", ["t22", "t16", "t48"])
def test_f64_harvest_end_to_end_vs_cpp(name):
    """HarvestKernel.compute(dtype=float64): int-truncated mean, literal
    stages, host contour.  F0 RMSE < 1e-6 Hz, max < 1e-4 Hz
    (tests/test_harvest.py), and voicing identical."""
    f = load_fixture(name)
    kern = TH.HarvestKernel(f.fs, len(f.x), f0_floor=40.0, frame_period=5.0,
                            device="cpu")
    assert kern.get_samples() == len(f.f0)
    f0, tpos = kern.compute(f.x, dtype=torch.float64)
    np.testing.assert_allclose(tpos, f.tpos, rtol=1e-12)
    np.testing.assert_array_equal(f0 > 0, f.f0 > 0)
    err = np.abs(f0 - f.f0)
    rmse = np.sqrt(np.mean(err ** 2))
    assert rmse < 1e-6, f"F0 RMSE {rmse} Hz"
    assert err.max() < 1e-4, f"max F0 err {err.max()} Hz"
    if name == "t22":
        # the facade and a batch of two give the same contour
        t2, g0 = api.Harvest(f.fs, api.HarvestOption(f0_floor=40.0),
                             device="cpu").compute(f.x, dtype=torch.float64)
        np.testing.assert_array_equal(g0, f0)
        np.testing.assert_array_equal(t2, tpos)
        out = kern.compute_batch(np.stack([f.x, 0.5 * f.x]),
                                 dtype=torch.float64)
        np.testing.assert_array_equal(out[0][0], f0)
        np.testing.assert_array_equal(out[1][0] > 0, f0 > 0)


def test_f64_harvest_matches_jax_facade():
    """The float64 facade against JAX's (its default dtype) on t22's first
    0.36 s: voicing identical, F0 within 1e-8 Hz (FFT libraries and
    reduction orders; both sit ~1e-12 Hz from the C++ on the whole
    file)."""
    from worldtpu import api as japi
    f = load_fixture("t22")
    x = f.x[:8000]
    jt, jf0 = japi.Harvest(f.fs, japi.HarvestOption(f0_floor=40.0)).compute(x)
    tt, tf0 = api.Harvest(f.fs, api.HarvestOption(f0_floor=40.0),
                          device="cpu").compute(x, dtype=torch.float64)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tf0 > 0, jf0 > 0)
    np.testing.assert_allclose(tf0, jf0, rtol=0, atol=1e-8)
    assert (tf0 > 0).sum() > 20
