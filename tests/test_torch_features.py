"""The feature entry point (``parallel.batch.batch_features``): WORLD's
analysis and codec in one program.

On the CPU: ``batch_features`` equals ``batch_analyze`` followed by the
codec on its frames, bit for bit, at two pitches; its coded outputs match
the JAX package's codec (``worldtpu.codec``) applied to the same analysis
at ``tests/test_torch_codec.py``'s float32 tolerances, and the JAX
package's whole chain (its float32 analysis, then its codec) within what
the two analyses' differences allow.  The mesh case is in
``tests/test_torch_mesh.py`` (its gloo ranks).  Tests marked ``cuda`` run
on the card (``python -m pytest tests/test_torch_features.py -m cuda
--noconftest``): a replayed call equal to its eager one bit for bit, no
host synchronisation, and the ``codec`` stage's marks after the
analysis'."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from worldtpu_torch import codec as TC
from worldtpu_torch import tracing
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
from worldtpu_torch.parallel import batch as TB
from worldtpu_torch.parallel import graphs as TG

torch.set_num_threads(1)

N_DIMS = 60
#: float32 tolerances of tests/test_torch_codec.py (port against JAX on
#: one input)
F32_AP_DB_ATOL = 2e-5
F32_CODED_SPEC_REL = 2e-5
#: tests/test_torch_analysis.py's float32 D4C tolerance (aperiodicity,
#: absolute), which the coded aperiodicity carries through 20 log10
D4C_ATOL = 1e-4


def _kw(fs, T):
    ck = CheapTrickKernel(fs)
    return dict(geo=TH.HarvestGeometry(fs, T, f0_floor=40.0), fs=fs,
                fft_size=ck.fft_size, max_half_window=ck.max_half_window)


def _coded(spec, ap, *, fs, fft_size):
    """The codec on [B, F, K] frames, flattened as batch_features codes
    them."""
    B, F, K = spec.shape
    mcep = TC.code_spectral_envelope(spec.reshape(B * F, K), fs=fs,
                                     fft_size=fft_size, n_dims=N_DIMS)
    bap = TC.code_aperiodicity(ap.reshape(B * F, K), fs=fs,
                               fft_size=fft_size)
    return mcep.reshape(B, F, -1), bap.reshape(B, F, -1)


@pytest.fixture(scope="module")
def t22x2():
    """t22 (0.7 s at 22,050 Hz) and a copy at 0.6 of its level: [2, T]."""
    from conftest import load_fixture
    f = load_fixture("t22")
    x = np.stack([f.x, 0.6 * np.asarray(f.x)]).astype(np.float32)
    return f.fs, x


@pytest.fixture(scope="module")
def port(t22x2):
    """(kw, features, analysis) of the port at pitch 1.0 on the CPU."""
    fs, x = t22x2
    kw = _kw(fs, x.shape[1])
    xt = torch.tensor(x)
    feats = TB.batch_features(xt, n_dims=N_DIMS, **kw)
    return kw, feats, TB.batch_analyze(xt, **kw)


def test_features_equal_analysis_then_codec(port):
    """F0 equal to batch_analyze's and the coded frames equal to the codec
    on its envelope and aperiodicity, bit for bit; the shapes
    [B, n_grid], [B, n_grid, 60], [B, n_grid, 2]."""
    kw, (f0, mcep, bap), (f0a, spec, ap) = port
    n = kw["geo"].n_grid()
    assert f0.shape == (2, n) and mcep.shape == (2, n, N_DIMS)
    assert bap.shape == (2, n, TC.get_number_of_aperiodicities(kw["fs"]))
    assert (f0 > 0).float().mean() > 0.3
    want = _coded(spec, ap, fs=kw["fs"], fft_size=kw["fft_size"])
    assert torch.equal(f0, f0a)
    assert torch.equal(mcep, want[0]) and torch.equal(bap, want[1])
    assert all(torch.isfinite(t).all() for t in (mcep, bap))


def test_pitch_scale_reaches_the_analysis(t22x2):
    """At pitch 0.8 the F0 is batch_analyze's at 0.8 and the coded frames
    the codec of its analysis, bit for bit."""
    fs, x = t22x2
    kw = _kw(fs, x.shape[1])
    xt = torch.tensor(x[:1])
    f0, mcep, bap = TB.batch_features(xt, n_dims=N_DIMS, pitch_scale=0.8,
                                      **kw)
    f0a, spec, ap = TB.batch_analyze(xt, pitch_scale=0.8, **kw)
    want = _coded(spec, ap, fs=fs, fft_size=kw["fft_size"])
    assert torch.equal(f0, f0a)
    assert torch.equal(mcep, want[0]) and torch.equal(bap, want[1])


def _band_db_tol(ap, fs, fft_size):
    """[B * F, n_ap]: the coded aperiodicity's image of D4C_ATOL: at each
    band, 20 log10(1 + D4C_ATOL / a) for the least aperiodicity a of the
    two bins interpolated."""
    out = []
    for b in range(TC.get_number_of_aperiodicities(fs)):
        j = int(3000.0 * (b + 1) * fft_size / fs)
        a = np.minimum(ap[:, j], ap[:, min(j + 1, ap.shape[1] - 1)])
        out.append(20.0 * np.log10(1.0 + D4C_ATOL / a))
    return np.stack(out, axis=-1)


def test_features_match_jax(port, t22x2):
    """Against the JAX package: its codec on the port's analysis within
    the codec's float32 tolerances; its whole chain (its float32
    batch_analyze, then its codec) with the same voicing, F0 within 1e-3
    relative (the two float32 refinements), the coded envelope within the
    codec's tolerance and the coded aperiodicity within the image of the
    D4C tolerance."""
    import jax.numpy as jnp
    from worldtpu import codec as J
    from worldtpu.analysis import harvest as JH
    from worldtpu.parallel import batch as JB
    kw, (f0, mcep, bap), (_, spec, ap) = port
    fs, fft = kw["fs"], kw["fft_size"]
    f0, mcep, bap = f0.numpy(), mcep.numpy(), bap.numpy()
    B, F, K = spec.shape

    def jcode(s, a):
        cs = J.code_spectral_envelope(jnp.asarray(s.reshape(B * F, K)),
                                      fs=fs, fft_size=fft, n_dims=N_DIMS)
        ca = J.code_aperiodicity(jnp.asarray(a.reshape(B * F, K)), fs=fs,
                                 fft_size=fft)
        return (np.asarray(cs).reshape(B, F, -1),
                np.asarray(ca).reshape(B, F, -1))

    jm, jb = jcode(spec.numpy(), ap.numpy())
    assert np.abs(mcep - jm).max() <= F32_CODED_SPEC_REL * np.abs(jm).max()
    np.testing.assert_allclose(bap, jb, rtol=0, atol=F32_AP_DB_ATOL)

    _, x = t22x2
    jf0, jspec, jap = JB.batch_analyze(
        jnp.asarray(x), geo=JH.HarvestGeometry(fs, x.shape[1],
                                               f0_floor=40.0),
        fs=fs, fft_size=fft, max_half_window=kw["max_half_window"])
    jf0, jspec, jap = (np.asarray(a) for a in (jf0, jspec, jap))
    np.testing.assert_array_equal(f0 > 0, jf0 > 0)
    np.testing.assert_allclose(f0, jf0, rtol=1e-3, atol=0)
    jm, jb = jcode(jspec, jap)
    assert np.abs(mcep - jm).max() <= F32_CODED_SPEC_REL * np.abs(jm).max()
    tol = _band_db_tol(jap.reshape(B * F, K), fs, fft).reshape(jb.shape)
    assert (np.abs(bap - jb) <= tol).all(), np.abs(bap - jb).max()


def test_features_refuse_no_option():
    """n_dims is the one option beyond batch_analyze's."""
    import inspect
    extra = set(inspect.signature(TB.batch_features).parameters) - set(
        inspect.signature(TB.batch_analyze).parameters)
    assert extra == {"n_dims"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_batch(dev, fs=22050, n=2, dur=0.8):
    """Two 0.8 s rows of gliding harmonics with a gap, on the card."""
    rng = np.random.RandomState(0)
    T = int(fs * dur)
    t = np.arange(T) / fs
    rows = []
    for i in range(n):
        ph = 2 * np.pi * np.cumsum((110 + 40 * i)
                                   * 2 ** (0.2 * np.sin(6 * np.pi * t))) / fs
        r = 0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph)
        r[int(0.3 * T):int(0.4 * T)] = 0.0
        rows.append(r + 0.003 * rng.randn(T))
    return torch.tensor(np.stack(rows).astype(np.float32), device=dev), \
        _kw(fs, T)


#: the stages a feature batch marks, in order
FEATURE_STAGES = ("decimate", "band_filter", "zc", "detect_overlap",
                  "refine_prepare", "refine_sums", "refine_finish", "prune",
                  "contour", "cheaptrick", "d4c", "codec")


@pytest.mark.cuda
def test_replayed_features_equal_eager_and_keep_the_codec_marks(dev):
    """batch_features' eager call, capture and replays give the eager
    program's bits (``_features`` run outside the cache) at pitches 1.0
    and 0.9 (one program serves both), with no host synchronisation
    eagerly nor in a replay; the codec equals the card's codec on the
    card's analysis; a profiled replay runs the 24 marks of the analysis'
    11 stages and the codec's, in order."""
    x, kw = _card_batch(dev)
    kw = dict(kw, n_dims=N_DIMS)
    TG.clear()
    try:
        def eager_call(p):
            with torch.no_grad():
                return TB._features(x, TG.scale_buffer(p, x), grid_ms=1,
                                    **kw)

        eager_call(1.0)               # a geometry's first call fills caches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = {p: eager_call(p) for p in (1.0, 0.9)}
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = [TB.batch_features(x, pitch_scale=p, **kw)
               for p in (1.0, 0.9, 1.0)]
        assert len(TG.programs()) == 1
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got.append(TB.batch_features(x, pitch_scale=0.9, **kw))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for g, p in zip(got, (1.0, 0.9, 1.0, 0.9)):
            assert all(torch.equal(u, v) for u, v in zip(g, eager[p]))
        f0a, spec, ap = TB.batch_analyze(
            x, **{k: kw[k] for k in ("geo", "fs", "fft_size",
                                     "max_half_window")})
        assert torch.equal(f0a, eager[1.0][0])
        want = _coded(spec, ap, fs=kw["fs"], fft_size=kw["fft_size"])
        assert torch.equal(want[0], eager[1.0][1])
        assert torch.equal(want[1], eager[1.0][2])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            again = TB.batch_features(x, pitch_scale=1.0, **kw)
            torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(again, eager[1.0]))
    finally:
        TG.clear()
    marks = [e.name() for e in sorted(
        prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
        if str(e.device_type()).endswith("CUDA")
        and e.name().startswith("wt_mark_")]
    assert marks == [f"wt_mark_{s}_{side}" for s in FEATURE_STAGES
                     for side in ("in", "out")]
    assert set(FEATURE_STAGES) <= set(tracing.STAGES)
