"""The port's long audio in float64 (``dtype=torch.float64`` through
LongHarvest and LongPipeline) against ``worldtpu``'s float64 long audio
(x64, CPU), and inside the port.

Against worldtpu: the float64 noise rows' bits and uniforms equal JAX's
(``jax.random.bits`` at uint64, ``jax.random.uniform``), the normals within
1e-10 of ``jax.random.normal``; the chunked time base equals
``worldtpu.longaudio._timebase_core`` in float64 pulse for pulse (the Q32
phase carried across chunks, block-local times and interp1 over the
block's knots; no sequential double sum); LongHarvest's F0 equals JAX's to
1e-8 Hz with identical voicing; and LongPipeline, on one F0 contour with
the same key, equals JAX's pipeline with its chunk step run un-jitted (its
time base then is the _timebase_core above): every 100 ms window past the
first within 1e-12 relative.  The first window differs because the port
pads the recording with its edge values where worldtpu pads zeros (the port's
departure, kept for float64).  worldtpu's jitted chunk step rounds its
float64 time base apart from its own un-jitted one at voicing knife edges
(a sample that lies half way between two knots) and moves pulses by a
sample, as its float32 one does (ROADMAP, "Q32 pulse wobble").

Inside the port, exactly or to float64 rounding: the frame-blocked float64
analysis is the unchunked float64 analysis, and the parallel mode the
sequential one.  Not one chunk size another: the block-local times of
worldtpu's float64 time base round a knife-edge sample with the block's
origin, so another chunk size can move a pulse by a sample and every later
one with it (on this contour, 100- against 400-frame chunks: 686 pulses
each, the 232nd on apart; PERF.md, section 6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_longform import _long_utterance
from test_torch_longaudio import FS, _assert_match, _contour, _windowed_rel
from worldtpu import longaudio as JLA
from worldtpu.analysis import longform as JL
from worldtpu.synthesis import synthesis as JS
from worldtpu_torch import longaudio as TLA
from worldtpu_torch.analysis import longform as TL
from worldtpu_torch.synthesis import noise as TN

torch.set_num_threads(1)

F64 = torch.float64


def _pipeline(chunk_frames, contour=None):
    """The port's LongPipeline; with ``contour`` (f0, tpos), its Harvest
    gives that contour."""
    lp = TLA.LongPipeline(FS, f0_floor=40.0, chunk_frames=chunk_frames,
                          harvest_chunk_ms=1500, harvest_halo_ms=750,
                          device="cpu")
    if contour is not None:
        lp.harvest.compute = lambda x, dtype=None: contour
    return lp


@pytest.fixture(scope="module")
def utterance():
    x = _long_utterance(FS, 3.0, seed=5).astype(np.float64)
    return x, _contour(len(x))


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 5, "tensor"])
def test_f64_noise_matches_jax(start):
    """Rows of 64-bit draws: the bits (Threefry's x0 << 32 | x1) and the
    uniforms exactly JAX's, the normals (torch.erfinv against XLA's
    float64 erfinv) within 1e-10 of jax.random.normal and of worldtpu's
    indexed_noise in float64; a tensor start and a batch of starts give
    the same rows."""
    lo = np.nextafter(-1.0, 0.0)
    for seed in (7, 2 ** 32 + 11):
        key = jax.random.PRNGKey(seed)
        s0 = 1234 if start == "tensor" else start
        st = torch.tensor(s0) if start == "tensor" else start
        for i in (0, 3, 70, 2 ** 31):
            k = jax.random.fold_in(key, s0 + i)
            want = np.asarray(jax.random.bits(k, (512,), jnp.uint64))
            y0, y1 = TN.row_words(seed, torch.tensor(s0 + i), 512)
            got = ((y0.numpy().astype(np.uint64) << np.uint64(32))
                   | y1.numpy().astype(np.uint64))
            np.testing.assert_array_equal(got, want)
            u = TN.uniform64(y0, y1)
            np.testing.assert_array_equal(u.numpy(), np.asarray(
                jax.random.uniform(k, (512,), jnp.float64, lo, 1.0)))
        rows = TN.indexed_noise(seed, st, 40, 512, dtype=F64)
        assert rows.shape == (40, 512) and rows.dtype == F64
        want = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key, s0 + i), (512,), jnp.float64))
            for i in range(40)])
        np.testing.assert_allclose(rows.numpy(), want, rtol=0, atol=1e-10)
        np.testing.assert_allclose(
            rows.numpy(), np.asarray(JS.indexed_noise(key, s0, 40, 512,
                                                      jnp.float64)),
            rtol=0, atol=1e-10)
        both = TN.indexed_noise(seed, torch.tensor([s0, s0 + 20]), 20, 512,
                                dtype=F64)
        assert torch.equal(both[0], rows[:20])
        assert torch.equal(both[1], rows[20:])
    with pytest.raises(ValueError, match="float32 or float64"):
        TN.indexed_noise(7, 0, 4, 16, dtype=torch.float16)


# ---------------------------------------------------------------------------
# the chunked time base against worldtpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_frames", [37, 150, 420])
def test_f64_chunked_pulses_equal_jax_timebase(utterance, chunk_frames):
    """Chunk by chunk, from the same carry, the port's float64 time base
    is worldtpu.longaudio._timebase_core in float64 (Q32 steps, the
    carried int cumsum): the same phase bits on every sample up to the
    output's end, pulses, ownership and carry; on a contour with voicing
    knife edges, pitch x1.2 and duration x1.25.  Past the output's end the
    port reads the recording's extrapolated knot where worldtpu reads the
    edge-padded one; no pulse lies there."""
    x, (f0, _) = utterance
    f0 = f0 * 1.2
    lp = _pipeline(chunk_frames)
    p = lp.plan(x, f0, 1.25, F64)
    assert p.n_chunks >= 2 and p.cf0_dev.dtype == F64
    F_pad = p.F_total + p.Fb
    f0_pad = np.concatenate([f0, np.full(F_pad - p.F_total, f0[-1])])
    carry = torch.zeros(1, dtype=torch.int64)
    jc = jnp.zeros((), jnp.uint32)
    n_pulses = 0
    for k in range(p.n_chunks):
        tb = TLA._timebase_core(p, torch.tensor([k]), carry)
        flo = p.flo[k]
        jt = JLA._timebase_core(
            jnp.asarray(f0_pad[flo:flo + p.Fb]), k * p.L,
            jnp.asarray(flo, jnp.int32), jc, dt=jnp.float64, fs=FS,
            fft_size=lp.fft_size, fp_s=p.fp_s, L=p.L, slack=p.slack,
            Fb=p.Fb, Pmax=p.Pmax, out_length=p.out_length, Fg=F_pad - p.Fb)
        m = min(p.L + p.slack, p.out_length - k * p.L)
        np.testing.assert_array_equal(
            tb["fbits"][0, :m].numpy(),
            np.asarray(jt["fbits"]).astype(np.int64)[:m])
        np.testing.assert_array_equal(tb["vuvi"][0, :m].numpy(),
                                      np.asarray(jt["vuvi"])[:m])
        for name in ("idx", "own"):
            np.testing.assert_array_equal(tb[name][0].numpy(),
                                          np.asarray(jt[name]))
        for name in ("n_det", "n_own", "overflowed"):
            assert int(tb[name][0]) == int(jt[name]), (k, name)
        # the carry of the chunk that ends past the output is never used
        if p.L <= m:
            assert int(tb["carry_out"][0]) == int(jt["carry_out"]), k
        n_pulses += int(tb["n_own"][0])
        carry, jc = tb["carry_out"], jt["carry_out"]
    assert n_pulses > 500


# ---------------------------------------------------------------------------
# LongHarvest and LongPipeline against worldtpu's
# ---------------------------------------------------------------------------

def test_f64_long_harvest_matches_jax():
    """float64 LongHarvest (the parity path's stages on each window, mean
    0, one host contour) against worldtpu's float64 LongHarvest.compute:
    two chunks, in two batches of one window on the port's side; voicing
    identical, F0 within 1e-8 Hz (two FFT libraries and other reduction
    orders; tests/test_torch_f64_harvest.py's facade tolerance)."""
    fs = 16000
    x = _long_utterance(fs, 3.0, seed=2).astype(np.float64)
    kw = dict(chunk_ms=1500, halo_ms=750)
    f0j, tpj = JL.LongHarvest(fs, **kw).compute(x, dtype=jnp.float64)
    lh = TL.LongHarvest(fs, device="cpu", **kw)
    assert lh.n_chunks(len(x)) == 2
    f0t, tpt = lh.compute(x, dtype=F64, max_batch=1)
    assert f0t.dtype == tpt.dtype == np.float64
    np.testing.assert_array_equal(tpt, tpj)
    np.testing.assert_array_equal(f0t > 0, f0j > 0)
    assert (f0t > 0).mean() > 0.6
    np.testing.assert_allclose(f0t, f0j, rtol=0, atol=1e-8)
    # the default batch (MAX_BATCH) gives the same contour
    f0d, _ = lh.compute(x, dtype=F64)
    np.testing.assert_array_equal(f0d, f0t)


def test_f64_long_pipeline_matches_jax(utterance, monkeypatch):
    """One F0 contour on both sides, the same key, pitch x1.2 and duration
    x1.25, worldtpu's chunk step un-jitted: _assert_match's gates with
    q90 < 0.1, and from the measurement: every 100 ms window but the first
    within 1e-12 relative (measured 5e-15), the first within 1e-2
    (measured 8.6e-3: the edge values the port pads with, where worldtpu
    pads zeros, reach its first frames' analysis), so q99 < 1e-2."""
    x, (f0, t) = utterance
    monkeypatch.setattr(JLA, "_chunk_step", JLA._chunk_step.__wrapped__)
    jl = JLA.LongPipeline(FS, f0_floor=40.0, chunk_frames=120)
    jl.harvest.compute = lambda x, dtype=None: (f0, t)
    yj, f0j = jl.copy_synthesis(x, key=jax.random.PRNGKey(3),
                                pitch_scale=1.2, duration_scale=1.25,
                                dtype=jnp.float64)
    yt, f0t = _pipeline(120, (f0, t)).copy_synthesis(
        x, seed=3, pitch_scale=1.2, duration_scale=1.25, dtype=F64)
    np.testing.assert_array_equal(f0t, f0j)
    assert yt.dtype == np.float64 and yt.shape == yj.shape
    _assert_match(yt, yj)
    rel = _windowed_rel(yt, yj)
    assert float(rel[0]) < 1e-2
    assert float(rel[1:].max()) < 1e-12
    assert float(np.quantile(rel, 0.99)) < 1e-2


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

def test_f64_chunked_analysis_equals_unchunked(utterance):
    """Each block's float64 CheapTrick and D4C frames (the parity path's
    literal windows, read from the slice with its first sample, the
    recording's float64 frame times, its edge values past its ends) are
    the unchunked float64 analysis' frames bit for bit."""
    from worldtpu_torch.analysis.cheaptrick import cheaptrick_frames
    from worldtpu_torch.analysis.d4c import d4c_frames
    x, (f0, _) = utterance
    lp = _pipeline(150)
    p = lp.plan(x, f0, 1.25, F64)
    F = len(f0)
    tp = torch.arange(F, dtype=F64) * 0.005
    xt, ft = torch.tensor(x)[None], torch.tensor(f0)[None]
    su = cheaptrick_frames(xt, ft, tp, fs=FS, fft_size=lp.fft_size,
                           max_half_window=lp.max_half_window)[0]
    au = d4c_frames(xt, ft, tp, fs=FS, fft_size_out=lp.fft_size)[0]
    assert su.dtype == au.dtype == F64
    compared = 0
    for k0 in range(0, p.n_chunks, 2):
        k1 = min(k0 + 2, p.n_chunks)
        spec, ap = TLA._analysis(p, torch.arange(k0, k1))
        for g, k in enumerate(range(k0, k1)):
            lo = p.flo[k]
            fr = np.arange(lo, min(lo + p.Fb, F))
            assert torch.equal(spec[g, fr - lo], su[fr])
            assert torch.equal(ap[g, fr - lo], au[fr])
            compared += len(fr)
    assert compared >= F


def test_f64_parallel_matches_sequential(utterance, monkeypatch):
    """float64, on one contour: parallel=True (groups of 3 chunks as rows,
    more chunks than one group) equals the sequential mode to float64
    rounding (1e-12 of the largest sample); the F0 identical."""
    x, contour = utterance
    monkeypatch.setattr(TLA, "PARALLEL_GROUP", 3)
    lp = _pipeline(100, contour)
    ys, f0s = lp.copy_synthesis(x, seed=7, dtype=F64)
    yp, f0p = lp.copy_synthesis(x, seed=7, dtype=F64, parallel=True)
    assert lp.plan(x, f0s, dtype=F64).n_chunks > 6
    np.testing.assert_array_equal(f0s, f0p)
    scale = float(np.abs(ys).max())
    assert scale > 0.01 and np.isfinite(ys).all()
    assert float(np.abs(yp - ys).max()) <= 1e-12 * scale
    # float32 input gives a float32 waveform of the float64 compute
    y32, _ = lp.copy_synthesis(x.astype(np.float32), seed=7, dtype=F64)
    assert y32.dtype == np.float32
