"""The port's long-audio pipeline (worldtpu_torch.longaudio) and its
counter-based noise (worldtpu_torch.synthesis.noise), on the CPU.

Against worldtpu: the noise bits of a (key, global ordinal) row equal
JAX's, the normals within 1e-5; LongPipeline.copy_synthesis with the same
key passes tests/test_longaudio.py's _assert_waveforms_match gates plus a
q90 gate on the windowed relative error (a noise desync that starts past
the midpoint leaves the median under its gate; the q90 catches it), against
worldtpu's LongPipeline and, with q99 < 1e-3, against worldtpu's unchunked
analysis and synthesis.
Inside the port, exactly: the chunked pulses (positions, shifts, noise
sizes, voicing) are the unchunked time base's at three chunk sizes, the
last segment included, the parallel mode's are the sequential mode's, and
the frame-blocked analysis gives the unchunked analysis' frames; across
chunk sizes and modes the waveforms agree to float32 rounding.

The pipeline tests feed both sides one F0 contour (the analytic F0 of the
test utterance with knife edges added) in place of LongHarvest, which
tests/test_torch_longform.py holds to JAX's; tests/test_torch_longaudio_jax.py
runs both pipelines whole."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_longaudio import _assert_waveforms_match
from test_longform import _long_utterance
from worldtpu import longaudio as JLA
from worldtpu.analysis.cheaptrick import CheapTrickKernel, cheaptrick_frames
from worldtpu.analysis.d4c import d4c_frames
from worldtpu.synthesis import synthesis as JS
from worldtpu_torch import longaudio as TLA
from worldtpu_torch.synthesis import noise as TN
from worldtpu_torch.synthesis import synthesis as TS

torch.set_num_threads(1)

FS_ALL = (8000, 16000, 22050, 24000, 44100, 48000)
FS = 16000


def _windowed_rel(yc, yu, fs=FS):
    """Relative error of yc against yu in 100 ms windows (the windows and
    floor of _assert_waveforms_match)."""
    yc, yu = yc.astype(np.float64), yu.astype(np.float64)
    w = int(0.1 * fs)
    n = (len(yu) // w) * w
    dw = np.sqrt(((yc[:n] - yu[:n]).reshape(-1, w) ** 2).mean(axis=1))
    uw = np.sqrt((yu[:n].reshape(-1, w) ** 2).mean(axis=1))
    return dw / np.maximum(uw, np.median(uw) * 1e-3)


def _assert_match(yc, yu):
    _assert_waveforms_match(yc, yu)
    q90 = float(np.quantile(_windowed_rel(yc, yu), 0.9))
    assert q90 < 0.1, f"q90 windowed rel {q90}"


def _contour(n_samples, fs=FS):
    """The utterance's analytic F0 on the 5 ms grid (the _long_utterance
    formula, its unvoiced gap and silent tail) with voicing knife edges:
    one-frame voiced and unvoiced islands, frames below the synthesis'
    lowest F0, and a steep rise into the last voiced frames so the
    extrapolated knot differs from the edge value."""
    F = 1 + int(1000.0 * n_samples / fs / 5.0)
    t = np.arange(F) * 0.005
    dur = n_samples / fs
    f0 = 170 * 2 ** ((40 / 1200) * np.sin(2 * np.pi * 0.35 * t))
    f0[(t >= 0.42 * dur) & (t < 0.47 * dur)] = 0.0
    f0[t >= dur - 0.4] = 0.0
    f0[60] = 0.0                   # one unvoiced frame in voiced speech
    gap = np.nonzero(t >= 0.42 * dur)[0][4]
    f0[gap] = 150.0                # one voiced frame in the gap
    f0[100:102] = 10.0             # below the lowest F0: unvoiced
    f0[-6:-1] = np.linspace(120.0, 260.0, 5)   # sloped, voiced end
    f0[-1] = 300.0
    return f0, t


def _pipeline(chunk_frames, contour=None):
    """The port's LongPipeline; with ``contour`` (f0, tpos), its Harvest
    gives that contour."""
    lp = TLA.LongPipeline(FS, f0_floor=40.0, chunk_frames=chunk_frames,
                          harvest_chunk_ms=1500, harvest_halo_ms=750,
                          device="cpu")
    if contour is not None:
        lp.harvest.compute = lambda x, dtype=None: contour
    return lp


# ---------------------------------------------------------------------------
# geometry and noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fs", FS_ALL)
def test_analysis_halo_matches_jax(fs):
    for floor in (40.0, 71.0, 100.0):
        assert TLA.analysis_halo_samples(fs, floor) \
            == JLA.analysis_halo_samples(fs, floor)


@pytest.mark.parametrize("start", [0, 5, "tensor"])
def test_noise_matches_jax(start):
    """Bits equal to jax.random.bits of fold_in(PRNGKey(s), ordinal), the
    normals within 1e-5 of jax.random.normal and of worldtpu's
    indexed_noise; a tensor start (the sequential mode's device-resident
    ordinal) and a batch of starts give the same rows."""
    for seed in (7, 2 ** 32 + 11):
        key = jax.random.PRNGKey(seed)
        s0 = 1234 if start == "tensor" else start
        st = torch.tensor(s0) if start == "tensor" else start
        for i in (0, 3, 70):
            want = np.asarray(jax.random.bits(
                jax.random.fold_in(key, s0 + i), (512,), jnp.uint32))
            got = TN.row_bits(seed, torch.tensor(s0 + i), 512).numpy()
            np.testing.assert_array_equal(got, want.astype(np.int64))
        rows = TN.indexed_noise(seed, st, 80, 512)
        assert rows.shape == (80, 512) and rows.dtype == torch.float32
        want = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key, s0 + i), (512,), jnp.float32))
            for i in range(80)])
        np.testing.assert_allclose(rows.numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            rows.numpy(), np.asarray(JS.indexed_noise(key, s0, 80, 512,
                                                      jnp.float32)),
            rtol=0, atol=1e-5)
        both = TN.indexed_noise(seed, torch.tensor([s0, s0 + 40]), 40, 512)
        assert torch.equal(both[0], rows[:40])
        assert torch.equal(both[1], rows[40:])


def test_noise_key_forms():
    assert TN.prng_key(7) == (0, 7)
    assert TN.prng_key(2 ** 32 + 11) == (1, 11)
    words = np.asarray(jax.random.PRNGKey(2 ** 32 + 11))
    assert TN.as_key(words) == TN.as_key(2 ** 32 + 11) == (1, 11)
    assert TN.as_key(torch.tensor([1, 11])) == (1, 11)
    with pytest.raises(ValueError):
        TN.as_key((1, 2, 3))
    with pytest.raises(ValueError):
        TN.indexed_noise(7, 0, 4, 16, dtype=torch.float16)


# ---------------------------------------------------------------------------
# the chunked time base against the unchunked one
# ---------------------------------------------------------------------------

def _chunked_pulses(lp, x, f0, duration_scale):
    """Every owned pulse of the chunked time base, chunk by chunk from the
    parallel mode's prescan, in global terms: (position, shift, noise
    size, voicing), with the prescan's carries and ordinals."""
    p = lp.plan(x, f0, duration_scale)
    carries, ords, ovf = TLA._phase_prescan(p, torch.device("cpu"))
    assert not bool(ovf.any())
    cols = [[], [], [], []]
    for k in range(p.n_chunks):
        pul = TLA._pulse_table(p, torch.tensor([k]), carries[k:k + 1])
        own = pul["own"][0]
        n_own = int(pul["n_own"][0])
        assert bool(own[:n_own].all()) and not bool(own[n_own:].any())
        assert int(ords[k]) == sum(len(c) for c in cols[0])
        if k + 1 < p.n_chunks:
            assert int(carries[k + 1]) == int(pul["carry_out"][0])
        cols[0].append((k * p.L + pul["idx"][0])[own])
        for c, name in zip(cols[1:], ("shift", "ns", "vuv_at")):
            c.append(pul[name][0][own])
    return p, [torch.cat(c) for c in cols]


@pytest.mark.parametrize("chunk_frames", [37, 150, 420])
def test_chunked_time_base_equals_unchunked(chunk_frames):
    """Pulse for pulse, the chunked time base is the unchunked _time_base
    (positions, sub-sample shifts, noise sizes, voicing: bit for bit) on a
    contour with voicing knife edges and a sloped end, with the true
    extrapolated last knot (and its voicing twin)."""
    n = int(FS * 3.2)
    x = np.zeros(n, np.float32)
    f0, _ = _contour(n)
    f0 = f0 * 1.2
    dur = 1.25
    lp = _pipeline(chunk_frames)
    p, (pos, shift, ns, vuv) = _chunked_pulses(lp, x, f0, dur)
    assert p.n_chunks >= 3 if chunk_frames < 420 else p.n_chunks >= 2
    fp_s = 0.005 * dur
    assert p.fp_s == fp_s
    f0t = torch.tensor(f0.astype(np.float32))[None]
    mp = TS.default_max_pulses(p.out_length, FS)
    idx, sh, n_p, vuv_at, valid, ovf = TS._time_base(
        f0t, FS, fp_s, p.out_length, FS / lp.fft_size + 1.0, mp)
    assert not bool(ovf.any())
    n_p = int(n_p[0])
    nxt = torch.minimum(torch.arange(mp) + 1, torch.tensor(n_p - 1))
    ns_u = torch.where(valid[0], idx[0][nxt] - idx[0], 0)
    assert len(pos) == n_p > 100
    assert torch.equal(pos, idx[0, :n_p])
    assert torch.equal(shift, sh[0, :n_p])
    assert torch.equal(ns, ns_u[:n_p])
    assert torch.equal(vuv, vuv_at[0, :n_p])
    # the last pulse's noise size is 0 (nothing follows it), as unchunked
    assert int(ns[-1]) == 0


# ---------------------------------------------------------------------------
# LongPipeline against worldtpu's
# ---------------------------------------------------------------------------

def test_long_pipeline_matches_jax_same_f0():
    """One F0 contour on both sides, with pitch and duration scaling and
    chunks much shorter than the frame blocks' halo."""
    x = _long_utterance(FS, 3.0, seed=5)
    f0, t = _contour(len(x))
    jl = JLA.LongPipeline(FS, f0_floor=40.0, chunk_frames=120)
    jl.harvest.compute = lambda x, dtype=None: (f0, t)
    yj, f0j = jl.copy_synthesis(x, key=jax.random.PRNGKey(3),
                                pitch_scale=1.2, duration_scale=1.25)
    yt, f0t = _pipeline(120, (f0, t)).copy_synthesis(
        x, seed=3, pitch_scale=1.2, duration_scale=1.25)
    np.testing.assert_array_equal(f0t, f0j)
    assert len(yt) == len(yj)
    _assert_match(yt, yj)


def _unchunked_jax(x, f0, key):
    """worldtpu's unchunked analysis and synthesis of x on the F0 contour
    f0 (pitch-scaled), with the noise rows of indexed_noise(key, 0, ...)."""
    F = len(f0)
    ck = CheapTrickKernel(FS)
    tpos = jnp.asarray((np.arange(F) * 0.005).astype(np.float32))
    f0j, xj = jnp.asarray(f0, jnp.float32), jnp.asarray(x)
    spec = cheaptrick_frames(xj, f0j, tpos, fs=FS, fft_size=ck.fft_size,
                             max_half_window=ck.max_half_window)
    ap = d4c_frames(xj, f0j, tpos, fs=FS, fft_size_out=ck.fft_size)
    out_len = int((F - 1) * 0.005 * FS) + 1
    mp = JS.estimate_max_pulses(f0.astype(np.float32), FS, ck.fft_size,
                                out_len)
    noise = JS.indexed_noise(key, 0, mp, ck.fft_size, jnp.float32)
    return np.asarray(JS.synthesis_frames_impl(
        f0j, spec, ap, noise, fs=FS, fft_size=ck.fft_size,
        frame_period_s=0.005, out_length=out_len, max_pulses=mp))


def test_long_pipeline_matches_unchunked_jax(utterance):
    """worldtpu's jitted chunk step may place a knife-edge pulse apart from
    worldtpu's own unchunked synthesis; the port's LongPipeline is held to
    that unchunked path (CheapTrick and D4C as jitted there,
    synthesis_frames_impl called as tests/test_longaudio.py calls it, the
    same noise rows) on one F0 contour: the waveform gates, q90 < 0.1 and
    q99 < 1e-3."""
    x, (f0, t) = utterance
    y, f0s = _pipeline(150, (f0, t)).copy_synthesis(x, seed=5,
                                                     pitch_scale=1.2)
    yu = _unchunked_jax(x, f0s, jax.random.PRNGKey(5))
    assert len(y) == len(yu)
    _assert_match(y, yu)
    assert float(np.quantile(_windowed_rel(y, yu), 0.99)) < 1e-3


# ---------------------------------------------------------------------------
# LongPipeline inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def utterance():
    x = _long_utterance(FS, 3.0, seed=6)
    return x, _contour(len(x))


def test_chunked_analysis_equals_unchunked(utterance):
    """Each block's CheapTrick and D4C frames (its audio slice, the
    recording's frame times, the slice's first sample, the recording's
    edge values past its ends) are the unchunked analysis' frames bit for
    bit, the first and last frames included."""
    from worldtpu_torch.analysis.cheaptrick import cheaptrick_frames
    from worldtpu_torch.analysis.d4c import d4c_frames
    x, (f0, _) = utterance
    lp = _pipeline(150)
    p = lp.plan(x, f0, 1.25)
    F = len(f0)
    tp = torch.arange(F, dtype=torch.float32) * 0.005
    xt, ft = torch.tensor(x)[None], torch.tensor(f0.astype(np.float32))[None]
    su = cheaptrick_frames(xt, ft, tp, fs=FS, fft_size=lp.fft_size,
                           max_half_window=lp.max_half_window)[0]
    au = d4c_frames(xt, ft, tp, fs=FS, fft_size_out=lp.fft_size)[0]
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


def test_chunk_size_invariance(utterance):
    """The waveform does not depend on the chunk size (counter-based noise,
    carried Q32 phase, the recording's frame times in every block): the
    same samples to float32 rounding."""
    x, contour = utterance
    ya, _ = _pipeline(90, contour).copy_synthesis(x, seed=1)
    yb, _ = _pipeline(400, contour).copy_synthesis(x, seed=1)
    assert len(ya) == len(yb)
    _assert_match(ya, yb)
    rel = _windowed_rel(ya, yb)
    assert float(np.quantile(rel, 0.99)) < 1e-3
    assert float(np.abs(ya - yb).max()) <= 1e-5 * float(np.abs(yb).max())


def test_parallel_matches_sequential(utterance, monkeypatch):
    """parallel=True (the prescan, then groups of chunks as rows) against
    the sequential carried path: the same F0, and on the CPU the same
    samples to float32 rounding; more chunks than one group."""
    x, contour = utterance
    monkeypatch.setattr(TLA, "PARALLEL_GROUP", 3)
    lp = _pipeline(100, contour)
    ys, f0s = lp.copy_synthesis(x, seed=7)
    yp, f0p = lp.copy_synthesis(x, seed=7, parallel=True)
    assert lp.plan(x, f0s).n_chunks > 6
    np.testing.assert_array_equal(f0s, f0p)
    assert float(np.abs(yp - ys).max()) <= 1e-5 * float(np.abs(ys).max())


def test_length_and_scaling(utterance):
    x, (f0, t) = utterance
    y, f0o = _pipeline(200, (f0, t)).copy_synthesis(
        x, pitch_scale=1.2, duration_scale=1.25)
    F = len(f0o)
    assert F == len(f0)
    np.testing.assert_array_equal(f0o, f0 * 1.2)
    assert len(y) == int((F - 1) * 0.005 * 1.25 * FS) + 1
    assert y.dtype == x.dtype
    assert np.isfinite(y).all()
    assert np.abs(y).max() > 0.01
    y64, _ = _pipeline(200, (f0, t)).copy_synthesis(x.astype(np.float64))
    assert y64.dtype == np.float64


def test_on_overflow_raise_and_warn(utterance, monkeypatch):
    """A pulse bound too small for the chunk raises, or warns and returns
    the (truncated) output."""
    x, contour = utterance
    real = TLA._plan

    def small(*a, **k):
        return dataclasses.replace(real(*a, **k), Pmax=16)
    monkeypatch.setattr(TLA, "_plan", small)
    lp = _pipeline(200, contour)
    with pytest.raises(RuntimeError, match="pulse bound"):
        lp.copy_synthesis(x)
    with pytest.warns(UserWarning, match="pulse bound"):
        y, _ = lp.copy_synthesis(x, parallel=True, on_overflow="warn")
    assert np.isfinite(y).all()


def test_float16_raises(utterance):
    """A dtype the pipeline does not compute in (float16) raises; float64
    long audio is ported (tests/test_torch_longaudio_f64.py)."""
    x, contour = utterance
    with pytest.raises(ValueError, match="unsupported dtype"):
        _pipeline(200, contour).copy_synthesis(x, dtype=torch.float16)
