"""The port's float64 synthesis on the CPU against the C++ golden waveforms
(tests/fixtures/t*.syn2.f64.gz: synthesis alone, a fresh randn() stream;
t*.syn.f64.gz: the whole pipeline, the stream continued past the analysis
dithers; t16.pulses: the time base's pulses), against the JAX package in
float64, the OLA's order of additions in float64, and the float32 main
path's results bit for bit as they were before the float64 path was
added."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURES, load_fixture
from worldtpu.synthesis import synthesis as JS
from worldtpu_torch import api
from worldtpu_torch.analysis import d4c as TD
from worldtpu_torch.analysis import dither as D
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
from worldtpu_torch.ops import ola_kernel as TO
from worldtpu_torch.parallel import batch as TB
from worldtpu_torch.synthesis import synthesis as TS

torch.set_num_threads(1)


def _setup(f):
    fp_s = f.frame_period / 1000.0
    out_length = int((len(f.f0) - 1) * fp_s * f.fs) + 1
    return dict(fs=f.fs, fft_size=f.fft_size, frame_period_s=fp_s,
                out_length=out_length,
                max_pulses=TS.default_max_pulses(out_length, f.fs))


def _synth(f, noise, kw):
    return TS.synthesis_frames(
        torch.tensor(f.f0), torch.tensor(f.spec), torch.tensor(f.ap),
        torch.tensor(noise), **kw).numpy()


def _analysis_generator(f):
    """The xorshift generator after the draws of CheapTrick's and D4C's
    dithers on fixture f, in the reference pipeline's call order."""
    x, f0, tpos = (torch.tensor(f.x)[None], torch.tensor(f.f0)[None],
                   torch.tensor(f.tpos))
    kern = CheapTrickKernel(f.fs, f0_floor=71.0)
    _, _, gen = D.cheaptrick_dither(f.f0, f.fs, kern.fft_size,
                                    kern.max_half_window)
    lt, gen = D.d4c_love_train_dither(f.f0, f.fs, TD.d4c_max_half_lt(f.fs),
                                      gen)
    ap0 = TD.love_train_ap0(x, f0, tpos, fs=f.fs,
                            lt_dither=torch.tensor(lt)[None])[0].numpy()
    active = (f.f0 != 0) & (ap0 > 0.85)
    return D.d4c_body_dither(f.f0, active, f.fs, TD.d4c_max_half_c(f.fs),
                             gen)[3]


@pytest.mark.parametrize("name", ["t16", "t48", "t22"])
def test_f64_synthesis_vs_cpp_fresh_stream(name):
    """Synthesis alone with the xorshift noise of a fresh process: max abs
    error < 1e-10 x scale (tests/test_synthesis.py; measured ~4e-15)."""
    f = load_fixture(name)
    kw = _setup(f)
    y = _synth(f, TS.parity_noise(f.f0, **kw), kw)
    assert y.dtype == np.float64
    scale = np.abs(f.syn2).max()
    err = np.abs(y - f.syn2).max()
    assert err < 1e-10 * scale, f"max abs err {err} (scale {scale})"
    if name == "t22":      # the facade with explicit noise
        y2 = api.Synthesis(f.fs, f.fft_size, f.frame_period,
                           device="cpu").compute(
            f.f0, f.spec, f.ap, kw["out_length"],
            noise=TS.parity_noise(f.f0, **kw), dtype=torch.float64)
        np.testing.assert_array_equal(y2.numpy(), y)


@pytest.mark.parametrize("name", ["t16", "t22"])
def test_f64_synthesis_vs_cpp_whole_pipeline(name):
    """The reference's whole run (Harvest, CheapTrick, D4C, Synthesis in
    one process): the synthesis noise continues the stream that the
    analysis dithers advanced.  Max abs error < 1e-10 x scale."""
    f = load_fixture(name)
    kw = _setup(f)
    noise = TS.parity_noise(f.f0, gen=_analysis_generator(f), **kw)
    y = _synth(f, noise, kw)
    scale = np.abs(f.syn).max()
    err = np.abs(y - f.syn).max()
    assert err < 1e-10 * scale, f"max abs err {err} (scale {scale})"
    # not the fresh stream's waveform
    assert np.abs(y - f.syn2).max() > 1e-3 * scale


def test_f64_pulse_metadata_vs_cpp_and_jax():
    """The float64 time base's pulses against the instrumented reference
    (t16.pulses): the same pulse samples, shifts to 1e-17; and against
    JAX's float64 time base: equal pulse samples and voicing, shifts to
    1e-17 (a strictly sequential phase sum on both sides)."""
    f = load_fixture("t16")
    kw = _setup(f)
    lowest = f.fs / f.fft_size + 1.0
    idx, shift, n_pulses, vuv_at, valid, ovf = TS._time_base(
        torch.tensor(f.f0)[None], f.fs, kw["frame_period_s"],
        kw["out_length"], lowest, kw["max_pulses"])
    raw = (FIXTURES / "t16.pulses").read_bytes()
    cn = int(np.frombuffer(raw[:4], "<i4")[0])
    cidx = np.frombuffer(raw[4:4 + 4 * cn], "<i4")
    cshift = np.frombuffer(raw[4 + 4 * cn:4 + 12 * cn], "<f8")
    n = int(n_pulses[0])
    assert n == cn and not bool(ovf[0])
    np.testing.assert_array_equal(idx[0, :n].numpy(), cidx)
    np.testing.assert_allclose(shift[0, :n].numpy(), cshift, atol=1e-17)
    j = JS._time_base(jnp.asarray(f.f0), f.fs, kw["frame_period_s"],
                      kw["out_length"], lowest, kw["max_pulses"])
    assert int(j[2]) == n
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(j[0]))
    np.testing.assert_allclose(shift[0, :n].numpy(), np.asarray(j[1])[:n],
                               atol=1e-17)
    np.testing.assert_array_equal(vuv_at[0].numpy(), np.asarray(j[3]))
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(j[4]))


def test_f64_synthesis_matches_jax():
    """Whole float64 synthesis against JAX's un-jitted float64 synthesis
    with the same numpy noise on t22: 1e-12 x scale (two FFT libraries)."""
    f = load_fixture("t22")
    kw = _setup(f)
    noise = np.random.RandomState(7).randn(kw["max_pulses"], f.fft_size)
    y = _synth(f, noise, kw)
    yj = np.asarray(JS.synthesis_frames_impl(
        jnp.asarray(f.f0), jnp.asarray(f.spec), jnp.asarray(f.ap),
        jnp.asarray(noise), **kw))
    assert np.abs(y - yj).max() < 1e-12 * np.abs(yj).max()
    # a batch of two equals two single calls
    f0b = torch.tensor(np.stack([f.f0, f.f0 * 1.1]))
    yb = TS.synthesis_frames_impl(
        f0b, torch.tensor(f.spec)[None].expand(2, -1, -1),
        torch.tensor(f.ap)[None].expand(2, -1, -1),
        torch.tensor(noise)[None].expand(2, -1, -1), **kw).numpy()
    np.testing.assert_array_equal(yb[0], y)


def test_f64_overlap_add_in_pulse_order():
    """The plain float64 overlap-add sums each output sample in pulse
    order (what the card's ``double`` instantiation of the OLA kernel is
    held to): equal to a sequential numpy loop, bit for bit."""
    rng = np.random.RandomState(8)
    B, P, fft, T = 2, 60, 64, 700
    resp = rng.randn(B, P, fft) * 10.0 ** rng.uniform(-6, 6, (B, P, 1))
    starts = np.sort(rng.randint(-(fft - 1), T, (B, P)), 1).astype(np.int32)
    n = np.array([60, 41], np.int64)
    want = np.zeros((B, T))
    for b in range(B):
        for p in range(int(n[b])):
            for j in range(fft):
                t = starts[b, p] + j
                if 0 <= t < T:
                    want[b, t] += resp[b, p, j]
    got = TO.overlap_add(torch.tensor(resp), torch.tensor(starts), T,
                         torch.tensor(n))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="float32 or float64"):
        TO.overlap_add_cuda(torch.tensor(resp).half(), torch.tensor(starts),
                            T)


def test_world_f64_matches_jax_facade():
    """World.analyze in float64 against JAX's on t22's first 0.36 s.  The
    port fixes the contour on the host (the reference's own chain); JAX's
    float64 World runs its device chain in float64: voicing identical, F0
    within 1e-6 Hz, spectra 1e-6 relative, aperiodicity 1e-6 absolute."""
    from worldtpu import api as japi
    f = load_fixture("t22")
    x = f.x[:8000]
    jt, jf0, jsp, jap = japi.World(f.fs, f0_floor=40.0).analyze(
        x, dtype=jnp.float64)
    tt, tf0, tsp, tap = api.World(f.fs, f0_floor=40.0, device="cpu").analyze(
        x, dtype=torch.float64)
    assert tf0.dtype == tsp.dtype == tap.dtype == np.float64
    np.testing.assert_allclose(tt, jt, rtol=1e-12)
    np.testing.assert_array_equal(tf0 > 0, jf0 > 0)
    np.testing.assert_allclose(tf0, jf0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsp, jsp, rtol=1e-6)
    np.testing.assert_allclose(tap, jap, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# float32: bit for bit what it was
# ---------------------------------------------------------------------------

def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _platform_fingerprint():
    """A digest of the float32 building blocks (a matmul, real FFTs, the
    elementwise transcendentals) on seeded inputs: machines that give other
    bits here would give other bits on the main path whatever the code."""
    rng = np.random.RandomState(11)
    a = torch.tensor(rng.randn(96, 200).astype(np.float32))
    b = torch.tensor(rng.randn(200, 130).astype(np.float32))
    v = torch.tensor(rng.uniform(0.1, 9.0, 4096).astype(np.float32))
    spec = torch.fft.rfft(a, n=256)
    return _digest((a @ b).numpy(), spec.real.numpy(), spec.imag.numpy(),
                   torch.fft.irfft(spec, n=256).numpy(),
                   torch.cos(v).numpy(), torch.sin(v).numpy(),
                   torch.exp(-v).numpy(), torch.log(v).numpy(),
                   torch.sqrt(v).numpy(), (v / v.flip(0)).numpy(),
                   torch.cumsum(v, 0).numpy())


def _main_path_digest():
    """Digests of the float32 main path and analysis on a seeded batch."""
    fs, n = 16000, 6400
    rng = np.random.RandomState(12)
    t = np.arange(n) / fs
    x = []
    for i in range(2):
        f0t = (120 + 60 * i) * 2 ** (0.2 * np.sin(2 * np.pi * 3 * t))
        ph = 2 * np.pi * np.cumsum(f0t) / fs
        w = 0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph)
        w[int(0.3 * n):int(0.4 * n)] = 0.0
        x.append(w + 0.003 * rng.randn(n))
    x = torch.tensor(np.stack(x).astype(np.float32))
    geo = TH.HarvestGeometry(fs, n, f0_floor=40.0)
    ck = CheapTrickKernel(fs)
    out_len = int((geo.n_grid() - 1) * 0.005 * 1.25 * fs) + 1
    mp = TS.capacity_max_pulses(out_len, fs, f0_cap=600.0)
    noise = torch.tensor(rng.randn(2, mp, ck.fft_size).astype(np.float32))
    kw = dict(geo=geo, fs=fs, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window)
    y, f0, ovf = TB.batch_wav_to_wav(
        x, noise, frame_period_s=0.005 * 1.25, out_length=out_len,
        max_pulses=mp, pitch_scale=1.2, return_overflow=True, **kw)
    f0a, spec, ap = TB.batch_analyze(x, **kw)
    assert y.dtype == torch.float32 and not bool(ovf.any())
    assert float((f0 > 0).float().mean()) > 0.3
    return {"y": _digest(y.numpy()), "f0": _digest(f0.numpy()),
            "analysis": _digest(f0a.numpy(), spec.numpy(), ap.numpy())}


#: platform fingerprint -> the main path's digests on the commit before the
#: float64 path was added (computed there with _main_path_digest)
_F32_BEFORE = {
    "f577952c543fae48": {"y": "dc28e5ac0dc1c09b", "f0": "5ed3104aed0812e5",
                         "analysis": "2e878f2cc7e805d4"},
}


def test_f32_main_path_bit_identical_to_before():
    """The float32 main path (batch_wav_to_wav, batch_analyze) gives, bit
    for bit, what it gave before the float64 branches were added beside
    it: digests recorded on the earlier commit, keyed by a fingerprint of
    the machine's float32 arithmetic.  On a machine whose arithmetic
    differs from every recorded one the comparison has no reference."""
    fp = _platform_fingerprint()
    if fp not in _F32_BEFORE:
        pytest.skip(f"no float32 digests recorded for this machine's "
                    f"arithmetic (fingerprint {fp})")
    assert _main_path_digest() == _F32_BEFORE[fp]
