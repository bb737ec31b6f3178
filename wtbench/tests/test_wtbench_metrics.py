"""The metrics' arithmetic on the CPU: the idle share and the breakdown on
a synthetic trace, the zc count against a hand count at the main path's
shapes, the end-to-end metric over every utterance of a window, and the
log-spectral distance of the comparison."""

import time
import types

import numpy as np
import pytest
import torch

from wtbench import generate as G, harness as Hn, roofline, trace as T


def synthetic():
    ms = 1_000_000
    device = [("(anonymous namespace)::zc_kernel(float const*)", 1 * ms, 3 * ms),
              ("ola_kernel", 2 * ms, 4 * ms),       # overlaps the first
              ("wt.zc", 1 * ms, 3 * ms),            # a range's shadow: no work
              ("gemm", 6 * ms, 7 * ms)]
    host = [("wtbench.window", 0, 10 * ms), ("wt.d4c", 4 * ms, 6 * ms),
            ("wt.prune", 7 * ms, 8 * ms)]
    device = [d for d in device if not d[0].startswith("wt.")]
    return T.Trace(device, host, *T.window_bounds(host))


def test_idle_share_and_busy_time():
    tr = synthetic()
    assert tr.window_s == pytest.approx(0.010)
    assert T.busy_s(tr) == pytest.approx(0.004)       # [1, 4] and [6, 7] ms
    assert T.idle_pct(tr) == pytest.approx(60.0)
    assert T.kernel_s(tr, "::zc_kernel(") == (pytest.approx(0.002), 1)
    assert T.idle_pct(T.Trace([], tr.host, tr.t0_ns, tr.t1_ns)) is None


def test_breakdown_names_ops_and_gaps():
    b = T.breakdown(synthetic())
    ops = dict(b["device_ops"])
    assert ops["(anonymous namespace)::zc_kernel(float const*)"] == pytest.approx(0.002)
    assert ops["ola_kernel"] == pytest.approx(0.002)
    gaps = dict(b["idle_gaps"])
    # gaps [0, 1] and [7, 10] under the window alone, [4, 6] under wt.d4c
    assert gaps["wt.d4c"] == pytest.approx(0.002)
    assert gaps["wtbench.window"] == pytest.approx(0.004)
    assert len(b["device_ops"]) <= 10


def test_zc_work_by_hand_at_the_main_path_shapes():
    cfg = Hn.config("ljspeech-22k")
    n_bytes, n_ops = roofline.zc_work(8, 98304, cfg)
    nb, L, F = 185, 1 + 98304 // 3, 1 + int(1000 * 98304 / 22050)
    assert (L, F) == (32769, 4459)
    assert n_bytes == 4 * (8 * nb * L + nb + 8 * nb * F)
    assert n_ops == 8 * nb * (6 * (L - 1) + 48 * F)
    # bytes bound it: 220.4 MB over 3.35 TB/s
    assert roofline.bound_s(n_bytes, n_ops) * 1e3 == pytest.approx(0.06579,
                                                                   abs=1e-5)


@pytest.mark.parametrize("name", ["zc_roofline.churn", "zc_roofline.replay"])
def test_zc_roofline_reader_matches_launches_to_batches(name):
    cfg = Hn.config("ljspeech-22k")
    reader = Hn.load_module(Hn.HERE / "metrics" / f"{name}.py")
    ms = 1_000_000
    device = [("void (anonymous namespace)::zc_kernel<true>(float const*)",
               i * ms, i * ms + ms // 2) for i in range(3)]
    device.append(("(anonymous namespace)::events_kernel(float const*)",
                   4 * ms, 5 * ms))
    host = [("wtbench.window", 0, 5 * ms)]
    tr = T.Trace(device, host, 0, 5 * ms)
    traced = types.SimpleNamespace(zc=[(98304, 2), (98304, 1)])
    res = dict(trace=tr, traced=traced, config=cfg, batch_size=8)
    least = 3 * roofline.bound_s(*roofline.zc_work(8, 98304, cfg))
    assert reader.read(res) == pytest.approx(100 * least / 0.0015)
    traced.zc = [(98304, 1)]                   # launches the trace lacks
    assert reader.read(res) is None


def voiced(fs, aperiodicity, jitter=0.0, seconds=1.0, f0=120.0):
    """WORLD-like voiced sound: a pulse train at f0 (each pulse moved by up
    to ``jitter`` samples, a fractional delay in the spectrum) and white
    noise mixed at the aperiodicity's amplitude with the power kept, both
    through one two-pole resonance at 700 Hz."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(1)
    n = int(fs * seconds)
    k = np.fft.rfftfreq(n) * n
    spec = np.zeros(k.size, complex)
    for t in np.arange(0, n, fs / f0):
        spec += np.exp(-2j * np.pi * k * (t + jitter * rng.uniform(-1, 1))
                       / n)
    p = np.fft.irfft(spec, n)
    q = np.random.default_rng(2).standard_normal(n)
    a = aperiodicity
    y = np.sqrt(1 - a * a) * p / p.std() + a * q / q.std()
    r, w = 0.97, 2 * np.pi * 700 / fs
    return lfilter([1.0], [1.0, -2 * r * np.cos(w), r * r], y)


def test_log_spectral_distance_sees_the_harmonic_to_noise_balance():
    """y_lsd_db: 0 on equal outputs; aperiodicity 3 dB higher at the same
    power, which the 10 ms envelope barely sees, reads several times what
    pulses moved by up to 0.02 samples read."""
    from wtbench import compare
    fs = 22050
    assert compare.stft_size(fs) == 1024 and compare.stft_size(48000) == 2048
    ref = voiced(fs, 0.2)
    f0 = np.full(201, 120.0)

    def numbers(y):
        return dict(compare.numbers([(y, ref, f0, f0)], fs))

    assert numbers(ref)["y_lsd_db"] == 0.0
    jitter = numbers(voiced(fs, 0.2, jitter=0.02))["y_lsd_db"]
    ap = numbers(voiced(fs, 0.2 * 10 ** (3 / 20)))
    assert 0 < jitter < 1.0
    assert ap["y_lsd_db"] > 3 * jitter and ap["y_env_rel"] < 0.03


def test_rtf_counts_every_completed_utterance(monkeypatch, tmp_path):
    """rtf over a window with the program's batch call stubbed: the valid
    input audio of every completed utterance over the window's wall."""
    import worldtpu_torch.parallel.batch as PB
    from wtbench.entries import corpus as CE

    def stub(x, noise, *, out_length, **kw):
        time.sleep(0.01)
        B = x.shape[0]
        return (torch.zeros(B, out_length), torch.zeros(B, 400),
                torch.zeros(B, dtype=torch.bool))

    monkeypatch.setattr(PB, "batch_wav_to_wav", stub)
    monkeypatch.setattr(CE.tempfile, "gettempdir", lambda: str(tmp_path))
    cfg = dict(Hn.config("ljspeech-22k"), length_mean_s=0.5,
               clips_per_length_s=100)
    mix = dict(Hn.traffic("corpus"), utterances=9, batch_size=4)
    ctx = Hn.Context(workload={"name": "t"}, config=cfg, traffic=mix,
                     seed=5, device=torch.device("cpu"), trace=False)
    st = CE.setup(ctx)
    t0 = time.perf_counter()
    res = CE.window(ctx, st, 0.3)
    wall = time.perf_counter() - t0
    tally = res["tally"]
    per_pass = sum(st["lengths"]) / 22050
    done = tally.attempted
    full, part = divmod(tally.batches, 3)
    order = sorted(st["lengths"])
    audio = full * per_pass + sum(order[:4 * part]) / 22050
    assert done == full * 9 + min(9, 4 * part)
    assert tally.audio_s == pytest.approx(audio)
    assert res["e2e"]["rtf"] == pytest.approx(audio / wall, rel=0.05)
    # each whole pass's wall, and the host's reading, calling and waiting
    # inside it
    assert len(tally.passes) == full
    assert sum(p[0] for p in tally.passes) <= wall
    assert all(p[0] >= p[1] + p[2] + p[3] for p in tally.passes)
    assert all(p[2] >= 3 * 0.01 for p in tally.passes)
