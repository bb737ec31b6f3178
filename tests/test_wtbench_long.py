"""The long-audio cell's reference and entries (``wtbench/reference/
longform.py``, ``wtbench/entries/long.py``, ``wtbench/entries/crops.py``)
and the long-audio trace points of the port (``longaudio.py``), on the
CPU.

``LongPipeline`` against the plain reference on a seeded 12 s recording;
the reference's Threefry bits against ``synthesis/noise.py``'s; the
reference importing nothing of the program; the chunk step's marks and
spans leaving the outputs bit-equal (on the CPU ``stage`` launches
nothing, so this holds that they are no-ops here; the ``cuda`` cases hold
the marks themselves on the card, and LongHarvest's contour on the card
against the host chain: ``python -m pytest tests/test_wtbench_long.py -m
cuda --noconftest``); the entries' generators.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from worldtpu_torch import longaudio as TLA
from worldtpu_torch import tracing
from worldtpu_torch.analysis import longform as TLF
from worldtpu_torch.synthesis import noise as TN
from wtbench import harness as Hn, speech
from wtbench.entries import crops as CR
from wtbench.entries import long as LE
from wtbench.reference import longform as RL
from wtbench.reference import noise as RN
from wtbench.reference.analysis import harvest as RH
from wtbench.reference.synthesis import synthesis as RS

torch.set_num_threads(1)

FS = 22050
SEED = 2 ** 31 + 1919
NOISE_SEED = 2 ** 40 + 77


def _stand_in_stages():
    """Harvest's device stages for both sides: the reference's decimation,
    band filter, zero crossings and candidate overlap, each candidate
    scored by its agreement with the frame's median candidate, then the
    pruning; memoized on each window's samples, so the program's and the
    reference's windows, when equal, get one computation.

    The stages' refinement in its plain version takes ~20 s a 3 s window
    on one CPU thread, ~4 min for both sides of this test; the stages
    themselves are held to the program elsewhere (the reference's copy
    bit for bit: ``wtbench/tests/test_wtbench_correct.py``; LongHarvest
    against JAX's: ``tests/test_torch_longform.py``).  What this test
    holds is everything around them: the windows, the stitching, the host
    contour, the analysis and the synthesis."""
    memo, geos = {}, {}

    def one(row, geo):
        key = (geo.fs, geo.x_length, row.numpy().tobytes())
        if key not in memo:
            gk = (geo.fs, geo.x_length, geo.f0_floor, geo.f0_ceil)
            if gk not in geos:
                geos[gk] = RH.HarvestGeometry(
                    geo.fs, geo.x_length, f0_floor=geo.f0_floor,
                    f0_ceil=geo.f0_ceil, frame_period=geo.frame_period)
            g = geos[gk]
            y = RH.decimate_stage(row[None], ratio=g.ratio,
                                  y_length=g.y_length)
            cand, _, _ = RH.candidates_stage(y, torch.zeros(1), g)
            on = cand > 0
            med = torch.where(on, cand, float("nan")).nanmedian(
                -1, keepdim=True).values
            score = torch.where(
                on, 1.0 / (1.0 + 20.0 * (cand / med - 1.0).abs()), 0.0)
            memo[key] = RH.remove_unreliable_stage(cand, score)
        return memo[key]

    def stages(x, mean_y=None, *, geo, grid=1):
        outs = [one(x[b], geo) for b in range(x.shape[0])]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))
    return stages


@pytest.fixture(scope="module")
def long_run():
    """(the program's y, F0, counts and host ranges, the reference's y and
    F0, the recording) on a 12 s recording, 2 s LongHarvest chunks with
    0.5 s halos, synthesis chunks of 200 frames."""
    stages = _stand_in_stages()
    mp = pytest.MonkeyPatch()
    mp.setattr(TLF, "harvest_device_stages", stages)
    mp.setattr(RH, "harvest_device_stages", stages)
    try:
        x = speech.utterances(FS, [12 * FS], SEED, "cpu")[0].astype(
            np.float32) / np.float32(32768.0)
        lp = TLA.LongPipeline(FS, f0_floor=40.0, f0_ceil=800.0,
                              chunk_frames=200, harvest_chunk_ms=2000,
                              harvest_halo_ms=500, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            y, f0 = lp.copy_synthesis(x, seed=NOISE_SEED, pitch_scale=1.2,
                                      duration_scale=1.25)
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("wt.")]
        yr, f0r = RL.copy_synthesis(
            torch.from_numpy(x), seed=NOISE_SEED, fs=FS, pitch_scale=1.2,
            duration_scale=1.25, chunk_ms=2000, halo_ms=500)
    finally:
        mp.undo()
    return dict(y=y, f0=f0, counts=lp.counts, names=names, yr=yr, f0r=f0r,
                x=x, lp=lp)


def test_long_pipeline_equals_the_reference(long_run):
    """Voicing equal on every frame.  F0 within 1e-9 relative: both sides
    fix the contour with the same numpy steps and smooth it with the same
    float64 recursion, the reference's held edges differing by less than
    0.875**300 of a value (~1e-18), so they agree to float64 rounding.
    y within 2e-5 relative RMS and 2e-4 at any sample: the same pulses
    (the chunked time base is the unchunked one, sample for sample), the
    same plain pulse chain, noise normals up to ~5.5e-6 relative apart
    (``torch.erfinv`` against XLA's polynomial) and the overlap-add summed
    in float32 over the whole output against the program's float32 chunk
    buffers added in float64: float32 rounding of a response (~1e-7 of
    full scale) over the ~45 responses a sample holds."""
    r = long_run
    f0, f0r, y, yr = r["f0"], r["f0r"], r["y"], r["yr"]
    assert f0.shape == f0r.shape == (2401,) and y.shape == yr.shape
    v = f0 > 0
    assert np.array_equal(v, f0r > 0) and 0.3 < v.mean() < 0.9
    assert np.max(np.abs(f0[v] - f0r[v]) / f0r[v]) < 1e-9
    d = y.astype(np.float64) - yr
    rel = np.sqrt(np.mean(d ** 2) / np.mean(yr.astype(np.float64) ** 2))
    assert rel < 2e-5 and np.abs(d).max() < 2e-4, (rel, np.abs(d).max())


def test_long_pipeline_counts_and_spans(long_run):
    """``counts``: one chunk step a chunk of 200 frames (250 synthesis
    frames' samples), and the pulses the reference's unchunked time base
    finds.  Host ranges of a profiled call: one ``wt.long.harvest``,
    ``wt.long.contour`` and ``wt.long.plan``, a ``wt.long.land`` and each
    chunk-step stage once a chunk, no prescan (sequential mode)."""
    r = long_run
    fp_s = 0.005 * 1.25
    L = int(round(200 * fp_s * FS))
    n_chunks = -(-len(r["yr"]) // L)
    f0t = torch.as_tensor(r["f0r"].astype(np.float32))[None]
    _, _, n_p, _, _, _ = RS._time_base(f0t, FS, fp_s, len(r["yr"]),
                                       FS / 1024 + 1.0, 40000)
    assert r["counts"] == {"chunk_steps": n_chunks, "pulses": int(n_p[0])}
    names = r["names"]
    for name in ("wt.long.harvest", "wt.long.contour", "wt.long.plan"):
        assert names.count(name) == 1, name
    assert names.count("wt.long.land") == n_chunks
    for s in ("long_analysis", "long_timebase", "long_noise", "long_pulses",
              "long_ola"):
        assert names.count("wt." + s) == n_chunks, s
    assert "wt.long_prescan" not in names


@pytest.mark.parametrize("seed", [0, 1234, 2 ** 32 + 5, 2 ** 63 + 11])
def test_reference_threefry_rows_equal_the_programs(seed):
    """The reference's bits of each row equal ``synthesis/noise.py``'s bit
    for bit (ordinals past 2**32 included, as the program masks them);
    its normals, by ``torch.erfinv``, within 2e-5 relative of the
    program's: XLA's float32 erfinv is Giles' polynomial, which departs
    from ``torch.erfinv`` by up to ~5.5e-6 relative (measured over 196,608
    values of three seeds)."""
    ords = torch.tensor([0, 1, 2, 977, 2 ** 31 + 3, 2 ** 32 + 9],
                        dtype=torch.int64)
    want = TN.row_bits(TN.prng_key(seed), ords, 1024)
    got = RN.row_bits(seed, ords, 1024)
    assert torch.equal(got, want)
    rows = RN.normal_rows(seed, 5000, 16, 1024, "cpu")
    prog = TN.indexed_noise(seed, 5000, 16, 1024)
    assert ((rows - prog).abs() / prog.abs().clamp(min=1e-3)).max() < 2e-5


def test_reference_imports_nothing_of_the_program():
    """Importing the long-audio reference loads no module of the program,
    the JAX package or JAX (a fresh interpreter)."""
    code = ("import sys; import wtbench.reference.longform; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'worldtpu_torch', 'worldtpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=Hn.HERE.parent)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _loop(lp, x, f0):
    p = lp.plan(x, f0, 1.25)
    return lp._sequential(p, TN.as_key(NOISE_SEED))[0]


def _recording(n_s=3.0, fs=16000):
    """A voiced tone with an unvoiced gap and its analytic F0 on the 5 ms
    grid (a stand-in for LongHarvest: the marks sit in the chunk step)."""
    n = int(n_s * fs)
    t = np.arange(n) / fs
    f = 140 * 2 ** (0.3 * np.sin(2 * np.pi * 0.5 * t))
    x = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / fs)
    x[int(0.4 * n):int(0.5 * n)] = 0.0
    F = 1 + int(1000.0 * n / fs / 5.0)
    tf = np.arange(F) * 0.005
    f0 = 140 * 2 ** (0.3 * np.sin(2 * np.pi * 0.5 * tf)) * 1.2
    f0[(tf >= 0.4 * n_s) & (tf < 0.5 * n_s)] = 0.0
    return x.astype(np.float32), f0


def test_chunk_step_marks_are_no_ops_on_the_cpu(monkeypatch):
    """The chunk step with its stages and spans gives the bits it gives
    with each stage and span replaced by an empty context."""
    import contextlib
    fs = 16000
    x, f0 = _recording(fs=fs)
    lp = TLA.LongPipeline(fs, f0_floor=40.0, chunk_frames=150, device="cpu")
    want = _loop(lp, x, f0)
    monkeypatch.setattr(TLA, "stage",
                        lambda name, device: contextlib.nullcontext())
    monkeypatch.setattr(TLA, "long_span",
                        lambda kind: contextlib.nullcontext())
    got = _loop(lp, x, f0)
    assert np.array_equal(got, want) and np.abs(want).max() > 0.01


def test_long_stages_follow_the_main_path():
    """The six long-audio stages come after the main path's 13, so every
    earlier mark keeps its index."""
    assert tracing.STAGES[:13] == (
        "decimate", "band_filter", "zc", "detect_overlap", "refine_prepare",
        "refine_sums", "refine_finish", "prune", "contour", "cheaptrick",
        "d4c", "pulse_train", "ola")
    assert tracing.STAGES[13:] == ("long_prescan", "long_analysis",
                                   "long_timebase", "long_noise",
                                   "long_pulses", "long_ola")
    with pytest.raises(ValueError):
        tracing.long_span("chunk")


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 977, 2 ** 33 + 1])
def test_chapter_lengths_and_checked_chapter_from_the_seed(seed):
    """Four chapters, one in each quarter of 540-660 s, in an order and
    at lengths drawn from the seed alone; the checked chapter is one of
    them; the compared stretches cover every frame and output sample once,
    60 s of input each."""
    cfg = Hn.config("librivox-22k")
    a = LE.chapter_lengths(cfg, seed)
    assert a == LE.chapter_lengths(cfg, seed)
    assert a != LE.chapter_lengths(cfg, seed + 1)
    assert len(a) == 4
    for q, n in enumerate(sorted(a)):
        assert 540 + 30 * q <= n / FS <= 540 + 30 * (q + 1)
    assert 0 <= LE.checked_chapter(cfg, seed) < 4
    F = 1 + int(1000.0 * max(a) / FS / 5.0)
    cuts = LE.stretches(F, 5.0, 6.25, FS, LE.STRETCH_S)
    assert cuts[0][:3:2] == (0, 0) and cuts[-1][1] == F
    assert cuts[-1][3] == int((F - 1) * 0.00625 * FS) + 1
    assert all(c[1] == d[0] and c[3] == d[2] for c, d in zip(cuts, cuts[1:]))
    assert all(c[1] - c[0] == 12000 for c in cuts[:-1]) and len(cuts) == 11


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 4242])
def test_crop_plans_from_the_seed(seed):
    """Each batch: 8 distinct clips of the 512, each crop inside its clip,
    a pitch in 0.8-1.2, drawn from the seed and the batch's index alone;
    the checked batches: the window's first, second and one of the next
    30."""
    cfg, mix = Hn.config("ljspeech-22k"), Hn.traffic("crops")
    ctx = Hn.Context(workload={"name": "ljspeech-22k.crops"}, config=cfg,
                     traffic=mix, seed=seed, device=torch.device("cpu"),
                     trace=False)
    from wtbench import generate as G
    lengths = G.corpus_lengths(cfg, mix)
    assert len(lengths) == 512 and min(lengths) >= mix["crop_samples"]
    pitches = []
    for i in range(40):
        clips, off, pitch = CR.batch_plan(ctx, lengths, i)
        again = CR.batch_plan(ctx, lengths, i)
        assert np.array_equal(clips, again[0]) and pitch == again[2]
        assert len(set(clips.tolist())) == 8
        assert np.all(off >= 0)
        assert np.all(off + mix["crop_samples"]
                      <= np.asarray(lengths)[clips])
        pitches.append(pitch)
    assert 0.8 <= min(pitches) and max(pitches) <= 1.2
    assert max(pitches) - min(pitches) > 0.2
    k = CR.checked_batches(seed)
    assert k[:2] == (0, 1) and 2 <= k[2] < 2 + CR.LATER
    assert k == CR.checked_batches(seed)


def _metric(name):
    return Hn.load_module(Hn.HERE / "metrics" / f"{name}.py")


@pytest.mark.parametrize("program", ["change", "parent"])
def test_long_metric_readers(program):
    """The three long-audio readers on a synthetic traced chapter: the
    host contour's outermost span, Harvest's marked device time a chapter
    and the long-audio stages' device time a chunk step.  A program
    without the spans, the long-audio marks or the counter (the parent's)
    gives None for what it lacks, and Harvest's marks still read."""
    from wtbench import trace as T
    ms = 1_000_000
    dev = [("wt_mark_decimate_in", 1 * ms, 1 * ms + 10),
           ("decimate_kernel", 2 * ms, 5 * ms),
           ("wt_mark_decimate_out", 6 * ms, 6 * ms + 10)]
    host = [("wtbench.window", 0, 100 * ms)]
    if program == "change":
        dev += [("wt_mark_long_noise_in", 10 * ms, 10 * ms + 10),
                ("threefry_kernel", 11 * ms, 17 * ms),
                ("wt_mark_long_noise_out", 18 * ms, 18 * ms + 10),
                ("wt_mark_long_prescan_in", 20 * ms, 20 * ms + 10),
                ("cumsum_kernel", 21 * ms, 23 * ms),
                ("wt_mark_long_prescan_out", 24 * ms, 24 * ms + 10)]
        host += [("wt.long.contour", 30 * ms, 70 * ms),
                 ("wt.long.contour", 40 * ms, 50 * ms)]     # nested: once
    tr = T.Trace(dev, host, 0, 100 * ms)
    traced = LE.Tally(chapters=1, chunk_steps=4 if program == "change"
                      else 0)
    res = dict(trace=tr, traced=traced)
    got = {n: _metric(n).read(res) for n in (
        "long.contour_ms.churn", "long.harvest_device_ms.churn",
        "long.chunk_device_ms.churn")}
    assert got["long.harvest_device_ms.churn"] == pytest.approx(3.0)
    if program == "change":
        assert got["long.contour_ms.churn"] == pytest.approx(40.0)
        assert got["long.chunk_device_ms.churn"] == pytest.approx(8.0 / 4)
    else:
        assert got["long.contour_ms.churn"] is None
        assert got["long.chunk_device_ms.churn"] is None
    assert all(_metric(n).read({}) is None for n in got)


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_chunk_step_marks_on_the_card(monkeypatch):
    """On the card the marks leave the loop's bits as they are (marks on
    against ``tracing._mark`` a no-op), and a profiled replayed loop runs
    each chunk-step stage's in and out marks in the step's order once a
    chunk, and once more for the capture's eager warm-up (the first chunk
    runs eagerly, the second warms, records and replays)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the marks are CUDA kernels)")
    fs = 16000
    x, f0 = _recording(fs=fs)
    lp = TLA.LongPipeline(fs, f0_floor=40.0, chunk_frames=150,
                          device="cuda")
    with torch.no_grad():
        want = _loop(lp, x, f0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            again = _loop(lp, x, f0)
            torch.cuda.synchronize()
        with monkeypatch.context() as m:
            m.setattr(tracing, "_mark", lambda index, device: None)
            bare = _loop(lp, x, f0)
    assert np.array_equal(want, again) and np.array_equal(want, bare)
    n_chunks = lp.counts["chunk_steps"]
    marks = [e.name() for e in sorted(
        prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
        if str(e.device_type()).endswith("CUDA")
        and e.name().startswith("wt_mark_long_")]
    step = [f"wt_mark_{s}_{side}" for s in (
        "long_analysis", "long_timebase", "long_noise", "long_pulses",
        "long_ola") for side in ("in", "out")]
    assert marks == step * (n_chunks + 1), (len(marks), n_chunks)


#: LongHarvest's device chain against the host chain on the same stitched
#: candidates of a 120 s recording: voicing agreement, and the median over
#: frames voiced on both of the relative F0 error
CARD_VOICING, CARD_F0_REL_MED = 0.999, 1e-6


@pytest.mark.cuda
def test_long_harvest_contour_on_the_card():
    """float32 LongHarvest on the card over 120 s of speech: its F0 against
    the host chain run on the same candidates, downloaded (voicing
    agreement >= CARD_VOICING, median relative error of frames voiced on
    both < CARD_F0_REL_MED: fix steps 1, 3 and 4 decide in float32 on the
    card, in float64 on the host); one launch each of the extend walk, the
    merge and the smoothing kernel a call; and the ``contour`` stage's
    marks once in a profiled call's device trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the contour kernels)")
    from worldtpu_torch import _build
    n = 120 * FS
    x = speech.utterances(FS, [n], SEED, "cuda")[0].astype(
        np.float32) / np.float32(32768.0)
    lh = TLF.LongHarvest(FS, f0_floor=40.0, f0_ceil=800.0, device="cuda")
    lh.compute(x)                                   # builds the library
    _build.launches.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        f0, tpos = lh.compute(x)
        torch.cuda.synchronize()
    counts = dict(_build.launches)
    for k in ("wt_extend", "wt_contour_merge", "wt_contour_smooth"):
        assert counts.get(k) == 1, (k, counts)
    marks = [e.name() for e in prof.profiler.kineto_results.events()
             if str(e.device_type()).endswith("CUDA")
             and e.name().startswith("wt_mark_contour_")]
    assert sorted(marks) == ["wt_mark_contour_in", "wt_mark_contour_out"]
    assert f0.shape == (24001,)
    agree, both, rel = _against_the_host_chain(lh, x, f0, tpos)
    assert both.mean() > 0.3
    assert agree >= CARD_VOICING and np.median(rel) < CARD_F0_REL_MED


def _against_the_host_chain(lh, x, f0, tpos):
    """LongHarvest's F0 on the card (f0, tpos) against the host chain on
    the same candidates, stitched again on the card and downloaded:
    (voicing agreement, the frames voiced on both, their relative F0
    errors); the flipped frames printed."""
    n = len(x)
    cand, score = lh._stitched(x, torch.float32,
                               TLF.MAX_BATCH[torch.float32], lh.device)
    f0_card, tp_card = lh._contour_on_card(cand, score, n)
    cand, score = cand.cpu(), score.cpu()
    f0_host, tp_host = lh._contour(cand, score, n)
    assert np.array_equal(f0_card, f0) and np.array_equal(tp_card, tpos)
    assert np.array_equal(tp_host, tpos)
    agree = float(((f0 > 0) == (f0_host > 0)).mean())
    both = (f0 > 0) & (f0_host > 0)
    rel = np.abs(f0[both] - f0_host[both]) / f0_host[both]
    print(f"voicing agreement {agree}, flipped frames "
          f"{np.nonzero((f0 > 0) != (f0_host > 0))[0].tolist()}, voiced "
          f"{both.mean():.3f}, relative F0 error median "
          f"{np.median(rel):.3e}, max {rel.max():.3e}")
    return agree, both, rel


@pytest.mark.cuda
def test_long_harvest_past_70_minutes_on_the_card():
    """float32 LongHarvest on the card over 72 min (a padded contour past
    2048 checkpoints of 2048 frames, the smoothing kernel's longest before
    its spacing was chosen by the length): 20 s of speech at the start,
    the middle and the end, digital silence between; its F0 against the
    host chain on the same candidates with the 120 s case's limits, one
    launch of each contour kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the contour kernels)")
    from worldtpu_torch import _build
    from worldtpu_torch.ops import contour_kernel as CK
    n, m = 72 * 60 * FS, 20 * FS
    x = np.zeros(n, np.float32)
    for start, row in zip((0, n // 2, n - m),
                          speech.utterances(FS, [m] * 3, SEED, "cuda")):
        x[start:start + m] = row.astype(np.float32) / np.float32(32768.0)
    lh = TLF.LongHarvest(FS, f0_floor=40.0, f0_ceil=800.0, device="cuda")
    assert lh.n_chunks(n) * lh.chunk_ms + 1 + 2 * CK.LAG > \
        CK.SMOOTH_CHECKPOINTS * CK.SMOOTH_MAX_CHUNK
    _build.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    f0, tpos = lh.compute(x)
    peak = torch.cuda.max_memory_allocated()
    counts = dict(_build.launches)
    for k in ("wt_extend", "wt_contour_merge", "wt_contour_smooth"):
        assert counts.get(k) == 1, (k, counts)
    print(f"peak device memory {peak / 2 ** 30:.3f} GiB")
    assert f0.shape == (1 + 72 * 60 * 200,)
    agree, both, rel = _against_the_host_chain(lh, x, f0, tpos)
    assert both.sum() > 3 * 20 * 200 * 0.3
    assert agree >= CARD_VOICING and np.median(rel) < CARD_F0_REL_MED
