"""The port's trace points (``worldtpu_torch/tracing.py``): the stage ranges
and device marks, and the graph cache's spans (``parallel/graphs.py``).

On the CPU: a stage opens its ``wt.<stage>`` range and launches nothing;
the stage list is the one in ``csrc/marks.cu``; no ``wt.`` range is opened
outside ``tracing.py``; the graph cache's calls give one outermost span
each, with a capture's parts inside; a capturing stream gets the marks and
no range.  Tests marked ``cuda`` run on the card (``python -m pytest
tests/test_torch_tracing.py -m cuda --noconftest``): the marks of a
profiled replay, the host span against them on one clock, bits and launch
counts."""

import pathlib
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from worldtpu_torch import _build, tracing
from worldtpu_torch.parallel import graphs as TG

PKG = pathlib.Path(tracing.__file__).resolve().parent


def host_spans(prof, prefix="wt."):
    """(name, start ns, end ns) of the profile's host ranges named
    ``prefix...``, in start order (an enclosing range first)."""
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(prefix)
             and not str(e.device_type()).endswith("CUDA")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


@pytest.mark.parametrize("name", tracing.STAGES)
def test_stage_on_cpu_opens_its_range_and_launches_nothing(name,
                                                           monkeypatch):
    """(a) On a CPU tensor's device a stage opens ``wt.<name>`` as a CPU
    activity and launches no mark: the kernel library is never asked
    for."""
    def refuse():
        raise AssertionError("the kernel library loaded on the CPU")
    monkeypatch.setattr(_build, "library", refuse)
    x = torch.ones(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.stage(name, x.device):
            y = x * 2
    assert torch.equal(y, x * 2)
    assert [s[0] for s in host_spans(prof)] == ["wt." + name]
    assert _build._lib is None


def test_stages_are_the_marks_of_the_kernel_source():
    """(b) ``STAGES`` is ``WT_STAGES`` of ``csrc/marks.cu``, in order."""
    src = (PKG / "csrc" / "marks.cu").read_text()
    block = re.search(r"#define WT_STAGES\(X\)(.*?)\n\n", src, re.S).group(1)
    assert tuple(re.findall(r"X\((\w+)\)", block)) == tracing.STAGES


def test_every_wt_range_is_opened_by_tracing():
    """(c) No module of the port but ``tracing.py`` opens a ``wt.`` range;
    every stage named at a ``stage(...)`` site is in ``STAGES``, and every
    stage of ``STAGES`` is opened somewhere."""
    named = set()
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        if path.name != "tracing.py":
            assert not re.search(r"record_function\(\s*[\"']wt\.", text), path
            assert "record_function" not in text, path
        named |= set(re.findall(r"(?<![\w.])stage\(\s*[\"'](\w+)[\"']",
                                text))
    assert named == set(tracing.STAGES)


class _Prog:
    def __init__(self, fn, static):
        self.fn, self.static = fn, static

    def replay(self, tensors, scale):
        return self.fn(*tensors, TG.scale_buffer(scale, tensors[0]),
                       **self.static)


def _outermost(spans):
    """[(span, [children])] of the graph spans: each outermost span and
    the spans that lie inside it."""
    out = []
    for name, s, e in spans:
        if out and s >= out[-1][0][1] and e <= out[-1][0][2]:
            out[-1][1].append(name)
        else:
            out.append(((name, s, e), []))
    return out


def test_graph_cache_calls_give_one_outermost_span_each(monkeypatch):
    """(d) Two passes of 7 keys, each key called 1 + 1 + 2 times, through
    a cache of MAX_PROGRAMS = 4 (capture stubbed with a replay that runs
    the function: the cache's bookkeeping, on the CPU): each pass gives
    one outermost span a call, 7 ``wt.graph.eager``, 7
    ``wt.graph.capture`` each holding ``warm`` and ``record`` (and
    ``evict`` when the cache is full), and 14 ``wt.graph.replay``."""
    monkeypatch.setattr(TG, "MAX_PROGRAMS", 4)
    monkeypatch.setattr(TG, "capturable", lambda tensors, dtypes: True)
    monkeypatch.setattr(TG, "_capture", lambda fn, tensors, scale, static,
                        pool: _Prog(fn, static))

    def fn(x, scale, *, tag):
        return (x * scale + tag,)

    progs, x = TG.Programs(), torch.zeros(3)
    for pass_ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for tag in range(7):
                for k in range(4):
                    out = progs.call(fn, (x,), 1.5, tag=tag)
                    assert torch.equal(out[0], x * 1.5 + tag)
        calls = _outermost(host_spans(prof, "wt.graph."))
        assert len(calls) == 28
        kinds = [c[0][0] for c in calls]
        assert kinds == ["wt.graph.eager", "wt.graph.capture",
                         "wt.graph.replay", "wt.graph.replay"] * 7
        evicting = [tag >= 4 or pass_ == 1 for tag in range(7)]
        captures = [c[1] for c in calls if c[0][0] == "wt.graph.capture"]
        assert captures == [["wt.graph.warm", "wt.graph.record"]
                            + ["wt.graph.evict"] * ev for ev in evicting]
        assert all(not c[1] for c in calls
                   if c[0][0] != "wt.graph.capture")
        assert len(progs.keys()) == 4


@pytest.mark.parametrize("capturing", [True, False],
                         ids=["capturing", "eager"])
def test_stage_on_a_capturing_stream_marks_without_a_range(capturing,
                                                           monkeypatch):
    """(e) On a CUDA device a stage launches its entry and exit marks
    (mark 2 i and 2 i + 1 of stage i) around its work; while the stream
    captures it opens no host range, otherwise ``wt.<name>`` around both
    marks.  (The launch and the stream's state stubbed, on the CPU.)"""
    seen = []
    monkeypatch.setattr(tracing, "_mark",
                        lambda index, device: seen.append(index))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    i = tracing.STAGES.index("d4c")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.stage("d4c", torch.device("cuda", 0)):
            seen.append("work")
    assert seen == [2 * i, "work", 2 * i + 1]
    assert [s[0] for s in host_spans(prof)] == ([] if capturing
                                                else ["wt.d4c"])


def test_marks_go_through_their_own_entry(monkeypatch):
    """A mark calls the library's ``wt_mark`` with its index and the
    device's current stream, and is not counted in ``_build.launches``; a
    refused launch raises."""
    calls = []

    class Lib:
        @staticmethod
        def wt_mark(index, stream):
            calls.append((index, stream))
            return 0 if index < 26 else 1

    class Stream:
        cuda_stream = 1234

    class Device:
        def __init__(self, device):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "library", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    before = dict(_build.launches)
    dev = torch.device("cuda", 0)
    tracing._mark(5, dev)
    assert calls == [(5, 1234)] and dict(_build.launches) == before
    with pytest.raises(RuntimeError, match="wt_mark 26"):
        tracing._mark(26, dev)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the marks are CUDA kernels)")
    return torch.device("cuda", 0)


def _batch(dev, fs=22050, n=2, dur=0.8):
    from worldtpu_torch.analysis import harvest as TH
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.synthesis import synthesis as TS
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
    x = torch.tensor(np.stack(rows).astype(np.float32), device=dev)
    geo = TH.HarvestGeometry(fs, T, f0_floor=40.0)
    ck = CheapTrickKernel(fs)
    out_len = int((geo.n_grid() - 1) * 0.00625 * fs) + 1
    mp = TS.capacity_max_pulses(out_len, fs, f0_cap=600.0)
    noise = TS.make_noise(torch.Generator(device=dev).manual_seed(0), n, mp,
                          ck.fft_size, device=dev)
    kw = dict(geo=geo, fs=fs, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window, frame_period_s=0.00625,
              out_length=out_len, max_pulses=mp, pitch_scale=1.2,
              return_overflow=True)
    return x, noise, kw


#: the main path's kernel launches a batch (one of each)
MAIN_LAUNCHES = {"wt_zc": 1, "wt_refine_sums": 1, "wt_ola": 1,
                 "wt_extend": 1, "wt_contour_merge": 1,
                 "wt_contour_smooth": 1, "wt_pulse_resp": 1}


@pytest.mark.cuda
def test_replayed_batch_keeps_its_stage_marks(dev):
    """batch_wav_to_wav's eager call, capture and replays give the same
    bits and count the main path's launches, marks not among them.  A
    profiled replay runs the 26 marks of the main path's 13 stages (the
    ``STAGES`` before the long-audio ones), each stage's in and out in
    ``STAGES`` order with none nested, so every device activity between
    the first and the last mark lies in at most one stage, and those
    between two stages are a sliver of the time; the replay's
    ``wt.graph.replay`` host range starts before its first mark (one
    clock)."""
    from worldtpu_torch.parallel import batch as TB
    x, noise, kw = _batch(dev)
    TG.clear()
    try:
        outs, deltas = [], []
        for _ in range(4):
            before = dict(_build.launches)
            outs.append(TB.batch_wav_to_wav(x, noise, **kw))
            torch.cuda.synchronize()
            deltas.append({k: v - before.get(k, 0)
                           for k, v in _build.launches.items()
                           if v != before.get(k, 0)})
        for o in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
        # the capture's call runs the warm-up eagerly and one replay
        assert deltas == [MAIN_LAUNCHES, {k: 2 * v for k, v in
                                          MAIN_LAUNCHES.items()},
                          MAIN_LAUNCHES, MAIN_LAUNCHES]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = TB.batch_wav_to_wav(x, noise, **kw)
            torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, outs[0]))
    finally:
        TG.clear()
    acts = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if str(e.device_type()).endswith("CUDA")
                  and not e.name().startswith("wt."))
    marks = [(k, a) for k, a in enumerate(acts)
             if a[2].startswith("wt_mark_")]
    main = tracing.STAGES[:tracing.STAGES.index("long_prescan")]
    assert [a[2] for _, a in marks] == [
        f"wt_mark_{s}_{side}" for s in main for side in ("in", "out")]
    first, last = marks[0][0], marks[-1][0]
    inside = between = 0
    for (k0, _), (k1, _) in zip(marks[::2], marks[1::2]):
        inside += sum(a[1] - a[0] for a in acts[k0 + 1:k1])
    for (k0, _), (k1, _) in zip(marks[1::2], marks[2::2]):
        between += sum(a[1] - a[0] for a in acts[k0 + 1:k1])
    assert inside > 0 and between < 0.02 * inside
    assert first > 0 and last < len(acts) - 1     # copies around them
    replay = [s for s in host_spans(prof) if s[0] == "wt.graph.replay"]
    assert len(replay) == 1 and replay[0][1] < marks[0][1][0]
