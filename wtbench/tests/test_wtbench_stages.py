"""The readers of the program's own trace points on the CPU
(``wtbench/stages.py``): the device time split by stage marks, with copies
outside any stage and a nested stage; the graph cache's replay share and
mean span times; a program without marks or spans reads nothing."""

import types

import pytest

from wtbench import harness as Hn, trace as T


def synthetic():
    """A stretch with the harness's ranges only, as a program without
    marks or graph spans gives."""
    ms = 1_000_000
    device = [("void (anonymous namespace)::zc_kernel<true>(float const*)",
               1 * ms, 3 * ms), ("gemm", 6 * ms, 7 * ms)]
    host = [("wtbench.window", 0, 10 * ms), ("wt.d4c", 4 * ms, 6 * ms)]
    return T.Trace(device, host, 0, 10 * ms)


def marked():
    """A traced stretch of two batches: the program's stage marks around
    their kernels (one stage nested in another), copies outside any stage,
    and the graph cache's spans on the host (an eager call holding a
    replay of another program, a capture with its parts, two replays)."""
    us = 1_000
    dev = [("memcpy HtoD", 0, 10 * us),
           ("wt_mark_decimate_in", 10 * us, 11 * us),
           ("elementwise", 11 * us, 31 * us),
           ("wt_mark_decimate_out", 31 * us, 32 * us),
           ("wt_mark_cheaptrick_in", 32 * us, 33 * us),
           ("fft", 33 * us, 73 * us),
           ("wt_mark_d4c_in", 73 * us, 74 * us),          # nested
           ("gemm", 74 * us, 104 * us),
           ("wt_mark_d4c_out", 104 * us, 105 * us),
           ("reduce", 105 * us, 115 * us),
           ("wt_mark_cheaptrick_out", 115 * us, 116 * us),
           ("wt_mark_ola_in", 116 * us, 117 * us),
           ("void (anonymous namespace)::ola_kernel(float const*)",
            117 * us, 137 * us),
           ("wt_mark_ola_out", 137 * us, 138 * us),
           ("memcpy DtoH", 138 * us, 148 * us),
           ("late", 300 * us, 310 * us)]                  # past the window
    host = [("wtbench.window", 0, 200 * us),
            ("wt.graph.eager", 0, 40 * us),
            ("wt.graph.replay", 5 * us, 6 * us),          # inside a call
            ("wt.graph.capture", 50 * us, 90 * us),
            ("wt.graph.warm", 51 * us, 60 * us),
            ("wt.graph.record", 60 * us, 80 * us),
            ("wt.graph.replay", 100 * us, 102 * us),
            ("wt.graph.replay", 110 * us, 114 * us),
            ("wt.graph.replay", 250 * us, 251 * us)]      # past the window
    return T.Trace(dev, host, 0, 200 * us)


def test_stage_marks_split_the_device_time():
    from wtbench import stages as S
    by, mark_s, marks = S.split(marked())
    assert marks == 8 and mark_s == pytest.approx(8e-6)
    assert by == pytest.approx({"outside": 20e-6, "decimate": 20e-6,
                                "cheaptrick": 50e-6, "d4c": 30e-6,
                                "ola": 20e-6})
    # a stage left open at the window's end keeps what follows it; an out
    # mark without its in closes nothing
    tr = T.Trace([("wt_mark_zc_out", 0, 1), ("a", 1, 3),
                  ("wt_mark_zc_in", 3, 4), ("b", 4, 9)], [], 0, 10)
    assert S.split(tr) == ({"outside": 2e-9, "zc": 5e-9}, 2e-9, 2)


def test_stage_readers_per_batch():
    traced = types.SimpleNamespace(batches=2)
    res = dict(trace=marked(), traced=traced)
    ms = {n: Hn.load_module(Hn.HERE / "metrics" / f"{n}.device_ms.replay.py"
                            ).read(res)
          for n in ("harvest", "cheaptrick", "d4c", "synthesis")}
    assert ms == pytest.approx({"harvest": 0.010, "cheaptrick": 0.025,
                                "d4c": 0.015, "synthesis": 0.010})


def test_graph_span_readers():
    res = dict(trace=marked())

    def read(name):
        return Hn.load_module(Hn.HERE / "metrics" / f"{name}.py").read(res)
    # outermost calls in the window: eager, capture, two replays
    assert read("graphs.replayed_pct.churn") == pytest.approx(50.0)
    assert read("graphs.replayed_pct.replay") == pytest.approx(50.0)
    assert read("graphs.capture_ms.churn") == pytest.approx(0.040)
    assert read("graphs.eager_ms.churn") == pytest.approx(0.040)


@pytest.mark.parametrize("name", [
    "harvest.device_ms.churn", "cheaptrick.device_ms.replay",
    "d4c.device_ms.churn", "synthesis.device_ms.replay",
    "graphs.replayed_pct.churn", "graphs.replayed_pct.replay",
    "graphs.capture_ms.churn", "graphs.eager_ms.churn"])
def test_readers_without_marks_or_spans_read_nothing(name):
    """A program without stage marks or graph spans (the harness's own
    ranges only), or a run without a traced pass: None, and no error."""
    reader = Hn.load_module(Hn.HERE / "metrics" / f"{name}.py")
    assert reader.read(dict(trace=synthetic(), traced=types.SimpleNamespace(
        batches=3))) is None
    assert reader.read(dict(attempted=0)) is None


def test_stage_split_printer():
    """``wtbench/stage_split.py``'s rows of a traced pass: ms a batch by
    stage, outside and in the marks; idle gaps by graph span, else by the
    harness's range; the graph spans' counts and mean ms."""
    from wtbench import stage_split as P
    r = P.stage_rows(marked(), 2)
    assert list(r["stages"]) == ["decimate", "cheaptrick", "d4c", "ola"]
    assert r["stages"] == pytest.approx({"decimate": 0.010,
                                         "cheaptrick": 0.025,
                                         "d4c": 0.015, "ola": 0.010})
    assert r["outside"] == pytest.approx(0.010)
    assert r["marks"] == pytest.approx(0.004)
    assert r["busy_s"] == pytest.approx(148e-6)
    assert r["inside_pct"] == pytest.approx(100.0 * 120 / 140)
    assert r["marks_pct"] == pytest.approx(100.0 * 8 / 148)
    # the device idles in [148, 200) us: under no graph span and no
    # harness range, then under a harness range, then under a replay
    us = 1_000
    assert P.idle_by_span(marked()) == pytest.approx({"none": 52e-6})
    tr = marked()
    tr.host.append(("wtbench.outputs", 140 * us, 190 * us))
    assert P.idle_by_span(tr) == pytest.approx({"wtbench.outputs": 52e-6})
    tr.host.append(("wt.graph.replay", 170 * us, 180 * us))
    assert P.idle_by_span(tr) == pytest.approx({"wt.graph.replay": 52e-6})
    spans = P.span_ms(marked())
    assert spans["wt.graph.replay"] == (3, pytest.approx(0.007 / 3))
    assert spans["wt.graph.capture"] == (1, pytest.approx(0.040))
    assert "wt.graph.evict" not in spans
    lines = P.report(marked(), 2)
    assert lines[0].startswith("traced pass: 2 batches")
    assert any(line.split()[0] == "d4c.device_ms" for line in lines)
