"""Reading the program's own trace points in a traced stretch: the stage
marks on the device and the graph cache's spans on the host.

Stage marks (``worldtpu_torch/tracing.py``, ``csrc/marks.cu``): each stage
of the main path launches an empty kernel ``wt_mark_<stage>_in`` at its
entry and ``wt_mark_<stage>_out`` at its exit, on the stream its kernels
run on, in eager calls and in replayed CUDA graphs alike.  ``split`` walks
the device activities in start order and gives each one to the innermost
stage open at that point.

Graph spans (``parallel/graphs.py``): one outermost host range
``wt.graph.eager``, ``wt.graph.capture`` or ``wt.graph.replay`` a call of
the graph cache.

A program without marks or spans gives nothing to read: the readers
return None.
"""

from __future__ import annotations

import collections
import re

#: a stage mark's device activity: (stage, "in" | "out")
MARK = re.compile(r"wt_mark_(\w+)_(in|out)\b")

#: the stages of each part of the main path, by the program's stage names
HARVEST = ("decimate", "band_filter", "zc", "detect_overlap",
           "refine_prepare", "refine_sums", "refine_finish", "prune",
           "contour")
CHEAPTRICK = ("cheaptrick",)
D4C = ("d4c",)
SYNTHESIS = ("pulse_train", "ola")

#: the graph cache's outermost spans, one a call
GRAPH_CALLS = ("wt.graph.eager", "wt.graph.capture", "wt.graph.replay")


def split(tr):
    """({stage: seconds}, marks' seconds, marks seen) over the device
    activities inside the window: each activity that is not a mark adds
    its duration to the innermost stage whose ``_in`` mark came before it
    and whose ``_out`` mark has not, or to ``"outside"``.  Activities run
    in stream order, so start order is the program's order."""
    acts = sorted((s, e, n) for n, s, e in tr.device
                  if s >= tr.t0_ns and e <= tr.t1_ns)
    by = collections.Counter()
    open_, mark_ns, marks = [], 0, 0
    for s, e, n in acts:
        m = MARK.search(n)
        if m is None:
            by[open_[-1] if open_ else "outside"] += e - s
            continue
        mark_ns += e - s
        marks += 1
        name, side = m.groups()
        if side == "in":
            open_.append(name)
        elif name in open_:
            # close it, and whatever opened inside it and was left open
            del open_[len(open_) - 1 - open_[::-1].index(name):]
    return {k: v / 1e9 for k, v in by.items()}, mark_ns / 1e9, marks


def device_ms(result, stages):
    """Device ms a batch under ``stages`` over the traced pass's batches;
    None without a traced pass or without marks in it."""
    tr, traced = result.get("trace"), result.get("traced")
    if tr is None or not getattr(traced, "batches", 0):
        return None
    by, _, marks = split(tr)
    if not marks:
        return None
    return 1e3 * sum(by.get(s, 0.0) for s in stages) / traced.batches


def graph_calls(tr):
    """{span name: [seconds...]} of the outermost graph spans that start
    inside the window (a span inside another of ``GRAPH_CALLS`` is a call
    made within a call, not one of the caller's)."""
    spans = sorted((s, -e, n) for n, s, e in tr.host
                   if n in GRAPH_CALLS and tr.t0_ns <= s < tr.t1_ns)
    out, end = {n: [] for n in GRAPH_CALLS}, None
    for s, neg_e, n in spans:
        if end is not None and s < end:
            continue
        end = -neg_e
        out[n].append((end - s) / 1e9)
    return out


def replayed_pct(result):
    """Replays as a share of the graph cache's calls in the traced pass,
    in %; None without such calls."""
    tr = result.get("trace")
    if tr is None:
        return None
    calls = graph_calls(tr)
    n = sum(len(v) for v in calls.values())
    return 100.0 * len(calls["wt.graph.replay"]) / n if n else None


def mean_ms(result, name):
    """Mean host ms of the outermost ``name`` spans in the traced pass;
    None without one."""
    tr = result.get("trace")
    if tr is None:
        return None
    spans = graph_calls(tr)[name]
    return 1e3 * sum(spans) / len(spans) if spans else None
