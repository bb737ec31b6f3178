"""Batch entry (``parallel/graphs.py``): mean host ms of the graph cache's
outermost ``wt.graph.capture`` spans in the traced pass: a capture (the
eager warm-up, the recording, an eviction when the cache is full, the first
replay), taken under the profiler's CPU-op recording; in a corpus pass whose
keys outnumber the graph cache's programs (eager calls and captures beside
replays; the cells that report ``rtf.churn``)."""

from wtbench import stages


def read(result):
    return stages.mean_ms(result, "wt.graph.capture")
