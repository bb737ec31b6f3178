"""Batch entry (``parallel/graphs.py``): mean host ms of the graph cache's
outermost ``wt.graph.eager`` spans in the traced pass: an eager call (a
key's first), taken under the profiler's CPU-op recording; in a corpus pass
whose keys outnumber the graph cache's programs (eager calls and captures
beside replays; the cells that report ``rtf.churn``)."""

from wtbench import stages


def read(result):
    return stages.mean_ms(result, "wt.graph.eager")
