"""Batch entry (``parallel/graphs.py``): the graph cache's replays as a
share of its calls (outermost ``wt.graph.replay`` spans over all
``wt.graph.eager``, ``.capture`` and ``.replay`` ones) in the traced pass,
in %; in a corpus pass whose keys outnumber the graph cache's programs
(eager calls and captures beside replays; the cells that report
``rtf.churn``)."""

from wtbench import stages


def read(result):
    return stages.replayed_pct(result)
