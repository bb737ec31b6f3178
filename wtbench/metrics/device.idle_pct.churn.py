"""Device (one H100): the share of the traced pass in which no activity ran on
the card, in %; in a corpus pass whose keys outnumber the graph cache's
programs (eager calls and captures beside replays; the cells that report
``rtf.churn``)."""

from wtbench import trace


def read(result):
    return trace.idle_pct_of(result)
