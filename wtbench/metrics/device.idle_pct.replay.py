"""Device (one H100): the share of the traced pass in which no activity ran on
the card, in %; in a corpus pass whose keys the graph cache holds, every
batch replayed (the cells that report ``rtf.replay``)."""

from wtbench import trace


def read(result):
    return trace.idle_pct_of(result)
