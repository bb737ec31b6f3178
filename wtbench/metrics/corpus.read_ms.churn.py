"""Corpus I/O (``io/corpus.py``, ``native.load_wavs_batch``): host ms a batch
in ``next()`` of ``iter_corpus``, over the window's batches; in a corpus
pass whose keys outnumber the graph cache's programs (eager calls and
captures beside replays; the cells that report ``rtf.churn``)."""

from wtbench import trace


def read(result):
    return trace.per_batch_ms(result, "read_s")
