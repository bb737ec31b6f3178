"""Corpus I/O (``io/corpus.py``, ``native.load_wavs_batch``): host ms a batch
in ``next()`` of ``iter_corpus``, over the window's batches; in a corpus
pass whose keys the graph cache holds, every batch replayed (the cells that
report ``rtf.replay``)."""

from wtbench import trace


def read(result):
    return trace.per_batch_ms(result, "read_s")
