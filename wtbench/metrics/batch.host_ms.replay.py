"""Batch entry (``parallel/batch.py``, ``parallel/graphs.py``): host ms a
batch from the call of ``batch_wav_to_wav`` to its return (eager calls,
captures and replays together), over the window's batches; in a corpus pass
whose keys the graph cache holds, every batch replayed (the cells that
report ``rtf.replay``)."""

from wtbench import trace


def read(result):
    return trace.per_batch_ms(result, "call_s")
