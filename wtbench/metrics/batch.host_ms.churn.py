"""Batch entry (``parallel/batch.py``, ``parallel/graphs.py``): host ms a
batch from the call of ``batch_wav_to_wav`` to its return (eager calls,
captures and replays together), over the window's batches; in a corpus pass
whose keys outnumber the graph cache's programs (eager calls and captures
beside replays; the cells that report ``rtf.churn``)."""

from wtbench import trace


def read(result):
    return trace.per_batch_ms(result, "call_s")
