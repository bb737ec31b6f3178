"""Stages: the codec (``codec.py``, coded by ``parallel/batch.py``'s
``batch_features``): device ms a batch under the ``codec`` stage (the
device activities between the program's stage marks, ``stages.split``),
over the traced pass's batches; in a feature pass whose keys the graph
cache holds, every batch replayed.  None where the program marks no such
stage."""

from wtbench import stages

#: the feature path's coding of the envelope and aperiodicity
CODEC = ("codec",)


def read(result):
    tr = result.get("trace")
    if tr is None or not any(s in stages.split(tr)[0] for s in CODEC):
        return None
    return stages.device_ms(result, CODEC)
