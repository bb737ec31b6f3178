"""Stages: CheapTrick (``analysis/cheaptrick.py``): device ms a batch under
its stage (the device activities between the program's stage marks,
``stages.split``), over the traced pass's batches; in a corpus pass whose
keys the graph cache holds, every batch replayed (the cells that report
``rtf.replay``)."""

from wtbench import stages


def read(result):
    return stages.device_ms(result, stages.CHEAPTRICK)
