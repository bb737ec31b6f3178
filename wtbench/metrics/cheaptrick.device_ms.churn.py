"""Stages: CheapTrick (``analysis/cheaptrick.py``): device ms a batch under
its stage (the device activities between the program's stage marks,
``stages.split``), over the traced pass's batches; in a corpus pass whose
keys outnumber the graph cache's programs (eager calls and captures beside
replays; the cells that report ``rtf.churn``)."""

from wtbench import stages


def read(result):
    return stages.device_ms(result, stages.CHEAPTRICK)
