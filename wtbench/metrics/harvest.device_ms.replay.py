"""Stages: Harvest (``analysis/harvest.py``, ``parallel/batch.py``,
``ops/refine_kernel.py``, ``analysis/contour_device.py``): device ms a batch
under its nine stages, decimate to contour (the device activities between
the program's stage marks, ``stages.split``), over the traced pass's
batches; in a corpus pass whose keys the graph cache holds, every batch
replayed (the cells that report ``rtf.replay``)."""

from wtbench import stages


def read(result):
    return stages.device_ms(result, stages.HARVEST)
