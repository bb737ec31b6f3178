"""Kernels (``ops/zc_kernel.py``, ``csrc/zc.cu``): the zc kernel's share of
its roofline over the traced pass, in % (``roofline.zc_share``); in a
corpus pass whose keys the graph cache holds, every batch replayed (the
cells that report ``rtf.replay``)."""

from wtbench import roofline


def read(result):
    return roofline.zc_share(result)
