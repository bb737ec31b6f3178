"""Kernels (``ops/zc_kernel.py``, ``csrc/zc.cu``): the zc kernel's share of
its roofline over the traced pass, in % (``roofline.zc_share``); in a
corpus pass whose keys outnumber the graph cache's programs (eager calls
and captures beside replays; the cells that report ``rtf.churn``)."""

from wtbench import roofline


def read(result):
    return roofline.zc_share(result)
