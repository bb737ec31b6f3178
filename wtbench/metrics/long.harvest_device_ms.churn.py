"""Long audio (``analysis/longform.py``, ``analysis/harvest.py``,
``ops/refine_kernel.py``): device ms a chapter under Harvest's stage
marks (``stages.HARVEST``: LongHarvest's batches of windows through
decimation, band filter, zero crossings, refinement and pruning; its
contour runs on the host), over the traced chapters; in a chapter stream
whose every chapter captures its own programs (the cells that report
``rtf.churn``).  None without marks in the trace."""

from wtbench import stages


def read(result):
    tr, traced = result.get("trace"), result.get("traced")
    if tr is None or not getattr(traced, "chapters", 0):
        return None
    by, _, marks = stages.split(tr)
    if not marks:
        return None
    return 1e3 * sum(by.get(s, 0.0) for s in stages.HARVEST) \
        / traced.chapters
