"""Long audio (``analysis/longform.py``): host ms of the host contour a
chapter, the outermost ``wt.long.contour`` spans of the traced chapter
(``LongHarvest._contour``: fixing and smoothing over the recording's 1 ms
grid, then the pick at the frame period), over its chapters; in a chapter
stream whose every chapter captures its own programs (the cells that
report ``rtf.churn``).  None where the program opens no such span."""


def read(result):
    tr, traced = result.get("trace"), result.get("traced")
    if tr is None or not getattr(traced, "chapters", 0):
        return None
    spans = sorted((s, e) for n, s, e in tr.host
                   if n == "wt.long.contour" and tr.t0_ns <= s < tr.t1_ns)
    total, end = 0, None
    for s, e in spans:
        if end is None or s >= end:
            total += e - s
            end = e
    return total / 1e6 / traced.chapters if spans else None
