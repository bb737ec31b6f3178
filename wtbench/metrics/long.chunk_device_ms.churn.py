"""Long audio (``longaudio.py``): device ms a chunk step under the
long-audio stage marks (analysis, time base, noise, pulse responses,
overlap-add, and the prescan's time base), over the traced chapters'
chunk steps (``LongPipeline.counts``); in a chapter stream whose every
chapter captures its own programs (the cells that report ``rtf.churn``).
None where the program has no such marks or no such counter."""

from wtbench import stages

#: the stages of the long-audio chunk step and prescan
LONG = ("long_prescan", "long_analysis", "long_timebase", "long_noise",
        "long_pulses", "long_ola")


def read(result):
    tr, traced = result.get("trace"), result.get("traced")
    if tr is None or not getattr(traced, "chunk_steps", 0):
        return None
    by, _, _ = stages.split(tr)
    if not any(s in by for s in LONG):
        return None
    return 1e3 * sum(by.get(s, 0.0) for s in LONG) / traced.chunk_steps
