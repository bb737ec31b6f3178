"""Structured per-stage metrics (SURVEY §5 metrics/logging row).

The port's own copy of ``worldtpu/metrics.py`` (unchanged in behaviour;
``tests/test_torch_io.py`` holds the JSON equal).  The reference only `cout`s stage wall times (test.cpp:112-263); here each
stage records a typed entry — wall seconds, realtime factor, frames/pulses
processed — into a recorder that can log through :mod:`logging` and emit
one JSON document for dashboards/CI.  Used by the CLI (`--metrics-json`)
and importable by any pipeline driver.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Optional

log = logging.getLogger("worldtpu_torch")


@dataclasses.dataclass
class StageMetric:
    stage: str
    wall_s: float
    audio_s: Optional[float] = None
    frames: Optional[int] = None
    pulses: Optional[int] = None

    @property
    def rtf(self) -> Optional[float]:
        if self.audio_s is None or self.wall_s <= 0:
            return None
        return self.audio_s / self.wall_s

    def as_dict(self):
        d = {"stage": self.stage, "wall_s": round(self.wall_s, 6)}
        if self.audio_s is not None:
            d["audio_s"] = round(self.audio_s, 6)
            d["rtf"] = round(self.rtf, 3)
        if self.frames is not None:
            d["frames"] = int(self.frames)
        if self.pulses is not None:
            d["pulses"] = int(self.pulses)
        return d


class MetricsRecorder:
    """Collects StageMetric entries; ``stage()`` is a context manager.

    >>> rec = MetricsRecorder(audio_s=3.0)
    >>> with rec.stage("harvest", frames=601):
    ...     run()
    >>> rec.emit_json("metrics.json")
    """

    def __init__(self, audio_s: Optional[float] = None):
        self.audio_s = audio_s
        self.entries: list[StageMetric] = []

    def stage(self, name, frames=None, pulses=None, audio_s=None):
        rec = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.time()
                return self

            def __exit__(self, *exc):
                m = StageMetric(
                    stage=name, wall_s=time.time() - self.t0,
                    audio_s=audio_s if audio_s is not None else rec.audio_s,
                    frames=frames, pulses=pulses)
                rec.entries.append(m)
                log.info("stage %s: %.3f ms%s", name, m.wall_s * 1e3,
                         f" ({m.rtf:.1f}x realtime)" if m.rtf else "")
                return False

        return _Ctx()

    def add(self, stage, wall_s, **kw):
        m = StageMetric(stage=stage, wall_s=wall_s,
                        audio_s=kw.pop("audio_s", self.audio_s), **kw)
        self.entries.append(m)
        return m

    def as_dict(self):
        total = sum(m.wall_s for m in self.entries)
        d = {"stages": [m.as_dict() for m in self.entries],
             "total_wall_s": round(total, 6)}
        if self.audio_s is not None and total > 0:
            d["audio_s"] = round(self.audio_s, 6)
            d["rtf"] = round(self.audio_s / total, 3)
        return d

    def emit_json(self, path=None):
        s = json.dumps(self.as_dict())
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s
