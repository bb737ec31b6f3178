"""The port's trace points: the stages of the main path, named on the host
and marked on the device, and the graph cache's calls.

A profiled eager call shows each stage as a host range ``wt.<stage>``
(``torch.profiler.record_function``).  A captured CUDA graph runs no
Python, so its replays have no host ranges.  ``stage`` therefore also
launches an empty kernel on the device at the stage's entry and one at its
exit (``csrc/marks.cu``: ``wt_mark_<stage>_in``, ``wt_mark_<stage>_out``).
Captured, the marks are nodes of the graph: every replay runs them, and a
profiler's device trace brackets each stage's kernels by them, on the
device's own clock.  A mark reads and writes nothing, so no output changes
by a bit.  Marks are launched through their own C entry (``wt_mark``), not
``_build.launch``: they are not counted in ``_build.launches`` nor in a
captured program's counts.

While the current stream captures, ``stage`` opens no host range but still
launches both marks: the host time of the recording then falls on the
graph cache's ``wt.graph.record`` span (``graph_span``), not on a stage.
On the CPU ``stage`` launches nothing and never loads the kernel library.

``graph_span`` opens the graph cache's ranges (``parallel/graphs.py``):
one outermost ``wt.graph.eager``, ``wt.graph.capture`` or
``wt.graph.replay`` a call; a capture holds ``wt.graph.warm``,
``wt.graph.record`` and, when the cache is full, ``wt.graph.evict``.

The long-audio path (``longaudio.py``) marks its chunk step and prescan
as stages of their own (the six ``long_*`` stages, appended after the main
path's), so a replayed chunk step is split on the device too; its host
work has host ranges only (``long_span``): ``wt.long.harvest``
(LongHarvest's device stages and the stitching of their rows),
``wt.long.contour`` (its contour chain: in float32 on the card the device
chain, inside the ``contour`` stage, and the download of its F0; else the
host chain), ``wt.long.plan`` (the chunk plan and its device tables) and
``wt.long.land`` (the host accumulation of chunk buffers).

Every ``wt.*`` range of the port is opened here.  What reads them:
``wtbench/stages.py``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

from worldtpu_torch import _build

#: the stages of the main path, in its order, then those of the long-audio
#: chunk step and prescan (``WT_STAGES`` in ``csrc/marks.cu``)
STAGES = ("decimate", "band_filter", "zc", "detect_overlap",
          "refine_prepare", "refine_sums", "refine_finish", "prune",
          "contour", "cheaptrick", "d4c", "pulse_train", "ola",
          "long_prescan", "long_analysis", "long_timebase", "long_noise",
          "long_pulses", "long_ola")

#: the graph cache's spans: a call's outermost one, and a capture's parts
GRAPH_SPANS = ("eager", "capture", "warm", "record", "evict", "replay")

#: the long-audio path's host ranges
LONG_SPANS = ("harvest", "contour", "plan", "land")

_MARK = {name: 2 * i for i, name in enumerate(STAGES)}


def _mark(index, device):
    """Launch mark ``index`` on ``device``'s current stream."""
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.wt_mark(index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wt_mark {index}: CUDA launch failed with error "
                           f"{err}")


@contextlib.contextmanager
def stage(name, device):
    """The main-path stage ``name`` (one of ``STAGES``) on ``device``: the
    host range ``wt.<name>`` unless the current stream captures, and on a
    CUDA device the marks at entry and exit."""
    index = _MARK[name]
    cuda = torch.device(device).type == "cuda"
    capturing = cuda and torch.cuda.is_current_stream_capturing()
    with (contextlib.nullcontext() if capturing
          else record_function("wt." + name)):
        if cuda:
            _mark(index, device)
        yield
        if cuda:
            _mark(index + 1, device)


def graph_span(kind):
    """The graph cache's host range ``wt.graph.<kind>`` (``GRAPH_SPANS``)."""
    if kind not in GRAPH_SPANS:
        raise ValueError(f"unknown graph span {kind!r}")
    return record_function("wt.graph." + kind)


def long_span(kind):
    """The long-audio path's host range ``wt.long.<kind>``
    (``LONG_SPANS``)."""
    if kind not in LONG_SPANS:
        raise ValueError(f"unknown long-audio span {kind!r}")
    return record_function("wt.long." + kind)
