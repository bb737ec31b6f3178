"""Captured CUDA graphs of the float32 main path: the port's counterpart of
``jax.jit``.

The JAX package jits ``batch_wav_to_wav`` and ``batch_analyze``
(worldtpu/parallel/batch.py:281-286, :329-333): one compiled program per
set of static arguments, F0 never leaving the device.  PyTorch runs
eagerly, and the main path is some three thousand small launches a batch,
so its wall follows the host.  Since the contour chain's loops are kernels
(ops/contour_kernel.py), a float32 call on the card makes no host
synchronisation and can be captured whole:

  - the first call of a key runs eagerly, so a one-off call costs what an
    eager call costs;
  - the second call runs eagerly once more, which warms what capture needs
    (cuFFT plans, cuBLAS handles, the kernels' shared-memory attributes)
    and fills every device constant cache the call reads, then captures
    the call into a ``torch.cuda.CUDAGraph`` and replays it;
  - later calls copy their tensors into the program's static inputs,
    replay, and return clones of its static outputs, so a returned tensor
    is never overwritten by a later replay.

The key is the function, each tensor's shape, dtype and device, and the
static arguments.  A ``HarvestGeometry`` is keyed by identity, as
``jax.jit`` keys the JAX package's (neither defines equality); the key
holds the object, so its id is not reused while the key lives.
``pitch_scale`` is not in the key: the program reads it from a 0-d float32
buffer (``scale_buffer``), so one program serves every pitch.  At most
``MAX_PROGRAMS`` programs are kept, the least recently used dropped first;
``clear()`` drops them all (``jax.clear_caches``).

A replay runs no Python, so it reads each device constant (band bounds,
filter banks, twiddles, the decimation's tables) at the address it had at
capture.  Those come from bounded per-device caches
(``ops.numeric.device_cache``); the program keeps every value that the
captured call took from them (``_Program.pins``), so that a cache may drop
an entry but the memory stays allocated while the program lives.

Launch counts: capture records each kernel's launches without adding them
to ``_build.launches`` (or ``zc_kernel.layout_launches``); each replay adds
them, so a replayed batch counts what an eager one counts.  These counts
are bookkeeping; ``chip_smoke.py`` checks them against the kernels that a
profiled replay ran on the device.

Only float32 CUDA tensors take this route; CPU tensors and float64 run
eagerly (as CPU tensors take the kernels' plain versions).  A capture error
raises: nothing retries eagerly.
"""

from __future__ import annotations

import collections

import torch

from worldtpu_torch import _build
from worldtpu_torch.ops.numeric import pinning

#: captured programs kept (the corpus stream needs one per padded length)
MAX_PROGRAMS = 4

#: key -> _Program, least recently used first
_programs: collections.OrderedDict = collections.OrderedDict()
#: keys that ran once eagerly and capture at their next call
_warm: collections.OrderedDict = collections.OrderedDict()


def _counters():
    from worldtpu_torch.ops import zc_kernel
    return (_build.launches, zc_kernel.layout_launches)


def _add(counter, delta, sign):
    for name, n in delta.items():
        counter[name] += sign * n
        if counter[name] == 0:
            del counter[name]


def scale_buffer(scale, like):
    """``scale`` as a 0-d tensor of like's dtype on like's device."""
    return torch.full((), scale, dtype=like.dtype, device=like.device)


def make_key(fn, tensors, static):
    """The cache key of fn over ``tensors`` with the static arguments."""
    return (fn, tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
            tuple(sorted(static.items())))


def capturable(tensors):
    """True when every tensor is float32 on the first one's CUDA device."""
    dev = tensors[0].device
    return dev.type == "cuda" and all(
        t.device == dev and t.dtype == torch.float32 for t in tensors)


class _Program:
    """One captured call: its graph, static inputs and outputs, the device
    constants it reads, and the kernel launches one replay makes."""

    def __init__(self, graph, inputs, scale, outputs, pins, counts):
        self.graph = graph
        self.inputs = inputs
        self.scale = scale
        self.outputs = outputs
        self.pins = pins
        self.counts = counts

    def replay(self, tensors, scale):
        for static, t in zip(self.inputs, tensors):
            static.copy_(t)
        self.scale.fill_(scale)
        self.graph.replay()
        for counter, delta in zip(_counters(), self.counts):
            _add(counter, delta, 1)
        return tuple(o.clone() for o in self.outputs)


def _capture(fn, tensors, scale, static):
    inputs = [t.clone() for t in tensors]
    buf = scale_buffer(scale, inputs[0])
    fn(*inputs, buf, **static)            # fills the caches capture reads
    before = [collections.Counter(c) for c in _counters()]
    graph = torch.cuda.CUDAGraph()
    try:
        with pinning() as pins, torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            outputs = fn(*inputs, buf, **static)
    finally:
        counts = [collections.Counter(c) - b
                  for c, b in zip(_counters(), before)]
        for counter, delta in zip(_counters(), counts):
            _add(counter, delta, -1)
    return _Program(graph, inputs, buf, tuple(outputs), pins, counts)


def call(fn, tensors, scale, **static):
    """``fn(*tensors, scale_buffer(scale), **static)`` (a tuple of
    tensors): eagerly, or through the key's captured program."""
    if not capturable(tensors):
        return fn(*tensors, scale_buffer(scale, tensors[0]), **static)
    key = make_key(fn, tensors, static)
    prog = _programs.get(key)
    if prog is None:
        if key not in _warm:
            _warm[key] = None
            while len(_warm) > MAX_PROGRAMS:
                _warm.popitem(last=False)
            return fn(*tensors, scale_buffer(scale, tensors[0]), **static)
        del _warm[key]
        prog = _capture(fn, tensors, scale, static)
        _programs[key] = prog
        while len(_programs) > MAX_PROGRAMS:
            _programs.popitem(last=False)
    else:
        _programs.move_to_end(key)
    return prog.replay(tensors, scale)


def clear():
    """Drop every captured program and warm-up record (their memory goes
    back to PyTorch's caching allocator)."""
    _programs.clear()
    _warm.clear()


def programs():
    """The keys of the captured programs, least recently used first."""
    return list(_programs)
