"""Captured CUDA graphs of the port's device programs: the port's
counterpart of ``jax.jit``.

The JAX package jits ``batch_wav_to_wav`` and ``batch_analyze``
(worldtpu/parallel/batch.py:281-286, :329-333), the full-batch Harvest
(``harvest_device_full_batch``) and LongPipeline's chunk step and prescan
(worldtpu/longaudio.py ``_chunk_step``, ``_phase_prescan``): one compiled
program per set of static arguments, nothing read back by the host inside
it.  PyTorch runs eagerly, and such a program is some thousands of small
launches, so its wall follows the host.  A call that makes no host
synchronisation can be captured whole:

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
holds the object, so its id is not reused while the key lives.  A value
that changes from call to call without changing the program (the pitch
scale, a chunk index, a noise key) is a tensor input and not part of the
key: ``pitch_scale`` is read from a 0-d buffer (``scale_buffer``) when the
caller passes ``scale``.  The module's ``call`` keeps at most
``MAX_PROGRAMS`` programs in one global cache, the least recently used
dropped first; ``clear()`` drops them all (``jax.clear_caches``).  A
caller whose programs serve one job keeps a ``Programs`` cache of its own
and drops it when the job ends (LongPipeline's chunk and prescan steps,
which read one recording's tables in place); its programs may share one
memory pool.

A replay runs no Python, so it reads each device constant (band bounds,
filter banks, twiddles, the decimation's tables) at the address it had at
capture.  Those come from bounded per-device caches
(``ops.numeric.device_cache``); the program keeps every value that the
captured call took from them (``_Program.pins``), so that a cache may drop
an entry but the memory stays allocated while the program lives.

Launch counts: capture records each kernel's launches without adding them
to ``_build.launches`` (or ``zc_kernel.layout_launches``); each replay adds
them, so a replayed call counts what an eager one counts.  These counts
are bookkeeping; ``chip_smoke.py`` checks them against the kernels that a
profiled replay ran on the device.

Spans (``tracing.graph_span``): each ``Programs.call`` opens one
outermost host range, ``wt.graph.eager`` (a key's first call, or tensors
that are not capturable), ``wt.graph.capture`` (a key's second call:
``wt.graph.warm`` the eager warm-up, ``wt.graph.record`` the capture
itself, ``wt.graph.evict`` the least recently used program's drop when
the cache is full, then the first replay) or ``wt.graph.replay``.  The
stages inside a captured call mark the device but open no host range, so
the recording's host time falls on ``wt.graph.record``.

Only CUDA tensors take this route, and only with floating tensors of the
caller's ``dtypes`` (float32 unless it says otherwise: the float64 batch
programs sync the host for their mean and contour); CPU tensors run
eagerly (as CPU tensors take the kernels' plain versions).  A capture
error raises: nothing retries eagerly.
"""

from __future__ import annotations

import collections

import torch

from worldtpu_torch import _build
from worldtpu_torch.ops.numeric import pinning
from worldtpu_torch.tracing import graph_span

#: captured programs a cache keeps (the global one: the main path's two,
#: the corpus stream's one per padded length, HarvestKernel.forward's)
MAX_PROGRAMS = 4


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


def capturable(tensors, dtypes=(torch.float32,)):
    """True when every tensor lies on the first one's CUDA device and
    every floating tensor has one of ``dtypes``."""
    dev = tensors[0].device
    return dev.type == "cuda" and all(
        t.device == dev
        and (t.dtype in dtypes or not t.dtype.is_floating_point)
        for t in tensors)


class _Program:
    """One captured call: its graph, static inputs and outputs, the device
    constants it reads, the kernel launches one replay makes, and the
    bytes its capture added to the memory reserved on its device
    (``held``)."""

    def __init__(self, graph, inputs, scale, outputs, pins, counts, held):
        self.graph = graph
        self.inputs = inputs
        self.scale = scale
        self.outputs = outputs
        self.pins = pins
        self.counts = counts
        self.held = held

    def replay(self, tensors, scale):
        for static, t in zip(self.inputs, tensors):
            static.copy_(t)
        if self.scale is not None:
            self.scale.fill_(scale)
        self.graph.replay()
        for counter, delta in zip(_counters(), self.counts):
            _add(counter, delta, 1)
        return tuple(o.clone() for o in self.outputs)


def _args(tensors, scale):
    """fn's positional arguments: the tensors, then the scale's buffer
    when there is a scale."""
    if scale is None:
        return tuple(tensors), None
    buf = scale_buffer(scale, tensors[0])
    return (*tensors, buf), buf


def _capture(fn, tensors, scale, static, pool=None):
    """Record fn over clones of ``tensors`` into a ``_Program`` (the
    caller has run fn once eagerly: that filled the caches capture reads)."""
    inputs = [t.clone() for t in tensors]
    args, buf = _args(inputs, scale)
    before = [collections.Counter(c) for c in _counters()]
    # the capture empties the allocator's cache on entry: what is reserved
    # after it beyond this is the program's pool
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(inputs[0].device)
    graph = torch.cuda.CUDAGraph()
    try:
        with pinning() as pins, torch.cuda.graph(
                graph, pool=pool, capture_error_mode="thread_local"):
            outputs = fn(*args, **static)
    finally:
        counts = [collections.Counter(c) - b
                  for c, b in zip(_counters(), before)]
        for counter, delta in zip(_counters(), counts):
            _add(counter, delta, -1)
    held = torch.cuda.memory_reserved(inputs[0].device) - reserved
    return _Program(graph, inputs, buf, tuple(outputs), pins, counts, held)


class Programs:
    """A cache of captured programs: at most ``MAX_PROGRAMS``, the least
    recently used dropped first, and the keys that ran once eagerly and
    capture at their next call.  ``shared_pool``: the programs share one
    memory pool (``torch.cuda.graph_pool_handle()``), so that they hold
    one pool's worth of intermediates between them, not one each; that is
    safe because replays run in stream order and each call clones its
    outputs before the next replay.  A caller whose programs serve one
    job keeps a cache of its own and drops it (``clear``) when the job
    ends; the module's functions serve the global one."""

    def __init__(self, shared_pool=False):
        self.shared_pool = shared_pool
        self._pool = None
        #: key -> _Program, least recently used first
        self._programs = collections.OrderedDict()
        #: keys that ran once eagerly and capture at their next call
        self._warm = collections.OrderedDict()

    def call(self, fn, tensors, scale=None, *, dtypes=(torch.float32,),
             **static):
        """``fn(*tensors, scale_buffer(scale), **static)``, or
        ``fn(*tensors, **static)`` when ``scale`` is None (a tuple of
        tensors): eagerly, or through the key's captured program when the
        tensors are ``capturable`` with ``dtypes``."""
        if not capturable(tensors, dtypes):
            with graph_span("eager"):
                return eager(fn, tensors, scale, **static)
        key = make_key(fn, tensors, static)
        prog = self._programs.get(key)
        if prog is not None:
            self._programs.move_to_end(key)
            with graph_span("replay"):
                return prog.replay(tensors, scale)
        if key not in self._warm:
            self._warm[key] = None
            while len(self._warm) > MAX_PROGRAMS:
                self._warm.popitem(last=False)
            with graph_span("eager"):
                return eager(fn, tensors, scale, **static)
        with graph_span("capture"):
            del self._warm[key]
            with graph_span("warm"):
                eager(fn, tensors, scale, **static)
            if self.shared_pool and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            with graph_span("record"):
                prog = _capture(fn, tensors, scale, static, self._pool)
            self._programs[key] = prog
            while len(self._programs) > MAX_PROGRAMS:
                with graph_span("evict"):
                    self._programs.popitem(last=False)
            return prog.replay(tensors, scale)

    def keys(self):
        """The keys of the captured programs, least recently used first."""
        return list(self._programs)

    def held(self):
        """The bytes each program's capture added to the reserved memory,
        in ``keys`` order."""
        return [p.held for p in self._programs.values()]

    def clear(self):
        """Drop every captured program, warm-up record and the shared
        pool (their memory goes back to PyTorch's caching allocator)."""
        self._programs.clear()
        self._warm.clear()
        self._pool = None


_cache = Programs()
_programs, _warm = _cache._programs, _cache._warm


def call(fn, tensors, scale=None, *, dtypes=(torch.float32,), **static):
    """``Programs.call`` through the global cache."""
    return _cache.call(fn, tensors, scale, dtypes=dtypes, **static)


def eager(fn, tensors, scale=None, *, dtypes=None, **static):
    """What ``call`` computes, run eagerly and outside any cache (the
    eager program, for a caller that must not capture or a measurement
    that times it)."""
    return fn(*_args(tensors, scale)[0], **static)


def clear():
    """Drop every program of the global cache (``jax.clear_caches``)."""
    _cache.clear()


def programs():
    """The keys of the global cache's programs, least recently used
    first."""
    return _cache.keys()
