"""Small numeric helpers shared by the port.

``rdiv`` exists because PyTorch evaluates ``scalar / tensor`` as
``tensor.reciprocal() * scalar`` (two roundings), while the reference's
``scalar / array`` is one IEEE division; the port uses it wherever the
quotient feeds an integer truncation or rounding (window half-widths,
harmonic counts), so those decisions match the reference's.  The scalar operand is filled on
the tensor's device (``torch.full``): a tensor built from a Python value
and moved there would be a blocking host-to-device copy.  Constants
copied from host data are made once and kept by ``device_cache``.
"""

from __future__ import annotations

import contextlib
import functools

import torch

#: while a CUDA graph is captured (parallel/graphs.py): every value that a
#: ``device_cache`` function handed out, kept alive by the captured program
_pins = None


def rdiv(scalar, t):
    """``scalar / t`` as one correctly rounded division."""
    return torch.div(torch.full((), scalar, dtype=t.dtype, device=t.device),
                     t)


def matlab_round(x):
    """Half-away-from-zero rounding to int32 (the reference's
    matlab_round)."""
    return torch.where(x > 0, torch.floor(x + 0.5),
                       torch.ceil(x - 0.5)).to(torch.int32)


def device_kind(t):
    """'cpu' or 'cuda' for a tensor; raises for any other device, since the
    kernel wrappers have exactly those two routes."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return kind


def device_cache(maxsize):
    """``functools.lru_cache`` for a function that returns device constants.

    A captured CUDA graph reads those constants at the addresses they had
    at capture, and a replay runs no Python to look them up again; while a
    capture runs (``pinning``) each value handed out is also kept by the
    captured program, so that the cache may drop its entry but the memory
    stays allocated for as long as the program lives."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kw):
            value = cached(*args, **kw)
            if _pins is not None:
                _pins.append(value)
            return value

        return get
    return wrap


@contextlib.contextmanager
def pinning():
    """Collect the values that ``device_cache`` functions hand out inside
    the block: yields the list they are appended to."""
    global _pins
    outer, _pins = _pins, []
    try:
        yield _pins
    finally:
        _pins = outer
