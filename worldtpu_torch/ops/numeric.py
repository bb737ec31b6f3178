"""Small numeric helpers shared by the port.

``rdiv`` exists because PyTorch evaluates ``scalar / tensor`` as
``tensor.reciprocal() * scalar`` (two roundings), while the reference's
``scalar / array`` is one IEEE division; the port uses it wherever the
quotient feeds an integer truncation or rounding (window half-widths,
harmonic counts), so those decisions match the reference's.  The scalar operand is filled on
the tensor's device (``torch.full``): a tensor built from a Python value
and moved there would be a blocking host-to-device copy.
"""

from __future__ import annotations

import torch


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
