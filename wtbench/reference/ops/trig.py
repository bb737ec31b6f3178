"""Affine-argument cosines from per-row seeds.

Port of worldtpu/ops/trig.py::cos_affine.  With i = Q*q + r,
``cos(a*i + b) = cos(aQq + b)cos(ar) - sin(aQq + b)sin(ar)``, so a
[.., ceil(W/Q)] and a [.., Q] seed pair replace the [.., W] grid of
transcendentals; each output is one product-sum of rounded seeds (f32
round-off).  Kept as written on the TPU so the port's windows match the
reference's to rounding.
"""

from __future__ import annotations

import torch


def cos_affine(alpha, beta, W, *, Q=128, second=False):
    """cos(alpha[..., None] * arange(W) + beta[..., None]).

    Args:
        alpha, beta: [...] per-row angle step and offset (same dtype).
        W: number of columns.
        second: also return cos of the doubled angle (2 cos^2 - 1).

    Returns:
        [..., W] (a pair of them if ``second``).
    """
    dt, dev = alpha.dtype, alpha.device
    nq = -(-W // Q)
    q = torch.arange(nq, dtype=dt, device=dev) * Q
    r = torch.arange(Q, dtype=dt, device=dev)
    a = alpha[..., None]
    big = a * q + beta[..., None]                     # [..., nq]
    cb, sb = torch.cos(big), torch.sin(big)
    small = a * r                                     # [..., Q]
    cs, ss = torch.cos(small), torch.sin(small)
    out = (cb[..., :, None] * cs[..., None, :]
           - sb[..., :, None] * ss[..., None, :])
    out = out.reshape(*out.shape[:-2], nq * Q)[..., :W]
    if not second:
        return out
    return out, 2.0 * out * out - 1.0
