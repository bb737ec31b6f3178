"""Linear interpolation with MATLAB histc edge semantics.

Port of worldtpu/ops/interp.py (the reference's interp1 / interp1Q / histc
trio).  ``interp1``: segment
``k = clip(searchsorted(x, xi, right), 1, n-1)``, then linear evaluation on
``[x[k-1], x[k]]`` (queries outside extrapolate with the end segments; a
query equal to an interior knot takes the segment to its right).
"""

from __future__ import annotations

import torch


def interp1(x, y, xi, n_valid=None):
    """Interpolate rows of knot values at query positions.

    Args:
        x: [N] increasing knot positions shared by all rows, or [..., N]
            with one row of knots per row of y.  May be padded past
            ``n_valid`` with +inf, which the search ignores.
        y: [..., N] knot values.
        xi: [M] query positions.
        n_valid: optional count of valid knots (an int, or a tensor [...]
            with one count per row): the segment index is clamped to
            ``[1, n_valid - 1]``.  Rows with fewer than two valid knots give
            values without meaning (finite or not), never an error.

    Returns:
        [..., M] interpolated values.
    """
    if x.dim() == 1 and n_valid is None:
        k = torch.searchsorted(x.contiguous(), xi.contiguous(), right=True)
        k = k.clamp(1, x.shape[0] - 1)
        x0, x1 = x[k - 1], x[k]
        y0, y1 = y[..., k - 1], y[..., k]
        s = (xi - x0) / (x1 - x0)
        return y0 + s * (y1 - y0)
    n = x.shape[-1]
    x = x.expand(y.shape).contiguous()
    q = xi.expand(*y.shape[:-1], xi.shape[-1]).contiguous()
    k = torch.searchsorted(x, q, right=True).clamp(min=1)
    # clip(k, 1, hi) as minimum(maximum(k, 1), hi); with hi < 1 the row has
    # no segment and the index is only kept inside the array.  A host
    # number stays a clamp bound (no host-to-device copy: a captured CUDA
    # graph cannot hold one)
    if isinstance(n_valid, torch.Tensor):
        k = torch.minimum(k, n_valid.to(y.device)[..., None] - 1)
    elif n_valid is not None:
        k = k.clamp(max=int(n_valid) - 1)
    k = k.clamp(1, n - 1)
    x0, x1 = x.gather(-1, k - 1), x.gather(-1, k)
    y0, y1 = y.gather(-1, k - 1), y.gather(-1, k)
    s = (q - x0) / (x1 - x0)
    return y0 + s * (y1 - y0)


def interp1q(x0, dx, y, xi, delta_clamp_last=True):
    """Uniform-grid linear interpolation (reference interp1Q):
    ``base = int((xi - x0) / dx)`` truncates toward zero like the C cast,
    and the last segment's slope is zero.

    Args:
        x0: grid origin (a number).
        dx: grid step (may be negative, as DCCorrection uses it).
        y: [N] values on the grid.
        xi: [...] query positions.
    """
    pos = (xi - x0) / dx
    base = pos.to(torch.int32)          # truncation toward zero
    frac = pos - base.to(pos.dtype)
    n = y.shape[-1]
    base_c = base.clamp(0, n - 1).long()
    y0 = y[base_c]
    y1 = y[(base_c + 1).clamp(0, n - 1)]
    delta = y1 - y0
    if delta_clamp_last:
        delta = torch.where(base_c >= n - 1, torch.zeros_like(delta), delta)
    return y0 + delta * frac
