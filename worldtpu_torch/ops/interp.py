"""Linear interpolation with MATLAB histc edge semantics.

Port of worldtpu/ops/interp.py::interp1: segment
``k = clip(searchsorted(x, xi, right), 1, len(x)-1)``, then linear
evaluation on ``[x[k-1], x[k]]`` (queries outside extrapolate with the end
segments; a query equal to an interior knot takes the segment to its right).
"""

from __future__ import annotations

import torch


def interp1(x, y, xi):
    """Interpolate rows of knot values at query positions.

    Args:
        x: [N] increasing knot positions (shared by all rows).
        y: [..., N] knot values.
        xi: [M] query positions.

    Returns:
        [..., M] interpolated values.
    """
    k = torch.searchsorted(x.contiguous(), xi.contiguous(), right=True)
    k = k.clamp(1, x.shape[0] - 1)
    x0, x1 = x[k - 1], x[k]
    y0, y1 = y[..., k - 1], y[..., k]
    s = (xi - x0) / (x1 - x0)
    return y0 + s * (y1 - y0)
