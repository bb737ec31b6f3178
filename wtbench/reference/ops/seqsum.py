"""Strictly sequential cumulative sum of float64 rows (the plain version:
``numpy.cumsum``, which accumulates in order).  Only the float64 branches
of the copied stages call it; the reference runs float32.
"""

from __future__ import annotations

import numpy as np
import torch


def cumsum_sequential(x):
    """Inclusive cumulative sum of float64 x [..., n] along the last axis,
    each row summed strictly left to right."""
    if x.dtype != torch.float64:
        raise ValueError(f"x: expected torch.float64, got {x.dtype}")
    return cumsum_sequential_plain(x)


def cumsum_sequential_plain(x):
    """``numpy.cumsum`` (in order, one rounding per step) of a CPU copy,
    returned on x's device."""
    out = np.cumsum(x.detach().cpu().contiguous().numpy(), axis=-1)
    return torch.from_numpy(out).to(x.device)


