"""Strictly sequential cumulative sum of float64 rows — wrapper of the CUDA
kernel ``csrc/seq_cumsum.cu`` and its plain version.

The float64 parity path needs sums that round once per step, left to right,
as the reference vocoder's loops do (the spectral integration of
LinearSmoothing, the phase sum of the synthesis time base; in the JAX
package ``worldtpu/ops/filters.py::linear_smoothing``'s ``lax.scan`` and the
``cumsum`` of ``worldtpu/synthesis/synthesis.py::_time_base`` on the CPU).
``torch.cumsum`` on a CUDA tensor is a parallel scan that reassociates, so a
CUDA tensor takes the kernel (one thread per row); a CPU tensor takes
``numpy.cumsum``, which accumulates in order.
"""

from __future__ import annotations

import numpy as np
import torch

from worldtpu_torch import _build
from worldtpu_torch.ops.numeric import device_kind


def cumsum_sequential(x):
    """Inclusive cumulative sum of float64 x [..., n] along the last axis,
    each row summed strictly left to right."""
    if x.dtype != torch.float64:
        raise ValueError(f"x: expected torch.float64, got {x.dtype}")
    if device_kind(x) == "cpu":
        return cumsum_sequential_plain(x)
    return cumsum_sequential_cuda(x)


def cumsum_sequential_plain(x):
    """``numpy.cumsum`` (in order, one rounding per step) of a CPU copy,
    returned on x's device."""
    out = np.cumsum(x.detach().cpu().contiguous().numpy(), axis=-1)
    return torch.from_numpy(out).to(x.device)


def cumsum_sequential_cuda(x):
    """Launch ``wt_seq_cumsum_f64``: one thread per row."""
    x = x.contiguous()
    _build.check_tensor(x, "x", torch.float64)
    out = torch.empty_like(x)
    n = x.shape[-1] if x.dim() else 1
    _build.launch("wt_seq_cumsum_f64", x.device, x, out,
                  x.numel() // max(n, 1), n)
    return out
