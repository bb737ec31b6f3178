"""Strictly sequential cumulative sum of float64 rows — wrapper of the CUDA
kernel ``csrc/seq_cumsum.cu`` and its plain version.

The float64 parity path needs sums that round once per step, left to right,
as the reference vocoder's loops do (the spectral integration of
LinearSmoothing, the phase sum of the synthesis time base; in the JAX
package ``worldtpu/ops/filters.py::linear_smoothing``'s ``lax.scan`` and the
``cumsum`` of ``worldtpu/synthesis/synthesis.py::_time_base`` on the CPU).
``torch.cumsum`` on a CUDA tensor is a parallel scan that reassociates, so a
CUDA tensor takes the kernel; a CPU tensor takes ``numpy.cumsum``, which
accumulates in order.

The kernel keeps each row's chain of dependent adds on one thread and
moves memory off it: producer warps stream the rows through shared memory
in column chunks, coalesced, and the chain thread reads its next values
from there.  ``plan`` is the host's choice of regime, rows a block and
chunk, the same rule the C entry applies.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from worldtpu_torch import _build
from worldtpu_torch.ops.numeric import device_kind

#: SMs of an H100 SXM (the C entry reads the device's own count)
SMS = 132
STAGES = 3
#: a stage row's pitch is chunk + PAD doubles: 16-byte aligned, and the
#: chain lanes' 16-byte reads of one column hit distinct banks
PAD = 2
#: rows a block at most: a launch of many rows spreads over several
#: blocks an SM, whose producers keep more bytes in flight
ROWS_MAX = 4
ROWS_CHUNK = 128
LONG_CHUNK = 1024
#: past this length, fewer rows than SMs take one block a row
LONG_N = 4096

Plan = collections.namedtuple("Plan", "regime rows chunk blocks smem")


def plan(n_rows, n, sms=SMS):
    """The launch of ``wt_seq_cumsum_f64`` for [n_rows, n] on ``sms`` SMs:
    regime "rows" (many rows: rows a block chosen so that the grid covers
    every SM wherever the rows allow) or "long" (fewer rows than SMs, each
    longer than LONG_N: one block a row), the rows a block, the columns a
    chunk, the blocks and the dynamic shared bytes (STAGES stages of rows x
    (chunk + PAD) doubles)."""
    if n_rows < sms and n > LONG_N:
        regime, rows, chunk = "long", 1, LONG_CHUNK
    else:
        regime, rows, chunk = ("rows", max(1, min(ROWS_MAX, n_rows // sms)),
                               ROWS_CHUNK)
    return Plan(regime, rows, chunk, -(-n_rows // rows),
                STAGES * rows * (chunk + PAD) * 8)


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
    """Launch ``wt_seq_cumsum_f64`` once (its launch as ``plan`` says)."""
    x = x.contiguous()
    _build.check_tensor(x, "x", torch.float64)
    out = torch.empty_like(x)
    n = x.shape[-1] if x.dim() else 1
    _build.launch("wt_seq_cumsum_f64", x.device, x, out,
                  x.numel() // max(n, 1), n)
    return out
