"""Overlap-add of pulse impulse responses — wrapper of the CUDA kernel
``csrc/ola.cu`` and its plain PyTorch version.

Port of worldtpu/ops/ola_kernel.py (Pallas ``_ola_kernel``).  The plain
version is the synthesis scatter twin (worldtpu/synthesis/synthesis.py,
``use_ola=False``) as an ``index_add_``.
"""

from __future__ import annotations

import torch

from worldtpu_torch import _build
from worldtpu_torch.ops.numeric import device_kind


def overlap_add(resp, starts, out_length):
    """Add resp[b, p] into out[b, starts[b, p] : starts[b, p] + fft],
    dropping samples outside [0, out_length).

    Args:
        resp: [B, P, fft] float32 responses.
        starts: [B, P] int32 start samples, non-decreasing along P (pulses
            in time order; padding pulses last with zero response).
        out_length: output samples per utterance.

    Returns:
        [B, out_length] float32.
    """
    if device_kind(resp) == "cpu":
        return overlap_add_plain(resp, starts, out_length)
    return overlap_add_cuda(resp, starts, out_length)


def overlap_add_plain(resp, starts, out_length):
    """Scatter form: one ``index_add_`` of every in-range sample."""
    B, P, fft = resp.shape
    T = out_length
    j = torch.arange(fft, device=resp.device)
    target = starts.to(torch.int64)[..., None] + j
    ok = (target >= 0) & (target < T)
    row = torch.arange(B, device=resp.device)[:, None, None] * (T + 1)
    flat_t = (torch.where(ok, target, T) + row).reshape(-1)
    flat_v = torch.where(ok, resp, torch.zeros((), dtype=resp.dtype,
                                                device=resp.device))
    out = torch.zeros(B * (T + 1), dtype=resp.dtype, device=resp.device)
    out.index_add_(0, flat_t, flat_v.reshape(-1))
    return out.reshape(B, T + 1)[:, :T]


def overlap_add_cuda(resp, starts, out_length):
    """Launch ``wt_ola``: one block per (utterance, 256-sample tile)."""
    B, P, fft = resp.shape
    _build.check_tensor(resp, "resp", torch.float32)
    _build.check_tensor(starts, "starts", torch.int32, (B, P), resp.device)
    out = torch.empty((B, out_length), dtype=torch.float32,
                      device=resp.device)
    _build.launch("wt_ola", resp.device, resp.data_ptr(), starts.data_ptr(),
                  out.data_ptr(), B, P, fft, out_length)
    return out
