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


#: the kernel's C entry by sample type
_ENTRIES = {torch.float32: "wt_ola", torch.float64: "wt_ola_f64"}


def overlap_add(resp, starts, out_length, n_pulses=None):
    """Add resp[b, p] into out[b, starts[b, p] : starts[b, p] + fft] for
    the first n_pulses[b] pulses of each utterance (all of them when
    n_pulses is None), dropping samples outside [0, out_length).

    Args:
        resp: [B, P, fft] float32 or float64 responses.
        starts: [B, P] int32 start samples, non-decreasing along P (pulses
            in time order; padding pulses last with zero response).
        out_length: output samples per utterance.
        n_pulses: optional [B] int64 count of the real pulses (the time
            base's, on the device): the kernel scans no pulse past it.

    Returns:
        [B, out_length] of resp's dtype.  On the card both dtypes sum each
        output sample in pulse order (no atomics): the float64 parity path
        needs the reference's order of additions.
    """
    if device_kind(resp) == "cpu":
        return overlap_add_plain(resp, starts, out_length, n_pulses)
    return overlap_add_cuda(resp, starts, out_length, n_pulses)


def overlap_add_plain(resp, starts, out_length, n_pulses=None):
    """Scatter form: one ``index_add_`` of every in-range sample."""
    B, P, fft = resp.shape
    T = out_length
    j = torch.arange(fft, device=resp.device)
    target = starts.to(torch.int64)[..., None] + j
    ok = (target >= 0) & (target < T)
    if n_pulses is not None:
        ok = ok & (torch.arange(P, device=resp.device)
                   < n_pulses[:, None])[..., None]
    row = torch.arange(B, device=resp.device)[:, None, None] * (T + 1)
    flat_t = (torch.where(ok, target, T) + row).reshape(-1)
    flat_v = torch.where(ok, resp, torch.zeros((), dtype=resp.dtype,
                                                device=resp.device))
    out = torch.zeros(B * (T + 1), dtype=resp.dtype, device=resp.device)
    out.index_add_(0, flat_t, flat_v.reshape(-1))
    return out.reshape(B, T + 1)[:, :T]


def overlap_add_cuda(resp, starts, out_length, n_pulses=None):
    """Launch ``wt_ola`` (float32) or ``wt_ola_f64`` (float64), the same
    kernel for either sample type: one block per (utterance, 512-sample
    tile)."""
    B, P, fft = resp.shape
    if resp.dtype not in _ENTRIES:
        raise ValueError(f"resp: expected float32 or float64, got "
                         f"{resp.dtype}")
    _build.check_tensor(resp, "resp", resp.dtype)
    _build.check_tensor(starts, "starts", torch.int32, (B, P), resp.device)
    if n_pulses is not None:
        _build.check_tensor(n_pulses, "n_pulses", torch.int64, (B,),
                            resp.device)
    out = torch.empty((B, out_length), dtype=resp.dtype,
                      device=resp.device)
    _build.launch(_ENTRIES[resp.dtype], resp.device, resp, starts, n_pulses, out, B, P,
                  fft, out_length)
    return out
