"""The long-audio noise rows in float32 on the card — wrapper of the CUDA
kernel ``csrc/noise.cu``.

No TPU kernel stands behind it: the JAX package leaves ``indexed_noise``
(worldtpu/synthesis/synthesis.py) to XLA.  Its plain version is
``synthesis.noise.indexed_noise_plain``, Threefry-2x32 in int64 tensor
operations masked to 32 bits; ``synthesis.noise.indexed_noise`` routes a
float32 draw whose ``start`` lies on a CUDA device here, and everything
else (the CPU, float64) there.  The kernel runs the rounds in uint32
registers, computes each row's key once a block and writes each float32
normal once; its bits and its normals equal the plain version's.
"""

from __future__ import annotations

import torch

from worldtpu_torch import _build


def noise_rows_cuda(key, start, count, fft_size):
    """Launch ``wt_noise_rows``: float32 noise rows [*start.shape, count,
    fft_size] for the int64 ``key`` [2] (two uint32 words, as
    ``noise.key_tensor`` makes it) and the int64 ordinals ``start`` (any
    shape), both on one CUDA device.  Reads nothing on the host."""
    dev = start.device
    _build.check_tensor(key, "key", torch.int64, (2,), dev)
    _build.check_tensor(start, "start", torch.int64, device=dev)
    count, fft_size = int(count), int(fft_size)
    if count < 0 or fft_size < 1:
        raise ValueError(f"count {count}, fft_size {fft_size}: expected "
                         f"count >= 0 and fft_size >= 1")
    out = torch.empty((*start.shape, count, fft_size), dtype=torch.float32,
                      device=dev)
    _build.launch("wt_noise_rows", dev, key, start, out, start.numel(), count,
                  fft_size)
    return out
