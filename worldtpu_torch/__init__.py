"""worldtpu_torch — the WORLD vocoder's f32 production path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``worldtpu`` (which stays the reference): B padded
wavs -> Harvest F0 (with the on-device contour chain) -> pitch scale ->
CheapTrick + D4C -> pulse/noise synthesis -> B wavs, as
``worldtpu_torch.parallel.batch.batch_wav_to_wav``.  The user entry points
mirror ``worldtpu``'s: the facades of ``api`` (exported here: Harvest,
CheapTrick, D4C, Synthesis, World and their options), ``HarvestKernel``,
and the CLI ``python -m worldtpu_torch.cli``.

Layout mirrors ``worldtpu``: ``ops/`` (DSP primitives and the kernel
wrappers ``zc_kernel``, ``refine_kernel``, ``ola_kernel``,
``extend_kernel``), ``analysis/``, ``synthesis/``, ``parallel/``, with the
CUDA sources in ``csrc/`` and their build in ``_build``.  A kernel wrapper
given CPU tensors runs its plain PyTorch version; given CUDA tensors it
launches the kernel or raises.

Importing the package sets float32 matmuls and cuDNN convolutions to full
f32 (no TF32): the reference is true f32, and TF32 keeps ~3 digits.
The package never imports JAX.  The CLI and the host contour branch of
``HarvestKernel`` read the numpy-only ``worldtpu.io``, ``worldtpu.metrics``
and ``worldtpu.analysis.contour`` (``worldtpu/__init__.py`` imports
nothing).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

_API_NAMES = (
    "HarvestOption", "CheapTrickOption", "D4COption",
    "Harvest", "CheapTrick", "D4C", "Synthesis", "World",
)


def __getattr__(name):
    if name in _API_NAMES:
        from worldtpu_torch import api
        return getattr(api, name)
    raise AttributeError(f"module 'worldtpu_torch' has no attribute "
                         f"{name!r}")
