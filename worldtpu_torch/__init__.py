"""worldtpu_torch — the WORLD vocoder in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a): the float32 production path and the
float64 parity path (``dtype=torch.float64`` on any entry point: the
reference's literal semantics, held to its golden dumps).

A port of the JAX package ``worldtpu`` (which stays the reference): B padded
wavs -> Harvest F0 (with the on-device contour chain) -> pitch scale ->
CheapTrick + D4C -> pulse/noise synthesis -> B wavs, as
``worldtpu_torch.parallel.batch.batch_wav_to_wav``.  Files and metrics
go through ``io`` and ``metrics``; a directory of wavs streams as padded
batches through ``io.corpus`` (``iter_corpus``, with a threaded C++
reader) into ``batch_wav_to_wav`` or ``HarvestKernel.compute_corpus``;
``codec`` compresses spectral envelopes (mel cepstra) and aperiodicity
(coarse bands) and back.  The user entry points
mirror ``worldtpu``'s: the facades of ``api`` (exported here: Harvest,
CheapTrick, D4C, Synthesis, World and their options), ``HarvestKernel``,
the codec functions, and the CLI ``python -m worldtpu_torch.cli``.

Layout mirrors ``worldtpu``: ``ops/`` (DSP primitives and the kernel
wrappers ``zc_kernel``, ``refine_kernel``, ``ola_kernel``,
``extend_kernel``, ``seqsum``), ``analysis/``, ``synthesis/``, ``parallel/``, with the
CUDA sources in ``csrc/`` and their build in ``_build``.  A kernel wrapper
given CPU tensors runs its plain PyTorch version; given CUDA tensors it
launches the kernel or raises.

Importing the package sets float32 matmuls and cuDNN convolutions to full
f32 (no TF32): the reference is true f32, and TF32 keeps ~3 digits.
The package imports neither JAX nor anything of ``worldtpu``: it keeps its
own copies of the numpy-only modules it needs (``io.wav``, ``io.params``,
``io.corpus``, ``metrics``, ``analysis.contour``, ``analysis.dither``) and
of its host helpers (``native``: the contour's smoother
``csrc/filter_f0.c``, the reference's randn() stream and int-truncating
sum ``csrc/parity.c``, the corpus reader ``csrc/corpusio.cpp``), held
equal to ``worldtpu``'s by the tests.
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
