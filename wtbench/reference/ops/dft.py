"""Real FFTs along the last axis.

Port of worldtpu/ops/dft.py.  There the TPU's slow FFT lowering made an
explicit matmul-DFT worth keeping (``mode="mm"``); on the GPU cuFFT is the
fast route, so every transform here is ``torch.fft`` and the matmul mode
has no counterpart.
"""

from __future__ import annotations

import torch


def rfft(x, n=None):
    """``jnp.fft.rfft(x, n, axis=-1)``."""
    return torch.fft.rfft(x, n=n, dim=-1)


def irfft(X, n=None):
    """``jnp.fft.irfft(X, n, axis=-1)``."""
    return torch.fft.irfft(X, n=n, dim=-1)


def rfft_real(x, n=None):
    """Real part of the rfft (exact for even-symmetric inputs such as
    mirrored log spectra, whose transform is real)."""
    return torch.fft.rfft(x, n=n, dim=-1).real
