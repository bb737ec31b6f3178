"""FFT helpers: size rules and the batched minimum-phase spectrum.

Port of worldtpu/ops/fftutil.py (reference GetSuitableFFTSize and
MinimumPhaseAnalysis::compute); the numpy-convention notes there apply.
"""

from __future__ import annotations

import math

import torch

from wtbench.reference.ops import dft


def get_suitable_fft_size(sample: int) -> int:
    """2**(int(log2(sample)) + 1) — reference GetSuitableFFTSize."""
    return int(2 ** (int(math.log(sample) / math.log(2.0)) + 1))


def fft_size_for_cheaptrick(fs: int, f0_floor: float) -> int:
    """Reference CheapTrick::getFFTSizeForCheapTrick."""
    return int(2 ** (1 + int(math.log(3.0 * fs / f0_floor + 1)
                             / math.log(2.0))))


def f0_floor_for_cheaptrick(fs: int, fft_size: int) -> float:
    """Reference CheapTrick::getF0FloorForCheapTrick."""
    return 3.0 * fs / (fft_size - 3.0)


def minimum_phase(log_amplitude):
    """Minimum-phase complex spectrum [..., K] from a half log-amplitude
    spectrum [..., K] (K = fft_size//2 + 1): real cepstrum, causal fold
    (double positive quefrencies, zero negative), exp of its spectrum."""
    k = log_amplitude.shape[-1]
    n = 2 * (k - 1)
    cep = dft.irfft(log_amplitude, n=n)
    scale = torch.ones(n, dtype=cep.dtype, device=cep.device)
    scale[1:n // 2] = 2.0
    scale[n // 2 + 1:] = 0.0
    return torch.exp(dft.rfft(cep * scale))
