"""The remaining MATLAB-replica utilities of the reference's public surface.

Port of worldtpu/ops/misc.py (reference fast_fftfilt, matlab_std,
matlab_round, fftshift, diff, histc).  The reference pipeline calls none of
them itself; they are exported API.
"""

from __future__ import annotations

import torch

from worldtpu_torch.ops import numeric


def fast_fftfilt(x, h, fft_size):
    """FFT convolution (reference fast_fftfilt): the first fft_size samples
    of the circular convolution of x [N] and h [M] (both <= fft_size),
    with the reference's scaling (both inputs over fft_size, an
    unnormalized inverse)."""
    X = torch.fft.rfft(x / fft_size, n=fft_size)
    Hs = torch.fft.rfft(h / fft_size, n=fft_size)
    return torch.fft.irfft(X * Hs, n=fft_size) * fft_size


def matlab_std(x):
    """Sample standard deviation with N-1 normalization."""
    mean = torch.mean(x)
    return torch.sqrt(torch.sum((x - mean) ** 2) / (x.shape[-1] - 1))


def matlab_round(x):
    """Half-away-from-zero rounding to int32 (``torch.round`` rounds half to
    even)."""
    return numeric.matlab_round(x)


def fftshift(x):
    """Even-length fftshift along the last axis."""
    return torch.roll(x, x.shape[-1] // 2, dims=-1)


def diff(x):
    """First difference along the last axis, length N-1."""
    return x[..., 1:] - x[..., :-1]


def histc(x, edges):
    """MATLAB histc bin indices (1-based segment count, as the reference's
    helper): ``clip(searchsorted(x, edges, right), 1, N-1)``."""
    k = torch.searchsorted(x.contiguous(), edges.contiguous(), right=True)
    return k.clamp(1, x.shape[-1] - 1)
