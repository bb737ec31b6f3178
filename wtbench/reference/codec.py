"""WORLD's parameter coding, plain: ``CodeSpectralEnvelope`` and
``CodeAperiodicity`` (WORLD's ``codec.cpp``), over the frames of a
[frames, K] tensor in float32, K = fft_size / 2 + 1.

Written from WORLD's algorithm, not from the program's codec:

CodeSpectralEnvelope.  Each frame's log envelope is resampled onto a
uniform mel axis by linear interpolation over the mel values of the
linear-frequency bins, then the first ``n_dims`` coefficients of its
DCT-II are kept, with N = fft_size / 2:

    mel(f)    = 1127.01048 ln(1 + f / 700)
    bin j     at mel(j fs / fft_size),                  j = 0 .. K - 1
    axis[n]   = mel(40) + n (mel(min(fs / 2, 20000)) - mel(40)) / N,
                                                        n = 0 .. N - 1
    c[k]      = w_k sqrt(2) / N  sum_n L[n] cos(pi k (2n + 1) / (2N)),
    w_0 = 1 / sqrt(2), w_k = 1 for k > 0.

WORLD computes the sum by an even-odd repack of L and a half-size FFT
(``DCTForCodec``); here it is the cosine sum itself, a product with an
[N, n_dims] matrix of cosines.

CodeAperiodicity.  20 log10 of the aperiodicity, sampled at every 3 kHz
below min(15 kHz, fs / 2 - 3 kHz) (``GetNumberOfAperiodicities`` bands)
by WORLD's ``interp1Q`` on the bin grid: the position in bins f fft_size /
fs, its integer part the left bin, the fraction towards the next bin, the
last bin held flat.

Imports nothing of the program, of ``worldtpu`` or of JAX.
"""

from __future__ import annotations

import math

import torch

from wtbench.reference import constants as C


def n_aperiodicities(fs):
    """WORLD's GetNumberOfAperiodicities: bands every 3 kHz up to 15 kHz
    or fs / 2 - 3 kHz, whichever is lower."""
    return int(min(C.UPPER_LIMIT, fs / 2.0 - C.FREQUENCY_INTERVAL)
               / C.FREQUENCY_INTERVAL)


def mel(f):
    """Hz -> mel (WORLD's FrequencyToMel), on a tensor."""
    return C.M0 * torch.log(1.0 + f / C.F0_MEL)


def dct_matrix(n, n_dims, device):
    """[n, n_dims] float32: column k holds w_k sqrt(2) / n cos(pi k (2 i +
    1) / (2 n)) over i, computed in float64."""
    i = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    k = torch.arange(n_dims, dtype=torch.float64, device=device)[None, :]
    w = torch.where(k == 0, 1.0 / math.sqrt(2.0), 1.0)
    m = w * math.sqrt(2.0) / n * torch.cos(C.PI * k * (2.0 * i + 1.0)
                                           / (2.0 * n))
    return m.to(torch.float32)


def lerp_rows(x, y, q):
    """Rows of y [..., M] given at increasing knots x [M], read at the
    queries q [Q] by linear interpolation between the two knots around
    each query (the end segments outside them)."""
    left = (torch.searchsorted(x, q, right=True) - 1).clamp(0, x.shape[0] - 2)
    x0, x1 = x[left], x[left + 1]
    t = (q - x0) / (x1 - x0)
    y0, y1 = y[..., left], y[..., left + 1]
    return y0 + t * (y1 - y0)


def code_spectral_envelope(spec, *, fs, fft_size, n_dims):
    """[frames, K] spectral envelope -> [frames, n_dims] coded envelope."""
    n = fft_size // 2
    dev = spec.device
    f32 = dict(dtype=torch.float32, device=dev)
    bins = mel(torch.arange(n + 1, **f32) * (fs / fft_size))
    lo = mel(torch.tensor(C.FLOOR_FREQUENCY, **f32))
    hi = mel(torch.tensor(min(fs / 2.0, C.CEIL_FREQUENCY), **f32))
    axis = lo + torch.arange(n, **f32) * ((hi - lo) / n)
    log_mel = lerp_rows(bins, torch.log(spec.to(torch.float32)), axis)
    return log_mel @ dct_matrix(n, n_dims, dev)


def code_aperiodicity(ap, *, fs, fft_size):
    """[frames, K] aperiodicity -> [frames, n_ap] coded aperiodicity in
    dB."""
    k = ap.shape[-1]
    log_ap = 20.0 * torch.log10(ap.to(torch.float32))
    out = []
    for band in range(n_aperiodicities(fs)):
        pos = C.FREQUENCY_INTERVAL * (band + 1.0) / (fs / fft_size)
        j = int(pos)
        step = log_ap[:, j + 1] - log_ap[:, j] if j + 1 < k \
            else torch.zeros_like(log_ap[:, j])
        out.append(log_ap[:, j] + step * (pos - j))
    return torch.stack(out, dim=-1)
