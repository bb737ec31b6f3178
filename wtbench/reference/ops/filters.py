"""DSP filter primitives: Nuttall window, the exact blocked-matmul IIR and
decimation, the zero-lag biquad, DC correction and linear smoothing.

Port of worldtpu/ops/filters.py (reference world_common.cpp DCCorrection /
LinearSmoothing / NuttallWindow and world_matlabfunctions.cpp decimate).
Every function takes a leading batch of rows; matmuls run in full f32
(the package turns TF32 off).  ``dc_correction_frames`` and
``linear_smoothing_frames`` take the f32 production forms for float32 and
the reference's literal arithmetic, term for term, for float64 (the parity
path: ``dc_correction``, ``linear_smoothing``).  ``iir_affine_scan`` and
``decimate`` are the same blocked matmuls in either dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn

from wtbench.reference import constants as C
from wtbench.reference.ops.numeric import device_cache
from wtbench.reference.ops.seqsum import cumsum_sequential

# Decimation anti-alias filter coefficients by ratio, verbatim from the
# reference FilterForDecimate (as in worldtpu/ops/filters.py).
_DECIMATE_COEFFS = {
    11: ((2.450743295230728, -2.06794904601978, 0.59574774438332101),
         (0.0026822508007163792, 0.0080467524021491377)),
    12: ((2.4981398605924205, -2.1368928194784025, 0.62187513816221485),
         (0.0021097275904709001, 0.0063291827714127002)),
    10: ((2.3936475118069387, -1.9873904075111861, 0.5658879979027055),
         (0.0034818622251927556, 0.010445586675578267)),
    9: ((2.3236003491759578, -1.8921545617463598, 0.53148928133729068),
        (0.0046331164041389372, 0.013899349212416812)),
    8: ((2.2357462340187593, -1.7780899984041358, 0.49152555365968692),
        (0.0063522763407111993, 0.019056829022133598)),
    7: ((2.1225239019534703, -1.6395144861046302, 0.44469707800587366),
        (0.0090366882681608418, 0.027110064804482525)),
    6: ((1.9715352749512141, -1.4686795689225347, 0.3893908434965701),
        (0.013469181309343825, 0.040407543928031475)),
    5: ((1.7610939654280557, -1.2554914843859768, 0.3237186507788215),
        (0.021334858522387423, 0.06400457556716227)),
    4: ((1.4499664446880227, -0.98943497080950582, 0.24578252340690215),
        (0.036710750339322612, 0.11013225101796784)),
    3: ((0.95039378983237421, -0.67429146741526791, 0.15412211621346475),
        (0.071221945171178636, 0.21366583551353591)),
    2: ((0.041156734567757189, -0.42599112459189636, 0.041037215479961225),
        (0.16797464681802227, 0.50392394045406674)),
}


def nuttall_window(length, dtype=torch.float32, device=None):
    """Nuttall window of the given length (reference NuttallWindow)."""
    t = torch.arange(length, dtype=dtype, device=device) / (length - 1.0)
    return (0.355768
            - 0.487396 * torch.cos(2.0 * C.PI * t)
            + 0.144232 * torch.cos(4.0 * C.PI * t)
            - 0.012604 * torch.cos(6.0 * C.PI * t))


def _nuttall(t):
    return (0.355768
            - 0.487396 * torch.cos(2.0 * C.PI * t)
            + 0.144232 * torch.cos(4.0 * C.PI * t)
            - 0.012604 * torch.cos(6.0 * C.PI * t))


def nuttall_window_ragged(length, max_length, dtype=torch.float64,
                          device=None):
    """Nuttall windows of per-row ``length`` (a number, or an integer
    tensor [...]) padded with zeros to max_length: [..., max_length]."""
    i = torch.arange(max_length, dtype=dtype, device=device)
    n = torch.as_tensor(length, device=device).to(dtype)[..., None]
    return torch.where(i < n, _nuttall(i / (n - 1.0)),
                       torch.zeros((), dtype=dtype, device=device))


@functools.lru_cache(maxsize=32)
def _iir_block_tables(a_coeffs, b_coeffs, block):
    """float64 blocked-recurrence tables of the reference IIR (see
    worldtpu/ops/filters.py::_iir_block_tables): within-block Toeplitz of
    the impulse response Hm, boundary read G, block input weights Wc and
    block transition M = A^block."""
    a0, a1, a2 = a_coeffs
    b0, b1 = b_coeffs
    A = np.array([[a0, a1, a2, 0.0],
                  [1.0, 0.0, 0.0, 0.0],
                  [0.0, 1.0, 0.0, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    e0 = np.array([1.0, 0.0, 0.0, 0.0])
    r = np.array([b0, b1, b1, b0])
    L = block
    Apow = np.empty((L + 1, 4, 4))
    Apow[0] = np.eye(4)
    for d in range(L):
        Apow[d + 1] = Apow[d] @ A
    h = np.array([r @ Apow[d] @ e0 for d in range(L)])
    G = np.array([r @ Apow[j + 1] for j in range(L)])
    Wc = np.array([Apow[L - 1 - j] @ e0 for j in range(L)])
    idx = np.arange(L)
    D = idx[None, :] - idx[:, None]
    Hm = np.where(D >= 0, h[np.clip(D, 0, L - 1)], 0.0)
    return Hm, G, Wc, Apow[L]


@functools.lru_cache(maxsize=32)
def _iir_boundary_table(a_coeffs, b_coeffs, block, nb):
    """[nb*4, nb*4] operator mapping block inputs to block-start states:
    s_k = sum_{j<k} M^(k-1-j) c_j."""
    M = _iir_block_tables(a_coeffs, b_coeffs, block)[3]
    Mp = np.empty((nb, 4, 4))
    Mp[0] = np.eye(4)
    for d in range(1, nb):
        Mp[d] = Mp[d - 1] @ M
    P = np.zeros((nb, nb, 4, 4))
    for k in range(1, nb):
        for j in range(k):
            P[k, j] = Mp[k - 1 - j]
    return P.transpose(0, 2, 1, 3).reshape(nb * 4, nb * 4)


@device_cache(maxsize=32)
def _iir_tensors(a_coeffs, b_coeffs, block, nb, dtype, device):
    Hm, G, Wc, _ = _iir_block_tables(a_coeffs, b_coeffs, block)
    P = _iir_boundary_table(a_coeffs, b_coeffs, block, nb)
    return tuple(torch.as_tensor(t, dtype=dtype, device=device)
                 for t in (Hm, G, Wc, P))


def iir_affine_scan(x, a_coeffs, b_coeffs, block=256):
    """The reference's direct-form-II IIR (FilterForDecimate) over the last
    axis of x [..., T], exactly, as blocked matmuls:
    block-start states from one product with the boundary table, outputs
    y_block = G s_k + H x_block."""
    T = x.shape[-1]
    L = block
    nb = -(-T // L)
    Hm, G, Wc, P = _iir_tensors(tuple(a_coeffs), tuple(b_coeffs), L, nb,
                                x.dtype, x.device)
    lead = x.shape[:-1]
    xb = Fn.pad(x, (0, nb * L - T)).reshape(-1, nb, L)
    # one product per row: on the card the kernel of this thin product,
    # and so its bits, follows the number of rows, and a mesh's data shard
    # must decimate its rows as the whole batch does (on the CPU the rows'
    # products are the batched product's bits)
    c = torch.stack([r @ Wc for r in xb])                   # [rows, nb, 4]
    s0 = (c.reshape(-1, nb * 4) @ P.T).reshape(-1, nb, 4)
    y = s0 @ G.T + xb @ Hm
    return y.reshape(*lead, nb * L)[..., :T]


def decimate(x, r):
    """Zero-phase decimation of x [..., T] by integer ratio r (2..12):
    9-sample 2*edge-x reflection pads, forward IIR, reverse, forward IIR,
    reverse, then every r-th sample from ``nbeg`` (reference decimate)."""
    if r not in _DECIMATE_COEFFS:
        raise ValueError(f"unsupported decimation ratio {r}")
    a, b = _DECIMATE_COEFFS[r]
    k_nfact = 9
    head = 2.0 * x[..., :1] - x[..., 1:k_nfact + 1].flip(-1)
    tail = 2.0 * x[..., -1:] - x[..., -k_nfact - 1:-1].flip(-1)
    xx = torch.cat([head, x, tail], dim=-1)
    y1 = iir_affine_scan(xx, a, b).flip(-1)
    y2 = iir_affine_scan(y1, a, b).flip(-1)
    x_length = x.shape[-1]
    nout = x_length // r + 1
    nbeg = r - r * nout + x_length
    n_picks = -(-(x_length + k_nfact - nbeg) // r)
    start = nbeg + k_nfact - 1
    return y2[..., start:start + r * (n_picks - 1) + 1:r]


def dc_correction(power_spectra, f0, fs, fft_size):
    """DCCorrection over [N, K] frames with per-frame f0 [N], in the
    reference's literal rounding order (world_common.cpp DCCorrection and
    interp1Q): mirror the sub-F0 power back onto the low bins.  The float64
    parity form."""
    N, K = power_spectra.shape
    dt = power_spectra.dtype
    dev = power_spectra.device
    f0 = f0.to(dt)[:, None]
    i = torch.arange(K, dtype=dt, device=dev)[None, :]
    upper_limit = 2 + (f0 * fft_size / fs).to(torch.int32)
    xi = i * fs / fft_size
    pos = (xi - f0) / (-(fs / fft_size))
    base = pos.to(torch.int32)
    frac = pos - base.to(dt)
    base_c = base.clamp(0, K - 2).long()
    y0 = torch.gather(power_spectra, 1, base_c)
    y1 = torch.gather(power_spectra, 1, base_c + 1)
    replica = y0 + (y1 - y0) * frac
    add = torch.where(i < (upper_limit - 1).to(dt), replica,
                      torch.zeros((), dtype=dt, device=dev))
    return power_spectra + add


def dc_correction_frames(power_spectra, f0, fs, fft_size, max_f0):
    """Batched DCCorrection over [N, K] frames with per-frame f0 [N]
    (assumed <= max_f0): mirror the sub-F0 power back onto the low bins.
    float32 touches only the first O(max_f0*fft/fs) bins; float64 takes
    the literal ``dc_correction``."""
    if power_spectra.dtype == torch.float64:
        return dc_correction(power_spectra, f0, fs, fft_size)
    N, K = power_spectra.shape
    dt = power_spectra.dtype
    L = min(K, int(max_f0 * fft_size / fs) + 4)
    ps = power_spectra[:, :L]
    i = torch.arange(L, dtype=dt, device=ps.device)
    f0 = f0.to(dt)
    upper_limit = 2 + (f0 * fft_size / fs).to(torch.int32)
    pos = f0[:, None] * fft_size / fs - i[None, :]
    base = pos.to(torch.int32)
    frac = pos - base.to(dt)
    base_c = base.clamp(0, L - 2).long()
    y0 = torch.gather(ps, 1, base_c)
    y1 = torch.gather(ps, 1, base_c + 1)
    replica = y0 + (y1 - y0) * frac
    add = torch.where(i[None, :] < (upper_limit[:, None] - 1).to(dt),
                      replica, torch.zeros((), dtype=dt, device=ps.device))
    return torch.cat([ps + add, power_spectra[:, L:]], dim=1)


def linear_smoothing(power_spectra, widths, fs, fft_size, max_boundary):
    """LinearSmoothing of [N, K] frames over per-frame widths [N] Hz in the
    reference's literal arithmetic, term for term (world_common.cpp
    SetParametersForLinearSmoothing / LinearSmoothing and interp1Q): mirror
    the spectrum by ``boundary`` bins, integrate it strictly left to right
    (``cumsum_sequential``: a reassociated sum differs by ~eps * total,
    which shows at near-zero tail bins after the high-minus-low
    cancellation), and difference the integral at f +- width/2.  The
    float64 parity form; ``max_boundary`` >= every row's boundary."""
    N, K = power_spectra.shape
    half = K - 1
    dt = power_spectra.dtype
    dev = power_spectra.device
    widths = widths.to(dt)[:, None]
    boundary = (widths * fft_size / fs).to(torch.int32) + 1       # [N, 1]
    j = torch.arange(K + 2 * max_boundary, device=dev)[None, :] - boundary
    refl = j.abs()
    refl = torch.where(refl > half, fft_size - refl, refl).clamp(0, half)
    mirr = torch.gather(power_spectra, 1, refl.long())
    seg = cumsum_sequential((mirr * fs) / fft_size)
    i = torch.arange(K, dtype=dt, device=dev)[None, :]
    freq = i / fft_size * fs - widths / 2.0
    origin = -(boundary.to(dt) - 0.5) * fs / fft_size
    dx = fs / fft_size

    def levels(xi):
        t = (xi - origin) / dx
        base = t.to(torch.int32)                  # truncation; t > 0 here
        frac = t - base.to(dt)
        base_c = base.clamp(0, seg.shape[1] - 2).long()
        y0 = torch.gather(seg, 1, base_c)
        y1 = torch.gather(seg, 1, base_c + 1)
        return y0 + (y1 - y0) * frac

    return (levels(freq + widths) - levels(freq)) / widths


def linear_smoothing_frames(power_spectra, widths, fs, fft_size,
                            max_boundary):
    """Batched LinearSmoothing of [N, K] frames over per-frame widths [N]
    Hz: float64 takes the literal ``linear_smoothing``, float32 the
    production form (port of
    worldtpu/ops/filters.py::linear_smoothing_batch).

    The interpolated integral difference is four taps of the mirrored
    prefix sum at row-constant offsets; their suffix sums form a dense
    non-negative kernel ((1-f_lo), 1..1, f_hi) that is applied as one
    depthwise convolution of the mirrored spectrum — positive accumulation,
    so relative error stays ~eps on high-dynamic-range spectra."""
    if power_spectra.dtype == torch.float64:
        return linear_smoothing(power_spectra, widths, fs, fft_size,
                                max_boundary)
    N, K = power_spectra.shape
    half = K - 1
    dt = power_spectra.dtype
    dev = power_spectra.device
    mb = max_boundary
    widths = widths.to(dt)
    b = (widths * fft_size / fs).to(torch.int32) + 1
    u = widths * fft_size / fs

    p = power_spectra
    mirr = torch.cat([p[:, 1:mb + 1].flip(1), p,
                      p[:, half - mb:half].flip(1)], dim=1) * (fs / fft_size)

    bf = b.to(dt)
    lo_v = bf - 0.5 - u / 2.0
    hi_v = bf - 0.5 + u / 2.0
    B_lo = lo_v.to(torch.int32)
    B_hi = hi_v.to(torch.int32)
    f_lo = lo_v - B_lo.to(dt)
    f_hi = hi_v - B_hi.to(dt)

    delta = mb - b
    Wk = 2 * mb + 4
    rows = torch.arange(N, device=dev)
    kern = torch.zeros((N, Wk), dtype=dt, device=dev)
    for off, val in ((B_lo + delta, -(1.0 - f_lo)),
                     (B_lo + delta + 1, -f_lo),
                     (B_hi + delta, 1.0 - f_hi),
                     (B_hi + delta + 1, f_hi)):
        kern.index_put_((rows, off.clamp(0, Wk - 1).long()), val,
                        accumulate=True)
    dense = kern.flip(1).cumsum(1).flip(1)
    # the taps' support lies inside [mb/2 - 1, 3mb/2 + 3): slice the kernel
    # to it (the dropped taps are exact zeros)
    s0 = max(mb // 2 - 2, 0)
    Wk_s = Wk - 2 * s0
    dense = dense[:, s0:s0 + Wk_s]
    padded = Fn.pad(mirr, (0, 4))[:, s0:s0 + K + Wk_s]
    conv = Fn.conv1d(padded[None], dense[:, None, :], groups=N)[0]
    return conv[:, :K] / widths[:, None]
