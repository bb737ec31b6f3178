"""Counter-based synthesis noise for chunked (long-audio) synthesis.

Port of ``worldtpu.synthesis.synthesis.indexed_noise``: row i of the noise
is a function of the key and the GLOBAL pulse ordinal ``start + i`` alone,
so a chunked synthesis draws the same noise for pulse n whichever chunk
synthesizes it.  The generator is JAX's default one, Threefry-2x32 with 20
rounds.  ``indexed_noise_plain`` runs it in int64 tensor operations masked
to 32 bits: the CPU's route, float64's on any device, and the yardstick of
the kernel.  A float32 draw on a CUDA device launches the kernel of
``csrc/noise.cu`` (``ops/noise_kernel.py``): the rounds in uint32
registers and one write a column, with the plain version's bits and
normals:

  - a key is two uint32 words; ``prng_key(seed)`` is JAX's ``PRNGKey(seed)``,
    the words (0, seed) for 0 <= seed < 2**32;
  - ``fold_in(key, n)`` is threefry(key, (0, n));
  - the 32 random bits of column j of a row are x0 ^ x1 of
    threefry(row key, (0, j)) (JAX's partitionable bit layout);
  - a standard normal is sqrt(2) * erfinv(u) of the uniform u in
    (-1, 1) that JAX builds from those bits, with XLA's float32 erfinv
    (Giles' polynomials in w = -log1p(-u^2));
  - float64 rows (JAX under x64) take 64 bits a column, the two words of
    threefry(row key, (0, j)) joined as x0 << 32 | x1, and a uniform from
    their top 52 bits; the normal is sqrt(2) * ``torch.erfinv(u)``.

The bits and the uniforms equal JAX's exactly; the float32 normals differ
from ``jax.random.normal`` only where log1p or the contraction of the
polynomial's steps rounds differently (under 1e-6 absolute), the float64
normals where ``torch.erfinv`` and XLA's float64 erfinv round apart (under
1e-10 absolute).
"""

from __future__ import annotations

import numpy as np
import torch

from worldtpu_torch.ops import noise_kernel as NK
from worldtpu_torch.ops.numeric import device_kind

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# nextafter(-1, 0) in float32 and float64: the uniform's lower end in
# jax.random.normal
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_LO64 = float(np.nextafter(-1.0, 0.0))
# the float64 exponent of 1.0, over the 52 mantissa bits
_ONE64 = 0x3FF0000000000000
# XLA's float32 erfinv: Giles' coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def prng_key(seed):
    """The two uint32 words of JAX's ``PRNGKey(seed)``: (high, low) 32 bits
    of a 64-bit seed."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} outside [0, 2**64)")
    return (seed >> 32, seed & _M32)


def as_key(key):
    """A seed (int) or two uint32 words (tuple, list, numpy array or
    tensor) -> the key as a tuple of two Python ints."""
    if isinstance(key, (int, np.integer)):
        return prng_key(key)
    words = [int(w) for w in np.asarray(
        key.cpu() if isinstance(key, torch.Tensor) else key).reshape(-1)]
    if len(words) != 2 or not all(0 <= w <= _M32 for w in words):
        raise ValueError(f"a key is two uint32 words, got {key!r}")
    return tuple(words)


def key_tensor(key, device):
    """A seed or two uint32 words (as ``as_key`` takes them) as an int64
    tensor [2] on device: the form of the key that ``indexed_noise`` reads
    on the device, so that a captured program takes it as an input."""
    return torch.stack([torch.full((), w, dtype=torch.int64, device=device)
                        for w in as_key(key)])    # no host-to-device copy


def _words(key, device):
    """key's two words: 0-d int64 tensors of a ``key_tensor`` on device,
    else Python ints (``as_key``)."""
    if (isinstance(key, torch.Tensor) and key.dtype == torch.int64
            and key.device == device and key.shape == (2,)):
        return key[0], key[1]
    return as_key(key)


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32, 20 rounds: key (k0, k1) as ints or int64 tensors,
    counters x0, x1 as int64 tensors of uint32 values (broadcastable) ->
    (y0, y1) int64 tensors of uint32 values."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def row_words(key, ords, n):
    """The two Threefry words (x0, x1) [..., n] (int64 tensors of uint32
    values) of column j of each global ordinal's row: threefry(fold_in(key,
    ord), (0, j))."""
    zero = torch.zeros((), dtype=torch.int64, device=ords.device)
    f0, f1 = threefry2x32(_words(key, ords.device), zero,
                          ords.to(torch.int64) & _M32)
    j = torch.arange(n, dtype=torch.int64, device=ords.device)
    return threefry2x32((f0[..., None], f1[..., None]), zero, j)


def row_bits(key, ords, n):
    """32 random bits [..., n] (int64 of uint32 values) of each global
    ordinal of ``ords`` (an int64 tensor): jax.random.bits(fold_in(key,
    ord), (n,), uint32)."""
    y0, y1 = row_words(key, ords, n)
    return y0 ^ y1


def erfinv_f32(x):
    """XLA's float32 erfinv of x in (-1, 1) (Giles' approximation), the
    one behind jax.random.normal."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0

    def horner(coeffs, v):
        p = torch.full_like(v, coeffs[0])
        for c in coeffs[1:]:
            p = p * v + c
        return p

    p = torch.where(lt, horner(_ERFINV_LT5, w - 2.5),
                    horner(_ERFINV_GE5, torch.sqrt(w) - 3.0))
    return p * x


def bits_to_normal(bits):
    """JAX's float32 standard normal of 32 random bits: a uniform in
    [nextafter(-1, 0), 1) from the top 23 bits, then sqrt(2) erfinv."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(f * 2.0 + _LO, min=_LO)
    return erfinv_f32(u) * float(np.float32(np.sqrt(2.0)))


def uniform64(y0, y1):
    """JAX's float64 uniform in [nextafter(-1, 0), 1) of the 64 random bits
    x0 << 32 | x1 (int64 tensors of uint32 values): the top 52 bits as the
    mantissa of a number in [1, 2), less 1, scaled to the interval."""
    mant = (y0 << 20) | (y1 >> 12)            # < 2**52: no sign to clear
    f = (mant | _ONE64).view(torch.float64) - 1.0
    return torch.clamp(f * 2.0 + _LO64, min=_LO64)


def bits_to_normal64(y0, y1):
    """JAX's float64 standard normal of the 64 random bits x0 << 32 | x1:
    sqrt(2) erfinv of ``uniform64``."""
    return torch.erfinv(uniform64(y0, y1)) * float(np.sqrt(2.0))


def indexed_noise(key, start, count, fft_size, dtype=torch.float32,
                  device=None):
    """Noise rows [..., count, fft_size]: row i is the standard normal row
    of the global pulse ordinal ``start + i`` under ``key`` (a seed or two
    uint32 words), as ``worldtpu``'s ``indexed_noise`` draws it in
    ``dtype`` (float32, or float64 as JAX draws it under x64).
    ``start`` is an int or an int64 tensor of any shape (on the device: no
    host sync); the leading dimensions follow its shape.  A ``key_tensor``
    on start's device is read there (no host read either).  float32 on a
    CUDA device launches the kernel; the CPU and float64 take
    ``indexed_noise_plain``."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"indexed_noise draws float32 or float64 rows, "
                         f"not {dtype}")
    if isinstance(start, torch.Tensor):
        device = start.device if device is None else torch.device(device)
        start = start.to(device=device, dtype=torch.int64)
    else:
        start = torch.full((), int(start), dtype=torch.int64, device=device)
    if dtype == torch.float32 and device_kind(start) == "cuda":
        words = _words(key, start.device)
        key = (key if isinstance(words[0], torch.Tensor)
               else key_tensor(words, start.device))
        return NK.noise_rows_cuda(key.contiguous(), start.contiguous(),
                                  count, fft_size)
    return indexed_noise_plain(key, start, count, fft_size, dtype)


def indexed_noise_plain(key, start, count, fft_size, dtype=torch.float32):
    """``indexed_noise`` by int64 tensor operations masked to 32 bits, on
    any device, for an int64 tensor ``start`` and a float32 or float64
    ``dtype`` (as ``indexed_noise`` passes them)."""
    ords = start[..., None] + torch.arange(count, dtype=torch.int64,
                                           device=start.device)
    if dtype == torch.float64:
        return bits_to_normal64(*row_words(key, ords, fft_size))
    return bits_to_normal(row_bits(key, ords, fft_size))
