"""Noise rows by global pulse ordinal: Threefry-2x32 in JAX's bit layout,
plain.

Row n of the long-audio noise is a function of the key and the pulse's
GLOBAL ordinal n alone (the n-th pulse of the whole output, counted from
0), so a recording synthesized whole draws the noise a chunked synthesis
draws.  The generator is Threefry-2x32 with 20 rounds (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011): a key of two
32-bit words, a third word k0 ^ k1 ^ 0x1BD11BDA, rotations 13, 15, 26, 6,
17, 29, 16, 24, and the key words injected after every fourth round with
the injection's count added to the second word.  JAX's layout:

  - the key of a seed s (0 <= s < 2**64) is the words (s >> 32, s & 0xFFFFFFFF);
  - a row's key is threefry(key, (0, n)) (``fold_in``);
  - column j's 32 bits are x0 ^ x1 of threefry(row key, (0, j));
  - a uniform u in [nextafter(-1, 0), 1) from the top 23 bits (a float in
    [1, 2) less 1, times 2, plus the lower end), and the normal
    sqrt(2) erfinv(u).

Departure: ``torch.erfinv`` in float32 in place of XLA's float32 erfinv
(Giles' polynomial): the normals differ from JAX's, and from the
program's, by a few float32 ulps; the bits and uniforms are exact.

Integer words are int64 tensors holding uint32 values, each sum and shift
masked to 32 bits (PyTorch has no unsigned 32-bit arithmetic on the
card).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
#: nextafter(-1, 0) in float32: the lower end of the uniform
LOWER = -0.99999994039535522


def seed_key(seed):
    """The two words of a seed's key."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} outside [0, 2**64)")
    return seed >> 32, seed & MASK


def threefry(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under the key (k0, k1):
    ints or int64 tensors of uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for r in range(20):
        rot = ROTATIONS[r % 8]
        x0 = (x0 + x1) & MASK
        x1 = (((x1 << rot) & MASK) | (x1 >> (32 - rot))) ^ x0
        if r % 4 == 3:
            s = r // 4 + 1
            x0 = (x0 + ks[s % 3]) & MASK
            x1 = (x1 + ks[(s + 1) % 3] + s) & MASK
    return x0, x1


def row_bits(seed, ordinals, n):
    """[len(ordinals), n] int64 tensor of the 32 random bits of each
    column of each ordinal's row (``ordinals``: an int64 tensor)."""
    k0, k1 = seed_key(seed)
    zero = torch.zeros_like(ordinals)
    r0, r1 = threefry(k0, k1, zero, ordinals & MASK)
    j = torch.arange(n, dtype=torch.int64, device=ordinals.device)
    y0, y1 = threefry(r0[:, None], r1[:, None], torch.zeros_like(j), j)
    return y0 ^ y1


def normal_rows(seed, first, count, n, device):
    """Standard-normal rows [count, n] (float32) of the global ordinals
    first .. first + count - 1."""
    ords = torch.arange(first, first + count, dtype=torch.int64,
                        device=device)
    bits = row_bits(seed, ords, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(f * 2.0 + LOWER, min=LOWER)
    return torch.erfinv(u) * math.sqrt(2.0)
