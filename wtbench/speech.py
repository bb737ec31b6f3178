"""Speech-shaped synthetic utterances, made on the device from a seed.

The benchmark's copy of ``bench.py``'s ``synth_utterance_diverse``, with
the utterance length a parameter and the signal computed in bulk on the
card: per utterance a speaker F0 base (105-280 Hz); leading silence; then
voiced vowels (a declining F0 contour with 5 Hz vibrato, 19 harmonics,
breath noise), fricative bursts (differenced white noise) and pauses, each
120-450 ms with 20 ms onset and offset ramps; a noise floor; peak
normalised to 0.8.  The segment plan is drawn on the host (a few dozen
numbers an utterance), the samples on the device with one generator.

``utterances`` returns 16-bit PCM: the wav files the corpus cells write and
the values every side of a comparison reads (``pcm / 32768``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

P_KINDS = (0.55, 0.25, 0.20)
HARMONICS = 19


def seed_words(*parts):
    """A 64-bit generator seed from any whole numbers (a run's seed may
    pass 32 bits)."""
    return int(np.random.SeedSequence([int(p) % (1 << 63) for p in parts])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def _plan(rng, fs, n):
    """One utterance's segments: rows (start, length, kind, pitch offset,
    breath, amplitude), kind -1 for silence, covering [0, n)."""
    rows = []
    pos = min(n, int(rng.uniform(0.05, 0.20) * fs))
    rows.append((0, pos, -1, 0.0, 0.0, 0.0))
    while pos < n - int(0.08 * fs):
        kind = int(rng.choice(3, p=P_KINDS))
        seg = min(int(rng.uniform(0.12, 0.45) * fs), n - pos)
        off = float(rng.uniform(-0.15, 0.35)) if kind == 0 else 0.0
        breath = float(rng.uniform(0.01, 0.08)) if kind == 0 else 0.0
        amp = float(rng.uniform(0.5, 1.0)) if kind != 2 else 0.0
        rows.append((pos, seg, kind if kind != 2 else -1, off, breath, amp))
        pos += seg
    if pos < n:
        rows.append((pos, n - pos, -1, 0.0, 0.0, 0.0))
    return rows


@torch.no_grad()
def utterances(fs, lengths, seed, device):
    """int16 numpy rows, one per length in ``lengths`` (samples), of
    speech-shaped audio drawn from ``seed``."""
    rng = np.random.default_rng(seed_words(seed, 1))
    lengths = [int(n) for n in lengths]
    seg, base, phase0 = [], [], []
    for u, n in enumerate(lengths):
        base.append(rng.uniform(105.0, 280.0))
        phase0.append(rng.uniform(0.0, 2.0 * math.pi))
        seg += [(u,) + r for r in _plan(rng, fs, n)]
    tab = np.asarray(seg, np.float64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    dev = torch.device(device)
    t64 = torch.as_tensor(tab, device=dev)
    utt = t64[:, 0].long()
    seg_len = t64[:, 2].long()
    total = int(sum(lengths))
    sid = torch.repeat_interleave(
        torch.arange(len(seg), device=dev), seg_len, output_size=total)
    gstart = torch.as_tensor(starts, device=dev)[utt] + t64[:, 1].long()
    i = torch.arange(total, device=dev) - gstart[sid]          # in segment
    L = seg_len[sid]
    kind = t64[:, 3].long()[sid]
    t = i.double() / fs
    t_last = ((L - 1).double() / fs).clamp(min=1e-6)
    f0 = torch.as_tensor(base, device=dev)[utt[sid]] * torch.pow(
        2.0, t64[:, 4][sid] - 0.1 * t / t_last
        + (25.0 / 1200.0) * torch.sin(2.0 * math.pi * 5.0 * t))
    voiced = kind == 0
    cs = torch.cumsum(torch.where(voiced, f0, 0.0), 0)
    ustart = torch.as_tensor(starts, device=dev)
    u_of = utt[sid]
    cs0 = torch.where(ustart > 0, cs[(ustart - 1).clamp(min=0)], 0.0)[u_of]
    ph = torch.as_tensor(phase0, device=dev)[u_of] \
        + 2.0 * math.pi * (cs - cs0) / fs
    del cs, cs0, f0, t, t_last
    g = torch.Generator(device=dev).manual_seed(seed_words(seed, 2))
    harm = torch.zeros(total, dtype=torch.float32, device=dev)
    ph32 = ph.remainder(2.0 * math.pi)
    for k in range(1, HARMONICS + 1):
        harm += (torch.sin((k * ph32).remainder(2.0 * math.pi)) / k).float()
    del ph, ph32
    w = torch.randn(total + 1, generator=g, device=dev)
    breath = torch.randn(total, generator=g, device=dev)
    vowel = harm / 2.2 + t64[:, 5].float()[sid] * breath
    fric = 0.25 * (w[1:] - w[:-1])
    s = torch.where(voiced, vowel, torch.where(kind == 1, fric, 0.0))
    ramp = torch.minimum(L // 4, torch.full_like(L, int(0.02 * fs)))
    ramp = torch.where(ramp > 0, ramp, 1)
    den = (ramp - 1).clamp(min=1).float()
    env = torch.minimum(torch.minimum(i.float() / den,
                                      (L - 1 - i).float() / den),
                        torch.ones((), device=dev))
    env = torch.where(ramp > 1, env, torch.where(i == 0, 0.0, 1.0))
    x = env * s * t64[:, 6].float()[sid]
    del w, breath, vowel, fric, s, env, harm, i, L, kind, voiced
    x = x + 0.0015 * torch.randn(total, generator=g, device=dev)
    peak = torch.zeros(len(lengths), device=dev).scatter_reduce_(
        0, u_of, x.abs(), "amax")
    x = x * torch.where(peak > 0, 0.8 / peak, 1.0)[u_of]
    x = x.clamp(-0.99, 0.99)
    pcm = (x.double() * 32767).trunc().clamp(-32768, 32767).short().cpu()
    pcm = pcm.numpy()
    return [pcm[s0:s0 + n] for s0, n in zip(starts, lengths)]
