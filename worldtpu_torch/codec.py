"""Parameter codec: mel-cepstral spectral-envelope compression and coarse
band-aperiodicity compression, batched over frames.

Port of worldtpu/codec.py (the reference's codec.cpp).  The reference
codes one frame at a time through a half-size real FFT (a DCT by even-odd
repack); here all frames go through one batched ``torch.fft.rfft`` /
``torch.fft.fft``, with the reference's conjugate FFT convention folded
into the weights.  Every function takes a tensor [F, K] (frames are
independent, so a batch flattens to [B*F, K]) and computes on its device
and in its dtype; constants are made in that dtype before any arithmetic,
in the order the JAX functions use, so that float32 rounds where theirs
does.

The coders make no host synchronisation and no host-to-device copy, and
write nothing in place, so a captured CUDA graph can hold them
(``parallel.batch.batch_features``).
"""

from __future__ import annotations

import math

import torch

from worldtpu_torch import constants as C
from worldtpu_torch.ops.interp import interp1


def _check(t):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}: "
                        f"the codec computes on its input's device")
    return t


def get_number_of_aperiodicities(fs: int) -> int:
    """Reference GetNumberOfAperiodicities: coarse bands every 3 kHz up to
    15 kHz or fs/2 - 3 kHz."""
    return int(min(C.UPPER_LIMIT, fs / 2.0 - C.FREQUENCY_INTERVAL)
               / C.FREQUENCY_INTERVAL)


def _freq_to_mel(f):
    return C.M0 * torch.log(f / C.F0_MEL + 1.0)


def _mel_to_freq(m):
    return C.F0_MEL * (torch.exp(m / C.M0) - 1.0)


def _arange(n, like):
    return torch.arange(n, dtype=like.dtype, device=like.device)


def _full(shape, v, like):
    """v in like's dtype on its device, filled there (no host copy, so no
    synchronization on the card)."""
    return torch.full(shape, v, dtype=like.dtype, device=like.device)


def _mel_bounds(fs, like):
    """(floor, ceil) of the mel axis, each the log of a scalar in like's
    dtype (as the JAX functions compute them)."""
    return (_freq_to_mel(_full((), C.FLOOR_FREQUENCY, like)),
            _freq_to_mel(_full((), min(fs / 2.0, C.CEIL_FREQUENCY), like)))


def code_aperiodicity(aperiodicity, *, fs, fft_size):
    """[F, K] -> [F, n_ap] coarse dB aperiodicity: 20 log10 of the
    aperiodicity at every 3 kHz, by uniform-grid interpolation (the
    reference's interp1Q: truncated base, zero slope on the last bin)."""
    ap = _check(aperiodicity)
    n_ap = get_number_of_aperiodicities(fs)
    log_ap = 20.0 * torch.log10(ap)
    coarse_axis = C.FREQUENCY_INTERVAL * (_arange(n_ap, ap) + 1.0)
    pos = coarse_axis * fft_size / fs
    base = pos.to(torch.int32)              # truncation toward zero
    frac = (pos - base.to(ap.dtype))[None, :]
    k = ap.shape[-1]
    base = base.clamp(0, k - 1).long()
    y0 = log_ap[:, base]
    y1 = log_ap[:, (base + 1).clamp(0, k - 1)]
    delta = torch.where(base >= k - 1, torch.zeros_like(y0), y1 - y0)
    return y0 + delta * frac


def decode_aperiodicity(coded, *, fs, fft_size):
    """[F, n_ap] -> [F, K]: rows whose mean coarse aperiodicity exceeds
    -0.5 dB are deemed unvoiced and left at the 1 - 1e-12 default; the
    others interpolate -60 dB at 0 Hz, the coded bands and ~0 dB at fs/2."""
    coded = _check(coded)
    F, n_ap = coded.shape
    K = fft_size // 2 + 1
    unvoiced = coded.mean(dim=-1) > -0.5
    coarse_axis = torch.cat([
        C.FREQUENCY_INTERVAL * _arange(n_ap + 1, coded),
        _full((1,), fs / 2.0, coded)])
    vals = torch.cat([_full((F, 1), -60.0, coded), coded,
                      _full((F, 1), -C.MY_SAFE_GUARD_MINIMUM, coded)], dim=-1)
    freq = _arange(K, coded) * fs / fft_size
    ap_db = interp1(coarse_axis, vals, freq)
    ap = torch.pow(_full((), 10.0, coded), ap_db / 20.0)
    return torch.where(unvoiced[:, None],
                       _full((), 1.0 - C.MY_SAFE_GUARD_MINIMUM, coded), ap)


def code_spectral_envelope(spectrogram, *, fs, fft_size, n_dims):
    """[F, K] -> [F, n_dims] mel-cepstrum: the log spectrum warped to a
    uniform mel axis, then a DCT (even-odd repack + rfft)."""
    spec = _check(spectrogram)
    max_dim = fft_size // 2
    floor_mel, ceil_mel = _mel_bounds(fs, spec)
    mel_axis = ((ceil_mel - floor_mel) * _arange(max_dim, spec)
                / max_dim + floor_mel)
    freq_mel = _freq_to_mel(_arange(fft_size // 2 + 1, spec)
                            * fs / fft_size)
    mel_sp = interp1(freq_mel, torch.log(spec), mel_axis)

    # even-odd repack + rfft = DCT (the reference's DCTForCodec)
    even = mel_sp[:, 0::2]                                  # mel[2i]
    odd = torch.flip(mel_sp[:, 1::2], dims=(-1,))           # mel[max-1-2i]
    S = torch.fft.rfft(torch.cat([even, odd], dim=-1), dim=-1)

    i = _arange(n_dims, spec)
    w0 = 2.0 * torch.cos(i * C.PI / fft_size) / math.sqrt(fft_size)
    w1 = 2.0 * torch.sin(i * C.PI / fft_size) / math.sqrt(fft_size)
    w0 = torch.where(i == 0, w0 / math.sqrt(2.0), w0)
    # the reference's spectrum is conj(numpy's): Re_ref*w0 - Im_ref*w1
    #   = Re*w0 + Im*w1 in numpy's convention
    Sd = S[:, :n_dims]
    return (Sd.real * w0 + Sd.imag * w1) / math.sqrt(max_dim)


def decode_spectral_envelope(coded, *, fs, fft_size, n_dims):
    """[F, n_dims] -> [F, K]: the inverse DCT (a complex FFT, unpacked
    even-odd), edge-duplicated, interpolated from the mel axis back to the
    linear frequency bins, exponentiated."""
    coded = _check(coded)
    F = coded.shape[0]
    max_dim = fft_size // 2
    K = fft_size // 2 + 1

    i = _arange(n_dims, coded)
    w0 = torch.cos(i * C.PI / fft_size) * math.sqrt(fft_size)
    w1 = torch.sin(i * C.PI / fft_size) * math.sqrt(fft_size)
    w0[0] = w0[0] / math.sqrt(2.0)
    norm = math.sqrt(max_dim)
    cdt = torch.complex128 if coded.dtype == torch.float64 \
        else torch.complex64
    inp = torch.zeros((F, max_dim), dtype=cdt, device=coded.device)
    inp[:, :n_dims] = torch.complex(coded * w0 * norm, -(coded * w1 * norm))
    # the reference's BACKWARD c2c == numpy's forward fft
    out = torch.fft.fft(inp, dim=-1).real

    half = max_dim // 2
    mel_sp = torch.empty((F, max_dim), dtype=coded.dtype, device=coded.device)
    mel_sp[:, 0::2] = out[:, :half]
    mel_sp[:, 1::2] = torch.flip(out[:, half:max_dim], dims=(-1,))
    # edge-duplicate padding (the reference's DecodeOneFrame)
    mel_pad = torch.cat([mel_sp[:, :1], mel_sp, mel_sp[:, -1:]], dim=-1)

    floor_mel, ceil_mel = _mel_bounds(fs, coded)
    mel_axis = torch.cat([
        _full((1,), 0.0, coded),
        _mel_to_freq((ceil_mel - floor_mel) * _arange(max_dim, coded)
                     / max_dim + floor_mel),
        _full((1,), fs / 2.0, coded)])
    freq = _arange(K, coded) * fs / fft_size
    env = interp1(mel_axis, mel_pad, freq)
    return torch.exp(env / max_dim)
