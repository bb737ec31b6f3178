"""Batched entry points: copy-synthesis and the one-pass wav -> wav main
path over [B, T] padded utterances on one device.

Port of worldtpu/parallel/batch.py with ``mesh=None`` (the JAX package's
single-chip program).  Batches are padded: utterances to a common T (zero
samples) and a common F (zero = unvoiced frames); callers slice outputs
back to their true lengths.  The dtype of ``x`` selects the path: float32
the production one, float64 the parity one (``harvest.harvest_parity``
and the float64 branches of the analysis and synthesis, without dither).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from worldtpu_torch.analysis import harvest as _hv
from worldtpu_torch.analysis.cheaptrick import cheaptrick_frames
from worldtpu_torch.analysis.d4c import d4c_frames
from worldtpu_torch.synthesis import synthesis as _syn


def batch_copy_synthesis(x, f0, tpos, noise, *, fs, fft_size,
                         max_half_window, frame_period_s, out_length,
                         max_pulses, return_overflow=False):
    """Analysis from given F0 (CheapTrick + D4C) and resynthesis.

    Args:
        x: [B, T] padded waveforms.
        f0: [B, F] padded F0 contours (0 = unvoiced/padding).
        tpos: [F] frame times (s).
        noise: [B, max_pulses, fft_size] synthesis noise.

    Returns:
        (y [B, out_length], spec [B, F, K], ap [B, F, K]); with
        ``return_overflow`` a trailing [B] bool of pulse-bound overflows.
    """
    spec, ap = _analysis(x, f0, tpos, fs=fs, fft_size=fft_size,
                         max_half_window=max_half_window)
    y, ovf = _syn.synthesis_frames_impl(
        f0, spec, ap, noise, fs=fs, fft_size=fft_size,
        frame_period_s=frame_period_s, out_length=out_length,
        max_pulses=max_pulses, return_overflow=True)
    return (y, spec, ap, ovf) if return_overflow else (y, spec, ap)


@torch.no_grad()
def batch_wav_to_wav(x, noise, *, geo, fs, fft_size, max_half_window,
                     frame_period_s, out_length, max_pulses, pitch_scale=1.0,
                     return_overflow=False, grid_ms=1):
    """The main path: [B, T] wavs -> Harvest F0 (float32: with the device
    contour chain) -> pitch scaling -> CheapTrick + D4C -> synthesis ->
    [B, out_length] wavs.  Duration modification is the synthesis
    frame_period_s.  ``grid_ms`` is Harvest's candidate-grid period
    (float32; ``analysis.harvest.HarvestKernel``).

    Returns (y, f0 [B, n_grid]), plus a [B] bool of pulse-bound overflows
    with ``return_overflow`` (size max_pulses with
    synthesis.capacity_max_pulses and check it)."""
    f0, tpos = _scaled_f0(x, geo, pitch_scale, grid_ms)
    y, _, _, ovf = batch_copy_synthesis(
        x, f0, tpos, noise, fs=fs, fft_size=fft_size,
        max_half_window=max_half_window, frame_period_s=frame_period_s,
        out_length=out_length, max_pulses=max_pulses, return_overflow=True)
    return (y, f0, ovf) if return_overflow else (y, f0)


@torch.no_grad()
def batch_analyze(x, *, geo, fs, fft_size, max_half_window, pitch_scale=1.0,
                  grid_ms=1):
    """Analysis in one call: [B, T] wavs -> (f0 [B, n_grid], spec
    [B, n_grid, K], ap [B, n_grid, K]) — Harvest (with the device contour
    chain, on the ``grid_ms`` candidate grid), pitch scaling, CheapTrick and
    D4C on the scaled F0."""
    f0, tpos = _scaled_f0(x, geo, pitch_scale, grid_ms)
    spec, ap = _analysis(x, f0, tpos, fs=fs, fft_size=fft_size,
                         max_half_window=max_half_window)
    return f0, spec, ap


def _scaled_f0(x, geo, pitch_scale, grid_ms):
    """Harvest F0 [B, n_grid] of x [B, T] on the grid_ms candidate grid
    times pitch_scale, and the frame times [n_grid]."""
    n_grid = geo.n_grid()
    mean = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    f0 = _hv.harvest_device_full(x, mean, geo=geo, n_out=n_grid,
                                 grid=grid_ms)
    f0 = (f0 * pitch_scale).to(x.dtype)
    tpos = torch.arange(n_grid, dtype=x.dtype, device=x.device) \
        * (geo.frame_period / 1000.0)
    return f0, tpos


def _analysis(x, f0, tpos, *, fs, fft_size, max_half_window):
    """CheapTrick and D4C of x [B, T] at F0 [B, F]: (spec, ap)."""
    with record_function("wt.cheaptrick"):
        spec = cheaptrick_frames(x, f0, tpos, fs=fs, fft_size=fft_size,
                                 max_half_window=max_half_window)
    with record_function("wt.d4c"):
        ap = d4c_frames(x, f0, tpos, fs=fs, fft_size_out=fft_size)
    return spec, ap


def pad_batch(waves, fs, frame_period_ms=5.0):
    """Pad 1-D waveforms to a [B, T] numpy batch + frame geometry.

    Returns (x [B, T], lengths, n_frames_per_utt, F, out_length)."""
    lengths = np.array([len(w) for w in waves])
    T = int(lengths.max())
    B = len(waves)
    x = np.zeros((B, T), dtype=np.asarray(waves[0]).dtype)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    n_frames = (1000.0 * lengths / fs / frame_period_ms).astype(int) + 1
    F = int(n_frames.max())
    out_length = int((F - 1) * frame_period_ms / 1000.0 * fs) + 1
    return x, lengths, n_frames, F, out_length
