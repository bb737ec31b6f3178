"""The benchmark's plain reference: WORLD copy-synthesis (Harvest with its
device contour chain, pitch scaling, CheapTrick, D4C, synthesis) in float32.

A frozen copy of ``worldtpu_torch``'s float32 main path as of commit
c704060, with every hand-written CUDA kernel replaced by the plain PyTorch
version the port keeps beside it (zc, refine, extend, the contour merge and
smoothing, OLA), no captured CUDA graphs, no host helpers and no float64
branches.  It imports nothing of ``worldtpu_torch``, ``worldtpu`` or
``jax`` and derives every table (geometry, filter banks, windows) itself,
so a later change of the program is judged against the semantics the
program had when the benchmark was written.  The module docstrings inside
the copy describe the port's modules they came from.

``wav_to_wav`` is the counterpart of ``batch_wav_to_wav`` on one device.
"""

from __future__ import annotations

import torch

from wtbench.reference import constants as C
from wtbench.reference.analysis import harvest as H
from wtbench.reference.analysis.cheaptrick import cheaptrick_frames
from wtbench.reference.analysis.d4c import d4c_frames
from wtbench.reference.ops.fftutil import fft_size_for_cheaptrick
from wtbench.reference.synthesis import synthesis as S


def sizes(fs, n_samples, *, frame_period_ms, duration_scale, f0_floor=40.0,
          f0_ceil=800.0):
    """The static sizes of one padded length: dict of the Harvest geometry
    (``geo``), CheapTrick's fft size and window half-width, the frame
    count, the synthesis frame period and output length, and the pulse
    capacity for unseen audio (the program's rule for its noise rows)."""
    geo = H.HarvestGeometry(fs, n_samples, f0_floor=f0_floor,
                            f0_ceil=f0_ceil, frame_period=frame_period_ms)
    fft = fft_size_for_cheaptrick(fs, C.FLOOR_F0)
    ct_floor = 3.0 * fs / (fft - 3.0)
    n_frames = geo.n_grid()
    synth_s = frame_period_ms / 1000.0 * duration_scale
    out_length = int((n_frames - 1) * synth_s * fs) + 1
    return dict(geo=geo, fft_size=fft,
                max_half_window=int(1.5 * fs / ct_floor + 0.5),
                n_frames=n_frames, synth_period_s=synth_s,
                out_length=out_length,
                max_pulses=S.capacity_max_pulses(out_length, fs))


@torch.no_grad()
def wav_to_wav(x, noise, *, fs, pitch_scale, frame_period_ms,
               duration_scale, out_length=None, f0_floor=40.0,
               f0_ceil=800.0):
    """x [B, T] float32, noise [B, max_pulses, fft] -> (y [B, out_length],
    f0 [B, F], pulse overflow [B] bool), on x's device.  ``out_length``
    defaults to the length that covers the F frames of T samples."""
    sz = sizes(fs, x.shape[1], frame_period_ms=frame_period_ms,
               duration_scale=duration_scale, f0_floor=f0_floor,
               f0_ceil=f0_ceil)
    geo, fft = sz["geo"], sz["fft_size"]
    n = sz["n_frames"]
    mean = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    f0 = H.harvest_device_full(x, mean, geo=geo, n_out=n)
    scale = torch.full((), pitch_scale, dtype=x.dtype, device=x.device)
    f0 = (f0 * scale).to(f0.dtype)
    tpos = torch.arange(n, dtype=x.dtype, device=x.device) \
        * (frame_period_ms / 1000.0)
    spec = cheaptrick_frames(x, f0, tpos, fs=fs, fft_size=fft,
                             max_half_window=sz["max_half_window"])
    ap = d4c_frames(x, f0, tpos, fs=fs, fft_size_out=fft)
    y, ovf = S.synthesis_frames_impl(
        f0, spec, ap, noise, fs=fs, fft_size=fft,
        frame_period_s=sz["synth_period_s"],
        out_length=out_length or sz["out_length"], max_pulses=noise.shape[1],
        return_overflow=True)
    return y, f0, ovf
