"""Exact reference randn() dither streams for bitwise analysis parity.

The port's copy of worldtpu/analysis/dither.py (numpy on the host), on the
port's own xorshift stream (``worldtpu_torch.native.XorshiftRandn``).

The C++ reference injects a stateful xorshift randn() dither into its
windowed waveforms and spectra:

- CheapTrick: ``waveform[i] = x*window + randn()*1e-15`` per window sample
  (cheaptrick.cpp:153) and ``power[i] += fabs(randn())
  * kEps`` per spectral bin (:227).
- D4C: ``waveform[i] = x*window + randn()*kMySafeGuardMinimum`` per window
  sample of every windowed read (d4c.cpp:291), reached
  from LoveTrain (:216), the two centroids (:417-420), and the smoothed
  power spectrum (:488).

randn() has a fixed process-wide seed and is call-order dependent
(world_matlabfunctions.cpp:243-264), so parity is only
defined single-threaded.  In the reference demo pipeline Harvest draws
nothing, CheapTrick's stream therefore starts at the seed, and D4C's
continues where CheapTrick stopped.  This module reproduces those streams
on the host, shaped as the padded per-frame arrays the batched kernels
accept as dither hooks.
"""

from __future__ import annotations

import numpy as np

from worldtpu_torch import constants as C
from worldtpu_torch.native import XorshiftRandn
from worldtpu_torch.ops.fftutil import f0_floor_for_cheaptrick


def _matlab_round(v: float) -> int:
    return int(np.floor(v + 0.5)) if v > 0 else int(np.ceil(v - 0.5))


def cheaptrick_dither(f0, fs, fft_size, max_half_window, f0_floor=None,
                      gen: XorshiftRandn | None = None):
    """CheapTrick's per-frame dither arrays in exact stream order.

    Per frame the reference draws ``2*half+1`` window values
    (cheaptrick.cpp:151-153) followed by ``fft_size/2+1`` spectrum values
    (:225-228).  Returns (window_dither [F, 2*max_half_window+1],
    spectrum_dither [F, K], gen); window draws sit at the centered in-window
    columns used by ``cheaptrick_frames`` and are pre-scaled by 1e-15
    (the kernel hook adds them raw), spectrum draws are raw randn values
    (the hook applies ``abs(.) * kEps``).
    """
    if gen is None:
        gen = XorshiftRandn()
    if f0_floor is None:
        f0_floor = f0_floor_for_cheaptrick(fs, fft_size)
    f0 = np.asarray(f0, np.float64)
    F = f0.shape[0]
    W = 2 * max_half_window + 1
    K = fft_size // 2 + 1
    win_d = np.zeros((F, W), np.float64)
    spec_d = np.zeros((F, K), np.float64)
    for i in range(F):
        cf0 = C.DEFAULT_F0 if f0[i] <= f0_floor else f0[i]
        half = _matlab_round(1.5 * fs / cf0)
        lo = max_half_window - half
        win_d[i, lo:lo + 2 * half + 1] = gen.draw(2 * half + 1) * 1e-15
        spec_d[i] = gen.draw(K)
    return win_d, spec_d, gen


def d4c_love_train_dither(f0, fs, max_half_lt,
                          gen: XorshiftRandn | None = None):
    """LoveTrain window dither [F, 2*max_half_lt+1], left-aligned like
    ``d4c._windowed_waveform``, pre-scaled by kMySafeGuardMinimum.

    Per voiced frame the reference draws ``2*round(1.5*fs/max(f0,40))+1``
    values (d4c.cpp:203,216,250,291); unvoiced frames draw nothing (:192-195).
    """
    if gen is None:
        gen = XorshiftRandn()
    f0 = np.asarray(f0, np.float64)
    F = f0.shape[0]
    out = np.zeros((F, 2 * max_half_lt + 1), np.float64)
    for i in range(F):
        if f0[i] == 0.0:
            continue
        half = _matlab_round(1.5 * fs / max(f0[i], 40.0))
        out[i, :2 * half + 1] = (gen.draw(2 * half + 1)
                                 * C.MY_SAFE_GUARD_MINIMUM)
    return out, gen


def d4c_body_dither(f0, active, fs, max_half_c,
                    gen: XorshiftRandn | None = None):
    """Main-loop window dithers (centroid1, centroid2, Hanning), each
    [F, 2*max_half_c+1] left-aligned and pre-scaled by kMySafeGuardMinimum.

    Frames with ``f0 == 0`` or failing the LoveTrain threshold draw nothing
    (d4c.cpp:147).  Active frames draw three windows of ``2*round(2*fs/
    max(47, f0))+1`` values each, in call order centroid(-0.25/f0),
    centroid(+0.25/f0) (:417-420), then the Hanning window (:488).
    """
    if gen is None:
        gen = XorshiftRandn()
    f0 = np.asarray(f0, np.float64)
    active = np.asarray(active)
    F = f0.shape[0]
    W = 2 * max_half_c + 1
    c1 = np.zeros((F, W), np.float64)
    c2 = np.zeros((F, W), np.float64)
    h = np.zeros((F, W), np.float64)
    for i in range(F):
        if not active[i]:
            continue
        f0d = max(C.FLOOR_F0_D4C, f0[i])
        half = _matlab_round(2.0 * fs / f0d)
        n = 2 * half + 1
        for buf in (c1, c2, h):
            buf[i, :n] = gen.draw(n) * C.MY_SAFE_GUARD_MINIMUM
    return c1, c2, h, gen
