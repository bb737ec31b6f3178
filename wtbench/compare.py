"""The comparison that decides ``correct``: the program's outputs of each
checked utterance against the plain reference's.

Each pair is (y, y_ref, f0, f0_ref) as numpy arrays, y cut to the
utterance's output length by each side and F0 at the utterance's own
frames.  The numbers:

  length_mismatch  utterances whose cut output length differs (exact: 0)
  f0_vuv_err       the share of frames voiced on one side only
  f0_rel_med       the median over the checked utterances of each one's RMS
                   F0 error relative to the reference's F0, over its frames
                   voiced on both sides.  The median, because Harvest's
                   discrete choices (a candidate, a contour path) on
                   near-ties can go the other way in one utterance when
                   the kernels' last bits differ, which moves a stretch of
                   frames by up to a fifth; a total over utterances then
                   swings with one such choice, while every utterance's
                   F0 moves when a stage computes otherwise.
  y_env_rel        the error of the short-time RMS envelopes (10 ms frames)
                   over the reference's, all checked utterances together, as
                   an RMS ratio
  y_lsd_db         the log-spectral distance of y: the RMS over frames and
                   bins of the difference of the two short-time log power
                   spectra (Hann frames of a power of two >= 40 ms, hop a
                   quarter), in dB, each spectrum floored 80 dB below the
                   reference utterance's loudest bin, over the frames of
                   the reference within 50 dB of its loudest; all checked
                   utterances together.  It sees the spectral envelope
                   (CheapTrick) and the harmonic-to-noise balance (D4C's
                   aperiodicity), which a pulse moved by a fraction of a
                   sample barely changes.

The waveform itself is not compared: a frame's F0 a few ulps apart moves
the pulses after it by a fraction of a sample, which changes the waveform
(sound runs read up to 0.24 relative RMS, and 1.1 on one utterance) but
not its envelope.
"""

from __future__ import annotations

import numpy as np


def envelope(y, frame):
    """Short-time RMS of y over frames of ``frame`` samples."""
    n = len(y) // frame * frame
    return np.sqrt((y[:n].reshape(-1, frame) ** 2).mean(axis=1))


def stft_size(fs, seconds=0.040):
    """The log spectra's frame: the power of two at or above ``seconds``."""
    return 1 << max(0, int(np.ceil(np.log2(seconds * fs))))


def log_power(y, n):
    """[frames, n//2 + 1] power spectra of y in Hann frames of n samples,
    hop n // 4 (y zero-padded to whole frames)."""
    hop = n // 4
    if len(y) < n:
        y = np.pad(y, (0, n - len(y)))
    m = 1 + -(-(len(y) - n) // hop)
    y = np.pad(y, (0, (m - 1) * hop + n - len(y)))
    idx = np.arange(n)[None, :] + hop * np.arange(m)[:, None]
    return np.abs(np.fft.rfft(y[idx] * np.hanning(n), axis=1)) ** 2


def lsd_terms(y, yr, n, floor_db=80.0, gate_db=50.0):
    """(sum of squared dB differences, count) over the reference's frames
    within ``gate_db`` of its loudest, spectra floored ``floor_db`` below
    its loudest bin."""
    p, pr = log_power(y, n), log_power(yr, n)
    top = pr.max()
    if top <= 0:
        return 0.0, 0
    floor = top * 10.0 ** (-floor_db / 10.0)
    d = 10.0 * np.log10(np.maximum(p, floor) / np.maximum(pr, floor))
    e = pr.sum(axis=1)
    keep = e >= e.max() * 10.0 ** (-gate_db / 10.0)
    return float((d[keep] ** 2).sum()), int(d[keep].size)


def numbers(pairs, fs):
    """[(name, value)] of the checked pairs at sample rate ``fs``;
    f0_vuv_err is None when no pair was compared, and f0_rel_med and
    y_lsd_db 0 when nothing is to be compared."""
    frame, n_fft = int(fs) // 100, stft_size(fs)
    mismatch = flips = frames = 0
    f0_rms = []
    v_err = v_ref = 0.0
    lsd2, n_lsd = 0.0, 0
    for y, yr, f0, f0r in pairs:
        y, yr = np.asarray(y, np.float64), np.asarray(yr, np.float64)
        f0, f0r = np.asarray(f0, np.float64), np.asarray(f0r, np.float64)
        if y.shape != yr.shape or f0.shape != f0r.shape \
                or not np.all(np.isfinite(y)) or not np.all(np.isfinite(f0)):
            mismatch += 1
            continue
        v, vr = f0 > 0, f0r > 0
        flips += int((v != vr).sum())
        frames += f0.size
        both = v & vr
        rel = np.abs(f0 - f0r)[both] / f0r[both]
        if rel.size:
            f0_rms.append(float(np.sqrt(np.mean(rel ** 2))))
        env, env_r = envelope(y, frame), envelope(yr, frame)
        v_err += float(((env - env_r) ** 2).sum())
        v_ref += float((env_r ** 2).sum())
        d2, nd = lsd_terms(y, yr, n_fft)
        lsd2 += d2
        n_lsd += nd
    return [("length_mismatch", float(mismatch)),
            ("f0_vuv_err", flips / frames if frames else None),
            ("f0_rel_med", float(np.median(f0_rms)) if f0_rms else 0.0),
            ("y_env_rel", _ratio(v_err, v_ref)),
            ("y_lsd_db", float(np.sqrt(lsd2 / n_lsd)) if n_lsd else 0.0)]


def _ratio(err, ref):
    """sqrt(err / ref): 0 where both are 0, infinite where only the
    reference is silent."""
    if ref > 0:
        return float(np.sqrt(err / ref))
    return 0.0 if err == 0 else float("inf")
