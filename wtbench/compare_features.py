"""The comparison that decides ``correct`` in a feature cell: the program's
features of each checked utterance against the plain reference's.

Each pair is (f0, f0_ref, mcep, mcep_ref, bap, bap_ref) as numpy arrays,
each cut to the utterance's own frames by each side: F0 [F], the coded
envelope [F, n_dims], the coded aperiodicity [F, n_ap] in dB.  The
numbers:

  length_mismatch  utterances whose frame count (or shape, or finiteness)
                   differs (exact: 0)
  f0_vuv_err       the share of frames voiced on one side only
  f0_rel_med       the median over the checked utterances of each one's RMS
                   F0 error relative to the reference's F0, over its frames
                   voiced on both sides (as ``compare.py``)
  mcep_rms_med     the median over the checked utterances of each one's RMS
                   coded-envelope difference over the RMS of the
                   reference's coded envelope
  bap_db_med       the median over the checked utterances of each one's RMS
                   coded-aperiodicity difference, in dB

Medians over utterances, for the reason ``compare.py`` gives: Harvest's
discrete choices on near-ties can go the other way in one utterance when
the kernels' last bits differ, which moves a stretch of its frames (and
the envelope and aperiodicity analysed at them), while a stage that
computes otherwise moves every utterance.
"""

from __future__ import annotations

import numpy as np

from wtbench.compare import _ratio


def numbers(pairs):
    """[(name, value)] of the checked pairs; f0_vuv_err is None when no
    pair was compared, the medians 0 when nothing is to be compared."""
    mismatch = flips = frames = 0
    f0_rms, mcep_rel, bap_db = [], [], []
    for f0, f0r, mc, mcr, ba, bar in pairs:
        f0, f0r, mc, mcr, ba, bar = (np.asarray(a, np.float64) for a in (
            f0, f0r, mc, mcr, ba, bar))
        if f0.shape != f0r.shape or mc.shape != mcr.shape \
                or ba.shape != bar.shape \
                or not all(np.isfinite(a).all() for a in (f0, mc, ba)):
            mismatch += 1
            continue
        v, vr = f0 > 0, f0r > 0
        flips += int((v != vr).sum())
        frames += f0.size
        both = v & vr
        rel = np.abs(f0 - f0r)[both] / f0r[both]
        if rel.size:
            f0_rms.append(float(np.sqrt(np.mean(rel ** 2))))
        mcep_rel.append(_ratio(float(((mc - mcr) ** 2).sum()),
                               float((mcr ** 2).sum())))
        if ba.size:
            bap_db.append(float(np.sqrt(np.mean((ba - bar) ** 2))))
    return [("length_mismatch", float(mismatch)),
            ("f0_vuv_err", flips / frames if frames else None),
            ("f0_rel_med", _median(f0_rms)),
            ("mcep_rms_med", _median(mcep_rel)),
            ("bap_db_med", _median(bap_db))]


def _median(values):
    return float(np.median(values)) if values else 0.0
