"""The traffic generator: what every mix draws from its configuration,
its parameters and the seed.

A corpus stretch (``corpus_lengths``) is the length-sorted run of
``utterances`` clips around the corpus's mean length at its density
(``clips_per_length_s``), so a batch of it spans what a batch of the real
sorted pass spans.  Its lengths do not depend on the seed; the audio does.
"""

from __future__ import annotations

from wtbench.speech import seed_words


def round_up(n, m):
    return -(-int(n) // m) * m


def corpus_lengths(cfg, mix):
    """Sample counts of the corpus stretch, shortest first."""
    n = int(mix["utterances"])
    span = n / float(cfg["clips_per_length_s"])
    lo = float(cfg["length_mean_s"]) - span / 2.0
    fs = int(cfg["fs"])
    return [int(round(fs * (lo + span * (i + 0.5) / n))) for i in range(n)]


def n_frames(n_samples, fs, frame_period_ms):
    """Frames of an utterance at the analysis frame period (the
    reference's getSamples)."""
    return int(1000.0 * n_samples / fs / frame_period_ms) + 1


def out_length(frames, period_ms, fs):
    """Output samples of ``frames`` frames at ``period_ms`` (the
    reference's ``(f0_length - 1) * frame_period / 1000 * fs + 1``, in its
    order of operations: the product can land a rounding from an
    integer)."""
    return int((frames - 1) * period_ms / 1000.0 * fs) + 1


def corpus_batches(lengths, cfg, mix):
    """The stretch as the sorted pass batches it: [(first index, count,
    padded T, frames F)] with F rounded up to ``frames_to`` and T to
    ``pad_to``; a short last batch is filled to ``batch_size`` rows."""
    b, fs, fp = int(mix["batch_size"]), int(cfg["fs"]), cfg["frame_period_ms"]
    order = sorted(lengths)
    out = []
    for i in range(0, len(order), b):
        grp = order[i:i + b]
        out.append((i, len(grp), round_up(max(grp), int(mix["pad_to"])),
                    round_up(n_frames(max(grp), fs, fp),
                             int(mix["frames_to"]))))
    return out
