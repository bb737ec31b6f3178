"""Batched corpus loader: a directory of WAV files -> padded [B, T] batches.

The port's own copy of ``worldtpu/io/corpus.py`` (numpy only), unchanged
but for its two imports (the port's ``io.wav`` and ``native``) and
``CorpusBatch.slice_outputs``, which also takes a tensor on the card and
copies it to the host once.  A corpus is streamed as static-shape batches:
utterances are sorted by length into batches (minimizing padding waste),
T is quantized up to a multiple of ``pad_to`` and the frame axis to a
multiple of ``frames_to`` so repeated batches reuse one geometry
(``HarvestGeometry`` and the synthesis sizes) per padded length.

Feeds ``HarvestKernel.compute_corpus`` and ``parallel.batch`` consumers;
``chip_smoke.py`` streams its corpus through this loader.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Iterator, Sequence

import numpy as np
import torch

from worldtpu_torch.io import wav as _wav


@dataclasses.dataclass
class CorpusBatch:
    """One padded batch plus the bookkeeping to undo the padding.

    x: [B, T] zero-padded waveforms (rows may repeat the last utterance to
        fill the batch when ``fill_batch`` is set; those rows have
        ``valid[i] = False``).
    lengths: [B] true sample counts.
    n_frames: [B] true frame counts at ``frame_period_ms``.
    names: utterance stems, '' for fill rows.
    valid: [B] bool, False for fill rows.
    F: padded frame-axis length shared by the batch.
    out_length: synthesis length covering F frames.
    """
    x: np.ndarray
    lengths: np.ndarray
    n_frames: np.ndarray
    names: list
    valid: np.ndarray
    fs: int
    frame_period_ms: float
    F: int
    out_length: int

    def slice_outputs(self, y):
        """Cut a [B, out_length] batch output back to true per-utterance
        lengths, dropping fill rows.  y may be numpy or a tensor (a tensor
        on the card is copied to the host once)."""
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu()
        y = np.asarray(y)
        out = []
        for i in range(y.shape[0]):
            if not self.valid[i]:
                continue
            n = int((self.n_frames[i] - 1)
                    * self.frame_period_ms / 1000.0 * self.fs) + 1
            out.append(y[i, :n])
        return out


def scan_corpus(root, pattern="*.wav"):
    """Sorted list of wav paths under ``root`` (recursive)."""
    root = pathlib.Path(root)
    if not root.exists():
        raise FileNotFoundError(f"corpus root {root} does not exist")
    return sorted(root.rglob(pattern))


def _round_up(n, m):
    return ((int(n) + m - 1) // m) * m


def iter_corpus(root, batch_size, *, fs=None, dtype=np.float32,
                frame_period_ms=5.0, pad_to=4096, frames_to=16,
                sort_by_length=True, fill_batch=True,
                pattern="*.wav") -> Iterator[CorpusBatch]:
    """Stream a wav directory as padded CorpusBatch objects.

    Args:
        root: directory containing wav files (searched recursively).
        batch_size: utterances per batch.
        fs: expected sample rate; files with another rate raise (resampling
            is a DSP decision the caller must make explicitly).  None =
            take the first file's rate.
        dtype: waveform dtype for the batch (float32 production path).
        pad_to: quantize the padded T up to this multiple so repeated
            batches hit the jit cache.
        frames_to: quantize the shared frame axis F likewise.
        sort_by_length: order utterances by length so batch padding waste
            is minimal (corpus order is not semantic).
        fill_batch: repeat the last utterance to fill a short final batch
            (keeps the batch shape static); fill rows have valid=False.
        pattern: glob for wav files.

    Yields:
        CorpusBatch per ``batch_size`` utterances.
    """
    paths = scan_corpus(root, pattern)
    if not paths:
        raise FileNotFoundError(f"no '{pattern}' files under {root}")
    metas = []
    for p in paths:
        n, file_fs, _ = _wav.wav_info(p)
        if fs is None:
            fs = file_fs
        if file_fs != fs:
            raise ValueError(
                f"{p}: sample rate {file_fs} != corpus rate {fs}")
        metas.append((p, n))
    if sort_by_length:
        metas.sort(key=lambda m: m[1])

    for start in range(0, len(metas), batch_size):
        group = metas[start:start + batch_size]
        n_fill = 0
        if fill_batch and len(group) < batch_size:
            n_fill = batch_size - len(group)
            group = group + [group[-1]] * n_fill
        T = _round_up(max(n for _, n in group), pad_to)
        B = len(group)
        names = [p.stem for p, _ in group]
        # threaded C++ batch reader (csrc/corpusio.cpp); Python fallback
        from worldtpu_torch import native as _native
        loaded = _native.load_wavs_batch([p for p, _ in group], T) \
            if dtype == np.float32 else None
        if loaded is not None and bool((loaded[1] >= 0).all()):
            x, lengths = loaded[0], loaded[1]
        else:
            x = np.zeros((B, T), dtype)
            lengths = np.zeros(B, np.int64)
            for i, (p, n) in enumerate(group):
                xi, file_fs, _ = _wav.wavread(p)
                x[i, :n] = xi.astype(dtype)
                lengths[i] = n
        valid = np.ones(B, bool)
        if n_fill:
            valid[-n_fill:] = False
            for i in range(B - n_fill, B):
                names[i] = ""
        n_frames = (1000.0 * lengths / fs / frame_period_ms).astype(int) + 1
        F = _round_up(n_frames.max(), frames_to)
        out_length = int((F - 1) * frame_period_ms / 1000.0 * fs) + 1
        yield CorpusBatch(x=x, lengths=lengths, n_frames=n_frames,
                          names=names, valid=valid, fs=int(fs),
                          frame_period_ms=frame_period_ms, F=int(F),
                          out_length=out_length)


def load_corpus(root, batch_size, **kw) -> Sequence[CorpusBatch]:
    """Eager list form of :func:`iter_corpus`."""
    return list(iter_corpus(root, batch_size, **kw))
