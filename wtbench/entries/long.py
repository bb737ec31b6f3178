"""The entry of the long mix: whole chapters, one at a time, through
``longaudio.LongPipeline.copy_synthesis`` (float32, the sequential mode,
the configuration's chunking).

Set-up draws the chapters' lengths from the seed (``chapter_lengths``),
makes them on the card (``speech.utterances``: one speaker a chapter, the
segment plan's pauses between its vowels and fricatives) and keeps each
on the host as a reader hands it over: 16-bit PCM / 32768 in float32.  It
then runs ``warm_chapters`` whole chapters, the pool's in the window's
order, ending with the one before the checked chapter
(``checked_chapter``), so the window starts with the checked one and
cycles through the pool.  One chapter does not warm the process: with it
the window's first one to three chapters often ran at 22-29 ms a second
of input and the later ones at 15-21, the host contour the slow part.  Every chapter pays LongHarvest's windows, the
host contour, a plan of its own and an eager step and a capture of its
chunk program before the replays.  The window runs whole chapters until
its time is up (the chapter in flight at the deadline runs to its end); a
traced run then profiles one more whole chapter.  A chapter that raises,
overflows its pulse bound or returns non-finite samples counts in
``failed``.

Checked after the window: the checked chapter, computed with the plain
reference (``wtbench/reference/longform.py``), against the program's
output of every window pass that ran it: the reference's F0 (LongHarvest)
against the program's, and the reference's y at the program's F0
(``reference_y`` says why) against the program's, in consecutive
stretches of ``STRETCH_S`` seconds of input (F0 frames and output samples
cut at the same times): each stretch is one item of ``compare.numbers``.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from wtbench import compare, generate as G, speech
from wtbench import trace as T

#: seconds of input a compared item holds: a chapter gives ~10
STRETCH_S = 60.0


def chapter_lengths(cfg, seed):
    """Sample counts of the pool's chapters: one drawn uniformly from each
    of ``chapters`` equal parts of [length_min_s, length_max_s], so the
    pool spans the range evenly, in an order drawn from the seed."""
    n, fs = int(cfg["chapters"]), int(cfg["fs"])
    lo, hi = float(cfg["length_min_s"]), float(cfg["length_max_s"])
    rng = np.random.default_rng(G.seed_words(seed, 21))
    part = (hi - lo) / n
    s = lo + part * (np.arange(n) + rng.random(n))
    return [int(round(fs * v)) for v in rng.permutation(s)]


def checked_chapter(cfg, seed):
    """The pool index of the chapter the check compares."""
    rng = np.random.default_rng(G.seed_words(seed, 22))
    return int(rng.integers(int(cfg["chapters"])))


def noise_seed(seed, c):
    """The noise key's seed of chapter c."""
    return G.seed_words(seed, 23, c)


def stretches(n_frames, fp_ms, fp_s_ms, fs, stretch_s):
    """[(frame lo, frame hi, sample lo, sample hi)] of consecutive
    stretches of ``stretch_s`` s of input: F0 frames at the analysis frame
    period ``fp_ms``, output samples where those frames' times fall at the
    synthesis frame period ``fp_s_ms`` (the last stretch to the ends)."""
    per = int(round(stretch_s * 1000.0 / fp_ms))
    bounds = list(range(0, n_frames, per)) + [n_frames]
    n_out = G.out_length(n_frames, fp_s_ms, fs)
    samples = [min(n_out, int(f * fp_s_ms / 1000.0 * fs))
               for f in bounds[:-1]] + [n_out]
    return [(f0, f1, s0, s1) for f0, f1, s0, s1 in zip(
        bounds[:-1], bounds[1:], samples[:-1], samples[1:])]


@dataclasses.dataclass
class Tally:
    """What a stretch of chapters did: chapters attempted and failed, the
    input audio completed (s), the program's chunk steps
    (``LongPipeline.counts``, 0 where the program has no such counter),
    and (pool index, input s, wall s, chunk steps, pulses) of each
    chapter."""
    attempted: int = 0
    failed: int = 0
    audio_s: float = 0.0
    chapters: int = 0
    chunk_steps: int = 0
    log: list = dataclasses.field(default_factory=list)


def setup(ctx):
    from worldtpu_torch.longaudio import LongPipeline
    cfg, dev = ctx.config, ctx.device
    fs = int(cfg["fs"])
    lengths = chapter_lengths(cfg, ctx.seed)
    pcm = speech.utterances(fs, lengths, ctx.seed, dev)
    lp = LongPipeline(
        fs, frame_period=cfg["frame_period_ms"],
        chunk_frames=int(cfg["chunk_frames"]), f0_floor=cfg["f0_floor"],
        f0_ceil=cfg["f0_ceil"], harvest_chunk_ms=int(cfg["harvest_chunk_ms"]),
        harvest_halo_ms=int(cfg["harvest_halo_ms"]), device=dev)
    c = checked_chapter(cfg, ctx.seed)
    n = len(lengths)
    st = dict(lp=lp, checked=c,
              x=[p.astype(np.float32) / np.float32(32768.0) for p in pcm],
              order=[(c + i) % n for i in range(n)], next=0, kept=[])
    warm = int(ctx.traffic["warm_chapters"])
    for k in range(warm):
        run_chapter(ctx, st, (c - warm + k) % n, Tally())
    return st


def run_chapter(ctx, st, c, tally, keep=False):
    """Pool chapter c through the program once."""
    cfg, lp = ctx.config, st["lp"]
    x = st["x"][c]
    t = time.perf_counter()
    ok, y, f0 = True, None, None
    with record_function("wtbench.chapter"):
        try:
            y, f0 = lp.copy_synthesis(
                x, seed=noise_seed(ctx.seed, c),
                pitch_scale=cfg["pitch_scale"],
                duration_scale=cfg["duration_scale"])
            ok = bool(np.isfinite(y).all())
        except Exception:           # a failed chapter is counted, not fatal
            traceback.print_exc(file=sys.stderr)
            ok = False
    wall = time.perf_counter() - t
    counts = (getattr(lp, "counts", None) or {}) if ok else {}
    tally.attempted += 1
    tally.failed += not ok
    tally.audio_s += len(x) / int(cfg["fs"]) if ok else 0.0
    tally.chapters += 1
    tally.chunk_steps += int(counts.get("chunk_steps", 0))
    tally.log.append((c, len(x) / int(cfg["fs"]), wall,
                      counts.get("chunk_steps"), counts.get("pulses")))
    if keep and ok and c == st["checked"]:
        st["kept"].append((y, f0))


def window(ctx, st, seconds):
    tally = Tally()
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + seconds:
        run_chapter(ctx, st, st["order"][st["next"] % len(st["order"])],
                    tally, keep=True)
        st["next"] += 1
    wall = time.perf_counter() - t0
    print(f"window: {tally.chapters} chapters, {tally.audio_s:.1f} s of "
          f"input, {tally.failed} failed, {wall:.3f} s", file=sys.stderr)
    # each chapter's input and wall seconds and the program's counts:
    # where a slow run lost its time
    print("chapters (pool index, input s, wall s, chunk steps, pulses): "
          + ", ".join("(%d, %.2f, %.3f, %s, %s)" % r for r in tally.log),
          file=sys.stderr)
    res = dict(attempted=tally.attempted, failed=tally.failed,
               e2e={"rtf": tally.audio_s / wall}, tally=tally)
    if ctx.trace:
        traced = Tally()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("wtbench.window"):
                run_chapter(ctx, st,
                            st["order"][st["next"] % len(st["order"])],
                            traced)
                torch.cuda.synchronize()
        st["next"] += 1
        res.update(trace=T.from_profile(prof), traced=traced,
                   attempted=tally.attempted + traced.attempted,
                   failed=tally.failed + traced.failed)
    return res


def check(ctx, st, res):
    """Free the program's state, then compute the checked chapter's F0
    with the reference on the card, and for every kept copy the
    reference's y at that copy's F0, and compare them stretch by
    stretch."""
    from worldtpu_torch.parallel import graphs
    graphs.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if not st["kept"]:
        return [("checked_chapters", None)]
    c = st["checked"]
    f0r = reference_f0(ctx, st, c)
    pairs = []
    for y, f0 in st["kept"]:
        yr = reference_y(ctx, st, c, f0) if len(f0) == len(f0r) else None
        pairs += chapter_pairs(ctx, y, f0, yr, f0r)
    return compare.numbers(pairs, int(ctx.config["fs"]))


def reference_f0(ctx, st, c):
    """The reference's pitch-scaled F0 of pool chapter c (float64
    numpy)."""
    from wtbench.reference import longform as RL
    cfg = ctx.config
    x = torch.as_tensor(st["x"][c], device=ctx.device)
    return RL.harvest_f0(
        x, fs=int(cfg["fs"]), frame_period_ms=cfg["frame_period_ms"],
        f0_floor=cfg["f0_floor"], f0_ceil=cfg["f0_ceil"],
        chunk_ms=int(cfg["harvest_chunk_ms"]),
        halo_ms=int(cfg["harvest_halo_ms"])) * cfg["pitch_scale"]


def reference_y(ctx, st, c, f0):
    """The reference's y of pool chapter c at the (pitch-scaled) F0 f0.

    y is compared at the program's own F0: the synthesis carries its Q32
    phase across the whole chapter, so an F0 a last bit apart (the
    kernels' rounding in Harvest's stages) moves every later pulse by a
    growing fraction of a sample, which over ten minutes reads as a
    spectral error several times the corpus cells' (PERF.md, section 2).  The
    reference's F0 is held to the program's by the F0 numbers."""
    from wtbench.reference import longform as RL
    cfg = ctx.config
    x = torch.as_tensor(st["x"][c], device=ctx.device)
    return RL.resynthesis(x, f0, seed=noise_seed(ctx.seed, c),
                          fs=int(cfg["fs"]),
                          duration_scale=cfg["duration_scale"],
                          frame_period_ms=cfg["frame_period_ms"])


def chapter_pairs(ctx, y, f0, yr, f0r):
    """compare.numbers' pairs of one copy (y, F0) against the reference's
    (yr, f0r), stretch by stretch; one mismatched pair where the lengths
    differ (yr None)."""
    if yr is None or len(y) != len(yr) or len(f0) != len(f0r):
        return [((), (0.0,), (), ())]
    cfg = ctx.config
    fp = cfg["frame_period_ms"]
    cuts = stretches(len(f0r), fp, fp * cfg["duration_scale"],
                     int(cfg["fs"]), STRETCH_S)
    return [(y[s0:s1], yr[s0:s1], f0[a:b], f0r[a:b])
            for a, b, s0, s1 in cuts]
