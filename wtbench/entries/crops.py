"""The entry of the crops mix: training-time augmentation.  Fixed-length
crops of the cell's seeded clips, already on the card, pitch-shifted per
batch through ``parallel.batch.batch_wav_to_wav``: one key, so every batch
after set-up replays the captured program, with no reader and no key
churn.

Set-up makes the configuration's clip stretch from the seed (the corpus
mix's lengths: ``generate.corpus_lengths``) on the card and keeps it
there as float32 (16-bit PCM / 32768) and makes one noise tensor, its
pulse capacity the bound at the F0 ceiling times the highest pitch, which
no crop can pass (``inputs``); then the geometry, and ``warm_batches``
batches: an eager call, the capture and a replay.  Batch i's crops (clip and offset of
each row) and pitch scale come from the seed and i alone
(``batch_plan``); its outputs' overflow and finiteness go to pinned
memory without blocking and are counted once the next batch is queued.
The window runs batches until its time is up (the batch in flight at the
deadline runs to its end); a traced run then profiles ``traced_batches``
more.

Checked after the window: the window's first and second batches and one
drawn from the seed among the next 30 (``checked_batches``), each against
the reference at its own pitch.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from wtbench import compare, generate as G, speech
from wtbench import reference as R
from wtbench import trace as T
from wtbench.entries.corpus import Tally, _pinned, _zc_launches
from wtbench.reference.synthesis.synthesis import default_max_pulses

#: the window's batches that the check compares: its first, its second,
#: and one drawn from the next LATER
LATER = 30


def batch_plan(ctx, clip_lengths, i):
    """(clip indices [B], offsets [B], pitch scale) of batch i: B distinct
    clips, each cut at an offset uniform over its whole crops, and a pitch
    scale uniform in the mix's range."""
    mix = ctx.traffic
    rng = np.random.default_rng(G.seed_words(ctx.seed, 11, i))
    clips = rng.choice(len(clip_lengths), int(mix["batch_size"]),
                       replace=False)
    room = np.asarray(clip_lengths)[clips] - int(mix["crop_samples"])
    offsets = (rng.random(len(clips)) * (room + 1)).astype(np.int64)
    lo, hi = mix["pitch_range"]
    return clips, offsets, float(rng.uniform(lo, hi))


def checked_batches(seed):
    """The window's batch indices that the check compares."""
    rng = np.random.default_rng(G.seed_words(seed, 12))
    return (0, 1, 2 + int(rng.integers(LATER)))


def crops(st, clips, offsets):
    """[B, crop] float32 on the card: the rows of batch (clips, offsets)."""
    start = torch.as_tensor(st["starts"][clips] + offsets,
                            device=st["audio"].device)
    return st["audio"][start[:, None] + st["span"]]


def inputs(ctx):
    """What set-up makes from the seed, without the program: the clips on
    the card, the noise, the output length and the pulse capacity."""
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    fs, n = int(cfg["fs"]), int(mix["crop_samples"])
    lengths = G.corpus_lengths(cfg, mix)
    if min(lengths) < n:
        raise ValueError(f"a clip of {min(lengths)} samples is shorter "
                         f"than a crop of {n}")
    pcm = speech.utterances(fs, lengths, ctx.seed, dev)
    audio = torch.as_tensor(np.concatenate(pcm), device=dev).float() \
        / 32768.0
    fp, dur = cfg["frame_period_ms"], cfg["duration_scale"]
    sz = R.sizes(fs, n, frame_period_ms=fp, duration_scale=dur,
                 f0_floor=cfg["f0_floor"], f0_ceil=cfg["f0_ceil"])
    ol = G.out_length(sz["n_frames"], fp * dur, fs)
    mp = default_max_pulses(ol, fs, f0_ceil=cfg["f0_ceil"]
                            * max(mix["pitch_range"]))
    gen = torch.Generator(device=dev).manual_seed(G.seed_words(ctx.seed, 4,
                                                               n))
    noise = torch.randn((int(mix["batch_size"]), mp, sz["fft_size"]),
                        generator=gen, device=dev)
    return dict(lengths=lengths, audio=audio,
                starts=np.concatenate([[0], np.cumsum(lengths)[:-1]]),
                span=torch.arange(n, device=dev), out_length=ol,
                max_pulses=mp, noise=noise)


def setup(ctx):
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.analysis.harvest import HarvestGeometry
    cfg = ctx.config
    st = inputs(ctx)
    st.update(geo=HarvestGeometry(
        int(cfg["fs"]), int(ctx.traffic["crop_samples"]),
        f0_floor=cfg["f0_floor"], f0_ceil=cfg["f0_ceil"],
        frame_period=cfg["frame_period_ms"]),
        ck=CheapTrickKernel(int(cfg["fs"])), next=0,
        checked=checked_batches(ctx.seed), kept={})
    run_batches(ctx, st, Tally(), count=int(ctx.traffic["warm_batches"]))
    return st


def _call(ctx, st, x, pitch):
    from worldtpu_torch.parallel.batch import batch_wav_to_wav
    cfg, ck = ctx.config, st["ck"]
    return batch_wav_to_wav(
        x, st["noise"], geo=st["geo"], fs=int(cfg["fs"]),
        fft_size=ck.fft_size, max_half_window=ck.max_half_window,
        frame_period_s=cfg["frame_period_ms"] / 1000.0
        * cfg["duration_scale"], out_length=st["out_length"],
        max_pulses=st["max_pulses"], pitch_scale=pitch,
        return_overflow=True)


def run_batches(ctx, st, tally, count=None, deadline=None, keep=None):
    """Batches st["next"], st["next"] + 1, ... until ``count`` ran or the
    clock passed ``deadline``; each batch's flags are counted once the
    next one is queued.  ``keep``: {index in this stretch: key} of batches
    whose inputs and outputs go to st["kept"][key]."""
    fs, n = int(ctx.config["fs"]), int(ctx.traffic["crop_samples"])
    pending, i = None, 0
    while (count is None or i < count) and (
            deadline is None or time.perf_counter() < deadline):
        clips, offsets, pitch = batch_plan(ctx, st["lengths"], st["next"])
        x = crops(st, clips, offsets)
        z0 = _zc_launches()
        t = time.perf_counter()
        with record_function("wtbench.batch"):
            y, f0, ovf = _call(ctx, st, x, pitch)
        tally.call_s += time.perf_counter() - t
        tally.zc.append((n, _zc_launches() - z0))
        bad = ovf | ~torch.isfinite(y).all(dim=1)
        host = _pinned(torch.empty(bad.shape, dtype=bad.dtype))
        host.copy_(bad, non_blocking=True)
        done = torch.cuda.Event() if x.device.type == "cuda" else None
        if done is not None:
            done.record()
        if keep and i in keep:
            st["kept"][keep[i]] = (clips, offsets, pitch, y, f0)
        if pending is not None:
            _count(tally, *pending, n / fs)
        pending = (host, done)
        st["next"] += 1
        i += 1
    if pending is not None:
        _count(tally, *pending, n / fs)


def _count(tally, host, done, seconds):
    with record_function("wtbench.outputs"):
        if done is not None:
            t = time.perf_counter()
            done.synchronize()
            tally.wait_s += time.perf_counter() - t
        bad = host.numpy()
    tally.attempted += len(bad)
    tally.failed += int(bad.sum())
    tally.audio_s += seconds * int((~bad).sum())
    tally.batches += 1


def window(ctx, st, seconds):
    tally = Tally()
    t0 = time.perf_counter()
    run_batches(ctx, st, tally, deadline=t0 + seconds,
                keep={k: k for k in st["checked"]})
    wall = time.perf_counter() - t0
    print(f"window: {tally.batches} batches, {tally.attempted} crops, "
          f"{tally.failed} failed; host s in the call {tally.call_s:.3f}, "
          f"waiting {tally.wait_s:.3f}", file=sys.stderr)
    res = dict(attempted=tally.attempted, failed=tally.failed,
               e2e={"rtf": tally.audio_s / wall}, tally=tally,
               config=ctx.config, batch_size=int(ctx.traffic["batch_size"]))
    if ctx.trace:
        traced = Tally()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("wtbench.window"):
                run_batches(ctx, st, traced,
                            count=int(ctx.traffic["traced_batches"]))
                torch.cuda.synchronize()
        res.update(trace=T.from_profile(prof), traced=traced,
                   attempted=tally.attempted + traced.attempted,
                   failed=tally.failed + traced.failed)
    return res


def check(ctx, st, res):
    """Free the program's state, then compute each kept batch with the
    reference from the same crops, noise and pitch and compare them."""
    from worldtpu_torch.parallel import graphs
    graphs.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    cfg = ctx.config
    fs, fp, dur = int(cfg["fs"]), cfg["frame_period_ms"], \
        cfg["duration_scale"]
    pairs = []
    for k in st["checked"]:
        if k not in st["kept"]:
            continue
        clips, offsets, pitch, y, f0 = st["kept"][k]
        yr, f0r, _ = reference_batch(ctx, st, clips, offsets, pitch)
        y, f0 = y.cpu().numpy(), f0.cpu().numpy()
        pairs += [(y[r], yr[r], f0[r], f0r[r]) for r in range(len(clips))]
    if not pairs:
        return [("checked_batches", None)]
    return compare.numbers(pairs, fs)


def reference_batch(ctx, st, clips, offsets, pitch):
    """The reference's (y, f0, overflow) of one batch, as numpy."""
    cfg = ctx.config
    y, f0, ovf = R.wav_to_wav(
        crops(st, clips, offsets), st["noise"], fs=int(cfg["fs"]),
        pitch_scale=pitch, frame_period_ms=cfg["frame_period_ms"],
        duration_scale=cfg["duration_scale"], out_length=st["out_length"],
        f0_floor=cfg["f0_floor"], f0_ceil=cfg["f0_ceil"])
    return y.cpu().numpy(), f0.cpu().numpy(), ovf.cpu().numpy()
