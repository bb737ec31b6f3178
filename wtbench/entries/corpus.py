"""The entry of the corpus mixes: a length-sorted corpus stretch, written as
16-bit wavs, streamed in passes through ``io.corpus.iter_corpus`` (the C++
reader) into ``parallel.batch.batch_wav_to_wav``, each batch's outputs
copied to pinned memory without blocking and cut by
``CorpusBatch.slice_outputs`` while the next batch runs.

Set-up writes the stretch under the temporary directory, makes one
``HarvestGeometry`` per padded length and one noise tensor per (T, F) key
from the seed (its pulse capacity the bound at the pitch-scaled F0 ceiling,
which no utterance can pass), and runs one whole pass, so the window starts where a pass
in the middle of a corpus job does: the graph cache holding the last keys
of the pass before.  The window runs whole passes until its time is up
(the pass in flight at the deadline runs to its end).  A traced run then profiles one more whole pass.

Checked after the window: three batches of one key, drawn from the seed
(the key's first batch, its second and one later: its eager call, its
capture and a replay), in every pass that ran them.
"""

from __future__ import annotations

import collections
import dataclasses
import pathlib
import shutil
import sys
import tempfile
import time
import wave

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from wtbench import compare, generate as G, speech
from wtbench import reference as R
from wtbench import trace as T
from wtbench.reference.synthesis.synthesis import default_max_pulses

#: stretch batches whose outputs the check compares (one key's first,
#: second and one later batch)
CHECKED = 3


def write_wav(path, pcm, fs):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.astype("<i2").tobytes())


def checked_batches(batches, seed):
    """Indices of the CHECKED batches of one key drawn from the seed."""
    runs = collections.defaultdict(list)
    for k, (_, _, T_, F) in enumerate(batches):
        runs[(T_, F)].append(k)
    keys = sorted(key for key, ks in runs.items() if len(ks) >= CHECKED)
    rng = np.random.default_rng(G.seed_words(seed, 5))
    ks = runs[keys[int(rng.integers(len(keys)))]]
    return [ks[0], ks[1], ks[int(rng.integers(2, len(ks)))]]


def setup(ctx):
    from worldtpu_torch.analysis.harvest import HarvestGeometry
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    fs = int(cfg["fs"])
    lengths = G.corpus_lengths(cfg, mix)
    pcm = speech.utterances(fs, lengths, ctx.seed, dev)
    root = pathlib.Path(tempfile.gettempdir()) / "wtbench" / \
        ctx.workload["name"]
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for i, p in enumerate(pcm):
        write_wav(root / f"u{i:04d}.wav", p, fs)
    batches = G.corpus_batches(lengths, cfg, mix)
    ck = CheapTrickKernel(fs)
    fp, dur, pitch = cfg["frame_period_ms"], cfg["duration_scale"], \
        cfg["pitch_scale"]
    shapes = {}
    for _, _, T_, F in batches:
        if (T_, F) in shapes:
            continue
        geo = next((s["geo"] for (t, _), s in shapes.items() if t == T_),
                   None) or HarvestGeometry(
            fs, T_, f0_floor=cfg["f0_floor"], f0_ceil=cfg["f0_ceil"],
            frame_period=fp)
        ol = G.out_length(F, fp * dur, fs)
        mp = default_max_pulses(ol, fs, f0_ceil=cfg["f0_ceil"] * pitch)
        gen = torch.Generator(device=dev).manual_seed(
            G.seed_words(ctx.seed, 4, T_, F))
        shapes[(T_, F)] = dict(geo=geo, out_length=ol, max_pulses=mp,
                               noise=torch.randn(
                                   (int(mix["batch_size"]), mp, ck.fft_size),
                                   generator=gen, device=dev))
    st = dict(root=root, pcm=pcm, lengths=lengths, batches=batches,
              shapes=shapes, ck=ck, checked=checked_batches(batches,
                                                            ctx.seed),
              kept=collections.defaultdict(list))
    run_pass(ctx, st, Tally(), keep=False)
    return st


@dataclasses.dataclass
class Tally:
    """What a stretch of passes did: utterances attempted and failed, the
    input audio completed (s), batches, host seconds in the reader and in
    the entry and waiting for the card's outputs, (T, zc launches) of each
    batch, and (wall, read, call, wait) seconds of each whole pass."""
    attempted: int = 0
    failed: int = 0
    overflowed: int = 0
    audio_s: float = 0.0
    batches: int = 0
    read_s: float = 0.0
    call_s: float = 0.0
    wait_s: float = 0.0
    zc: list = dataclasses.field(default_factory=list)
    passes: list = dataclasses.field(default_factory=list)


def _zc_launches():
    from worldtpu_torch import _build
    return getattr(_build, "launches", {}).get("wt_zc", 0)


def _pinned(t):
    """t in page-locked memory when there is a card to copy to or from."""
    return t.pin_memory() if torch.cuda.is_available() else t


def run_pass(ctx, st, tally, keep=True):
    """One whole pass of the stretch."""
    from worldtpu_torch.io import corpus as CO
    from worldtpu_torch.parallel.batch import batch_wav_to_wav
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    fs, ck = int(cfg["fs"]), st["ck"]
    fp, dur = cfg["frame_period_ms"], cfg["duration_scale"]
    it = CO.iter_corpus(st["root"], int(mix["batch_size"]), fs=fs,
                        frame_period_ms=fp, pad_to=int(mix["pad_to"]),
                        frames_to=int(mix["frames_to"]))
    pending, k = None, 0
    t_pass = time.perf_counter()
    before = (tally.read_s, tally.call_s, tally.wait_s)
    while True:
        t = time.perf_counter()
        with record_function("wtbench.read"):
            b = next(it, None)
        tally.read_s += time.perf_counter() - t
        if b is None:
            break
        sh = st["shapes"][(b.x.shape[1], b.F)]
        xb = _pinned(torch.from_numpy(b.x)).to(dev, non_blocking=True)
        z0 = _zc_launches()
        t = time.perf_counter()
        with record_function("wtbench.batch"):
            y, f0, ovf = batch_wav_to_wav(
                xb, sh["noise"], geo=sh["geo"], fs=fs, fft_size=ck.fft_size,
                max_half_window=ck.max_half_window,
                frame_period_s=fp / 1000.0 * dur, out_length=sh["out_length"],
                max_pulses=sh["max_pulses"], pitch_scale=cfg["pitch_scale"],
                return_overflow=True)
        tally.call_s += time.perf_counter() - t
        tally.zc.append((b.x.shape[1], _zc_launches() - z0))
        host = [_pinned(torch.empty(v.shape, dtype=v.dtype))
                for v in (y, f0, ovf)]
        for h, v in zip(host, (y, f0, ovf)):
            h.copy_(v, non_blocking=True)
        done = torch.cuda.Event() if dev.type == "cuda" else None
        if done is not None:
            done.record()
        if pending is not None:
            _finish(ctx, st, tally, *pending, keep=keep)
        pending = (k, b, host, done)
        k += 1
    if pending is not None:
        _finish(ctx, st, tally, *pending, keep=keep)
    tally.passes.append((time.perf_counter() - t_pass, *(
        a - b for a, b in zip((tally.read_s, tally.call_s, tally.wait_s),
                              before))))


def _finish(ctx, st, tally, k, b, host, done, keep):
    """Cut batch k's outputs once they are on the host, count them, and
    keep the checked batches' outputs."""
    hy, hf, ho = host
    with record_function("wtbench.outputs"):
        if done is not None:
            t = time.perf_counter()
            done.synchronize()
            tally.wait_s += time.perf_counter() - t
        # the cut at the synthesis frame period: slice_outputs cuts at the
        # batch's frame period, which the duration scale stretches
        out = dataclasses.replace(
            b, frame_period_ms=b.frame_period_ms
            * ctx.config["duration_scale"])
        ys = out.slice_outputs(hy)
        rows = np.flatnonzero(b.valid)
        fs = int(ctx.config["fs"])
        f0s = [hf[i, :b.n_frames[i]].numpy() for i in rows]
        ovf = ho.numpy()
        for y, i in zip(ys, rows):
            bad = bool(ovf[i]) or not np.isfinite(y).all()
            tally.overflowed += bool(ovf[i])
            tally.attempted += 1
            tally.failed += bad
            tally.audio_s += 0.0 if bad else b.lengths[i] / fs
        tally.batches += 1
        if keep and k in st["checked"]:
            st["kept"][k].append(([b.names[i] for i in rows],
                                  [y.copy() for y in ys],
                                  [f.copy() for f in f0s]))


def window(ctx, st, seconds):
    tally = Tally()
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + seconds:
        run_pass(ctx, st, tally)
    wall = time.perf_counter() - t0
    print(f"window: {tally.batches} batches, {tally.attempted} utterances, "
          f"{tally.failed} failed ({tally.overflowed} overflowed)",
          file=sys.stderr)
    # each pass's wall and its host seconds reading, in the entry and
    # waiting for the card: where a slow run lost its time
    print("passes (wall, read, call, wait) s: " + ", ".join(
        "(%.3f, %.3f, %.3f, %.3f)" % p for p in tally.passes),
          file=sys.stderr)
    res = dict(attempted=tally.attempted, failed=tally.failed,
               e2e={"rtf": tally.audio_s / wall}, tally=tally,
               config=ctx.config, batch_size=int(ctx.traffic["batch_size"]))
    if ctx.trace:
        traced = Tally()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("wtbench.window"):
                run_pass(ctx, st, traced)
                torch.cuda.synchronize()
        res.update(trace=T.from_profile(prof), traced=traced,
                   attempted=tally.attempted + traced.attempted,
                   failed=tally.failed + traced.failed)
    return res


def check(ctx, st, res):
    """Free the program's state, then compute the checked batches with the
    reference on the same wavs and noise and compare every kept copy."""
    from worldtpu_torch.parallel import graphs
    graphs.clear()
    torch.cuda.empty_cache()
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    fs, fp, dur = int(cfg["fs"]), cfg["frame_period_ms"], \
        cfg["duration_scale"]
    order = np.argsort(st["lengths"], kind="stable")
    pairs = []
    for k in st["checked"]:
        first, count, T_, F = st["batches"][k]
        idx = order[first:first + count]
        B = int(mix["batch_size"])
        x = np.zeros((B, T_), np.float32)
        for r, i in enumerate(idx):
            x[r, :len(st["pcm"][i])] = st["pcm"][i] / 32768.0
        for r in range(count, B):                 # fill rows
            x[r] = x[count - 1]
        sh = st["shapes"][(T_, F)]
        y, f0, _ = R.wav_to_wav(
            torch.from_numpy(x).to(dev), sh["noise"], fs=fs,
            pitch_scale=cfg["pitch_scale"], frame_period_ms=fp,
            duration_scale=dur, out_length=sh["out_length"],
            f0_floor=cfg["f0_floor"], f0_ceil=cfg["f0_ceil"])
        y, f0 = y.cpu().numpy(), f0.cpu().numpy()
        names = [f"u{i:04d}" for i in idx]
        for got_names, ys, f0s in st["kept"].get(k, []):
            if got_names != names:
                pairs += [((), (0.0,), (), ())] * count
                continue
            for r, i in enumerate(idx):
                nf = G.n_frames(st["lengths"][i], fs, fp)
                n = G.out_length(nf, fp * dur, fs)
                pairs.append((ys[r], y[r, :n], f0s[r], f0[r, :nf]))
    if not pairs:
        return [("checked_batches", None)]
    return compare.numbers(pairs, fs)
