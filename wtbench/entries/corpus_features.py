"""The entry of the feature mix: a length-sorted corpus stretch, written as
16-bit wavs, streamed in passes through ``io.corpus.iter_corpus`` (the C++
reader) into ``parallel.batch.batch_features``, each batch's F0, coded
envelope and coded aperiodicity copied to pinned memory without blocking
and cut to each clip's frames, fill rows dropped, while the next batch
runs: what a feature-extraction job for TTS training stores.

Set-up writes the stretch under the temporary directory, makes one
``HarvestGeometry`` per padded length and runs one whole pass.  The
program's key is the padded length T alone (``batch_features`` takes no
frame count), so the stretch's three lengths are three programs, which the
graph cache's four hold: set-up's pass makes each length's eager call and
capture, and every batch of the window replays.  The window runs whole
passes until its time is up (the pass in flight at the deadline runs to
its end).  A traced run then profiles one more whole pass.

Checked after the window: three batches of one padded length, drawn from
the seed (its first, second and one later batch: in set-up's pass the
eager call, the capture and a replay), in every pass that ran them, set-up's
included.
"""

from __future__ import annotations

import collections
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from wtbench import compare_features, generate as G, speech
from wtbench import trace as T
from wtbench.entries import corpus as CE

#: stretch batches whose outputs the check compares (one key's first,
#: second and one later batch)
CHECKED = 3


def checked_batches(batches, seed):
    """Indices of the CHECKED batches of one padded length drawn from the
    seed."""
    runs = collections.defaultdict(list)
    for k, (_, _, T_, _) in enumerate(batches):
        runs[T_].append(k)
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
        CE.write_wav(root / f"u{i:04d}.wav", p, fs)
    batches = G.corpus_batches(lengths, cfg, mix)
    geos = {T_: HarvestGeometry(fs, T_, f0_floor=cfg["f0_floor"],
                                f0_ceil=cfg["f0_ceil"],
                                frame_period=cfg["frame_period_ms"])
            for T_ in sorted({b[2] for b in batches})}
    st = dict(root=root, pcm=pcm, lengths=lengths, batches=batches,
              geos=geos, ck=CheapTrickKernel(fs),
              checked=checked_batches(batches, ctx.seed),
              kept=collections.defaultdict(list))
    run_pass(ctx, st, CE.Tally())
    return st


def run_pass(ctx, st, tally, keep=True):
    """One whole pass of the stretch."""
    from worldtpu_torch.io import corpus as CO
    from worldtpu_torch.parallel.batch import batch_features
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    fs, ck = int(cfg["fs"]), st["ck"]
    it = CO.iter_corpus(st["root"], int(mix["batch_size"]), fs=fs,
                        frame_period_ms=cfg["frame_period_ms"],
                        pad_to=int(mix["pad_to"]),
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
        xb = CE._pinned(torch.from_numpy(b.x)).to(dev, non_blocking=True)
        z0 = CE._zc_launches()
        t = time.perf_counter()
        with record_function("wtbench.batch"):
            outs = batch_features(
                xb, geo=st["geos"][b.x.shape[1]], fs=fs,
                fft_size=ck.fft_size, max_half_window=ck.max_half_window,
                n_dims=int(cfg["n_dims"]), pitch_scale=cfg["pitch_scale"])
        tally.call_s += time.perf_counter() - t
        tally.zc.append((b.x.shape[1], CE._zc_launches() - z0))
        host = [CE._pinned(torch.empty(v.shape, dtype=v.dtype))
                for v in outs]
        for h, v in zip(host, outs):
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
    """Cut batch k's outputs to each clip's frames once they are on the
    host, count them, and keep the checked batches' outputs."""
    with record_function("wtbench.outputs"):
        if done is not None:
            t = time.perf_counter()
            done.synchronize()
            tally.wait_s += time.perf_counter() - t
        fs = int(ctx.config["fs"])
        rows = np.flatnonzero(b.valid)
        cut = [[h[i, :b.n_frames[i]].numpy() for i in rows] for h in host]
        for r, i in enumerate(rows):
            bad = not all(np.isfinite(c[r]).all() for c in cut)
            tally.attempted += 1
            tally.failed += bad
            tally.audio_s += 0.0 if bad else b.lengths[i] / fs
        tally.batches += 1
        if keep and k in st["checked"]:
            st["kept"][k].append(([b.names[i] for i in rows],
                                  *[[a.copy() for a in c] for c in cut]))


def window(ctx, st, seconds):
    tally = CE.Tally()
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + seconds:
        run_pass(ctx, st, tally)
    wall = time.perf_counter() - t0
    print(f"window: {tally.batches} batches, {tally.attempted} utterances, "
          f"{tally.failed} failed", file=sys.stderr)
    print("passes (wall, read, call, wait) s: " + ", ".join(
        "(%.3f, %.3f, %.3f, %.3f)" % p for p in tally.passes),
          file=sys.stderr)
    res = dict(attempted=tally.attempted, failed=tally.failed,
               e2e={"rtf": tally.audio_s / wall},
               tally=tally, config=ctx.config,
               batch_size=int(ctx.traffic["batch_size"]))
    if ctx.trace:
        traced = CE.Tally()
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


def batch_input(ctx, st, k):
    """Batch k of the stretch as the program reads it: [B, T] float32
    (pcm / 32768, fill rows repeating the last clip) and the stretch
    indices of its clips."""
    first, count, T_, _ = st["batches"][k]
    idx = np.argsort(st["lengths"], kind="stable")[first:first + count]
    x = np.zeros((int(ctx.traffic["batch_size"]), T_), np.float32)
    for r, i in enumerate(idx):
        x[r, :len(st["pcm"][i])] = st["pcm"][i] / 32768.0
    x[count:] = x[count - 1]
    return x, idx


def reference_batch(ctx, x):
    """The plain reference's features of x [B, T] on its device: (F0
    [B, F], coded envelope [B, F, n_dims], coded aperiodicity [B, F,
    n_ap]), the analysis and its pitch scale as ``wtbench.reference``'s
    ``wav_to_wav`` has them."""
    from wtbench import reference as R
    from wtbench.reference import codec as RC
    cfg = ctx.config
    fs, fp = int(cfg["fs"]), cfg["frame_period_ms"]
    sz = R.sizes(fs, x.shape[1], frame_period_ms=fp, duration_scale=1.0,
                 f0_floor=cfg["f0_floor"], f0_ceil=cfg["f0_ceil"])
    fft, n = sz["fft_size"], sz["n_frames"]
    mean = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    f0 = R.H.harvest_device_full(x, mean, geo=sz["geo"], n_out=n)
    scale = torch.full((), cfg["pitch_scale"], dtype=x.dtype,
                       device=x.device)
    f0 = (f0 * scale).to(f0.dtype)
    tpos = torch.arange(n, dtype=x.dtype, device=x.device) * (fp / 1000.0)
    spec = R.cheaptrick_frames(x, f0, tpos, fs=fs, fft_size=fft,
                               max_half_window=sz["max_half_window"])
    ap = R.d4c_frames(x, f0, tpos, fs=fs, fft_size_out=fft)
    B, F, K = spec.shape
    mcep = RC.code_spectral_envelope(spec.reshape(B * F, K), fs=fs,
                                     fft_size=fft, n_dims=int(cfg["n_dims"]))
    bap = RC.code_aperiodicity(ap.reshape(B * F, K), fs=fs, fft_size=fft)
    return f0, mcep.reshape(B, F, -1), bap.reshape(B, F, -1)


def reference_pairs(ctx, st, k, outs, kept):
    """The pairs of batch k: each kept copy's clips against the reference's
    outputs ``outs`` (numpy), cut to each clip's frames."""
    fs, fp = int(ctx.config["fs"]), ctx.config["frame_period_ms"]
    f0, mcep, bap = outs
    _, idx = batch_input(ctx, st, k)
    names = [f"u{i:04d}" for i in idx]
    pairs = []
    for got_names, f0s, mceps, baps in kept:
        if got_names != names:
            pairs += [((), (0.0,), (), (), (), ())] * len(idx)
            continue
        for r, i in enumerate(idx):
            nf = G.n_frames(st["lengths"][i], fs, fp)
            pairs.append((f0s[r], f0[r, :nf], mceps[r], mcep[r, :nf],
                          baps[r], bap[r, :nf]))
    return pairs


def check(ctx, st, res):
    """Free the program's state, then compute the checked batches with the
    reference on the same wavs and compare every kept copy."""
    from worldtpu_torch.parallel import graphs
    graphs.clear()
    torch.cuda.empty_cache()
    pairs = []
    for k in st["checked"]:
        x, _ = batch_input(ctx, st, k)
        outs = [o.cpu().numpy() for o in reference_batch(
            ctx, torch.from_numpy(x).to(ctx.device))]
        pairs += reference_pairs(ctx, st, k, outs, st["kept"].get(k, []))
    if not pairs:
        return [("checked_batches", None)]
    return compare_features.numbers(pairs)
