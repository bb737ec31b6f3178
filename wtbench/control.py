"""The control of a cell's comparison, and a planted fault: the plain
reference put in the program's place and computed otherwise, compared with
the reference as a run compares the program.

    python3 wtbench/control.py --workload CONFIG.TRAFFIC --seeds 11,12,13 [--fault tf32]

``--fault``:

  tf32   the control: one precision step below the configuration's
         (float32 with TF32 matrix products, where the configurations state
         float32 without)
  ap3db  D4C's aperiodicity 3 dB higher, held under 1 (a wrong
         aperiodicity)
  none   the reference against itself: F0 exact, y to the card's
         floating-point atomics (envelope ~1e-8, ~1e-5 dB)

Prints one JSON line a seed with the numbers ``compare.numbers`` gives.
Needs a card; it loads nothing of the program.  Each seed's inputs are
those a run of the cell makes from it, and the checked items are the ones
a run checks: a corpus cell's three batches of one key.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

FAULTS = ("none", "tf32", "ap3db")


@contextlib.contextmanager
def fault(name):
    """The reference with ``name`` planted for the duration."""
    import torch
    from wtbench import reference as R
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, R.d4c_frames)
    try:
        if name == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        elif name == "ap3db":
            d4c = R.d4c_frames
            R.d4c_frames = lambda *a, **k: (d4c(*a, **k)
                                            * 10.0 ** (3.0 / 20.0)).clamp(
                max=0.999999)
        elif name != "none":
            raise ValueError(f"unknown fault {name!r}")
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, R.d4c_frames) = saved


def corpus_pairs(ctx, planted):
    """(y, y_ref, f0, f0_ref) of each checked utterance, the reference with
    the fault ``planted`` in the program's place."""
    import numpy as np
    import torch
    from wtbench import generate as G, speech
    from wtbench import reference as R
    from wtbench.entries import corpus as CE
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    fs, fp, dur = int(cfg["fs"]), cfg["frame_period_ms"], \
        cfg["duration_scale"]
    lengths = G.corpus_lengths(cfg, mix)
    pcm = speech.utterances(fs, lengths, ctx.seed, dev)
    batches = G.corpus_batches(lengths, cfg, mix)
    order = np.argsort(lengths, kind="stable")
    pairs = []
    for k in CE.checked_batches(batches, ctx.seed):
        first, count, T_, F = batches[k]
        idx = order[first:first + count]
        x = np.zeros((int(mix["batch_size"]), T_), np.float32)
        for r, i in enumerate(idx):
            x[r, :len(pcm[i])] = pcm[i] / 32768.0
        ol = G.out_length(F, fp * dur, fs)
        mp = CE.default_max_pulses(ol, fs,
                                   f0_ceil=cfg["f0_ceil"] * cfg["pitch_scale"])
        gen = torch.Generator(device=dev).manual_seed(
            G.seed_words(ctx.seed, 4, T_, F))
        fft = R.sizes(fs, T_, frame_period_ms=fp,
                      duration_scale=dur)["fft_size"]
        noise = torch.randn((x.shape[0], mp, fft), generator=gen, device=dev)
        outs = []
        for name in ("none", planted):
            with fault(name):
                y, f0, _ = R.wav_to_wav(
                    torch.from_numpy(x).to(dev), noise, fs=fs,
                    pitch_scale=cfg["pitch_scale"], frame_period_ms=fp,
                    duration_scale=dur, out_length=ol,
                    f0_floor=cfg["f0_floor"], f0_ceil=cfg["f0_ceil"])
            outs.append((y.cpu().numpy(), f0.cpu().numpy()))
        (yr, fr), (yc, fc) = outs
        for r, i in enumerate(idx):
            nf = G.n_frames(lengths[i], fs, fp)
            n = G.out_length(nf, fp * dur, fs)
            pairs.append((yc[r, :n], yr[r, :n], fc[r, :nf], fr[r, :nf]))
    return pairs


def workload(name):
    """The cell ``<config>.<traffic>`` (whether or not ``BENCHMARK.json``
    lists it yet)."""
    config, traffic = name.rsplit(".", 1)
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}


def main():
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import torch
    from wtbench import compare, harness as Hn
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=FAULTS, default="tf32")
    args = ap.parse_args()
    cell = workload(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cfg, mix = Hn.config(cell["config"]), Hn.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Hn.Context(workload=cell, config=cfg, traffic=mix, seed=seed,
                         device=torch.device("cuda", 0), trace=False)
        pairs = corpus_pairs(ctx, args.fault)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "fault": args.fault,
                          "numbers": dict(compare.numbers(
                              pairs, int(cfg["fs"])))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
