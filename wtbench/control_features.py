"""The control of a feature cell's comparison, and planted faults: the plain
reference put in the program's place and computed otherwise, compared with
the reference as a run of the cell compares the program.

    python3 wtbench/control_features.py --workload ljspeech-22k-tts.features --seeds 11,12,13 [--fault tf32]

``--fault``:

  tf32   the control: one precision step below the configuration's
         (float32 with TF32 matrix products, where the configuration
         states float32 without)
  ap3db  D4C's aperiodicity 3 dB higher, held under 1 (``control.py``'s)
  fft16  every FFT of CheapTrick and D4C with its input and its output
         rounded to float16's precision (a spectral stage computed in half
         precision, without half precision's range)
  none   the reference against itself

Prints one JSON line a seed with the numbers ``compare_features.numbers``
gives and the seconds the reference computations took.  Needs a card; it
loads nothing of the program.  Each seed's inputs and checked batches are
the ones a run of the cell makes and checks from it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import types

FAULTS = ("none", "tf32", "ap3db", "fft16")


def _half(t):
    """t rounded to float16's precision, its 11-bit significand (round half
    to even), a complex tensor part by part.  float32's exponent range is
    kept, so nothing overflows or underflows: a fault of precision, not of
    range (D4C's group delay reaches 1e12, past float16's 65,504)."""
    import torch
    if t.is_complex():
        return torch.complex(_half(t.real), _half(t.imag))
    m, e = torch.frexp(t)
    return torch.ldexp(torch.round(m * 2048.0) / 2048.0, e)


def half_dft(dft):
    """A stand-in for the reference's ``ops.dft`` whose transforms round
    their input and their output to float16's precision."""
    return types.SimpleNamespace(
        rfft=lambda x, n=None: _half(dft.rfft(_half(x), n=n)),
        irfft=lambda X, n=None: _half(dft.irfft(_half(X), n=n)),
        rfft_real=lambda x, n=None: _half(dft.rfft_real(_half(x), n=n)))


@contextlib.contextmanager
def fault(name):
    """The reference with ``name`` planted for the duration."""
    from wtbench import control
    from wtbench.reference.analysis import cheaptrick as RCT, d4c as RD4
    if name != "fft16":
        with control.fault(name):
            yield
        return
    saved = RCT.dft, RD4.dft
    try:
        RCT.dft, RD4.dft = half_dft(RCT.dft), half_dft(RD4.dft)
        yield
    finally:
        RCT.dft, RD4.dft = saved


def feature_pairs(ctx, planted):
    """The pairs of the checked batches: the reference with ``planted`` in
    the program's place against the reference."""
    import torch
    from wtbench import generate as G, speech
    from wtbench.entries import corpus_features as FE
    cfg, mix = ctx.config, ctx.traffic
    lengths = G.corpus_lengths(cfg, mix)
    st = dict(lengths=lengths, batches=G.corpus_batches(lengths, cfg, mix),
              pcm=speech.utterances(int(cfg["fs"]), lengths, ctx.seed,
                                    ctx.device))
    pairs = []
    for k in FE.checked_batches(st["batches"], ctx.seed):
        x, idx = FE.batch_input(ctx, st, k)
        outs = []
        for name in ("none", planted):
            with fault(name):
                outs.append([o.cpu().numpy() for o in FE.reference_batch(
                    ctx, torch.from_numpy(x).to(ctx.device))])
        ref, got = outs
        kept = [([f"u{i:04d}" for i in idx],
                 *[[o[r, :G.n_frames(lengths[i], int(cfg["fs"]),
                                     cfg["frame_period_ms"])]
                    for r, i in enumerate(idx)] for o in got])]
        pairs += FE.reference_pairs(ctx, st, k, ref, kept)
    return pairs


def main():
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import torch
    from wtbench import compare_features, control, harness as Hn
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="ljspeech-22k-tts.features")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=FAULTS, default="tf32")
    args = ap.parse_args()
    cell = control.workload(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mix = Hn.config(cell["config"]), Hn.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Hn.Context(workload=cell, config=cfg, traffic=mix, seed=seed,
                         device=torch.device("cuda", 0), trace=False)
        t = time.perf_counter()
        pairs = feature_pairs(ctx, args.fault)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "fault": args.fault,
                          "seconds": time.perf_counter() - t,
                          "numbers": dict(compare_features.numbers(pairs))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
