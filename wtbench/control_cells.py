"""The control and the planted fault of the cells that ``control.py``
does not drive: ``librivox-22k.long`` (one chapter) and
``ljspeech-22k.crops`` (three batches, each at its own pitch).  The plain
reference is put in the program's place and computed otherwise
(``control.fault``), then compared with the reference as a run compares
the program.

    python3 wtbench/control_cells.py --workload librivox-22k.long --seeds 11,12,13 [--fault tf32]

``--fault``: ``tf32`` (the control), ``ap3db`` or ``none`` (the reference
against itself), as ``control.py`` has them.  Prints one JSON line a seed
with the numbers ``compare.numbers`` gives and the seconds the
reference computations took.  Needs a card; loads nothing of the
program.  Each seed's inputs and checked items are the ones a run of the
cell makes and checks from it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def long_pairs(ctx, planted):
    """The checked chapter stretch by stretch, the reference with
    ``planted`` in the program's place: its F0 against the reference's,
    its y against the reference's y at its own F0, as a run compares the
    program's."""
    import numpy as np
    from wtbench import speech
    from wtbench.control import fault
    from wtbench.entries import long as L
    cfg = ctx.config
    pcm = speech.utterances(int(cfg["fs"]), L.chapter_lengths(cfg, ctx.seed),
                            ctx.seed, ctx.device)
    st = dict(x=[p.astype(np.float32) / np.float32(32768.0) for p in pcm])
    c = L.checked_chapter(cfg, ctx.seed)
    f0r = L.reference_f0(ctx, st, c)
    with fault(planted):
        f0 = L.reference_f0(ctx, st, c)
        y = L.reference_y(ctx, st, c, f0)
    return L.chapter_pairs(ctx, y, f0, L.reference_y(ctx, st, c, f0), f0r)


def crops_pairs(ctx, planted):
    """The three checked batches: (y, y_ref, F0, F0_ref) of each row."""
    from wtbench.control import fault
    from wtbench.entries import crops as CR
    st = CR.inputs(ctx)
    warm = int(ctx.traffic["warm_batches"])
    pairs = []
    for k in CR.checked_batches(ctx.seed):
        plan = CR.batch_plan(ctx, st["lengths"], warm + k)
        outs = []
        for name in ("none", planted):
            with fault(name):
                outs.append(CR.reference_batch(ctx, st, *plan))
        (yr, fr, _), (yc, fc, _) = outs
        pairs += [(yc[r], yr[r], fc[r], fr[r]) for r in range(len(yr))]
    return pairs


PAIRS = {"long": long_pairs, "crops": crops_pairs}


def main():
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import torch
    from wtbench import compare, control, harness as Hn
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=control.FAULTS, default="tf32")
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
        pairs = PAIRS[mix["entry"]](ctx, args.fault)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "fault": args.fault,
                          "seconds": time.perf_counter() - t,
                          "numbers": dict(compare.numbers(
                              pairs, int(cfg["fs"])))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
