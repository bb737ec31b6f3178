"""Print the stage and span split of one traced chapter of
``librivox-22k.long``: device ms a chapter under each stage's marks (the
long-audio stages and Harvest's), the device's idle time by graph span,
and the host seconds of the long-audio spans.

    python3 wtbench/long_split.py --seed N [--warm CHAPTERS]

From the root of a checkout on a machine with an NVIDIA GPU.  Runs the
cell's set-up (``--warm`` chapters, the traffic's ``warm_chapters`` by
default) and traces the next chapter as ``wtbench/run.py --trace 1``
does, without a window or the check; ``stage_split.report`` prints the
rows with the chapter as its one batch.
"""

from __future__ import annotations

import os
import sys


def long_spans(tr):
    """{span: (count, seconds)} of the ``wt.long.*`` host ranges and the
    graph cache's outermost calls in the traced window."""
    out = {}
    for n, s, e in tr.host:
        if n.startswith("wt.long.") or n in ("wt.graph.eager",
                                             "wt.graph.capture",
                                             "wt.graph.replay"):
            c, t = out.get(n, (0, 0.0))
            out[n] = (c + 1, t + (e - s) / 1e9)
    return dict(sorted(out.items()))


def main(argv=None):
    import argparse
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "4"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--warm", type=int, default=None)
    args = ap.parse_args(argv)

    import torch
    from wtbench import harness as Hn, stage_split
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = "librivox-22k.long"
    cell = {w["name"]: w for w in Hn.load_json(
        os.path.join(root, "BENCHMARK.json"))["workloads"]}[name]
    mix = Hn.traffic(cell["traffic"])
    if args.warm is not None:
        mix = dict(mix, warm_chapters=args.warm)
    ctx = Hn.Context(workload=cell, config=Hn.config(cell["config"]),
                     traffic=mix, seed=args.seed,
                     device=torch.device("cuda", 0), trace=True)
    drv = Hn.entry(mix["entry"])
    res = drv.window(ctx, drv.setup(ctx), 0.0)
    print(f"{name} seed {args.seed} [{torch.cuda.get_device_name(0)}]; "
          f"traced chapter (pool index, input s, wall s, chunk steps, "
          f"pulses): {res['traced'].log}")
    print("\n".join(stage_split.report(res["trace"], 1)))
    print("long-audio and graph spans (count, host s):")
    for n, (c, t) in long_spans(res["trace"]).items():
        print(f"  {n:20s} {c:5d} {t:9.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
