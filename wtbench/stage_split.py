"""Print the stage split of one traced pass of a cell: device ms a batch
under each stage's marks, outside any stage and in the marks themselves,
and the device's idle time by the graph-cache span around each gap.

    python3 wtbench/stage_split.py --workload NAME --seed N [--seconds S]

From the root of a checkout on a machine with an NVIDIA GPU.  Runs the
cell's set-up and window as ``wtbench/run.py --trace 1`` does (the traced
pass is one more whole pass after a window of S seconds, 0 by default),
without the check against the reference, and prints the rows that
``PERF.md`` section 5 gives per cell.  Needs a program with stage marks
and graph spans (``worldtpu_torch/tracing.py``); without them the rows
are empty.
"""

from __future__ import annotations

import collections
import os
import sys

#: the graph cache's spans, outermost calls and a capture's parts
GRAPH_SPANS = ("wt.graph.eager", "wt.graph.capture", "wt.graph.replay",
               "wt.graph.warm", "wt.graph.record", "wt.graph.evict")


def stage_rows(tr, batches):
    """{"stages": {stage: ms a batch} in main-path order then any other,
    "outside", "marks": ms a batch, "busy_s", "inside_pct": the share of
    the device time (marks left out) that falls inside a stage,
    "marks_pct": the marks' share of the busy time}."""
    from wtbench import stages as S
    by, mark_s, _ = S.split(tr)
    order = [*S.HARVEST, *S.CHEAPTRICK, *S.D4C, *S.SYNTHESIS]
    names = [n for n in order if n in by] + sorted(
        n for n in by if n not in order and n != "outside")
    work = sum(by.values())
    outside = by.get("outside", 0.0)
    from wtbench import trace as T
    busy = T.busy_s(tr)
    return {"stages": {n: 1e3 * by[n] / batches for n in names},
            "outside": 1e3 * outside / batches,
            "marks": 1e3 * mark_s / batches,
            "busy_s": busy,
            "inside_pct": 100.0 * (work - outside) / work if work else None,
            "marks_pct": 100.0 * mark_s / busy if busy else None}


def idle_by_span(tr):
    """{range: idle seconds}: every idle gap of the device in the window
    (``trace.gaps``) given whole to the innermost graph span that holds its
    middle, else to the innermost harness range (``wtbench.*``), else to
    ``"none"``; the largest first."""
    from wtbench import trace as T
    host = [h for h in tr.host if h[2] > tr.t0_ns and h[1] < tr.t1_ns]
    spans = [h for h in host if h[0] in GRAPH_SPANS]
    harness = [h for h in host if h[0].startswith("wtbench.")
               and h[0] != "wtbench.window"]
    by = collections.Counter()
    for s, e in T.gaps(tr):
        mid = (s + e) // 2
        name = T._innermost(spans, mid)
        if name == "none":
            name = T._innermost(harness, mid)
        by[name] += (e - s) / 1e9
    return dict(by.most_common())


def span_ms(tr):
    """{span name: (count, mean ms)} of each graph span starting in the
    window, outermost or not."""
    got = collections.defaultdict(list)
    for n, s, e in tr.host:
        if n in GRAPH_SPANS and tr.t0_ns <= s < tr.t1_ns:
            got[n].append((e - s) / 1e6)
    return {n: (len(got[n]), sum(got[n]) / len(got[n]))
            for n in GRAPH_SPANS if got[n]}


def report(tr, batches):
    """The printed lines of one traced pass of ``batches`` batches."""
    r = stage_rows(tr, batches)
    from wtbench import stages as S
    lines = [f"traced pass: {batches} batches, window {tr.window_s:.3f} s, "
             f"busy {r['busy_s']:.3f} s"]
    lines += [f"  {n:16s} {v:9.3f} ms a batch"
              for n, v in r["stages"].items()]
    for label, part in (("harvest", S.HARVEST),
                        ("cheaptrick", S.CHEAPTRICK), ("d4c", S.D4C),
                        ("synthesis", S.SYNTHESIS)):
        v = sum(r["stages"].get(n, 0.0) for n in part)
        lines.append(f"  {label + '.device_ms':16s} {v:9.3f} ms a batch")
    lines.append(f"  {'outside':16s} {r['outside']:9.3f} ms a batch")
    lines.append(f"  {'marks':16s} {r['marks']:9.4f} ms a batch")
    if r["inside_pct"] is not None:
        lines.append(f"  inside a stage   {r['inside_pct']:.2f}% of the "
                     f"device time; the marks {r['marks_pct']:.3f}% of busy")
    idle = idle_by_span(tr)
    lines.append(f"idle {sum(idle.values()):.3f} s of {tr.window_s:.3f} s, "
                 "by the innermost graph span (else the harness's range):")
    lines += [f"  {n:20s} {v:.3f} s" for n, v in idle.items()]
    lines.append("graph spans (count, mean ms):")
    lines += [f"  {n:20s} {c:4d} {m:9.2f}" for n, (c, m) in
              span_ms(tr).items()]
    return lines


def main(argv=None):
    import argparse
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "4"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the checkout's root in place of this directory, whose module names
    # (trace, ...) would shadow the standard library's
    sys.path[0] = root
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    import torch
    from wtbench import harness as Hn
    bench = Hn.load_json(os.path.join(root, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mix = Hn.traffic(cell["traffic"])
    ctx = Hn.Context(workload=cell, config=Hn.config(cell["config"]),
                     traffic=mix, seed=args.seed,
                     device=torch.device("cuda", 0), trace=True)
    drv = Hn.entry(mix["entry"])
    state = drv.setup(ctx)
    res = drv.window(ctx, state, args.seconds)
    print(f"{args.workload} seed {args.seed} "
          f"[{torch.cuda.get_device_name(0)}]")
    print("\n".join(report(res["trace"], res["traced"].batches)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
