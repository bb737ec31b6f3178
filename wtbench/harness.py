"""The benchmark's runner: finds a cell's configuration, traffic, entry,
limits and metric readers by name, runs set-up, the window and the check,
and prints the result line.

Everything that belongs to one configuration, traffic mix, entry or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

    configs/<config>.json      the deployment's sizes and settings
    traffic/<traffic>.json     the mix: its ``entry`` and its parameters
    entries/<entry>.py         setup(ctx), window(ctx, state, seconds),
                               check(ctx, state, result)
    limits/<workload>.json     the limit of each number compared
    metrics/<metric>.py        read(result) -> a number, or None when the
                               run holds nothing to read

An entry's window reports its end-to-end quantities by their plain names
(``rtf``); an end-to-end metric ``<quantity>.<class>`` of ``BENCHMARK.json``
takes its cell's ``<quantity>``: the class names the cells whose runs
spread alike, which share a bound (``rtf.churn``, ``rtf.replay``).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent

#: modules that may not be loaded in a measured process (top-level names,
#: compared whole: ``worldtpu_torch`` is not ``worldtpu``)
FORBIDDEN = ("jax", "jaxlib", "flax", "worldtpu")


@dataclasses.dataclass
class Context:
    """What an entry gets: the cell, its configuration and traffic, the
    seed, the device and whether this run is traced."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    trace: bool


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """Import the file ``path`` as a module of its own (a name may hold
    dots, as metric names do)."""
    name = "wtbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def config(name, base=HERE):
    return load_json(base / "configs" / f"{name}.json")


def traffic(name, base=HERE):
    return load_json(base / "traffic" / f"{name}.json")


def entry(name, base=HERE):
    return load_module(base / "entries" / f"{name}.py")


def limits(workload, base=HERE):
    path = base / "limits" / f"{workload}.json"
    return load_json(path) if path.exists() else {}


def listing(base=HERE):
    """{kind: sorted names} of every configuration, traffic mix, entry,
    limits file and metric reader the harness finds under ``base``."""
    kinds = {"configs": "*.json", "traffic": "*.json", "entries": "*.py",
             "limits": "*.json", "metrics": "*.py"}
    return {k: sorted(p.name.rsplit(".", 1)[0] for p in (base / k).glob(pat)
                      if not p.name.startswith("_"))
            for k, pat in kinds.items()}


def cell_metrics(bench, workload, traced):
    """The metrics a run of ``workload`` reports: the end-to-end ones
    untraced, the per-layer ones traced, each where its ``workloads`` lists
    the cell (or, without the key, where the cell reports what it
    ``moves``)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def forbidden_modules():
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def judge(numbers, lim):
    """(correct, [[name, value, limit]...]): every number within its
    limit; a number without a limit or that is not finite is not."""
    rows, ok = [], True
    for name, value in numbers:
        limit = lim.get(name)
        good = (limit is not None and value is not None
                and math.isfinite(value) and value <= limit)
        ok = ok and good
        rows.append([name, value, limit])
    return ok, rows


def parse(argv):
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, root, process_age_s):
    args = parse(argv)
    root = pathlib.Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "4")))
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # the configurations state float32 without TF32 (PyTorch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mix = config(cell["config"]), traffic(cell["traffic"])
    ctx = Context(workload=cell, config=cfg, traffic=mix, seed=args.seed,
                  device=torch.device("cuda", 0), trace=bool(args.trace))
    drv = entry(mix["entry"])

    state = drv.setup(ctx)
    torch.cuda.synchronize()
    setup_s = process_age_s()
    result = drv.window(ctx, state, args.seconds)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    found = forbidden_modules()
    if found:
        print(f"loaded in the measured process: {found}", file=sys.stderr)
        return 4
    numbers = drv.check(ctx, state, result)
    correct, rows = judge(numbers, limits(cell["name"]))

    metrics = {}
    for m in cell_metrics(bench, cell["name"], ctx.trace):
        if m["name"] == "setup_s":
            value = setup_s
        elif ctx.trace:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(
                result)
        else:
            value = result["e2e"].get(m["name"].split(".")[0])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": metrics,
            "device": device}
    if ctx.trace:
        tr = result["trace"]
        from wtbench import trace as T
        device["busy_s"] = T.busy_s(tr)
        device["window_s"] = tr.window_s
        line["breakdown"] = T.breakdown(tr)
    line["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    found = forbidden_modules()
    if found:
        print(f"loaded in the measured process: {found}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for n, v, lim in rows:
        print(f"compared {n} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
