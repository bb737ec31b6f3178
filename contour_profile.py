#!/usr/bin/env python3
"""Where the contour merge kernel's time goes, by phase, on one NVIDIA GPU.

    python3 contour_profile.py                 # from the repository root
    python3 contour_profile.py --baseline DIR  # also DIR/contour.cu, an
                                               # earlier design (8075e49's)

Builds a copy of worldtpu_torch/csrc/contour.cu whose merge kernel stamps
clock64() at each phase boundary (thread 0 of each block, after the
phase's barrier) and, inside the merge steps, sums the cycles of the
contested sums and of the row writes; runs it on chip_smoke.py's main-path
batch, the same audio as one 24.33 s utterance, and tests/test_longform.py's
60 s signal, on the arguments the contour chain hands the kernel; and
prints each phase in us of the SM clock (measured with torch.cuda._sleep)
for the slowest block.  The copies are made by exact text substitutions on
the sources: a source that no longer contains a marked line stops the
script with the line it missed.  The kernels' results are not checked here
(chip_smoke.py does that).
"""

import argparse
import ctypes
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
PHASES_NEW = ["init", "section sums", "mean scan", "rank + source init",
              "merge steps", "output"]
PHASES_OLD = ["init", "section sums", "mean scan + order", "row init",
              "merge steps", "copy out"]


def patch(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"contour_profile: the source no longer holds "
                             f"exactly one {old.splitlines()[0]!r}")
        src = src.replace(old, new)
    return src


def instrument_new(src):
    """The current merge kernel, stamped: prof [B, 16] int64 per block:
    7 phase stamps, n_ch, then the steps' contested-sum and row-write
    cycles, contested steps, frames summed and frames written."""
    return patch(src, [
        ("unsigned char* __restrict__ ordered, int F, float c_len) {",
         "unsigned char* __restrict__ ordered, int F, float c_len,\n"
         "                 long long* prof) {\n"
         "  long long* pf = prof + 16 * blockIdx.x;\n"
         "  if (threadIdx.x == 0) pf[0] = clock64();"),
        ("  if (ns <= 0) {\n    for (int j = tid; j < F; j += kThreadsA) "
         "o[j] = u.f0[j];\n    return;\n  }\n\n  // section sums",
         "  if (tid == 0) pf[1] = clock64();\n"
         "  if (ns <= 0) {\n    for (int j = tid; j < F; j += kThreadsA) "
         "o[j] = u.f0[j];\n    return;\n  }\n\n  // section sums"),
        ("    __syncthreads();  // red is free for the next section\n  }\n"
         "  __syncthreads();\n",
         "    __syncthreads();  // red is free for the next section\n  }\n"
         "  __syncthreads();\n  if (tid == 0) pf[2] = clock64();\n"),
        ("  __syncthreads();\n  const int n_ch = sh_nch;",
         "  __syncthreads();\n  if (tid == 0) pf[3] = clock64();\n"
         "  const int n_ch = sh_nch;"),
        ("      src[j] = source(s, u, first, j);\n  }\n  __syncthreads();\n",
         "      src[j] = source(s, u, first, j);\n  }\n  __syncthreads();\n"
         "  if (tid == 0) pf[4] = clock64();\n"),
        ("  if (warp == 0) {\n    int b0 = static_cast<int>(u.so[S + first]);",
         "  long long c_sum = 0, c_paint = 0, n_sum = 0, n_paint = 0,\n"
         "            n_cont = 0;\n"
         "  if (warp == 0) {\n"
         "    int b0 = static_cast<int>(u.so[S + first]);"),
        ("        int lo = i1;\n        if (!fresh && !covered) {",
         "        int lo = i1;\n        long long t1 = clock64();\n"
         "        if (!fresh && !covered) {"),
        ("        if (fresh || !covered) {\n#pragma unroll 4\n",
         "        if (!fresh && !covered) {\n          n_cont += 1;\n"
         "          n_sum += b1 - i1 + 1;\n        }\n        __syncwarp();\n"
         "        long long t2 = clock64();\n"
         "        if (fresh || !covered) n_paint += i2 - lo + 1;\n"
         "        if (fresh || !covered) {\n#pragma unroll 4\n"),
        ("        if (fresh || !covered) b1 = i2;\n        __syncwarp();\n",
         "        if (fresh || !covered) b1 = i2;\n        __syncwarp();\n"
         "        c_sum += t2 - t1;\n        c_paint += clock64() - t2;\n"),
        ("  __syncthreads();\n  // the output from the sources",
         "  __syncthreads();\n  if (tid == 0) pf[5] = clock64();\n"
         "  // the output from the sources"),
        ("      if (j0 + kThreadsA * r < F) o[j0 + kThreadsA * r] = v[r];\n"
         "  }\n}",
         "      if (j0 + kThreadsA * r < F) o[j0 + kThreadsA * r] = v[r];\n"
         "  }\n  __syncthreads();\n  if (tid == 0) {\n"
         "    pf[6] = clock64(); pf[7] = n_ch; pf[8] = c_sum;\n"
         "    pf[9] = c_paint; pf[10] = n_cont; pf[11] = n_sum;\n"
         "    pf[12] = n_paint;\n  }\n}"),
        ("                                int E, float c_len, void* stream) {",
         "                                int E, float c_len, long long* prof,"
         "\n                                void* stream) {"),
        ("u, n_sec, out, ssum, keep, order, src, s1, s2, ordered, F, c_len);",
         "u, n_sec, out, ssum, keep, order, src, s1, s2, ordered, F, c_len,"
         " prof);"),
        ('extern "C" int wt_contour_merge(',
         'extern "C" int wt_contour_merge_prof('),
    ])


def instrument_old(src):
    """8075e49's merge kernel (the first design), stamped: 7 phase stamps and
    n_ch."""
    return patch(src, [
        ("float* __restrict__ s2_out, int F, float c_len) {",
         "float* __restrict__ s2_out, int F, float c_len,\n"
         "                 long long* prof) {\n"
         "  long long* pf = prof + 16 * blockIdx.x;\n"
         "  if (threadIdx.x == 0) pf[0] = clock64();"),
        ("  if (ns <= 0) {\n    for (int j = tid; j < F; j += kThreadsA) "
         "o[j] = u.f0[j];\n    return;\n  }\n",
         "  if (tid == 0) pf[1] = clock64();\n"
         "  if (ns <= 0) {\n    for (int j = tid; j < F; j += kThreadsA) "
         "o[j] = u.f0[j];\n    return;\n  }\n"),
        ("    sm[k] = (float)acc;\n  }\n  __syncthreads();\n",
         "    sm[k] = (float)acc;\n  }\n  __syncthreads();\n"
         "  if (tid == 0) pf[2] = clock64();\n"),
        ("  __syncthreads();\n  const int n_ch = sh_nch;",
         "  __syncthreads();\n  if (tid == 0) pf[3] = clock64();\n"
         "  const int n_ch = sh_nch;"),
        ("  int b1 = static_cast<int>(u.so[first]);\n  __syncthreads();\n",
         "  int b1 = static_cast<int>(u.so[first]);\n  __syncthreads();\n"
         "  if (tid == 0) pf[4] = clock64();\n"),
        ("  for (int j = tid; j < F; j += kThreadsA) o[j] = mrg[j];\n}",
         "  if (tid == 0) pf[5] = clock64();\n"
         "  for (int j = tid; j < F; j += kThreadsA) o[j] = mrg[j];\n"
         "  __syncthreads();\n"
         "  if (tid == 0) { pf[6] = clock64(); pf[7] = n_ch; }\n}"),
        ("int B, int F, int S, int E, float c_len,\n"
         "                                void* stream) {",
         "int B, int F, int S, int E, float c_len,\n"
         "                                long long* prof, void* stream) {"),
        ("u, n_sec, out, ssum, keep, order, rows, s1, s2, F, c_len);",
         "u, n_sec, out, ssum, keep, order, rows, s1, s2, F, c_len, prof);"),
        ('extern "C" int wt_contour_merge(',
         'extern "C" int wt_contour_merge_prof('),
    ])


def build(_build, text, name):
    """Compile one instrumented source into its own library (its own
    hash directory under build/) and bind wt_contour_merge_prof."""
    d = _build.BUILD_ROOT / "profile"
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{name}.cu"
    path.write_text(text)
    so, _ = _build.build([path])
    return ctypes.CDLL(str(so))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="a directory holding an earlier contour.cu "
                         "(8075e49's) to profile beside the current one")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("contour_profile: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from bench import synth_utterance_diverse
    from worldtpu_torch import _build
    from worldtpu_torch.analysis import contour_device as CDV
    from worldtpu_torch.analysis import harvest as H
    from worldtpu_torch.ops import contour_kernel as CK
    from worldtpu_torch.parallel.batch import pad_batch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = CS.card_line()
    print(card, flush=True)
    _build.library()
    sig = list(_build._SIGNATURES["wt_contour_merge"])
    libs = {"current": (build(_build, instrument_new(
        (_build.CSRC / "contour.cu").read_text()), "contour_new"), sig)}
    if args.baseline is not None:
        old_sig = list(CS.OLD_ENTRIES["contour.cu"][0][1])
        libs["8075e49"] = (build(_build, instrument_old(
            (args.baseline / "contour.cu").read_text()), "contour_old"),
            old_sig)
    for lib, s in libs.values():
        lib.wt_contour_merge_prof.argtypes = s[:-1] + [ctypes.c_void_p,
                                                        s[-1]]
        lib.wt_contour_merge_prof.restype = ctypes.c_int
    per_us = CS.sleep_cycles_per_ms(torch) / 1000
    print(f"SM clock: {per_us:.0f} cycles a us (torch.cuda._sleep)  "
          f"[{card}]", flush=True)

    waves = [synth_utterance_diverse(CS.FS, i) for i in range(CS.BATCH)]
    x_np, lengths, _, _, _ = pad_batch(waves, CS.FS)
    T = -(-x_np.shape[1] // 4096) * 4096
    x = torch.tensor(np.pad(x_np, ((0, 0), (0, T - x_np.shape[1]))),
                     device=dev)
    x1 = torch.cat([x[i, :int(n)] for i, n in enumerate(lengths)])[None]
    x60 = torch.tensor(CS.long_utterance(CS.FS, CS.TEST_SIGNAL_S),
                       device=dev)[None]
    for label, xs in ((f"main path B={CS.BATCH}", x),
                      (f"one {x1.shape[1] / CS.FS:.2f} s utterance", x1),
                      (f"the {CS.TEST_SIGNAL_S:g} s test signal", x60)):
        g = H.HarvestGeometry(CS.FS, xs.shape[1], f0_floor=40.0)
        with torch.no_grad():
            cand, score = H.harvest_device_stages(xs, geo=g)
            _, (margs, mkw), _, _ = CS.chain_calls(
                torch, CDV, CK, cand, score, g.n_grid(), g.frame_period)
            _, seen = CS.capture(_build, lambda: CK.contour_merge_cuda(
                *margs, **mkw))
        call = seen[0][2]
        B = margs[0].shape[0]
        for name, (lib, _) in libs.items():
            a = call if name == "current" else CS.old_contour_args(
                "wt_contour_merge", call, CS.old_merge_rows(torch, margs))
            pf = torch.zeros((B, 16), dtype=torch.int64, device=dev)
            for _ in range(3):      # the last of three warm runs
                err = lib.wt_contour_merge_prof(
                    *_build.c_args(a + (pf,)),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            torch.cuda.synchronize()
            p = pf.cpu().numpy()
            us = np.diff(p[:, :7], axis=1) / per_us
            w = int(np.argmax(p[:, 6] - p[:, 0]))
            phases = PHASES_NEW if name == "current" else PHASES_OLD
            line = (f"{label}, {name} merge by phase (us; the slowest "
                    f"block, row {w}, {p[w, 7]} kept sections, total "
                    f"{(p[w, 6] - p[w, 0]) / per_us:.2f}): " + ", ".join(
                        f"{n} {v:.2f}" for n, v in zip(phases, us[w])))
            if name == "current":
                line += (f"; in the merge steps: contested sums "
                         f"{p[w, 8] / per_us:.2f} ({p[w, 10]} steps, "
                         f"{p[w, 11]} frames), row writes "
                         f"{p[w, 9] / per_us:.2f} ({p[w, 12]} frames)")
            print(f"{line}  [{card}]", flush=True)
        del cand, score, margs, seen
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
