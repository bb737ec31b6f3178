#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (worldtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure raises, so the exit code is not 0):
  1. environment: python/torch/CUDA versions and the card's name and power
     limit (nvidia-smi);
  2. build: the CUDA kernels from worldtpu_torch/csrc/*.cu for sm_90a;
  3. main path: batch_wav_to_wav on B=8 synthetic 22.05 kHz utterances
     (bench.synth_utterance_diverse) padded to a multiple of 4096 samples,
     f0_floor 40, pitch x1.2, duration x1.25 (frame period 6.25 ms at
     synthesis), static pulse capacity; checks shape, finiteness, level,
     pulse overflow, and that the zc, refine and OLA kernels each ran;
     reports wall time per batch and the realtime factor, the host
     synchronisations of the main path and of its contour chain (counted
     with CUDA sync debug mode), and, from one torch.profiler run of the
     main path, each stage's host and device time (the ``wt.*`` ranges)
     and the device's busy share of that run's wall;
  4. per kernel, at the main path's shapes: kernel against its plain
     PyTorch version on the card (stated tolerances), median times of both
     from CUDA events;
  5. the port on the card against the port on the CPU (plain versions) on
     the tests/fixtures/t22.wav batch: F0 and short-time RMS envelope.

The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.  Without a CUDA device, or outside
the repository, the script exits non-zero and prints no result.
"""

import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings
import wave

import numpy as np

FS = 22050
BATCH = 8
PITCH = 1.2
DUR = 1.25

# kernel tolerances (kernel vs plain version, same inputs, same card)
ZC_REL = 1e-4          # candidate Hz, relative, where both are nonzero
ZC_FLIP_FRAC = 1e-4    # fraction of entries whose band gate may differ
REFINE_REL = 1e-5      # DFT sums, abs error over the largest |sum|
REFINE_F0_REL = 1e-4   # refined F0, relative, where both are nonzero
OLA_ATOL, OLA_RTOL = 1e-5, 1e-4


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def count_syncs(torch, fn):
    """(fn(), number of synchronizing CUDA calls fn made), counted with
    CUDA sync debug mode (each blocking copy, .item(), synchronize...)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
    return out, n


def stage_profile(torch, fn):
    """One torch.profiler run of fn.  Returns (wall ms with the profiler
    on, device activities [(start us, ms, name)], {stage: [host ms,
    device ms]}) for the ``wt.*`` record_function ranges of the main path.
    A stage's host ms is its range on the host; its device ms sums the
    device activities that start inside the range's span on the device
    timeline (so kernels launched through ctypes count too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages, spans, acts = {}, [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("wt."):
            st = stages.setdefault(e.name, [0.0, 0.0])
            if e.device_type == DeviceType.CPU:
                st[0] += tr.elapsed_us() / 1000
            else:
                spans.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            # kernels, copies and memsets on one stream: their durations
            # add up to the device's busy time
            acts.append((tr.start, tr.elapsed_us() / 1000, e.name))
    for start, ms, _ in acts:
        for s0, s1, name in spans:
            if s0 <= start <= s1:
                stages[name][1] += ms
                break
    return wall * 1000, acts, stages


def read_wav(path):
    with wave.open(str(path)) as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: expected 16-bit mono")
        raw = w.readframes(w.getnframes())
        return (np.frombuffer(raw, "<i2") / 32768.0).astype(np.float32), \
            w.getframerate()


def short_time_rms(y, w=160):
    n = (y.shape[-1] // w) * w
    return np.sqrt(np.mean(y[..., :n].reshape(*y.shape[:-1], -1, w) ** 2,
                           -1))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from bench import synth_utterance_diverse
    from worldtpu_torch import _build, constants as C
    from worldtpu_torch.analysis import harvest as H
    from worldtpu_torch.analysis.cheaptrick import (CheapTrickKernel,
                                                    cheaptrick_frames)
    from worldtpu_torch.analysis import contour_device as CDV
    from worldtpu_torch.analysis.d4c import d4c_frames
    from worldtpu_torch.ops import ola_kernel, refine_kernel, zc_kernel
    from worldtpu_torch.parallel.batch import batch_wav_to_wav, pad_batch
    from worldtpu_torch.synthesis import synthesis as S

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. environment ----
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {name}")
    log(card)

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s; flags {' '.join(_build.NVCC_FLAGS)})")

    # ---- 3. main path ----
    waves = [synth_utterance_diverse(FS, i) for i in range(BATCH)]
    x_np, lengths, _, _, _ = pad_batch(waves, FS)
    T = -(-x_np.shape[1] // 4096) * 4096
    x_np = np.pad(x_np, ((0, 0), (0, T - x_np.shape[1])))
    geo = H.HarvestGeometry(FS, T, f0_floor=40.0)
    ck = CheapTrickKernel(FS)
    n_grid = geo.n_grid()
    out_len = int((n_grid - 1) * 0.005 * DUR * FS) + 1
    mp = S.capacity_max_pulses(out_len, FS, f0_cap=C.DEFAULT_F0 * PITCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = S.make_noise(gen, BATCH, mp, ck.fft_size, device=dev)
    x = torch.tensor(x_np, device=dev)
    kw = dict(geo=geo, fs=FS, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window,
              frame_period_s=0.005 * DUR, out_length=out_len, max_pulses=mp,
              pitch_scale=PITCH, return_overflow=True)
    log(f"main path: B={BATCH} T={T} F(1ms)={geo.f0_length} "
        f"bands={geo.n_channels} e_max={geo.e_max} out_length={out_len} "
        f"max_pulses={mp} fft={ck.fft_size}")

    def run():
        out = batch_wav_to_wav(x, noise, **kw)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    log(f"main path first run (warm-up): {time.perf_counter() - t0:.3f} s")
    _build.launches.clear()
    t0 = time.perf_counter()
    y, f0, ovf = run()
    walls = [time.perf_counter() - t0]
    counts = dict(_build.launches)
    for _ in range(4):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    audio_s = float(lengths.sum()) / FS
    y_np = y.cpu().numpy()
    rms = float(np.sqrt(np.mean(y_np ** 2)))
    log(f"main path launches: {counts}")
    log(f"main path wall per batch: median {wall * 1000:.1f} ms of "
        f"{[round(w * 1000, 1) for w in walls]}; input audio {audio_s:.2f} s; "
        f"realtime factor {audio_s / wall:.1f}x  [{card}]")
    log(f"output rms {rms:.4f}; "
        f"voiced frames {float((f0 > 0).float().mean()):.3f}")
    if tuple(y_np.shape) != (BATCH, out_len):
        raise AssertionError(f"output shape {y_np.shape}")
    if not np.isfinite(y_np).all():
        raise AssertionError("non-finite output")
    if not rms > 0.01:
        raise AssertionError(f"output rms {rms}")
    if bool(ovf.any()):
        raise AssertionError(f"pulse capacity overflow: {ovf.tolist()}")
    for k in ("wt_zc", "wt_refine_sums", "wt_ola"):
        if counts.get(k, 0) < 1:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 f"main path")

    with torch.no_grad():
        _, n_path = count_syncs(torch, lambda: batch_wav_to_wav(x, noise,
                                                                **kw))
        mean = torch.zeros(BATCH, device=dev)
        cand, score = H.harvest_device_stages(x, mean, geo=geo)
        _, n_contour = count_syncs(torch, lambda: CDV.fix_and_smooth(
            cand, score, n_grid, geo.frame_period))
    log(f"host syncs per batch (CUDA sync debug mode): main path {n_path}, "
        f"of which contour chain {n_contour}")
    p_wall, acts, stages = stage_profile(
        torch, lambda: batch_wav_to_wav(x, noise, **kw))
    busy = sum(a[1] for a in acts)
    log(f"profiled main path: wall {p_wall:.1f} ms (profiler on), device "
        f"busy {busy:.1f} ms = {100 * busy / p_wall:.1f}% of that wall, "
        f"{len(acts)} device activities  [{card}]")
    for nm, (h_ms, d_ms) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        log(f"  stage {nm:18s} host {h_ms:8.3f} ms  device {d_ms:8.3f} ms")
    d_sum = sum(v[1] for v in stages.values())
    log(f"  sum of stages      host "
        f"{sum(v[0] for v in stages.values()):8.3f} ms  device "
        f"{d_sum:8.3f} ms (outside any stage {busy - d_sum:.3f} ms)")
    by_name = collections.Counter()
    for _, ms, nm in acts:
        by_name[nm] += ms
    for nm, ms in by_name.most_common(6):
        log(f"  device {ms:8.3f} ms  {nm[:80]}")

    # ---- 4. kernels vs plain versions at the main path's shapes ----
    results = []
    with torch.no_grad():
        y_dec = H.decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
        filt = H.band_filter(y_dec, geo)
        bounds = torch.as_tensor(geo.boundary_f0, dtype=torch.float32,
                                 device=dev)
        zargs = zc_kernel.geometry_args(geo)
        zk = zc_kernel.band_candidates_cuda(filt, bounds, **zargs)
        zp = zc_kernel.band_candidates_plain(filt, bounds, **zargs)
        both = (zk > 0) & (zp > 0)
        flips = int(((zk > 0) != (zp > 0)).sum())
        rel = float(((zk - zp).abs() / zp.abs().clamp(min=1e-3))[both].max())
        zerr = float((zk - zp).abs()[both].max())
        log(f"zc: filt {tuple(filt.shape)} -> {tuple(zk.shape)}; "
            f"nonzero {int((zk > 0).sum())} vs {int((zp > 0).sum())}; "
            f"max rel {rel:.2e} (tol {ZC_REL}), gate flips {flips}")
        if rel > ZC_REL or flips > ZC_FLIP_FRAC * int((zp > 0).sum()):
            raise AssertionError("zc kernel disagrees with its plain version")
        z_ms = median_ms(torch, lambda: zc_kernel.band_candidates_cuda(
            filt, bounds, **zargs), 10)
        z_plain = median_ms(torch, lambda: zc_kernel.band_candidates_plain(
            filt, bounds, **zargs), 3)
        results.append(("zc", "worldtpu_torch/csrc/zc.cu",
                        "worldtpu/ops/zc_kernel.py:112", "wt_zc", zerr,
                        z_ms, z_plain))

        cand, _, _ = H.candidates_stage(y_dec, mean, geo)
        tpos = torch.arange(geo.f0_length, dtype=torch.float32,
                            device=dev) / 1000.0
        prep = refine_kernel.prepare(y_dec, cand, tpos, geo=geo,
                                     dedup_tol=H.REFINE_DEDUP_TOL)
        rk_args = prep["kernel_args"]
        rkw = dict(hwmax=geo.max_half_window, n_fft=geo.refine_fft)
        rk = refine_kernel.spectral_sums_cuda(*rk_args, **rkw)
        rp = refine_kernel.spectral_sums_plain(*rk_args, **rkw)
        rerr = float((rk - rp).abs().max())
        rscale = float(rp.abs().max())
        fk, _ = refine_kernel.finish(rk, prep, geo=geo)
        fp, _ = refine_kernel.finish(rp, prep, geo=geo)
        fboth = (fk > 0) & (fp > 0)
        frel = float(((fk - fp).abs() / fp.clamp(min=1e-3))[fboth].max())
        fflips = int(((fk > 0) != (fp > 0)).sum())
        log(f"refine: seg {tuple(rk_args[0].shape)} active "
            f"{int(rk_args[4].sum())} -> sums {tuple(rk.shape)}; max abs err "
            f"{rerr:.3e} of max |sum| {rscale:.3e} (tol {REFINE_REL} rel); "
            f"refined F0 max rel {frel:.2e} (tol {REFINE_F0_REL}), "
            f"score-gate flips {fflips} (tol 0)")
        if rerr > REFINE_REL * rscale or frel > REFINE_F0_REL or fflips:
            raise AssertionError("refine kernel disagrees with its plain "
                                 "version")
        r_ms = median_ms(torch, lambda: refine_kernel.spectral_sums_cuda(
            *rk_args, **rkw), 10)
        r_plain = median_ms(torch, lambda: refine_kernel.spectral_sums_plain(
            *rk_args, **rkw), 3)
        results.append(("refine", "worldtpu_torch/csrc/refine.cu",
                        "worldtpu/ops/refine_kernel.py:49", "wt_refine_sums",
                        rerr, r_ms, r_plain))

        tpos5 = torch.arange(n_grid, dtype=torch.float32, device=dev) \
            * (geo.frame_period / 1000.0)
        spec = cheaptrick_frames(x, f0, tpos5, fs=FS, fft_size=ck.fft_size,
                                 max_half_window=ck.max_half_window)
        ap = d4c_frames(x, f0, tpos5, fs=FS, fft_size_out=ck.fft_size)
        resp, starts, _ = S.pulse_train(
            f0, spec, ap, noise, fs=FS, fft_size=ck.fft_size,
            frame_period_s=0.005 * DUR, out_length=out_len, max_pulses=mp)
        ok_ = ola_kernel.overlap_add_cuda(resp, starts, out_len)
        op = ola_kernel.overlap_add_plain(resp, starts, out_len)
        oerr = float((ok_ - op).abs().max())
        obad = int(((ok_ - op).abs() > OLA_ATOL + OLA_RTOL * op.abs()).sum())
        log(f"ola: resp {tuple(resp.shape)} -> {tuple(ok_.shape)}; max abs "
            f"err {oerr:.3e} (tol {OLA_ATOL} + {OLA_RTOL}*|y|), "
            f"out of tolerance {obad}")
        if obad:
            raise AssertionError("OLA kernel disagrees with its plain version")
        o_ms = median_ms(torch, lambda: ola_kernel.overlap_add_cuda(
            resp, starts, out_len), 20)
        o_plain = median_ms(torch, lambda: ola_kernel.overlap_add_plain(
            resp, starts, out_len), 5)
        results.append(("ola", "worldtpu_torch/csrc/ola.cu",
                        "worldtpu/ops/ola_kernel.py:51", "wt_ola", oerr,
                        o_ms, o_plain))
    for r in results:
        log(f"{r[0]}: kernel {r[5]:.3f} ms, plain {r[6]:.3f} ms  [{card}]")

    # ---- 5. port on the card vs port on the CPU, t22 fixture batch ----
    x22, fs22 = read_wav(root / "tests" / "fixtures" / "t22.wav")
    xb = np.stack([x22, 0.6 * x22]).astype(np.float32)
    g22 = H.HarvestGeometry(fs22, xb.shape[1], f0_floor=40.0)
    n22 = g22.n_grid()
    out22 = int((n22 - 1) * 0.005 * DUR * fs22) + 1
    mp22 = S.capacity_max_pulses(out22, fs22, f0_cap=C.DEFAULT_F0 * PITCH)
    noise22 = S.make_noise(torch.Generator().manual_seed(1), 2, mp22,
                           ck.fft_size)
    kw22 = dict(kw, geo=g22, fs=fs22, out_length=out22, max_pulses=mp22)
    y_c, f0_c, _ = batch_wav_to_wav(torch.tensor(xb), noise22, **kw22)
    y_g, f0_g, _ = batch_wav_to_wav(torch.tensor(xb, device=dev),
                                    noise22.to(dev), **kw22)
    f0_c, f0_g = f0_c.numpy(), f0_g.cpu().numpy()
    vc, vg = f0_c > 0, f0_g > 0
    agree = float((vc == vg).mean())
    both = vc & vg
    f0_rmse = float(np.sqrt(np.mean((f0_c[both] - f0_g[both]) ** 2)))
    env = float(np.abs(short_time_rms(y_c.numpy())
                       - short_time_rms(y_g.cpu().numpy())).max())
    log(f"card vs CPU (t22 x2): voicing agreement {agree:.4f}, F0 rmse on "
        f"voiced {f0_rmse:.4f} Hz, short-time RMS max diff {env:.2e}")
    if agree < 0.97 or f0_rmse > 1.0 or env > 0.02:
        raise AssertionError("the port on the card disagrees with the port "
                             "on the CPU")

    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    launches=int(counts.get(key, 0)), max_abs_err=err,
                    ms=ms, plain_ms=pms)
               for n, src, rep, key, err, ms, pms in results]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
