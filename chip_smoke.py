#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (worldtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure raises, so the exit code is not 0):
  1. environment: python/torch/CUDA versions and the card's name and power
     limit (nvidia-smi);
  2. build: the CUDA kernels from worldtpu_torch/csrc/*.cu for sm_90a (one
     nvcc per source, all started together);
  3. main path: batch_wav_to_wav on B=8 synthetic 22.05 kHz utterances
     (bench.synth_utterance_diverse) padded to a multiple of 4096 samples,
     f0_floor 40, pitch x1.2, duration x1.25 (frame period 6.25 ms at
     synthesis), static pulse capacity; checks shape, finiteness, level,
     pulse overflow, and that the zc, refine, OLA and extend kernels each
     ran; reports wall time per batch and the realtime factor, the host
     synchronisations of the main path and of its contour chain (counted
     with CUDA sync debug mode), and, from one torch.profiler run of the
     main path, each stage's host and device time (the ``wt.*`` ranges)
     and the device's busy share of that run's wall;
  4. per kernel, at the main path's shapes: kernel against its plain
     PyTorch version on the card (stated tolerances), median times of both
     from CUDA events; the zc phase-1 entry (zc_kernel.zc_events, the zc
     events kernel's path, driven with the counts set to 0) and the zc
     split (events ms beside full zc ms); the contour chain with the extend
     kernel against the same chain with the plain walk, in turns;
  5. the port on the card against the port on the CPU (plain versions) on
     the tests/fixtures/t22.wav batch: F0 and short-time RMS envelope;
  6. the user entry points on the card: HarvestKernel.compute_batch with
     the capacity check on the B=8 batch (F0 equal to the main path's),
     HarvestKernel.compute on the batch's audio as one long utterance (the
     device contour chain past 8192 frames, with its peak device memory),
     api.World.copy_synthesis on t22, and the CLI (analyze, synthesize,
     copy-syn --fused) with --device cuda on t22 into a temporary directory.

The line before the last is a JSON object {"kernels": [...]}: for each
kernel its launches in the main path's run (zc_events: in its own path's
run), its largest difference from its plain version and both times.  The
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside the repository, the script exits non-zero and prints no result.
"""

import collections
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
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


def wall_ms(torch, fn, reps):
    """Median host wall of fn() ending in a synchronize, in ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)


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
    from worldtpu_torch.ops import (extend_kernel, ola_kernel, refine_kernel,
                                    zc_kernel)
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
    for k in ("wt_zc", "wt_refine_sums", "wt_ola", "wt_extend"):
        if counts.get(k, 0) < 1:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 f"main path")

    with torch.no_grad():
        _, n_path = count_syncs(torch, lambda: batch_wav_to_wav(x, noise,
                                                                **kw))
        mean = torch.zeros(BATCH, device=dev)
        hcand, hscore = H.harvest_device_stages(x, mean, geo=geo)

        def chain():
            return CDV.fix_and_smooth(hcand, hscore, n_grid, geo.frame_period)

        _, n_contour = count_syncs(torch, chain)
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
                        "worldtpu/ops/zc_kernel.py:112", counts["wt_zc"],
                        zerr, z_ms, z_plain))

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
                        "worldtpu/ops/refine_kernel.py:49",
                        counts["wt_refine_sums"], rerr, r_ms, r_plain))

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
                        "worldtpu/ops/ola_kernel.py:51", counts["wt_ola"],
                        oerr, o_ms, o_plain))

        # the extend walk on the batch's own walks: the arguments the
        # contour chain passes (one call per chain)
        seen = []
        real_walk = extend_kernel.extend_walk

        def spy(*a, **k):
            seen.append((a, k))
            return real_walk(*a, **k)

        extend_kernel.extend_walk = spy
        try:
            chain()
        finally:
            extend_kernel.extend_walk = real_walk
        if len(seen) != 1:
            raise AssertionError(f"{len(seen)} extend walks per chain")
        wargs, wkw = seen[0]
        ek = extend_kernel.extend_walk_cuda(*wargs, **wkw)
        ep = extend_kernel.extend_walk_plain(*wargs, **wkw)
        eerr = max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(ek, ep))
        n_on = ek[2]
        log(f"extend: {tuple(n_on.shape)} walks (B, W), S={wargs[0].shape[2]}"
            f", steps run {int(n_on.sum())} of "
            f"{n_on.numel() * (wkw['ext_lim'] + 1)} (longest "
            f"{int(n_on.max())}); kernel vs plain in vals/scs/n_on/so: max "
            f"abs diff {eerr} (tol 0, exact)")
        if not all(torch.equal(a, b) for a, b in zip(ek, ep)):
            raise AssertionError("extend kernel disagrees with its plain "
                                 "version")
        e_ms = median_ms(torch, lambda: extend_kernel.extend_walk_cuda(
            *wargs, **wkw), 20)
        e_plain = median_ms(torch, lambda: extend_kernel.extend_walk_plain(
            *wargs, **wkw), 5)
        results.append(("extend", "worldtpu_torch/csrc/extend.cu",
                        "worldtpu/ops/extend_kernel.py:44",
                        counts["wt_extend"], eerr, e_ms, e_plain))

        # the zc phase-1 entry, its own path: counts from 0
        groups = zc_kernel.make_groups(geo)
        _build.launches.clear()
        evs = zc_kernel.zc_events(filt, geo)
        torch.cuda.synchronize()
        ev_launches = _build.launches["wt_zc_events"]
        if ev_launches != len(groups):
            raise AssertionError(f"zc events: {ev_launches} launches for "
                                 f"{len(groups)} groups")
        zeerr, kept, same = 0.0, 0, True
        for g, (ev, cc) in zip(groups, evs):
            pev, pcc = zc_kernel.zc_events_plain(filt, g.lo, g.hi,
                                                 e_cap=g.e_cap,
                                                 c_row=g.c_row)
            same = same and torch.equal(cc, pcc) and torch.equal(ev, pev)
            fin = torch.isfinite(pev)
            if torch.equal(fin, torch.isfinite(ev)):
                zeerr = max(zeerr, float((ev - pev)[fin].abs().max()))
            else:
                same = False
            kept += int(pcc.sum())
        log(f"zc events: {len(groups)} groups, e_cap {groups[0].e_cap}.."
            f"{groups[-1].e_cap}, c_row {groups[0].c_row}..{groups[-1].c_row}"
            f", {kept} kept events; kernel vs plain: counts and +inf "
            f"positions equal {same}, max abs diff {zeerr} (tol 0, exact)")
        if not same:
            raise AssertionError("zc events kernel disagrees with its plain "
                                 "version")
        ze_ms = median_ms(torch, lambda: zc_kernel.zc_events(filt, geo), 10)
        ze_plain = median_ms(torch, lambda: [zc_kernel.zc_events_plain(
            filt, g.lo, g.hi, e_cap=g.e_cap, c_row=g.c_row)
            for g in groups], 3)
        log(f"zc split: events alone (phase 1, {len(groups)} launches) "
            f"{ze_ms:.3f} ms beside the full zc kernel {z_ms:.3f} ms  "
            f"[{card}]")
        results.append(("zc_events", "worldtpu_torch/csrc/zc_events.cu",
                        "worldtpu/ops/zc_kernel.py:349", ev_launches, zeerr,
                        ze_ms, ze_plain))

        # the contour chain and the main path with the plain walk (before
        # the extend kernel) and with the kernel, in turns in this process
        walls = {"plain": [], "kernel": []}
        paths = {"plain": [], "kernel": []}
        for mode in ("plain", "kernel", "kernel", "plain"):
            if mode == "plain":
                extend_kernel.extend_walk = extend_kernel.extend_walk_plain
            try:
                chain()
                walls[mode].append(round(wall_ms(torch, chain, 10), 3))
                paths[mode].append(round(wall_ms(
                    torch, lambda: batch_wav_to_wav(x, noise, **kw), 5), 3))
            finally:
                extend_kernel.extend_walk = real_walk
        log(f"contour chain (fix_and_smooth, B={BATCH}) wall, medians of 10 "
            f"in turns: plain walk {walls['plain']} ms, extend kernel "
            f"{walls['kernel']} ms; main path, medians of 5: plain walk "
            f"{paths['plain']} ms, extend kernel {paths['kernel']} ms  "
            f"[{card}]")
        extend_kernel.extend_walk = extend_kernel.extend_walk_plain
        try:
            _, _, st_plain = stage_profile(
                torch, lambda: batch_wav_to_wav(x, noise, **kw))
        finally:
            extend_kernel.extend_walk = real_walk
        hp, dp = st_plain["wt.contour"]
        hk_, dk_ = stages["wt.contour"]
        log(f"profiled wt.contour: plain walk host {hp:.3f} ms device "
            f"{dp:.3f} ms; extend kernel host {hk_:.3f} ms device "
            f"{dk_:.3f} ms  [{card}]")
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

    # ---- 6. the user entry points on the card ----
    from worldtpu_torch import api
    _build.launches.clear()
    hk = H.HarvestKernel(FS, T, f0_floor=40.0, device=dev)
    t0 = time.perf_counter()
    hres = hk.compute_batch(x, check_capacity=True)
    h_ms = (time.perf_counter() - t0) * 1000
    viol = H.zc_capacity_violations_batch(x, geo=geo)
    hf0 = torch.tensor(np.stack([r[0] for r in hres]), dtype=torch.float32,
                       device=dev)
    same = torch.equal((hf0 * PITCH).to(torch.float32), f0)
    log(f"HarvestKernel.compute_batch(check_capacity=True), B={BATCH}: "
        f"{h_ms:.1f} ms, zc event-buffer overflows {viol.tolist()}, F0 "
        f"equal to the main path's (before pitch scaling): {same}")
    if bool(viol.any()) or not same:
        raise AssertionError("HarvestKernel disagrees with the main path")
    # one long utterance (the batch's audio end to end, past the 8192
    # frames where CPU input takes the host chain): the card keeps the
    # device contour chain
    x_long = torch.cat([x[i, :int(n)] for i, n in enumerate(lengths)])
    hk_long = H.HarvestKernel(FS, x_long.shape[0], f0_floor=40.0, device=dev)
    _build.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    l_ms = []
    for _ in range(2):          # the first call at a new geometry is cold
        t0 = time.perf_counter()
        f0_long, _ = hk_long.compute(x_long)
        l_ms.append((time.perf_counter() - t0) * 1000)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    voiced_long = float((f0_long > 0).mean())
    log(f"HarvestKernel.compute, one {x_long.shape[0] / FS:.2f} s utterance "
        f"({hk_long.geo.f0_length} frames of 1 ms): first call "
        f"{l_ms[0]:.1f} ms, second {l_ms[1]:.1f} ms, peak device memory "
        f"{peak_gb:.2f} GiB, voiced {voiced_long:.3f}, launches "
        f"{dict(_build.launches)}  [{card}]")
    if (f0_long.shape != (hk_long.get_samples(),)
            or not np.isfinite(f0_long).all() or voiced_long < 0.2
            or _build.launches["wt_extend"] < 1):
        raise AssertionError("long-utterance Harvest on the card")
    _build.launches.clear()

    world = api.World(fs22, f0_floor=40.0, device=dev)
    world.copy_synthesis(x22, pitch_scale=PITCH, duration_scale=DUR)
    t0 = time.perf_counter()
    yw, f0w = world.copy_synthesis(x22, pitch_scale=PITCH,
                                   duration_scale=DUR)
    w_ms = (time.perf_counter() - t0) * 1000
    rms_w = float(np.sqrt(np.mean(yw ** 2)))
    log(f"World.copy_synthesis t22 ({len(x22) / fs22:.2f} s): {w_ms:.1f} ms "
        f"wall, output {yw.shape[0]} samples, rms {rms_w:.4f}, voiced "
        f"{float((f0w > 0).mean()):.3f}  [{card}]")
    if yw.shape[0] != out22 or not np.isfinite(yw).all() or rms_w < 0.01:
        raise AssertionError("World.copy_synthesis output")
    entry_counts = dict(_build.launches)
    log(f"entry points' launches: {entry_counts}")
    for k in ("wt_zc", "wt_refine_sums", "wt_ola", "wt_extend"):
        if entry_counts.get(k, 0) < 1:
            raise AssertionError(f"kernel {k} not launched by the entry "
                                 f"points")

    fx = str(root / "tests" / "fixtures" / "t22.wav")
    with tempfile.TemporaryDirectory() as td:
        pre, syn, fused = (str(pathlib.Path(td) / n)
                           for n in ("p", "syn.wav", "fused.wav"))
        for args in (["analyze", fx, pre, "--f32"],
                     ["synthesize", pre, syn, "--f32", "--f0-scale", "1.2"],
                     ["copy-syn", fx, fused, "--fused", "--f0-scale",
                      "1.2"]):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "worldtpu_torch.cli",
                                *args, "--device", "cuda"], cwd=root,
                               capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"cli {args[0]} exited {r.returncode}:"
                                     f"\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-2000:]}")
            log(f"cli {args[0]}: rc 0 in {time.perf_counter() - t0:.1f} s")
        for ext in (".f0", ".spec", ".ap"):
            if not pathlib.Path(pre + ext).stat().st_size:
                raise AssertionError(f"cli analyze wrote no {ext}")
        for path in (syn, fused):
            yc, fsc = read_wav(path)
            rms_c = float(np.sqrt(np.mean(yc ** 2)))
            log(f"cli output {pathlib.Path(path).name}: {yc.shape[0]} "
                f"samples at {fsc} Hz, rms {rms_c:.4f}")
            if fsc != fs22 or not np.isfinite(yc).all() or rms_c < 0.01:
                raise AssertionError(f"cli output {path}")

    jaxy = [m for m in sys.modules
            if m in ("jax", "worldtpu") or m.startswith(("jax.", "worldtpu."))]
    if jaxy:
        raise AssertionError(f"the smoke test imported {jaxy}")

    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    launches=int(launched), max_abs_err=err, ms=ms,
                    plain_ms=pms)
               for n, src, rep, launched, err, ms, pms in results]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
