#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (worldtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU
    python3 chip_smoke.py --baseline DIR
        # also times the earlier designs of the kernels whose sources DIR
        # holds (ola.cu: wt_ola without the pulse count; extend.cu;
        # zc_events.cu: one wt_zc_events call per band group; contour.cu:
        # 8075e49's merge and smoothing; seq_cumsum.cu: 60827b6's one
        # thread a row) against the current ones, in turns

Phases (any failure raises, so the exit code is not 0):
  1. environment: python/torch/CUDA versions and the card's name and power
     limit (nvidia-smi);
  2. build: the CUDA kernels from worldtpu_torch/csrc/*.cu for sm_90a (one
     nvcc per source, all started together), with nvcc's -Xptxas -v report
     (registers, shared memory, spills) of the refine, zc and zc events
     kernels;
  3. main path: batch_wav_to_wav on B=8 synthetic 22.05 kHz utterances
     (bench.synth_utterance_diverse) padded to a multiple of 4096 samples,
     f0_floor 40, pitch x1.2, duration x1.25 (frame period 6.25 ms at
     synthesis), static pulse capacity, through the graph cache
     (parallel/graphs.py: the first call eager, the second captured and
     replayed, later calls replayed); checks shape, finiteness, level,
     pulse overflow, that the zc, refine, OLA, extend, D4C,
     pulse-response and the two contour kernels each ran once a batch,
     eagerly (counted at the
     wrappers; the kernels line's launches) and replayed (the capture's recorded counts,
     and each kernel once in a profiled replay's device trace), and which
     event layout zc used; the replayed F0, y and overflow flags bit-equal
     to the eager program's, also for a second, equal geometry object and
     after EVICT_GEOMETRIES other geometries ran eagerly in between (the
     programs keep the device constants they read); reports wall time per batch and the realtime factor,
     eager and replayed in turns (medians of 5), the host synchronisations
     of the eager and the replayed path and of the contour chain alone
     (counted with CUDA sync debug mode; gate 0), from one torch.profiler
     run of the eager path each stage's host and device time (the
     ``wt.*`` ranges) and the device's busy share of that run's wall, the
     replayed path's busy share, and peak device memory eagerly and with
     one and two captured programs;
  4. per kernel, at the main path's shapes: kernel against its plain
     PyTorch version on the card (stated tolerances); the kernel's device
     time alone (``device_ms``: the wrapper's launches captured once, with
     their arguments and outputs allocated once, then issued again through
     the C entries N times back to back between two CUDA events, queued
     behind a sleep kernel so the device never waits for the host inside
     the window, divided by N), its wrapper-inclusive time (median of CUDA
     events around single wrapper calls, as measured before) and the
     plain version's; the kernel's bound (the larger of its bytes over
     3.35 TB/s and its operations over 67 TFLOP/s, counted from this run's
     inputs) and, for OLA, the one PyTorch call that computes the same sums
     (index_add_, device time alone); the pulse-response kernel against
     the plain chain it replaced (each real row's relative RMS within
     PULSE_ROW_REL, padded rows zero, the voicing gate equal), with the
     chain's own device time alone as the old design; the D4C kernel
     against its plain chain on the main path's own D4C call and on a
     48 kHz batch of 8 (rows of frames both call active within D4C_ATOL,
     each gate flip at a float64 LoveTrain ratio within D4C_KNIFE of the
     threshold, inactive rows the default), with the chain's device time
     alone as the old design and the bound counted from the frames the
     gate let through; OLA's real and padding pulses,
     extend's longest walk and device time per step of it (the chain's
     floor); the zc phase-1 entry (zc_kernel.zc_events, the zc events
     kernel's path, driven with the counts set to 0) and the zc split
     (events ms beside full zc ms); with --baseline, the earlier OLA and
     extend designs against the current ones (old, new, new, old); the
     contour chain with the extend kernel against the same chain with the
     plain walk, in turns; the contour kernels (section filter and merge,
     per-section smoothing) against their plain versions on the main
     path's batch and on phase 6's long utterance (the merge's
     shared-memory rows), on phase 9's 60 s test signal (its global-memory
     rows) and on the fixtures t22, t16 and t48: the merge's section sums
     bit-equal to the CPU plain version, its keep and merge decisions
     equal but within KNIFE_REL of their threshold (each printed), its
     output and the whole chain (within CONTOUR_F0_ATOL, identical
     voicing) equal to the plain versions' on every row without such a
     flip, the smoothing bit-equal to the host float64 filter rounded
     once on every live section and within CONTOUR_F0_ATOL of its plain
     version; per shape the live sections and the longest, the smoothing's
     longest chain run, its orbit and cycle hits and full-run stretches
     (its trace), and the merge's sections summed in parallel and in frame
     order; with --baseline holding contour.cu, 8075e49's two kernels on the
     main batch, the long utterance and the 60 s signal: the chain's F0
     with them bit-equal to this one's on every row without a printed
     knife-edge decision, and each kernel's device time alone in turns;
  5. the port on the card against the port on the CPU (plain versions) on
     the tests/fixtures/t22.wav batch: F0 and short-time RMS envelope;
     and Harvest on each of the main path's utterances, card against CPU:
     voicing identical (where not, the differing merge decisions are
     printed);
  6. the user entry points on the card: HarvestKernel.compute_batch with
     the capacity check on the B=8 batch (F0 equal to the main path's),
     then replayed (HarvestKernel.forward's captured program) against the
     eager program: F0 bit-equal, launches equal, walls in turns;
     HarvestKernel.compute on the batch's audio as one long utterance (the
     device contour chain past 8192 frames and zc's global event layout,
     with its peak device memory beside the same call with the contour
     chain's plain versions: no higher), api.World.copy_synthesis on t22,
     and the
     CLI (analyze, synthesize, copy-syn --fused) with --device cuda on t22
     into a temporary directory, each in a process where ``jax`` and
     ``worldtpu`` cannot be imported;
  7. float64 on the card (the parity path: dtype=torch.float64 through the
     same entry points, no fallback to the CPU) at full width on the
     tests/fixtures utterances t22, t16 and t48, against the C++ golden
     dumps: Harvest against t*.f0.gz (voicing identical, F0 RMSE < 1e-3
     Hz), CheapTrick and D4C with the xorshift dither streams against
     t*.spec.gz and t*.ap.gz (q99.9 < 1e-6), Synthesis with the xorshift
     noise against t*.syn2.f64.gz (max abs error < 1e-8 x scale), each
     figure beside its gate and beside the tolerance the CPU tests meet,
     with the wall of each entry point; the launches of the path's two
     float64 kernels (the OLA kernel's double instantiation and the
     sequential cumulative sum), counted from 0; both kernels against their
     plain versions at t22's shapes (OLA within 1e-12 relative of
     index_add_; every cumulative-sum launch of t22's D4C and Synthesis
     bit-equal to numpy.cumsum of its own input), their device
     times, bounds and library calls (index_add_, torch.cumsum); the
     latency of a dependent __dadd_rn (one thread, DADD_STEPS adds between
     clock64 reads: cycles, ns, the SM clock) and, for the cumulative sum
     at t22's largest launch, t22's time base and (after the next item)
     the time base of phase 6's long utterance's float64 F0, the C entry's
     launch plan against seqsum.plan, the device time alone, ns a step
     against the add latency, the chain floor ((n - 1) x the latency) and
     the bytes floor (the kernels line's bound is the larger), and with
     --baseline holding seq_cumsum.cu the earlier design bit-equal and
     timed in turns; float64
     Harvest at length: phase 6's long utterance through
     HarvestKernel.compute(dtype=torch.float64), its wall, peak device
     memory and agreement with phase 6's float32 F0 (voicing >= 0.97, F0
     RMSE <= 1 Hz), two calls; the host syncs of the float64 device
     stages (after the host mean, before the download) on t22 and on that
     utterance (CUDA sync debug mode; gate 0); and the CLI analyze +
     synthesize without --f32, --device cuda, with ``jax`` and
     ``worldtpu`` blocked;
  8. the codec and corpus streaming on the card: (a) bench.py config 5's
     corpus (16 bench.synth_utterance_diverse wavs written as 16-bit
     files) through io.corpus.iter_corpus (the C++ reader, required) in
     batches of 8 padded to 4096 samples and 16 frames, one geometry per
     padded length, batch_wav_to_wav (pitch x1.2, duration x1.25),
     batch k's download and slice_outputs overlapped with batch k+1;
     checks 16 finite, audible outputs of their slice_outputs lengths, no
     pulse overflow and one launch of each main-path kernel per batch
     (counted from 0); the first pass eager, the second capturing one
     program per padded length, later passes replayed, their F0 and
     outputs bit-equal to the first pass's; reports the first pass's wall,
     the capturing pass's, and steady passes with and without the
     overlap, in turns, and
     HarvestKernel.compute_corpus against compute_batch and the eager
     program (F0 equal bit for bit, launches equal, walls in turns); (b)
     the codec in float64 on the C++ dumps of
     t22, t16, t48 at tests/test_codec.py's tolerances, and in float32 on
     the main path's spectrogram and aperiodicity against the CPU, with
     each function's device time; (c) MCD (bench.quality_metrics) against
     the C++ spectrogram dumps: float64 Harvest + CheapTrick on the card
     and the float64 codec round trip, each < 0.1 dB; float32 reported;
  9. long audio on the card (longaudio.LongPipeline, analysis.longform.
     LongHarvest) on one 10-minute recording, bench.synth_utterance_diverse
     utterances joined to 600 s at 22.05 kHz, f0_floor 40, Harvest chunks
     of 8 s with 1 s halos, synthesis chunks of 1000 frames, pitch x1.2,
     duration x1.25: (a) LongHarvest (float32 on the card: the device
     contour chain) against the unchunked HarvestKernel.compute (the same
     chain), on tests/test_longform.py's 60 s signal (its gates: voicing
     identical, F0 RMSE < 0.1 Hz, max < 5 Hz) and on the recording's
     first minute of whole utterances (voicing agreement >= 0.99, median
     |dF0| < 0.01 Hz; the unchunked stages with the host contour reported
     beside it, with both peaks of device memory), and
     copy_synthesis against the unchunked CheapTrick + D4C + synthesis on
     its F0 with the same indexed_noise rows (pulse positions identical;
     100 ms windowed relative error q99 < 1e-3 and q90 < 0.1; block
     analysis frames that differ from the unchunked analysis counted);
     (b) the 600 s recording, sequential and parallel=True in turns, their
     chunk steps (and the prescan's) replayed from captured CUDA graphs,
     each loop's own (finite, rms > 0.01, no pulse overflow, F0 identical
     between the modes, waveforms within (a)'s gates; each mode's wall and
     realtime factor, and the memory reserved after it; LongHarvest's wall
     split into device stages, the stitching on the device and the device
     contour chain, and the device chain against the host chain on the
     same candidates (voicing agreement, median and maximum |dF0|, both
     contours' walls); the
     synthesis loops alone eager and replayed in turns, y bit-equal,
     launches equal but the capture's eager step, the replayed loop's
     peak reserved memory within the eager loop's plus three eager step
     working sets and 256 MiB and the second replayed loop's within the
     first's, with the pool each capture reserved; one replayed chunk step
     profiled (its device trace shows the OLA, pulse and noise kernels
     once), the noise kernel's rows at that step against the plain
     version's bit for bit (the kernels line's "noise" row); host syncs of
     each loop (replayed: at most the flags' read after the last replay);
     zc, refine, extend, merge, smoothing and OLA launches counted from
     0; peak device memory within
     the first 150 s run's peak plus the input, table and stitched
     candidate bytes that grow,
     plus 5%);
     (c) OLA on one parallel group's [8, Pmax, fft] and zc and refine on
     two LongHarvest windows [2, 220,500] against their plain versions at
     phase 4's tolerances;
 10. (a) the grid_ms fast mode on the main path: phase 3's batch through
     batch_wav_to_wav(grid_ms=2) (a 2 ms candidate grid: zc at grid_hz
     500, refine on half the frames, the extend walk at ext_lim 50 and
     miss_lim 2), its wall per batch in turns with grid_ms=1, the wt.*
     stage table, one launch of zc, refine, OLA and extend a batch, zc and
     extend equal to their plain versions and refine within phase 4's
     tolerance at the grid-2 shapes, F0 at grid 2 against grid 1
     (reported), and HarvestKernel(grid_ms=2) on t16 against the C++ F0 at
     tests/test_harvest.py's gates (vuv > 0.96, RMSE < 5 Hz, median < 0.2
     Hz); (b) float64 long audio on phase 9's recording: one float64
     LongHarvest window's peak memory, LongPipeline.copy_synthesis(dtype=
     torch.float64) on phase 9's 58.52 s cut, sequential and parallel
     (walls, LongHarvest's split, peaks; F0 against phase 9's float32
     LongHarvest: voicing agreement >= 0.97, median |dF0| < 0.05 Hz;
     parallel against sequential: F0 identical, windowed q99 < 1e-3 and
     q90 < 0.1), the synthesis loops alone eager and replayed in turns (y
     bit-equal, launches equal, host syncs, peak reserved memory gated as
     in phase 9), one replayed float64 chunk step profiled (its device
     trace shows the OLA kernel's double instantiation once and the
     sequential cumulative sum as often as an eager step launches it),
     the OLA kernel's double instantiation on a chunk and a
     parallel group (1e-12 relative) and the sequential cumulative sum of
     one chunk step (each launch bit-equal to numpy.cumsum; the largest
     timed as in phase 7, and with --baseline in turns with the earlier
     design) against their plain versions, and the first 150 s sequential (wall, realtime factor, the
     float64 kernels' launches, no float32 kernel; peak within the 58.52 s
     run's plus the bytes that grow, plus 5%).  600 s in float64 is left
     out for the script's time;
 11. the mesh paths (worldtpu_torch.parallel on torch.distributed), on
     phase 3's batch (the mesh path runs eagerly: the graph cache takes
     single-device calls): (a) an NCCL world of this process alone, mesh
     (1, 1): batch_wav_to_wav's F0 and y bit-equal to the single-card
     call, each kernel launched once, its host syncs and wall in turns
     with the single-card call, and what moves y on a shard of 2 rows
     (each stage's bits against the whole batch's rows, cuFFT's rfft by
     row count; reported); (b) four gloo ranks sharing cuda:0
     (``--mesh-rank``: this script, spawned once; a FileStore; every rank
     joined within MESH_JOIN_S or the phase fails), each with meshes
     (4, 1) (make_mesh's default, data only), (2, 2) and (1, 4): Harvest's
     stages (bit-equal to the single-card stages or not, reported), F0
     within 1e-4 Hz with identical voicing and y's 160-sample short-time
     RMS within 0.02 of the single-card results, each kernel launched
     once a batch per rank, zc exact and refine within its tolerance at
     the rank's shard shapes against their plain versions, host syncs,
     walls per batch in turns with the single-card path run by every rank
     at once (ranks time-slice one card: the mesh code's overhead, not
     scaling), peak memory per rank, make_mesh(3, 1) degrading to (4, 1),
     and float64
     batch_copy_synthesis on t22 x4 under (2, 2) at rtol 1e-9 and atol
     1e-12 with the OLA kernel's double instantiation; (c)
     LongPipeline.copy_synthesis(mesh=(2, 2)) on phase 9's 58.52 s cut
     (12 chunks, three a rank) against this process's sequential run
     (every rank's y equal, F0 and pulses identical, windowed q99 < 1e-3
     and q90 < 0.1) and parallel run (bit-equality reported).

The line before the last is a JSON object {"kernels": [...]}: for each
kernel its launches in the main path's run (``launches_main``; zc_events,
off the main path, counts ``launches`` in its own path's run), its largest
difference from its plain version, its device time alone (``ms``), its
wrapper-inclusive time (``call_ms``), its plain version's, its bound and
what bounds it (for the sequential cumulative sum the larger of its chain
floor, n - 1 dependent adds at the measured latency, "operations", and
its bytes; its ``cases`` give each timed launch), the share bound/ms, and the library call's device time
(null where no single PyTorch call computes the function), and its
launches in one pass of phase 8's corpus stream (``launches_corpus``), in
phase 9's 600 s recording, counted in eager calls (LongHarvest's zc,
refine, extend, merge and smoothing in the first sequential run, OLA in
the eager sequential synthesis loop: ``launches_long``; a replay's counts are bookkeeping, and a profiled
replayed chunk step's device trace is gated instead), in one grid-2
batch of phase 10(a) (``launches_grid2``) and in phase 10(b)'s eager
float64 sequential synthesis loop over the 58.52 s cut
(``launches_f64_long``), and per gloo rank of phase 11 in one
(2, 2) batch and its float64 copy-synthesis (``launches_mesh``, a list by
rank); the line above it gives the whole script's wall.  The two contour
kernels (contour_merge, contour_smooth) have no TPU kernel behind them:
their ``replaces`` names the JAX loop each stands for.  Phases 9 and
10(b) start with the graph cache cleared, so that their peaks of device
memory hold no captured program.
The last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or outside the repository, the script exits non-zero and prints no
result.
"""

import argparse
import collections
import ctypes
import json
import pathlib
import re
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

# kernel tolerances (kernel vs plain version, same inputs, same card);
# zc, extend, zc events and the sequential cumulative sum are held to exact
# equality
REFINE_REL = 1e-5      # DFT sums, abs error over the largest |sum|
REFINE_F0_REL = 1e-4   # refined F0, relative, where both are nonzero
OLA_ATOL, OLA_RTOL = 1e-5, 1e-4
PULSE_ROW_REL = 1e-5   # pulse responses: each row's relative RMS
D4C_ATOL = 1e-4        # aperiodicity, frames both call active (the
                       # tolerance the CPU tests hold it to against JAX)
D4C_KNIFE = 1e-6       # a gate flip's LoveTrain ratio from the threshold
OLA_F64_REL = 1e-12    # float64 OLA vs index_add_, of the largest |y|

# float64 on the card against the C++ dumps: (gate on the card, what the CPU
# tests hold the same quantity to)
F64_GATES = {"f0_rmse_hz": (1e-3, 1e-6), "spec_q999_rel": (1e-6, 5e-12),
             "ap_q999_abs": (1e-6, 1e-10), "syn_max_rel": (1e-8, 1e-10)}
F64_FIXTURES = ("t22", "t16", "t48")
# float64 without tensor cores (H100 SXM data sheet); bound() counts
# float32 operations, so a float64 kernel's count is scaled by the ratio
PEAK_F64_FLOP_S = 34e12

# the H100 SXM's data-sheet peaks at 700 W (the kernels' bounds)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# instructions a lane issues: four schedulers an SM, one warp instruction
# (32 lanes) each a clock, against 128 FP32 lanes where an FMA counts two;
# the integer ALU pipe (IADD3, LOP3, SHF, ISETP, ...): 64 lanes an SM
PEAK_ISSUE_S = PEAK_F32_FLOP_S / 2
PEAK_INT32_OPS_S = PEAK_F32_FLOP_S / 4
# the noise kernel's loop, a column on its common path (the normal's w < 5
# branch, fft a multiple of 4): SASS instructions, and those of them on the
# integer ALU pipe; counted in ``cuobjdump -sass`` of csrc/noise.cu built
# for sm_90a as the library builds it (-O3, --fmad=false).  The Threefry's
# adds go half to IADD3 and half to IMAD.IADD on the FMA pipe, so the
# columns are bound by issue.  The block's prologue (its rows' keys, a
# Threefry a row) is left out: the bound is a floor.
NOISE_SASS_A_COLUMN = 155
NOISE_ALU_A_COLUMN = 75


# the C entries of the designs the current kernels replaced (--baseline),
# by source: wt_ola without the pulse count, wt_extend as now, wt_zc_events
# for one band group (filt, ev, ccol, n_rows, nb, lo, nb_g, L, e_cap, c_row,
# n_cols, n_store), 8075e49's contour kernels (wt_contour_merge without
# the ``ordered`` trace; wt_contour_smooth without the scratch row, the
# trace and the cap: f0, st, ed, n_sec, out, B, F, n, NS, lag, chunk), and
# 60827b6's sequential cumulative sum (one thread a row; the entry as now)
_CP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_ENTRIES = {"seq_cumsum.cu": (("wt_seq_cumsum_f64",
                                  (_CP, _CP, _CI, _CI, _CP)),),
               "ola.cu": (("wt_ola", (_CP,) * 3 + (_CI,) * 4 + (_CP,)),),
               "extend.cu": (("wt_extend",
                              (_CP,) * 11 + (_CI,) * 6 + (_CF, _CP)),),
               "zc_events.cu": (("wt_zc_events",
                                 (_CP,) * 3 + (_CI,) * 9 + (_CP,)),),
               "contour.cu": (("wt_contour_merge",
                               (_CP,) * 17 + (_CI,) * 4 + (_CF, _CP)),
                              ("wt_contour_smooth",
                               (_CP,) * 5 + (_CI,) * 6 + (_CP,)))}


# 8075e49's merge kept its two float rows (8 F bytes) in shared memory up to
# this F, else in a [B, 2, F] scratch
OLD_MERGE_SHARED_MAX_F = (227 * 1024 - 1024) // 8


def old_contour_args(name, args, rows=None):
    """The current contour entries' launch arguments as 8075e49's entries
    take them (OLD_ENTRIES["contour.cu"]); ``rows`` is 8075e49's merge
    scratch (old_merge_rows)."""
    if name == "wt_contour_merge":
        return args[:14] + (rows,) + args[15:17] + args[18:]
    return args[:5] + args[7:13]


def old_merge_rows(torch, margs):
    """8075e49's merge scratch for the merge arguments margs: None where its
    rows fit in shared memory."""
    B, F = margs[0].shape
    return (None if F <= OLD_MERGE_SHARED_MAX_F else torch.empty(
        (B, 2, F), dtype=torch.float32, device=margs[0].device))

# runs the CLI (its arguments follow -c) where jax and worldtpu cannot be
# imported, so any import of either by the port fails the command
CLI_NO_JAX = ("import runpy, sys\n"
              "sys.modules['jax'] = None\n"
              "sys.modules['worldtpu'] = None\n"
              "runpy.run_module('worldtpu_torch.cli', run_name='__main__', "
              "alter_sys=True)\n")


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


def capture(_build, fn):
    """(fn(), the kernel launches fn made: [(C entry, device, args)]), the
    arguments' tensors kept alive with them."""
    seen = []
    real = _build.launch

    def spy(name, device, *args):
        seen.append((name, device, args))
        return real(name, device, *args)

    _build.launch = spy
    try:
        out = fn()
    finally:
        _build.launch = real
    return out, seen


def replayer(torch, _build, lib, seen, adapt=None):
    """A function that issues the captured launches again through ``lib``'s
    C entries on the current stream: no checks, no allocation, no count
    (``adapt`` maps (name, args) to the arguments of another build's
    entry)."""
    stream = torch.cuda.current_stream().cuda_stream
    calls = [(getattr(lib, name), name,
              _build.c_args(adapt(name, args) if adapt else args))
             for name, _, args in seen]

    def run():
        for fn, name, args in calls:
            err = fn(*args, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA launch failed ({err})")
    return run


def sleep_cycles_per_ms(torch):
    """The rate of torch.cuda._sleep on this card, in cycles per ms."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10 ** 6)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    torch.cuda.synchronize()
    return 10 ** 7 / a.elapsed_time(b)


def device_ms(torch, cycles_per_ms, run, n, windows=3):
    """Device time of one run() in ms, run() only issuing kernels: CUDA
    events around n back-to-back runs, divided by n, the median of
    ``windows`` windows.  Each window's runs are queued behind a sleep
    kernel that outlasts the host's queueing of them (checked), so the
    device never waits for the host between the two events."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    queue_ms = (time.perf_counter() - t0) * 1000
    torch.cuda.synchronize()
    times = []
    sleep_ms = 2 * queue_ms + 1.0
    while len(times) < windows:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        queued = (time.perf_counter() - t0) * 1000
        b.record()
        torch.cuda.synchronize()
        if queued < 0.8 * s.elapsed_time(a):
            times.append(a.elapsed_time(b) / n)
        elif sleep_ms > 1000:
            raise RuntimeError(f"device_ms: queueing {n} runs took "
                               f"{queued:.1f} ms, past any sleep")
        else:
            sleep_ms *= 2
    return statistics.median(times)


def bound(n_bytes, n_ops):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take to move n_bytes and do n_ops float32 operations (no tensor
    cores)."""
    tb = n_bytes / PEAK_BYTES_S * 1e3
    to = n_ops / PEAK_F32_FLOP_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


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


# dependent double adds of the latency probe (wt_dadd_latency)
DADD_STEPS = 1 << 20


def dadd_latency(torch, lib, dev):
    """The latency of one dependent __dadd_rn on this card, the sequential
    cumulative sum's floor a step: one thread runs DADD_STEPS dependent
    adds between two clock64() reads (wt_dadd_latency).  Returns cycles a
    step (clock64), ns a step (CUDA events around the launch), the SM clock
    the two imply (MHz) and nvidia-smi's clocks.sm after the run."""
    inp = torch.tensor([1.0, 2.0 ** -60], dtype=torch.float64, device=dev)
    out = torch.empty(1, dtype=torch.float64, device=dev)
    cyc = torch.empty(1, dtype=torch.int64, device=dev)

    def run():
        err = lib.wt_dadd_latency(inp.data_ptr(), out.data_ptr(),
                                  cyc.data_ptr(), DADD_STEPS,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wt_dadd_latency: CUDA launch failed ({err})")

    run()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    torch.cuda.synchronize()
    cycles = int(cyc.item()) / DADD_STEPS
    ns = a.elapsed_time(b) * 1e6 / DADD_STEPS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if not float(out.item()) == 1.0 or not 0 < cycles < 1000:
        raise AssertionError(f"the add latency probe: sum {out.item()!r}, "
                             f"{cycles} cycles a step")
    return dict(cycles=cycles, ns=ns, mhz=cycles / ns * 1e3, smi=smi)


def bits_equal(a, b):
    """numpy arrays equal bit for bit (-0.0 apart from +0.0), NaN where
    NaN."""
    na, nb = np.isnan(a), np.isnan(b)
    return (a.shape == b.shape and np.array_equal(na, nb)
            and np.array_equal(a[~na].view(np.int64), b[~nb].view(np.int64)))


def cumsum_case(torch, cycles_per_ms, lib, old, seen, dadd, label, reps):
    """One launch of the sequential cumulative sum, ``seen`` a captured
    (entry, device, (x, out, n_rows, n)): its output bit-equal to
    numpy.cumsum of its input; the C entry's plan (wt_seq_cumsum_plan)
    equal to seqsum.plan; its device time alone and ns a step against the
    add latency; the chain floor ((n - 1) dependent adds at dadd["ns"]) and
    the bytes floor (input and output once at PEAK_BYTES_S); with ``old``
    (a baseline library holding an earlier seq_cumsum.cu) the earlier
    design's output bit-equal to this one's and both device times alone in
    turns (old, new, new, old).  Raises on a failed gate; returns the
    figures."""
    from worldtpu_torch import _build
    from worldtpu_torch.ops import seqsum
    name, d, (cx, cout, n_rows, n) = seen
    torch.cuda.synchronize()
    got = cout.cpu().numpy().reshape(n_rows, n)
    with np.errstate(invalid="ignore"):
        want = np.cumsum(cx.cpu().numpy().reshape(n_rows, n), axis=-1)
    sms = torch.cuda.get_device_properties(d).multi_processor_count
    buf = (ctypes.c_int * 5)()
    lib.wt_seq_cumsum_plan(n_rows, n, 0, ctypes.addressof(buf))
    plan = seqsum.plan(n_rows, n, sms)
    plan_c = (("rows", "long")[buf[0]],) + tuple(buf[1:])
    exact = bits_equal(got, want)
    r = dict(label=label, shape=[n_rows, n], regime=plan.regime,
             rows_a_block=plan.rows, blocks=plan.blocks,
             chain_floor_ms=(n - 1) * dadd["ns"] * 1e-6,
             bytes_floor_ms=2 * n_rows * n * 8 / PEAK_BYTES_S * 1e3)
    new_run = replayer(torch, _build, lib, [seen])
    if old is None:
        r["ms"] = device_ms(torch, cycles_per_ms, new_run, reps)
        turns = ""
    else:
        o_out = torch.empty_like(cout)
        old_seen = [(name, d, (cx, o_out, n_rows, n))]
        old_run = replayer(torch, _build, old, old_seen)
        old_run()
        torch.cuda.synchronize()
        r["old_same"] = torch.equal(o_out.view(torch.int64),
                                    cout.view(torch.int64))
        r["old_ms"], r["new_ms"] = [], []
        for turn in ("old", "new", "new", "old"):
            r[f"{turn}_ms"].append(device_ms(
                torch, cycles_per_ms, old_run if turn == "old" else new_run,
                reps))
        r["ms"] = statistics.median(r["new_ms"])
        turns = (f"; the earlier design (--baseline) bit-equal "
                 f"{r['old_same']}, in turns (old, new, new, old): old "
                 f"{[round(v, 4) for v in r['old_ms']]} ms, new "
                 f"{[round(v, 4) for v in r['new_ms']]} ms")
    r["step_ns"] = r["ms"] * 1e6 / max(n - 1, 1)
    log(f"seq_cumsum, {label} {(n_rows, n)}: regime {plan.regime}, "
        f"{plan.rows} rows a block, {plan.blocks} blocks, chunk "
        f"{plan.chunk}, {plan.smem} B shared (C plan equal "
        f"{plan_c == tuple(plan)}); bit-equal to numpy.cumsum {exact}; "
        f"{r['ms']:.4f} ms device time alone = {r['step_ns']:.2f} ns a step "
        f"= {r['step_ns'] / dadd['ns']:.2f}x the add latency "
        f"{dadd['ns']:.3f} ns; chain floor {r['chain_floor_ms']:.4f} ms, "
        f"bytes floor {r['bytes_floor_ms']:.4f} ms" + turns
        + f"  [{card_line()}]")
    if not exact or plan_c != tuple(plan) or not r.get("old_same", True):
        raise AssertionError(f"the sequential cumulative sum at {label} "
                             f"{(n_rows, n)}")
    return r


def cumsum_bound(case):
    """(the larger of the chain and the bytes floor, what bounds it: the
    chain's dependent adds are operations)."""
    c, b = case["chain_floor_ms"], case["bytes_floor_ms"]
    return (c, "operations") if c >= b else (b, "bytes")


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


def main(argv=None):
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap_.add_argument("--baseline", type=pathlib.Path, default=None,
                     help="a directory with earlier ola.cu, extend.cu, "
                          "zc_events.cu, contour.cu or seq_cumsum.cu to "
                          "time in turns with the current kernels")
    ap_.add_argument("--mesh-rank", type=int, default=None,
                     help="internal: run one gloo rank of phase 11")
    ap_.add_argument("--mesh-dir", type=pathlib.Path, default=None,
                     help="internal: phase 11's directory of references")
    args = ap_.parse_args(argv)
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank, args.mesh_dir)
    baseline = args.baseline
    old_sources = [] if baseline is None else [
        f for f in OLD_ENTRIES if (baseline / f).is_file()]
    if baseline is not None and not old_sources:
        print(f"chip_smoke: {baseline} holds none of {sorted(OLD_ENTRIES)}",
              file=sys.stderr)
        return 2
    t_script = time.perf_counter()
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
    from worldtpu_torch.ops import (extend_kernel, ola_kernel, pulse_kernel,
                                    refine_kernel, zc_kernel)
    from worldtpu_torch.parallel import batch as PB, graphs as PG
    from worldtpu_torch.parallel.batch import (batch_analyze,
                                               batch_wav_to_wav, pad_batch)
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
        f"(nvcc {_build.build_seconds:.1f} s; flags {' '.join(_build.NVCC_FLAGS)}"
        f"; --fmad=true for {sorted(_build.FMAD)}, false for the rest)")
    for stem in ("refine", "zc", "zc_events", "contour", "seq_cumsum"):
        for line in _build.ptxas_report.get(stem, "").splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"  ptxas {stem}: {line.strip()}")

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

    static = {k: v for k, v in kw.items() if k != "pitch_scale"}

    def run():
        out = batch_wav_to_wav(x, noise, **kw)
        torch.cuda.synchronize()
        return out

    def run_eager():
        # the program batch_wav_to_wav captures, called outside the cache
        with torch.no_grad():
            out = PB._wav_to_wav(x, noise, PG.scale_buffer(PITCH, x),
                                 grid_ms=1, **static)
        torch.cuda.synchronize()
        return out

    def mem():
        return (torch.cuda.max_memory_allocated() / 2 ** 30,
                torch.cuda.memory_allocated() / 2 ** 30,
                torch.cuda.memory_reserved() / 2 ** 30)

    PG.clear()
    # the kernels line's main-path launches: the first call, eager, through
    # the entry point (each wrapper counts where it launches)
    _build.launches.clear()
    zc_kernel.layout_launches.clear()
    t0 = time.perf_counter()
    run()
    log(f"main path first call (eager): {time.perf_counter() - t0:.3f} s")
    counts = dict(_build.launches)
    main_layouts = dict(zc_kernel.layout_launches)
    torch.cuda.reset_peak_memory_stats()
    run_eager()
    peaks = {"eager call, no program": mem()}
    t0 = time.perf_counter()
    run()
    log(f"main path second call (eager again, capture, replay): "
        f"{time.perf_counter() - t0:.3f} s; programs {len(PG.programs())}")
    if len(PG.programs()) != 1:
        raise AssertionError("the second call did not capture a program")
    torch.cuda.reset_peak_memory_stats()
    run()
    peaks["replay, one program"] = mem()
    _build.launches.clear()
    t0 = time.perf_counter()
    y, f0, ovf = run()
    walls = [time.perf_counter() - t0]
    rcounts = dict(_build.launches)
    for _ in range(4):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    _build.launches.clear()
    ye, f0e, ovfe = run_eager()
    eager_counts = dict(_build.launches)
    same_bits = (torch.equal(y, ye) and torch.equal(f0, f0e)
                 and torch.equal(ovf, ovfe))
    audio_s = float(lengths.sum()) / FS
    y_np = y.cpu().numpy()
    rms = float(np.sqrt(np.mean(y_np ** 2)))
    log(f"main path launches: the first call (eager) {counts}; a replayed "
        f"batch (the counts its capture recorded) {rcounts}; the eager "
        f"program {eager_counts}; zc event layout: {main_layouts} (e_max "
        f"{geo.e_max})")
    log(f"main path replayed: F0, y and the overflow flags bit-equal to the "
        f"eager program {same_bits} (F0 max |d| "
        f"{float((f0 - f0e).abs().max()):.3e} Hz, y max |d| "
        f"{float((y - ye).abs().max()):.3e})")
    log(f"main path wall per batch (replayed): median {wall * 1000:.1f} ms "
        f"of {[round(w * 1000, 1) for w in walls]}; input audio "
        f"{audio_s:.2f} s; realtime factor {audio_s / wall:.1f}x  [{card}]")
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
    for k in MAIN_KERNELS:
        if {counts.get(k, 0), rcounts.get(k, 0),
                eager_counts.get(k, 0)} != {1}:
            raise AssertionError(f"kernel {k} was launched "
                                 f"{counts.get(k, 0)} times by the first "
                                 f"call, {rcounts.get(k, 0)} by a replayed "
                                 f"batch and {eager_counts.get(k, 0)} by "
                                 f"the eager program, not once")
    if not same_bits:
        raise AssertionError("the replayed main path is not bit-equal to "
                             "the eager program")
    turns = {"eager": [], "replayed": []}
    for mode in ("eager", "replayed", "replayed", "eager"):
        turns[mode].append(round(wall_ms(
            torch, run_eager if mode == "eager" else run, 5), 3))
    med = {k: statistics.median(v) for k, v in turns.items()}
    log(f"main path wall per batch in turns (eager, replayed, replayed, "
        f"eager), medians of 5: eager {turns['eager']} ms, replayed "
        f"{turns['replayed']} ms; {audio_s / med['eager'] * 1000:.1f}x / "
        f"{audio_s / med['replayed'] * 1000:.1f}x realtime  [{card}]")

    with torch.no_grad():
        _, n_eager = count_syncs(torch, run_eager)
        _, n_path = count_syncs(torch, lambda: batch_wav_to_wav(x, noise,
                                                                **kw))
        mean = torch.zeros(BATCH, device=dev)
        hcand, hscore = H.harvest_device_stages(x, geo=geo)

        def chain():
            return CDV.fix_and_smooth(hcand, hscore, n_grid, geo.frame_period)

        _, n_contour = count_syncs(torch, chain)
    log(f"host syncs per batch (CUDA sync debug mode): eager {n_eager}, "
        f"replayed {n_path}, the contour chain alone {n_contour} (gate 0)")
    if n_eager or n_path or n_contour:
        for nm, fn in (("eager", run_eager), ("replayed", run),
                       ("contour chain", chain)):
            log(f"first sync of the {nm} path: {sync_site(torch, fn)}")
        raise AssertionError("the main path synchronizes the host")
    p_wall, acts, stages = stage_profile(torch, run_eager)
    busy = sum(a[1] for a in acts)
    log(f"profiled main path, eager: wall {p_wall:.1f} ms (profiler on), "
        f"device busy {busy:.1f} ms = {100 * busy / p_wall:.1f}% of that "
        f"wall, {len(acts)} device activities  [{card}]")
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
    r_wall, r_acts, _ = stage_profile(torch, run)
    r_busy = sum(a[1] for a in r_acts)
    log(f"profiled main path, replayed: wall {r_wall:.1f} ms (profiler on), "
        f"device busy {r_busy:.1f} ms = {100 * r_busy / r_wall:.1f}% of that "
        f"wall, {len(r_acts)} device activities  [{card}]")
    # a replay's counts are what its capture recorded: the device trace
    # shows which kernels the replay really ran
    e_tr, r_tr = traced_kernels(acts), traced_kernels(r_acts)
    log(f"our kernels in one batch's device trace: eager {e_tr}, replayed "
        f"{r_tr} (gate: each once)")
    if any(e_tr[k] != 1 or r_tr[k] != 1 for k in MAIN_KERNELS):
        raise AssertionError("the device trace does not show each kernel "
                             "once a batch")
    akw = dict(geo=geo, fs=FS, fft_size=ck.fft_size,
               max_half_window=ck.max_half_window, pitch_scale=PITCH)
    for _ in range(2):                     # eager, then captured
        batch_analyze(x, **akw)
    a_rep = batch_analyze(x, **akw)
    with torch.no_grad():
        a_eag = PB._analyze(x, PG.scale_buffer(PITCH, x), **{
            k: v for k, v in akw.items() if k != "pitch_scale"}, grid_ms=1)
    a_same = all(torch.equal(u, v) for u, v in zip(a_rep, a_eag))
    log(f"batch_analyze replayed: F0, spectrogram and aperiodicity "
        f"bit-equal to the eager program {a_same}")
    if not a_same:
        raise AssertionError("the replayed batch_analyze is not bit-equal "
                             "to the eager program")
    del a_rep, a_eag
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    peaks["replay, two programs"] = mem()
    log("peak device memory during a call, memory held after it, "
        "reserved by the allocator (GiB): " + "; ".join(
            f"{k} {v[0]:.3f} / {v[1]:.3f} / {v[2]:.3f}"
            for k, v in peaks.items()) + f"  [{card}]")
    if len(PG.programs()) != 2:
        raise AssertionError("batch_analyze did not capture a program")
    graph_constants(torch, dev, x, noise, kw, ck, (ye, f0e, ovfe))
    PG.clear()

    # ---- 4. kernels vs plain versions at the main path's shapes ----
    results = []
    lib = _build.library()
    cycles_per_ms = sleep_cycles_per_ms(torch)

    def alone_ms(seen, n, other=None, adapt=None):
        """Device time alone of the captured launches (through ``other``,
        an earlier build, with ``adapt`` mapping their arguments)."""
        return device_ms(torch, cycles_per_ms, replayer(
            torch, _build, other or lib, seen, adapt), n)

    with torch.no_grad():
        y_dec = H.decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
        filt = H.band_filter(y_dec, geo)
        bounds = torch.as_tensor(geo.boundary_f0, dtype=torch.float32,
                                 device=dev)
        zargs = zc_kernel.geometry_args(geo)
        zk, z_seen = capture(_build, lambda: zc_kernel.band_candidates_cuda(
            filt, bounds, **zargs))
        zp = zc_kernel.band_candidates_plain(filt, bounds, **zargs)
        both = (zk > 0) & (zp > 0)
        flips = int(((zk > 0) != (zp > 0)).sum())
        rel = float(((zk - zp).abs() / zp.abs().clamp(min=1e-3))[both].max())
        zerr = float((zk - zp).abs()[both].max())
        log(f"zc: filt {tuple(filt.shape)} -> {tuple(zk.shape)}; "
            f"nonzero {int((zk > 0).sum())} vs {int((zp > 0).sum())}; "
            f"max rel {rel:.2e}, gate flips {flips} (tol 0: bit-exact)")
        if not torch.equal(zk, zp):
            raise AssertionError("zc kernel disagrees with its plain version")
        z_ms = alone_ms(z_seen, 30)
        z_call = median_ms(torch, lambda: zc_kernel.band_candidates_cuda(
            filt, bounds, **zargs), 10)
        z_plain = median_ms(torch, lambda: zc_kernel.band_candidates_plain(
            filt, bounds, **zargs), 3)
        n_rows, L = filt.shape[0] * filt.shape[1], filt.shape[2]
        # per sample two differences and four sign tests; per frame and
        # type the interpolation (~12 operations)
        z_bound = bound(nbytes(filt, bounds, zk),
                        n_rows * (6 * (L - 1) + 48 * geo.f0_length))
        results.append(dict(
            name="zc", source="worldtpu_torch/csrc/zc.cu",
            replaces="worldtpu/ops/zc_kernel.py:112",
            launches=counts["wt_zc"],
            launches_main=counts["wt_zc"], max_abs_err=zerr, ms=z_ms,
            call_ms=z_call, plain_ms=z_plain, bound=z_bound,
            library_ms=None))

        cand, _, _ = H.candidates_stage(y_dec, mean, geo)
        tpos = torch.arange(geo.f0_length, dtype=torch.float32,
                            device=dev) / 1000.0
        prep = refine_kernel.prepare(y_dec, cand, tpos, geo=geo,
                                     dedup_tol=H.REFINE_DEDUP_TOL)
        rk_args = prep["kernel_args"]
        rkw = dict(hwmax=geo.max_half_window, n_fft=geo.refine_fft)
        rk, r_seen = capture(_build, lambda: refine_kernel.spectral_sums_cuda(
            *rk_args, **rkw))
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
        r_ms = alone_ms(r_seen, 30)
        r_call = median_ms(torch, lambda: refine_kernel.spectral_sums_cuda(
            *rk_args, **rkw), 10)
        r_plain = median_ms(torch, lambda: refine_kernel.spectral_sums_plain(
            *rk_args, **rkw), 3)
        # useful work: 24 multiply-adds per window sample of each active
        # (frame, slot) pair.  The bytes it needs: the dense output and
        # n_active; of a frame with an active pair, its delta and the span
        # of its widest window in the segment; of an active pair, its half
        # window and six bins (inactive slots and frames are never read)
        _, _, hw_, _, na_ = rk_args
        act = (torch.arange(hw_.shape[1], device=dev)[None, :]
               < na_[:, None])
        hwc = hw_.clamp(max=geo.max_half_window)
        samples = int(((2 * hwc + 1) * act).sum())
        pairs = int(act.sum())
        live = int((na_ > 0).sum())
        span = int((2 * torch.where(act, hwc, -1).amax(1) + 1)
                   .clamp(min=0).sum())
        r_bytes = nbytes(rk, na_) + 4 * (span + live + 7 * pairs)
        r_bound = bound(r_bytes, 48 * samples)
        log(f"refine: {pairs} active pairs of {act.numel()} in {live} "
            f"frames, {samples} window samples, {48 * samples / 1e9:.3f} "
            f"GFLOP; bytes needed {r_bytes / 1e6:.1f} MB (output "
            f"{nbytes(rk) / 1e6:.1f}, window spans {4 * span / 1e6:.1f}, "
            f"active-pair tables {28 * pairs / 1e6:.1f})")
        results.append(dict(
            name="refine", source="worldtpu_torch/csrc/refine.cu",
            replaces="worldtpu/ops/refine_kernel.py:49",
            launches=counts["wt_refine_sums"],
            launches_main=counts["wt_refine_sums"], max_abs_err=rerr, ms=r_ms,
            call_ms=r_call, plain_ms=r_plain, bound=r_bound,
            library_ms=None))

        tpos5 = torch.arange(n_grid, dtype=torch.float32, device=dev) \
            * (geo.frame_period / 1000.0)
        spec = cheaptrick_frames(x, f0, tpos5, fs=FS, fft_size=ck.fft_size,
                                 max_half_window=ck.max_half_window)
        ap = d4c_frames(x, f0, tpos5, fs=FS, fft_size_out=ck.fft_size)
        resp, starts, n_pulses, _ = S.pulse_train(
            f0, spec, ap, noise, fs=FS, fft_size=ck.fft_size,
            frame_period_s=0.005 * DUR, out_length=out_len, max_pulses=mp)
        ok_, o_seen = capture(_build, lambda: ola_kernel.overlap_add_cuda(
            resp, starts, out_len, n_pulses))
        op = ola_kernel.overlap_add_plain(resp, starts, out_len)
        oerr = float((ok_ - op).abs().max())
        obad = int(((ok_ - op).abs() > OLA_ATOL + OLA_RTOL * op.abs()).sum())
        log(f"ola: resp {tuple(resp.shape)} -> {tuple(ok_.shape)}; max abs "
            f"err {oerr:.3e} (tol {OLA_ATOL} + {OLA_RTOL}*|y|), "
            f"out of tolerance {obad}")
        if obad:
            raise AssertionError("OLA kernel disagrees with its plain version")
        o_ms = alone_ms(o_seen, 100)
        o_call = median_ms(torch, lambda: ola_kernel.overlap_add_cuda(
            resp, starts, out_len, n_pulses), 20)
        o_plain = median_ms(torch, lambda: ola_kernel.overlap_add_plain(
            resp, starts, out_len), 5)
        # only the real pulses need their responses (the padding pulses
        # after them carry zero responses); one add per response sample
        real = int(n_pulses.sum())
        zero_tail = bool((resp[torch.arange(mp, device=dev)[None, :]
                               >= n_pulses[:, None]] == 0).all())
        o_bound = bound(real * resp.shape[2] * 4 + nbytes(starts, ok_),
                        real * resp.shape[2])
        # the library yardstick: the index_add_ of overlap_add_plain, its
        # flat indices and values built outside the timed window
        j = torch.arange(resp.shape[2], device=dev)
        target = starts.to(torch.int64)[..., None] + j
        okm = (target >= 0) & (target < out_len)
        rows = torch.arange(BATCH, device=dev)[:, None, None] \
            * (out_len + 1)
        flat_t = (torch.where(okm, target, out_len) + rows).reshape(-1)
        flat_v = torch.where(okm, resp, 0.0).reshape(-1)
        acc = torch.zeros(BATCH * (out_len + 1), device=dev)
        o_lib = device_ms(torch, cycles_per_ms,
                          lambda: acc.index_add_(0, flat_t, flat_v), 10)
        del target, okm, flat_t, flat_v, acc
        log(f"ola: {real} real pulses of {starts.numel()} (per utterance "
            f"{n_pulses.tolist()}); the kernel scans no padding pulse past "
            f"the count: {starts.numel() - real} not scanned (zero "
            f"responses: {zero_tail}); library call index_add_ {o_lib:.4f} "
            f"ms beside the kernel {o_ms:.4f} ms (device time alone)  "
            f"[{card}]")
        if not zero_tail:
            raise AssertionError("padding pulses with nonzero responses")
        results.append(dict(
            name="ola", source="worldtpu_torch/csrc/ola.cu",
            replaces="worldtpu/ops/ola_kernel.py:51",
            launches=counts["wt_ola"],
            launches_main=counts["wt_ola"], max_abs_err=oerr, ms=o_ms,
            call_ms=o_call, plain_ms=o_plain, bound=o_bound,
            library_ms=o_lib))
        del resp, ok_, op
        results.append(d4c_row(torch, dev, card, cycles_per_ms, counts,
                               run_eager))
        results.append(pulse_row(torch, _build, S, pulse_kernel, alone_ms,
                                 cycles_per_ms, card, counts, dict(
                                     f0=f0, spectrogram=spec,
                                     aperiodicity=ap, noise=noise, fs=FS,
                                     fft_size=ck.fft_size,
                                     frame_period_s=0.005 * DUR,
                                     out_length=out_len, max_pulses=mp)))

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
        ek, e_seen = capture(_build, lambda: extend_kernel.extend_walk_cuda(
            *wargs, **wkw))
        ep = extend_kernel.extend_walk_plain(*wargs, **wkw)
        eerr = max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(ek, ep))
        n_on = ek[2]
        longest = int(n_on.max())
        log(f"extend: {tuple(n_on.shape)} walks (B, W), S={wargs[0].shape[2]}"
            f", steps run {int(n_on.sum())} of "
            f"{n_on.numel() * (wkw['ext_lim'] + 1)} (longest "
            f"{longest}); kernel vs plain in vals/scs/n_on/so: max "
            f"abs diff {eerr} (tol 0, exact)")
        if not all(torch.equal(a, b) for a, b in zip(ek, ep)):
            raise AssertionError("extend kernel disagrees with its plain "
                                 "version")
        e_ms = alone_ms(e_seen, 100)
        e_call = median_ms(torch, lambda: extend_kernel.extend_walk_cuda(
            *wargs, **wkw), 20)
        e_plain = median_ms(torch, lambda: extend_kernel.extend_walk_plain(
            *wargs, **wkw), 5)
        # the steps actually run, each reading one candidate row and one
        # score row of S floats; per walk its five arguments, the two step
        # rows of E values and two results
        steps = int(n_on.sum())
        S_ = wargs[0].shape[2]
        e_bound = bound(steps * 2 * S_ * 4 + nbytes(*wargs[2:], *ek),
                        steps * 6 * S_)
        log(f"extend chain floor: the longest walk runs {longest} dependent "
            f"steps; device time alone {e_ms:.4f} ms = "
            f"{1000 * e_ms / max(longest, 1):.3f} us per step of it, beside "
            f"the byte bound {e_bound[0]:.4f} ms  [{card}]")
        results.append(dict(
            name="extend", source="worldtpu_torch/csrc/extend.cu",
            replaces="worldtpu/ops/extend_kernel.py:44",
            launches=counts["wt_extend"],
            launches_main=counts["wt_extend"], max_abs_err=eerr, ms=e_ms,
            call_ms=e_call, plain_ms=e_plain, bound=e_bound,
            library_ms=None, longest_walk=longest))

        old = None
        if old_sources:
            # the designs the current kernels replaced, built from
            # baseline's sources as a second library
            so_path, _ = _build.build([baseline / f for f in old_sources])
            old = ctypes.CDLL(str(so_path))
            for f in old_sources:
                for nm, sig in OLD_ENTRIES[f]:
                    getattr(old, nm).argtypes = list(sig)
                    getattr(old, nm).restype = ctypes.c_int
        if {"ola.cu", "extend.cu"} <= set(old_sources):
            # earlier OLA and extend: their results on the same inputs,
            # then their device times alone on the same captured
            # arguments, in turns with the current ones (the current OLA
            # also without the pulse count)
            o_old = torch.empty_like(ok_)
            e_old = [torch.empty_like(t) for t in ek]
            replayer(torch, _build, old,
                     [(nm, d, (a[0], a[1], o_old) + a[4:])
                      for nm, d, a in o_seen]
                     + [(nm, d, a[:7] + tuple(e_old) + a[11:])
                        for nm, d, a in e_seen])()
            torch.cuda.synchronize()
            log(f"baseline kernels on the same inputs: OLA max abs diff "
                f"from the current {float((o_old - ok_).abs().max()):.3e}; "
                f"extend equal to the current in all four outputs "
                f"{all(torch.equal(a, b) for a, b in zip(e_old, ek))}")
            o_nocount = [(nm, d, a[:2] + (None,) + a[3:])
                         for nm, d, a in o_seen]
            ab = {k: [] for k in ("ola old", "ola new", "ola new, no count",
                                  "extend old", "extend new")}
            for turn in ("old", "new", "new", "old"):
                if turn == "old":
                    ab["ola old"].append(alone_ms(
                        o_seen, 100, old, lambda nm, a: a[:2] + a[3:]))
                    ab["extend old"].append(alone_ms(e_seen, 100, old))
                else:
                    ab["ola new"].append(alone_ms(o_seen, 100))
                    ab["ola new, no count"].append(alone_ms(o_nocount, 100))
                    ab["extend new"].append(alone_ms(e_seen, 100))
            log("baseline vs current, device time alone, in turns (old, new, "
                "new, old): " + "; ".join(
                    f"{k} {[round(v, 4) for v in vs]} ms"
                    for k, vs in ab.items()) + f"  [{card}]")

        # the zc phase-1 entry, its own path: counts from 0
        groups = zc_kernel.make_groups(geo)
        _build.launches.clear()
        evs, ze_seen = capture(_build, lambda: zc_kernel.zc_events(filt, geo))
        torch.cuda.synchronize()
        ev_launches = _build.launches["wt_zc_events"]
        if ev_launches != 1 or len(evs) != len(groups):
            raise AssertionError(f"zc events: {ev_launches} launches (not 1) "
                                 f"and {len(evs)} results for {len(groups)} "
                                 f"groups")
        zeerr, kept, same = 0.0, 0, True
        plains = []
        for g, (ev, cc) in zip(groups, evs):
            pev, pcc = zc_kernel.zc_events_plain(filt, g.lo, g.hi,
                                                 e_cap=g.e_cap,
                                                 c_row=g.c_row)
            plains.append((pev, pcc))
            same = same and torch.equal(cc, pcc) and torch.equal(ev, pev)
            fin = torch.isfinite(pev)
            if torch.equal(fin, torch.isfinite(ev)):
                zeerr = max(zeerr, float((ev - pev)[fin].abs().max()))
            else:
                same = False
            kept += int(pcc.sum())
        log(f"zc events: {len(groups)} groups in {ev_launches} launch, e_cap "
            f"{groups[0].e_cap}..{groups[-1].e_cap}, c_row {groups[0].c_row}"
            f"..{groups[-1].c_row}, {kept} kept events; kernel vs plain: "
            f"counts and +inf positions equal {same}, max abs diff {zeerr} "
            f"(tol 0, exact)")
        if not same:
            raise AssertionError("zc events kernel disagrees with its plain "
                                 "version")
        # a single-group call is the same kernel with a one-entry table
        g5 = groups[len(groups) // 2]
        ev1, cc1 = zc_kernel.zc_events_cuda(filt, g5.lo, g5.hi,
                                            e_cap=g5.e_cap, c_row=g5.c_row)
        pev, pcc = plains[len(groups) // 2]
        if not (torch.equal(ev1, pev) and torch.equal(cc1, pcc)):
            raise AssertionError("zc events: the single-group call disagrees "
                                 "with its plain version")
        ze_ms = alone_ms(ze_seen, 30)
        ze_call = median_ms(torch, lambda: zc_kernel.zc_events(filt, geo),
                            10)
        ze_plain = median_ms(torch, lambda: [zc_kernel.zc_events_plain(
            filt, g.lo, g.hi, e_cap=g.e_cap, c_row=g.c_row)
            for g in groups], 3)
        log(f"zc split: events alone (phase 1, {ev_launches} launch for "
            f"{len(groups)} groups) {ze_ms:.4f} ms beside the full zc kernel "
            f"{z_ms:.4f} ms  [{card}]")
        ze_bound = bound(nbytes(filt) + sum(nbytes(ev, cc)
                                            for ev, cc in evs),
                         6 * filt.numel())
        results.append(dict(
            name="zc_events", source="worldtpu_torch/csrc/zc_events.cu",
            replaces="worldtpu/ops/zc_kernel.py:349", launches=ev_launches,
            launches_main=counts.get("wt_zc_events", 0),
            max_abs_err=zeerr, ms=ze_ms, call_ms=ze_call, plain_ms=ze_plain,
            bound=ze_bound, library_ms=None))
        del plains
        # the same kernel on the batch's audio as one utterance (the shape
        # of phase 6's long Harvest: one row per band, fewer blocks than the
        # card has slots); recorded, not tuned for
        geo1 = H.HarvestGeometry(FS, int(lengths.sum()), f0_floor=40.0)
        x1 = torch.cat([x[i, :int(n)] for i, n in enumerate(lengths)])[None]
        filt1 = H.band_filter(H.decimate_stage(
            x1, ratio=geo1.ratio, y_length=geo1.y_length), geo1)
        _, ze1_seen = capture(_build,
                              lambda: zc_kernel.zc_events(filt1, geo1))
        ze1_ms = alone_ms(ze1_seen, 30)
        log(f"zc events on one {x1.shape[1] / FS:.2f} s utterance (filt "
            f"{tuple(filt1.shape)}, {filt1.shape[1]} blocks): {ze1_ms:.4f} ms "
            f"device time alone  [{card}]")
        del filt1, ze1_seen

        if "zc_events.cu" in old_sources:
            # the earlier zc events design (one call of two launches per
            # band group): equal results, then device times alone in turns
            n_cols = -(-L // 128)
            old_seen, old_out = [], []
            for g in groups:
                oev = torch.empty((BATCH, g.n_bands, 4, g.e_cap),
                                  dtype=torch.float32, device=dev)
                occ = torch.empty((BATCH, g.n_bands, 4, n_cols),
                                  dtype=torch.int32, device=dev)
                old_out.append((oev, occ))
                old_seen.append(("wt_zc_events", dev, (
                    filt, oev, occ, BATCH * g.n_bands, filt.shape[1], g.lo,
                    g.n_bands, L, g.e_cap, g.c_row, n_cols,
                    -(-n_cols // 8) * 8)))
            replayer(torch, _build, old, old_seen)()
            torch.cuda.synchronize()
            eq = all(torch.equal(a, c) and torch.equal(b, d)
                     for (a, b), (c, d) in zip(old_out, evs))
            ab = {"zc events old": [], "zc events new": []}
            for turn in ("old", "new", "new", "old"):
                if turn == "old":
                    ab["zc events old"].append(alone_ms(old_seen, 30, old))
                else:
                    ab["zc events new"].append(alone_ms(ze_seen, 30))
            log(f"baseline zc events ({len(old_seen)} calls of two launches) "
                f"equal to the current (1 launch) in every group: {eq}; "
                f"device time alone, in turns (old, new, new, old): "
                + "; ".join(f"{k} {[round(v, 4) for v in vs]} ms"
                            for k, vs in ab.items()) + f"  [{card}]")
            if not eq:
                raise AssertionError("the baseline zc events kernel "
                                     "disagrees with the current one")
            del old_seen, old_out

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
                paths[mode].append(round(wall_ms(torch, run_eager, 5), 3))
            finally:
                extend_kernel.extend_walk = real_walk
        log(f"contour chain (fix_and_smooth, B={BATCH}) wall, medians of 10 "
            f"in turns: plain walk {walls['plain']} ms, extend kernel "
            f"{walls['kernel']} ms; main path, medians of 5: plain walk "
            f"{paths['plain']} ms, extend kernel {paths['kernel']} ms  "
            f"[{card}]")
        extend_kernel.extend_walk = extend_kernel.extend_walk_plain
        try:
            _, _, st_plain = stage_profile(torch, run_eager)
        finally:
            extend_kernel.extend_walk = real_walk
        hp, dp = st_plain["wt.contour"]
        hk_, dk_ = stages["wt.contour"]
        log(f"profiled wt.contour: plain walk host {hp:.3f} ms device "
            f"{dp:.3f} ms; extend kernel host {hk_:.3f} ms device "
            f"{dk_:.3f} ms  [{card}]")
    # kernels A and B: at the main path's shapes (their rows in the kernels
    # line); at phase 6's one long utterance
    # (A's shared-memory rows) and phase 9's 60 s test signal (its
    # global-memory rows); and fix_step3 on the fixtures t22, t16 and t48
    # (with --baseline holding contour.cu, 8075e49's design on each of the
    # first three, in turns)
    from worldtpu_torch.ops import contour_kernel as CK
    old_contour = old if "contour.cu" in old_sources else None
    margs, mkw, sargs, info = contour_check(
        torch, f"main path B={BATCH}", hcand, hscore, n_grid,
        geo.frame_period,
        cycles_per_ms=cycles_per_ms if old_contour else None,
        old=old_contour)
    results.extend(contour_rows(torch, cycles_per_ms, card, margs, mkw,
                                sargs, counts))
    for r, nm in zip(results[-2:], ("merge", "smoothing")):
        if info["baseline"]:
            r["old_design_ms"] = info["baseline"][f"{nm} old"]
            r["new_design_ms"] = info["baseline"][f"{nm} new"]
    del margs, sargs
    long_inputs = [(f"one {x1.shape[1] / FS:.2f} s utterance", x1, geo1,
                    "shared"),
                   (f"phase 9's {TEST_SIGNAL_S:g} s test signal",
                    torch.tensor(long_utterance(FS, TEST_SIGNAL_S),
                                 device=dev)[None], None, "global")]
    fixd = root / "tests" / "fixtures"
    for nm in F64_FIXTURES:
        xf, fsf = read_wav(fixd / f"{nm}.wav")
        long_inputs.append((f"fixture {nm}",
                            torch.tensor(xf, device=dev)[None],
                            H.HarvestGeometry(fsf, len(xf), f0_floor=40.0),
                            None))
    for label, xl, gl, variant in long_inputs:
        gl = gl or H.HarvestGeometry(FS, xl.shape[1], f0_floor=40.0)
        with torch.no_grad():
            cl, sl = H.harvest_device_stages(xl, geo=gl)
        _, _, _, info = contour_check(
            torch, label, cl, sl, gl.n_grid(), gl.frame_period,
            cycles_per_ms=cycles_per_ms if variant else None,
            old=old_contour if variant else None)
        if variant is not None and info["variant"] != variant:
            raise AssertionError(f"{label}: kernel A took its "
                                 f"{info['variant']} rows, not {variant}")
        del cl, sl
    del long_inputs
    torch.cuda.empty_cache()
    log("library_ms null: no single PyTorch call computes the zc "
        "candidates, the refine sums, the extend walk, the zc events, the "
        "contour's section filter and merge, its per-section smoothing or "
        "the pulse responses from their inputs")
    for r in results:
        b_ms, b_by = r["bound"]
        log(f"{r['name']}: kernel alone {r['ms']:.4f} ms (with its wrapper "
            f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), share {b_ms / r['ms']:.3f}, library "
            f"{'-' if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms  [{card}]")

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
    # the main path's utterances one by one: Harvest on the card (kernels)
    # against Harvest on the CPU (plain versions), voicing identical; where
    # it is not, the CPU chain on the card's own candidates tells the
    # stages from the chain, and the merge decisions are printed
    flips = []
    for i, w in enumerate(waves):
        xw = np.asarray(w, np.float32)
        hg = H.HarvestKernel(FS, len(xw), f0_floor=40.0, device=dev)
        hc = H.HarvestKernel(FS, len(xw), f0_floor=40.0, device="cpu")
        fg, _ = hg.compute(xw)
        fc, _ = hc.compute(xw)
        nf = int(((fg > 0) != (fc > 0)).sum())
        both = (fg > 0) & (fc > 0)
        log(f"card vs CPU, synth_utterance_diverse({FS}, {i}) "
            f"({len(xw) / FS:.2f} s): voicing flips {nf} of {len(fg)}, F0 "
            f"max |d| on voiced {float(np.abs(fg - fc)[both].max()):.3e} Hz")
        if nf:
            flips.append(i)
            with torch.no_grad():
                cg, sg = H.harvest_device_stages(
                    torch.tensor(xw, device=dev)[None], geo=hg.geo)
            _, (margs, mkw), _, _ = chain_calls(
                torch, CDV, CK, cg, sg, hg.geo.n_grid(), hg.geo.frame_period)
            chain_cpu = CDV.fix_and_smooth(cg.cpu(), sg.cpu(),
                                           hg.geo.n_grid(),
                                           hg.geo.frame_period)[0].numpy()
            log(f"  the CPU chain on the card's candidates: voicing flips "
                f"against the card {int(((chain_cpu > 0) != (fg > 0)).sum())}"
                f" (0: the stages differ, not the chain)")
            with torch.no_grad():
                _, tr_k = CK.contour_merge_cuda(*margs, **mkw, trace=True)
                _, tr_c = CK.contour_merge_plain(
                    *(a.cpu() for a in margs), **mkw, trace=True)
            kf, mf, _ = merge_decisions(margs, mkw["grid_ms"], tr_k, tr_c)
            for f in kf:
                log(f"  keep flip: slot {f[1]}: c/mean {f[2]!r} against "
                    f"length {f[3]!r}")
            for f in mf:
                log(f"  merge flip: step {f[1]}: card s1 {f[2]!r} s2 "
                    f"{f[3]!r}; CPU s1 {f[4]!r} s2 {f[5]!r}")
    if flips:
        raise AssertionError(f"voicing differs between the card and the CPU "
                             f"on utterances {flips}")

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
    # compute_batch replays HarvestKernel.forward's captured program from
    # its second call on: against the eager program, walls in turns
    def hk_eager():
        with torch.no_grad():
            f, _ = PG.eager(H._forward, (x,), geo=hk.geo, grid=1)
        return f.cpu().numpy().astype(np.float64)

    def hk_replayed():
        return np.stack([r[0] for r in hk.compute_batch(x)])

    _build.launches.clear()
    f_e = hk_eager()
    e_counts = dict(_build.launches)
    hk_replayed()                       # the second call: captures
    _build.launches.clear()
    f_r = hk_replayed()
    r_counts = dict(_build.launches)
    same_hk = np.array_equal(f_r, f_e) and np.array_equal(
        f_r, np.stack([r[0] for r in hres]))
    hk_turns = {"eager": [], "replayed": []}
    for mode in ("eager", "replayed", "replayed", "eager"):
        hk_turns[mode].append(round(wall_ms(
            torch, hk_eager if mode == "eager" else hk_replayed, 5), 3))
    t0 = time.perf_counter()
    hk.compute_batch(x, check_capacity=True)
    c_ms = (time.perf_counter() - t0) * 1000
    log(f"HarvestKernel.compute_batch replayed (its forward a captured "
        f"program): F0 bit-equal to the eager program's and to the first "
        f"call's {same_hk}; launches of the eager program {e_counts}, of a "
        f"replayed call {r_counts}; walls in turns (eager, replayed, "
        f"replayed, eager), medians of 5: eager {hk_turns['eager']} ms, "
        f"replayed {hk_turns['replayed']} ms; replayed with check_capacity "
        f"{c_ms:.1f} ms (the first call, eager, {h_ms:.1f} ms)  [{card}]")
    if not same_hk or e_counts != r_counts or any(
            r_counts.get(k, 0) != 1 for k in HARVEST_KERNELS):
        raise AssertionError("the replayed HarvestKernel.forward")
    # one long utterance (the batch's audio end to end, past the 8192
    # frames where CPU input takes the host chain): the card keeps the
    # device contour chain
    x_long = torch.cat([x[i, :int(n)] for i, n in enumerate(lengths)])
    hk_long = H.HarvestKernel(FS, x_long.shape[0], f0_floor=40.0, device=dev)
    _build.launches.clear()
    zc_kernel.layout_launches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    l_ms = []
    # the first call at a new geometry is cold and eager; the second runs
    # eagerly again, captures and replays; the third replays
    for _ in range(3):
        t0 = time.perf_counter()
        f0_long, _ = hk_long.compute(x_long)
        l_ms.append((time.perf_counter() - t0) * 1000)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    voiced_long = float((f0_long > 0).mean())
    log(f"HarvestKernel.compute, one {x_long.shape[0] / FS:.2f} s utterance "
        f"({hk_long.geo.f0_length} frames of 1 ms): first call "
        f"{l_ms[0]:.1f} ms, second (captures) {l_ms[1]:.1f} ms, third "
        f"(replayed) {l_ms[2]:.1f} ms, peak device memory "
        f"{peak_gb:.2f} GiB, voiced {voiced_long:.3f}, launches "
        f"{dict(_build.launches)}, zc event layout "
        f"{dict(zc_kernel.layout_launches)} (e_max {hk_long.geo.e_max})  "
        f"[{card}]")
    if (f0_long.shape != (hk_long.get_samples(),)
            or not np.isfinite(f0_long).all() or voiced_long < 0.2
            or any(_build.launches[k] < 1 for k in (
                "wt_extend", "wt_contour_merge", "wt_contour_smooth"))
            or set(zc_kernel.layout_launches) != {"global"}):
        raise AssertionError("long-utterance Harvest on the card")
    # the eager program with the contour kernels, and with the chain's
    # plain versions (the dense [B, R, F] channels and the blocked-matmul
    # smoothing that the kernels replace): a replay would run no Python
    def long_eager():
        with torch.no_grad():
            PG.eager(H._forward, (x_long[None],), geo=hk_long.geo, grid=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            PG.eager(H._forward, (x_long[None],), geo=hk_long.geo, grid=1)
        return torch.cuda.max_memory_allocated() / 2 ** 30

    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 2 ** 30
    peak_gb = long_eager()
    real_cm, real_cs = CK.contour_merge, CK.contour_smooth
    CK.contour_merge = CK.contour_merge_plain
    CK.contour_smooth = CK.contour_smooth_plain
    try:
        peak_plain = long_eager()
    finally:
        CK.contour_merge, CK.contour_smooth = real_cm, real_cs
    log(f"HarvestKernel.forward's eager program, the "
        f"{x_long.shape[0] / FS:.2f} s utterance: "
        f"peak device memory {peak_gb:.4f} GiB with the contour kernels, "
        f"{peak_plain:.4f} GiB with the chain's plain versions (gate: no "
        f"higher); {held_gb:.4f} GiB of it held by earlier phases, so the "
        f"call itself adds {peak_gb - held_gb:.4f} / "
        f"{peak_plain - held_gb:.4f} GiB  [{card}]")
    if peak_gb > peak_plain:
        raise AssertionError("the contour kernels raised the long "
                             "utterance's peak device memory")
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
    for k in ("wt_zc", "wt_refine_sums", "wt_ola", "wt_extend", "wt_d4c",
              "wt_pulse_resp"):
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
            r = subprocess.run([sys.executable, "-c", CLI_NO_JAX, *args,
                                "--device", "cuda"], cwd=root,
                               capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"cli {args[0]} exited {r.returncode}:"
                                     f"\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-2000:]}")
            log(f"cli {args[0]}: rc 0 in {time.perf_counter() - t0:.1f} s "
                f"(jax and worldtpu blocked)")
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

    # ---- 7. float64 on the card against the C++ golden dumps ----
    import gzip
    from worldtpu_torch.analysis import d4c as D4
    from worldtpu_torch.analysis import dither as DI
    from worldtpu_torch.io import params as P_, wav as W_
    from worldtpu_torch.ops import seqsum
    fixd = root / "tests" / "fixtures"
    f64 = torch.float64
    _build.launches.clear()
    first22 = None
    for nm in F64_FIXTURES:
        xf, fsf, _ = W_.wavread(str(fixd / f"{nm}.wav"))
        f0_ref, tpos_ref, fp_ms = P_.read_f0(str(fixd / f"{nm}.f0.gz"))
        spec_ref, meta = P_.read_spectral_envelope(
            str(fixd / f"{nm}.spec.gz"))
        ap_ref, _ = P_.read_aperiodicity(str(fixd / f"{nm}.ap.gz"))
        syn_ref = np.frombuffer(
            gzip.open(fixd / f"{nm}.syn2.f64.gz").read(), "<f8")
        fft_f = meta["fft_size"]
        walls = {}

        def timed(key, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[key] = (time.perf_counter() - t0) * 1000
            return out

        har = api.Harvest(fsf, api.HarvestOption(f0_floor=40.0), device=dev)
        har.compute(xf, dtype=f64)                  # first call: FFT plans
        tpos_g, f0_g = timed("Harvest", lambda: har.compute(xf, dtype=f64))
        same_v = bool(np.array_equal(f0_g > 0, f0_ref > 0))
        f0_rmse = float(np.sqrt(np.mean((f0_g - f0_ref) ** 2)))
        f0_max = float(np.abs(f0_g - f0_ref).max())

        # the reference's dither streams, in its call order, from the port's
        # own xorshift (host); the LoveTrain gate of the body dither on the
        # card
        ct = api.CheapTrick(fsf, device=dev)
        ckf = ct._kernel
        wd, sd, gen_x = DI.cheaptrick_dither(f0_ref, fsf, fft_f,
                                             ckf.max_half_window)
        spec_g = timed("CheapTrick", lambda: ct.compute(
            xf, tpos_ref, f0_ref, dtype=f64, window_dither=wd,
            spectrum_dither=sd))
        lt, gen_x = DI.d4c_love_train_dither(
            f0_ref, fsf, D4.d4c_max_half_lt(fsf), gen_x)
        xt = torch.as_tensor(xf, dtype=f64, device=dev)[None]
        f0t = torch.as_tensor(f0_ref, dtype=f64, device=dev)[None]
        ap0 = D4.love_train_ap0(
            xt, f0t, torch.as_tensor(tpos_ref, dtype=f64, device=dev),
            fs=fsf, lt_dither=torch.as_tensor(lt, device=dev)[None])
        active = (f0_ref != 0) & (ap0[0].cpu().numpy() > 0.85)
        c1, c2, hd, gen_x = DI.d4c_body_dither(
            f0_ref, active, fsf, D4.d4c_max_half_c(fsf), gen_x)
        d4 = api.D4C(fsf, device=dev)
        ap_g = timed("D4C", lambda: d4.compute(
            xf, tpos_ref, f0_ref, fft_f, dtype=f64, lt_dither=lt,
            c1_dither=c1, c2_dither=c2, h_dither=hd))
        spec_rel = (np.abs(spec_g.cpu().numpy() - spec_ref)
                    / (np.abs(spec_ref) + 1e-300))
        ap_err = np.abs(ap_g.cpu().numpy() - ap_ref)

        out_f = int((len(f0_ref) - 1) * fp_ms / 1000.0 * fsf) + 1
        skw = dict(fs=fsf, fft_size=fft_f, frame_period_s=fp_ms / 1000.0,
                   out_length=out_f,
                   max_pulses=S.default_max_pulses(out_f, fsf))
        nz = S.parity_noise(f0_ref, **skw)          # host, fresh stream
        syn = api.Synthesis(fsf, fft_f, fp_ms, device=dev)
        y_g = timed("Synthesis", lambda: syn.compute(
            f0_ref, spec_ref, ap_ref, out_f, noise=nz, dtype=f64))
        y_g = y_g.cpu().numpy()
        syn_rel = float(np.abs(y_g - syn_ref).max() / np.abs(syn_ref).max())
        figs = {"f0_rmse_hz": f0_rmse,
                "spec_q999_rel": float(np.quantile(spec_rel, 0.999)),
                "ap_q999_abs": float(np.quantile(ap_err, 0.999)),
                "syn_max_rel": syn_rel}
        log(f"float64 on the card, {nm} ({len(xf) / fsf:.2f} s at {fsf} Hz, "
            f"fft {fft_f}, {len(f0_ref)} frames) vs the C++ dumps: F0 "
            f"voicing identical {same_v}, max |dF0| {f0_max:.3e} Hz, spec "
            f"max rel {float(spec_rel.max()):.3e}, ap max abs "
            f"{float(ap_err.max()):.3e}; "
            + "; ".join(f"{k} {v:.3e} (gate {F64_GATES[k][0]:g}, CPU tests "
                        f"{F64_GATES[k][1]:g})" for k, v in figs.items()))
        log(f"float64 entry points' walls, {nm}: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in walls.items())
            + f"  [{card}]")
        if (not same_v or not np.allclose(tpos_g, tpos_ref, rtol=1e-12)
                or any(not v < F64_GATES[k][0] for k, v in figs.items())):
            raise AssertionError(f"float64 on the card disagrees with the "
                                 f"C++ dumps on {nm}")
        if nm == "t22":
            first22 = dict(x=xf, tpos=tpos_ref, f0=f0_ref, spec=spec_ref,
                           ap=ap_ref, nz=nz, skw=skw, fs=fsf, fft=fft_f,
                           fp_ms=fp_ms)
    f64_counts = dict(_build.launches)
    log(f"float64 path launches (Harvest, CheapTrick, D4C and Synthesis on "
        f"{len(F64_FIXTURES)} utterances, counted from 0): {f64_counts}")
    for k in ("wt_ola_f64", "wt_seq_cumsum_f64"):
        if f64_counts.get(k, 0) < 1:
            raise AssertionError(f"kernel {k} not launched by the float64 "
                                 f"path")
    if any(k in f64_counts for k in ("wt_zc", "wt_refine_sums", "wt_ola",
                                     "wt_extend", "wt_d4c",
                                     "wt_pulse_resp")):
        raise AssertionError("the float64 path launched a float32 kernel")

    # the float64 path's two kernels at t22's shapes against their plain
    # versions
    with torch.no_grad():
        q = first22
        as64 = lambda a: torch.as_tensor(a, dtype=f64, device=dev)[None]
        resp64, st64, np64, _ = S.pulse_train(
            as64(q["f0"]), as64(q["spec"]), as64(q["ap"]), as64(q["nz"]),
            **q["skw"])
        T64 = q["skw"]["out_length"]
        ok64, o64_seen = capture(_build, lambda: ola_kernel.overlap_add_cuda(
            resp64, st64, T64, np64))
        op64 = ola_kernel.overlap_add_plain(resp64, st64, T64, np64)
        o64_err = float((ok64 - op64).abs().max())
        o64_scale = float(op64.abs().max())
        again = ola_kernel.overlap_add_cuda(resp64, st64, T64, np64)
        log(f"ola float64 (the OLA kernel's double instantiation): resp "
            f"{tuple(resp64.shape)} -> {tuple(ok64.shape)}; max abs err vs "
            f"index_add_ {o64_err:.3e} of max |y| {o64_scale:.3e} (tol "
            f"{OLA_F64_REL} relative); two runs equal bit for bit "
            f"{torch.equal(ok64, again)}")
        if o64_err > OLA_F64_REL * o64_scale or not torch.equal(ok64, again):
            raise AssertionError("the float64 OLA kernel disagrees with its "
                                 "plain version")
        real64 = int(np64.sum())
        j64 = torch.arange(resp64.shape[2], device=dev)
        tg64 = st64.to(torch.int64)[..., None] + j64
        okm = ((tg64 >= 0) & (tg64 < T64)
               & (torch.arange(resp64.shape[1], device=dev)
                  < np64[:, None])[..., None])
        flat_t = torch.where(okm, tg64, T64).reshape(-1)
        flat_v = torch.where(okm, resp64, 0.0).reshape(-1)
        acc = torch.zeros(T64 + 1, dtype=f64, device=dev)
        results.append(dict(
            name="ola_f64", source="worldtpu_torch/csrc/ola.cu",
            replaces="worldtpu/ops/ola_kernel.py:51",
            launches=f64_counts["wt_ola_f64"],
            launches_main=counts.get("wt_ola_f64", 0), max_abs_err=o64_err,
            ms=alone_ms(o64_seen, 100),
            call_ms=median_ms(torch, lambda: ola_kernel.overlap_add_cuda(
                resp64, st64, T64, np64), 20),
            plain_ms=median_ms(torch, lambda: ola_kernel.overlap_add_plain(
                resp64, st64, T64, np64), 5),
            bound=bound(real64 * resp64.shape[2] * 8 + nbytes(st64, ok64),
                        real64 * resp64.shape[2] * PEAK_F32_FLOP_S
                        / PEAK_F64_FLOP_S),
            library_ms=device_ms(torch, cycles_per_ms,
                                 lambda: acc.index_add_(0, flat_t, flat_v),
                                 20)))
        del tg64, okm, flat_t, flat_v, acc

        # the sequential cumulative sum at every shape this path gives it
        # (t22's D4C: LoveTrain's and the coarse bands' cumulative power,
        # LinearSmoothing's mirrored spectra; the synthesis time base's one
        # long row): the launches of one D4C and one Synthesis call, each
        # output against numpy.cumsum of its own input
        _, c_seen = capture(_build, lambda: (
            api.D4C(q["fs"], device=dev).compute(
                q["x"], q["tpos"], q["f0"], q["fft"], dtype=f64),
            api.Synthesis(q["fs"], q["fft"], q["fp_ms"], device=dev).compute(
                q["f0"], q["spec"], q["ap"], T64, noise=q["nz"], dtype=f64)))
        torch.cuda.synchronize()
        c_seen = [c for c in c_seen if c[0] == "wt_seq_cumsum_f64"]
        c_worst, c_shapes, scan_same = 0.0, [], True
        for _, _, (cx, cout, n_rows, n) in c_seen:
            xs = cx.cpu().numpy().reshape(n_rows, n)
            want = np.cumsum(xs, axis=-1)
            got = cout.cpu().numpy().reshape(n_rows, n)
            c_shapes.append((n_rows, n))
            fin = np.isfinite(want)
            if not bits_equal(got, want):
                raise AssertionError(f"the sequential cumulative sum "
                                     f"disagrees with numpy.cumsum at "
                                     f"{(n_rows, n)}")
            c_worst = max(c_worst, float(np.abs(got - want)[fin].max()))
            par = torch.cumsum(cx.reshape(n_rows, n), -1).cpu().numpy()
            scan_same = scan_same and np.array_equal(par, want,
                                                     equal_nan=True)
        log(f"seq_cumsum: {len(c_seen)} launches of t22's float64 D4C and "
            f"Synthesis, shapes {sorted(set(c_shapes))}: each bit-equal to "
            f"numpy.cumsum of its input True; torch.cumsum on the card (a "
            f"parallel scan) equal to it on all of them {scan_same}")
        if len(c_seen) < 2:
            raise AssertionError("the float64 D4C and Synthesis launched "
                                 "the sequential cumulative sum < 2 times")
        # the chain's floor a step, then each regime at its path shape
        dadd = dadd_latency(torch, lib, dev)
        log(f"dependent __dadd_rn latency (one thread, {DADD_STEPS} adds "
            f"between clock64 reads): {dadd['cycles']:.3f} cycles = "
            f"{dadd['ns']:.4f} ns a step, an SM clock of {dadd['mhz']:.0f} "
            f"MHz (nvidia-smi clocks.sm after it: {dadd['smi']})  [{card}]")
        seq_old = old if "seq_cumsum.cu" in old_sources else None
        big = max(c_seen, key=lambda c: c[2][2] * c[2][3])
        row = max(c_seen, key=lambda c: c[2][3])
        xs_t = big[2][0]
        seq_cases = [
            cumsum_case(torch, cycles_per_ms, lib, seq_old, big, dadd,
                        "t22's largest launch", 50),
            cumsum_case(torch, cycles_per_ms, lib, seq_old, row, dadd,
                        "t22's time base", 20)]
        results.append(dict(
            name="seq_cumsum", source="worldtpu_torch/csrc/seq_cumsum.cu",
            replaces="worldtpu/ops/filters.py:373",
            launches=f64_counts["wt_seq_cumsum_f64"],
            launches_main=counts.get("wt_seq_cumsum_f64", 0),
            max_abs_err=c_worst, ms=seq_cases[0]["ms"],
            call_ms=median_ms(
                torch, lambda: seqsum.cumsum_sequential_cuda(xs_t), 20),
            plain_ms=median_ms(
                torch, lambda: seqsum.cumsum_sequential_plain(xs_t), 5),
            bound=cumsum_bound(seq_cases[0]),
            library_ms=device_ms(torch, cycles_per_ms,
                                 lambda: torch.cumsum(xs_t, -1), 50),
            dadd_latency=dadd, cases=seq_cases))
    for r in results[-2:]:
        b_ms, b_by = r["bound"]
        log(f"{r['name']}: kernel alone {r['ms']:.4f} ms (with its wrapper "
            f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), share {b_ms / r['ms']:.3f}, library "
            f"{r['library_ms']:.4f} ms; launches on the float64 path "
            f"{r['launches']}  [{card}]")
    sq = results[-1]
    log(f"seq_cumsum on t22's largest launch "
        f"{tuple(sq['cases'][0]['shape'])}: {sq['ms']:.4f} ms against "
        f"torch.cumsum's {sq['library_ms']:.4f} ms (other bits): "
        f"{'faster' if sq['ms'] < sq['library_ms'] else 'slower'}, "
        f"{sq['library_ms'] / sq['ms']:.2f}x; its bound is the "
        f"{sq['bound'][1]} floor  [{card}]")

    # float64 Harvest at length: phase 6's one long utterance through the
    # parity path on the card, against phase 6's float32 F0 of it (the
    # card-vs-CPU gates of phase 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    l64_ms = []
    for _ in range(2):          # the first call makes the FFT plans
        t0 = time.perf_counter()
        f0_l64, _ = hk_long.compute(x_long, dtype=f64)
        l64_ms.append((time.perf_counter() - t0) * 1000)
    peak64 = torch.cuda.max_memory_allocated() / 2 ** 30

    # the float64 device stages between the host mean and the download:
    # their host syncs (CUDA sync debug mode, gate 0; after a first call,
    # which uploads a new geometry's band tables to their device cache)
    # and device calls
    def f64_stages(xs, geo64):
        with torch.no_grad():
            y64 = H.decimate_stage(xs.to(f64)[None], ratio=geo64.ratio,
                                   y_length=geo64.y_length)
            m64 = H.int_trunc_mean(y64)
            H._stages_f64(y64, m64, geo64)
            _, n = count_syncs(torch, lambda: H._stages_f64(y64, m64,
                                                            geo64))
            t0 = time.perf_counter()
            H._stages_f64(y64, m64, geo64)
            torch.cuda.synchronize()
        S_ = geo64.max_candidates
        cap = min(S_, max(32, S_ // 2))
        calls = -(-geo64.f0_length // max(1, H.REFINE_F64_PAIRS // cap))
        return n, calls, (time.perf_counter() - t0) * 1000

    geo22 = H.HarvestGeometry(fs22, len(x22), f0_floor=40.0)
    stage_syncs = {
        "t22": f64_stages(torch.as_tensor(x22, device=dev), geo22),
        f"{x_long.shape[0] / FS:.2f} s": f64_stages(x_long, hk_long.geo)}
    log("float64 Harvest's device stages (candidates, refine, prune; "
        "after the host mean, before the download): "
        + "; ".join(f"{k}: {n} host syncs (gate 0), {c} refine calls, "
                    f"{ms:.1f} ms" for k, (n, c, ms)
                    in stage_syncs.items())
        + f"; refine {H.REFINE_F64_PAIRS} pairs a call  [{card}]")
    if any(v[0] for v in stage_syncs.values()):
        raise AssertionError("the float64 device stages synchronize the "
                             "host")
    v32, v64 = f0_long > 0, f0_l64 > 0
    agree64 = float((v32 == v64).mean())
    both64 = v32 & v64
    rmse64 = float(np.sqrt(np.mean((f0_long[both64] - f0_l64[both64]) ** 2)))
    log(f"HarvestKernel.compute(dtype=torch.float64), the same "
        f"{x_long.shape[0] / FS:.2f} s utterance: {l64_ms[0]:.1f} ms the "
        f"first call, {l64_ms[1]:.1f} ms the second, peak device memory "
        f"{peak64:.2f} GiB; against its float32 "
        f"F0 on the card: voicing agreement {agree64:.4f} (gate 0.97), F0 "
        f"RMSE on voiced {rmse64:.4f} Hz (gate 1), max |dF0| "
        f"{float(np.abs(f0_long[both64] - f0_l64[both64]).max()):.3f} Hz  "
        f"[{card}]")
    if (f0_l64.shape != f0_long.shape or not np.isfinite(f0_l64).all()
            or agree64 < 0.97 or rmse64 > 1.0):
        raise AssertionError("float64 Harvest at length disagrees with the "
                             "float32 F0 on the card")

    # the time base of a float64 copy-synthesis of that utterance (its F0
    # just computed): the long regime's one row of ~536,000 samples
    with torch.no_grad():
        f0_tb = torch.as_tensor(f0_l64, dtype=f64, device=dev)[None]
        T_tb = int((f0_tb.shape[1] - 1) * 0.005 * FS) + 1
        _, tb_seen = capture(_build, lambda: S._time_base(
            f0_tb, FS, 0.005, T_tb, FS / ck.fft_size + 1.0,
            S.default_max_pulses(T_tb, FS)))
    tb_seen = [c for c in tb_seen if c[0] == "wt_seq_cumsum_f64"]
    if len(tb_seen) != 1:
        raise AssertionError("the float64 time base launched the "
                             "sequential cumulative sum "
                             f"{len(tb_seen)} times, not once")
    seq_cases.append(cumsum_case(
        torch, cycles_per_ms, lib, seq_old, tb_seen[0], dadd,
        f"the {x_long.shape[0] / FS:.2f} s utterance's time base", 5))
    del tb_seen, f0_tb

    # the CLI without --f32 (float64, the JAX CLI's default) on the card
    with tempfile.TemporaryDirectory() as td:
        pre, syn_w = (str(pathlib.Path(td) / n) for n in ("p64", "y64.wav"))
        for args in (["analyze", fx, pre], ["synthesize", pre, syn_w]):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-c", CLI_NO_JAX, *args,
                                "--device", "cuda"], cwd=root,
                               capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"cli {args[0]} (float64) exited "
                                     f"{r.returncode}:\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-2000:]}")
            log(f"cli {args[0]} without --f32 (float64): rc 0 in "
                f"{time.perf_counter() - t0:.1f} s (jax and worldtpu "
                f"blocked)")
        f0_c, _, _ = P_.read_f0(pre + ".f0")
        f0_22, _, _ = P_.read_f0(str(fixd / "t22.f0.gz"))
        yc, fsc = read_wav(syn_w)
        rms_c = float(np.sqrt(np.mean(yc ** 2)))
        d_cli = float(np.abs(f0_c - f0_22).max())
        log(f"cli float64: F0 max |d| vs t22.f0.gz {d_cli:.3e} Hz (gate "
            f"{F64_GATES['f0_rmse_hz'][0]:g}); output {yc.shape[0]} samples "
            f"at {fsc} Hz, rms {rms_c:.4f}")
        if (not d_cli < F64_GATES["f0_rmse_hz"][0] or fsc != fs22
                or not np.isfinite(yc).all() or rms_c < 0.01):
            raise AssertionError("cli float64 output")

    # ---- 8. codec and corpus on the card ----
    corpus_counts = corpus_stream(torch, dev, card)
    for r in results:
        r["launches_corpus"] = corpus_counts.get(C_ENTRY[r["name"]], 0)
    codec_on_card(torch, dev, card, cycles_per_ms, x, f0, geo, ck)
    mcd_on_card(torch, dev, card)

    # ---- 9. long audio on the card ----
    PG.clear()                 # the captured programs' memory, before peaks
    torch.cuda.empty_cache()
    long_counts, cut = long_audio(torch, dev, card, cycles_per_ms)
    results.append(dict(cut.pop("noise"),
                        launches_main=counts.get("wt_noise_rows", 0),
                        launches_corpus=corpus_counts.get("wt_noise_rows", 0)))
    for r in results:
        r["launches_long"] = long_counts.get(C_ENTRY[r["name"]], 0)

    # ---- 10. grid_ms = 2 on the main path; float64 long audio ----
    grid_counts = grid_phase(torch, dev, card, cycles_per_ms, x, noise, kw,
                             audio_s)
    PG.clear()
    torch.cuda.empty_cache()
    f64_counts = long_audio_f64(torch, dev, card, cycles_per_ms, cut["x60"],
                                cut["f0_x60"], cut["x150"], old=seq_old,
                                dadd=dadd, cases=seq_cases)
    for r in results:
        r["launches_grid2"] = grid_counts.get(C_ENTRY[r["name"]], 0)
        r["launches_f64_long"] = f64_counts.get(C_ENTRY[r["name"]], 0)

    # ---- 11. the mesh paths: NCCL world of one, gloo ranks on cuda:0 ----
    mesh_counts = mesh_phase(torch, dev, card, x, noise, kw, cut["x60"])
    for r in results:
        r["launches_mesh"] = mesh_counts.get(C_ENTRY[r["name"]],
                                             [0] * MESH_RANKS)

    jaxy = [m for m in sys.modules
            if m in ("jax", "worldtpu") or m.startswith(("jax.", "worldtpu."))]
    if jaxy:
        raise AssertionError(f"the smoke test imported {jaxy}")

    log(f"whole script wall: {time.perf_counter() - t_script:.1f} s")
    kernels = []
    for r in results:
        b_ms, b_by = r.pop("bound")
        kernels.append(dict(r, route="cuda", bound_ms=b_ms, bound_by=b_by,
                            share=b_ms / r["ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def d4c_case(torch, card, cycles_per_ms, label, run):
    """The D4C kernel on the arguments of the one D4C call ``run`` makes,
    against its plain chain on the same card tensors: the rows of frames
    both call active within D4C_ATOL, each gate flip at a float64 LoveTrain
    ratio within D4C_KNIFE of the threshold, inactive rows the default;
    the kernel's device time alone, its call's, the plain chain's with
    its host and its device time alone (a captured program of it
    replayed); the bound, counted from the frames the gate let
    through."""
    from worldtpu_torch import _build, constants as C
    from worldtpu_torch.analysis import d4c as D4
    from worldtpu_torch.ops import d4c_kernel as DK
    seen = []
    real = DK.d4c_frames_cuda

    def spy(*a, **k):
        seen.append((a, k))
        return real(*a, **k)

    DK.d4c_frames_cuda = spy
    try:
        run()
    finally:
        DK.d4c_frames_cuda = real
    (a, k), = seen
    x, f0, tp = a
    fs, so = k["fs"], k.get("sample_offset")
    with torch.no_grad():
        got, c_seen = capture(_build, lambda: DK.d4c_frames_cuda(*a, **k))
        want = DK.d4c_frames_plain(*a, **k)
        ag, aw = got[..., 0] < 0.5, want[..., 0] < 0.5
        both = ag & aw
        err = float((got - want)[both].abs().max())
        default = bool((got[~ag] == 1.0 - C.MY_SAFE_GUARD_MINIMUM).all())
        flips = (ag != aw).nonzero().tolist()
        ap0 = D4.love_train_ap0(x.double(), f0.double(), tp.double(), fs=fs,
                                sample_offset=so) if flips else None
        flip_ap0 = [(b, f, float(ap0[b, f])) for b, f in flips]
        ms = device_ms(torch, cycles_per_ms, replayer(
            torch, _build, _build.library(), c_seen), 30)
        call = median_ms(torch, lambda: DK.d4c_frames_cuda(*a, **k), 10)
        plain = median_ms(torch, lambda: DK.d4c_frames_plain(*a, **k), 3)
        # the chain's device time alone, captured once and replayed: its
        # thousands of launches would fill the launch queue behind the
        # sleep kernel of device_ms
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            DK.d4c_frames_plain(*a, **k)
            with torch.cuda.graph(graph, stream=side):
                DK.d4c_frames_plain(*a, **k)
        torch.cuda.current_stream().wait_stream(side)
        old = device_ms(torch, cycles_per_ms, graph.replay, 3)
        del graph
    ip, _ = DK.kernel_params(fs, k["fft_size_out"], k["threshold"],
                             k["f0_ceil_bound"])
    N, n_lt, n_ap = int(ip[0]), int(ip[13]), int(ip[8])
    K = N // 2 + 1
    voiced = int((f0 > 0).sum())
    act = int(ag.sum())
    f0d = f0.double()[ag].clamp(min=C.FLOOR_F0_D4C)

    def fft(m):
        return 5 * m * (m.bit_length() - 1)

    # a voiced frame: LoveTrain's window (~10 operations a sample) and its
    # packed transform; an active frame besides: the centroids' and the
    # Hanning window, two N-point and one N/2-point complex FFT, the bands
    # two to an N-point FFT, the three smoothings' taps (width * N / fs + 2
    # a bin) and ~20 operations a bin for the rows' arithmetic
    taps = float(((2.5 * f0d * N / fs + 6) * K).sum())
    hc = (4.0 * fs / f0d / 2.0).round().clamp(max=D4.d4c_max_half_c(fs))
    ops = (voiced * (10 * (3 * fs / 40 + 1) + fft(n_lt // 2))
           + act * (2 * fft(N) + fft(N // 2) + -(-n_ap // 2) * fft(N)
                    + 20 * K) + taps + float(30 * (2 * hc + 1).sum()))
    n_bytes = nbytes(x, f0, tp, got)
    b = bound(n_bytes, ops)
    log(f"d4c, {label}: x {tuple(x.shape)}, {f0.shape[1]} frames a row, "
        f"fft {N} (LoveTrain {n_lt}), {voiced} voiced frames, {act} past "
        f"the gate; max |d ap| against the plain chain {err:.3e} on "
        f"{int(both.sum())} frames both call active (tol {D4C_ATOL}); "
        f"inactive rows the default {default}; gate flips (b, f, float64 "
        f"ap0) {flip_ap0} (tol: within {D4C_KNIFE} of {k['threshold']}); "
        f"kernel alone {ms:.4f} ms, call {call:.4f} ms, the plain chain "
        f"(the design it replaced) {old:.4f} ms device alone, {plain:.3f} "
        f"ms with its host; {ops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB; "
        f"bound {b[0]:.4f} ms ({b[1]}), share {b[0] / ms:.3f}  [{card}]")
    if (err > D4C_ATOL or not default
            or any(abs(v - k["threshold"]) > D4C_KNIFE for _, _, v in
                   flip_ap0)):
        raise AssertionError(f"the D4C kernel disagrees with its plain "
                             f"chain ({label})")
    return dict(label=label, shape=list(got.shape), fft=N, voiced=voiced,
                active=act, max_abs_err=err, gate_flips=flip_ap0, ms=ms,
                call_ms=call, plain_ms=plain, old_design_ms=old,
                bound_ms=b[0], bound_by=b[1], launches=len(c_seen))


def d4c_row(torch, dev, card, cycles_per_ms, counts, run_eager):
    """The kernels line's D4C row: the main path's own D4C call (the eager
    program's arguments), then batch_analyze's eager program's on a 48 kHz
    batch of 8 (bench.synth_utterance_diverse, the port's Harvest F0); the
    row's figures are the main path's, each case's in ``cases``."""
    from bench import synth_utterance_diverse
    from worldtpu_torch.analysis import harvest as H
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.parallel import batch as PB, graphs as PG
    cases = [d4c_case(torch, card, cycles_per_ms,
                      f"the main path ({FS} Hz, B={BATCH})", run_eager)]
    fs48 = 48000
    waves = [synth_utterance_diverse(fs48, i) for i in range(BATCH)]
    x_np, _, _, _, _ = PB.pad_batch(waves, fs48)
    T = -(-x_np.shape[1] // 4096) * 4096
    x48 = torch.tensor(np.pad(x_np, ((0, 0), (0, T - x_np.shape[1]))),
                       device=dev)
    ck48 = CheapTrickKernel(fs48)
    akw = dict(geo=H.HarvestGeometry(fs48, T, f0_floor=40.0), fs=fs48,
               fft_size=ck48.fft_size, max_half_window=ck48.max_half_window,
               grid_ms=1)

    def analyze48():
        with torch.no_grad():
            PB._analyze(x48, PG.scale_buffer(1.0, x48), **akw)

    cases.append(d4c_case(torch, card, cycles_per_ms,
                          f"batch_analyze's program at {fs48} Hz, "
                          f"B={BATCH}", analyze48))
    main = cases[0]
    return dict(name="d4c", source="worldtpu_torch/csrc/d4c.cu",
                replaces="none (worldtpu/analysis/d4c.py, left to XLA)",
                launches=counts["wt_d4c"], launches_main=counts["wt_d4c"],
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=main["ms"], call_ms=main["call_ms"],
                plain_ms=main["plain_ms"],
                bound=(main["bound_ms"], main["bound_by"]), library_ms=None,
                old_design_ms=main["old_design_ms"], cases=cases)


def pulse_row(torch, _build, S, PK, alone_ms, cycles_per_ms, card, counts,
              train):
    """The pulse-responses kernel at the main path's shapes (the arguments
    pulse_train hands it, ``train`` being pulse_train's): against the plain
    chain with irfft as defined (padded rows zero, each real row's relative
    RMS within PULSE_ROW_REL, the voicing gate equal: with zero noise a row
    is zero exactly where it is off or ns is 0; the plain chain with
    cuFFT's own irfft printed beside it), its device time alone, with its
    wrapper, the plain chain's host-inclusive time and its device time
    alone (the design it replaced), the real pulses' share, the bound.

    irfft as defined (numpy, pocketfft, FFTW, the CPU's torch.fft): a real
    signal's transform takes only the real parts of bins 0 and n/2.  For
    some plans cuFFT's complex-to-real transform also reads the imaginary
    part of bin n/2, which the periodic spectrum has (its phase's |sin| is
    not 0 there); the kernel follows the definition."""
    from worldtpu_torch.ops import dft

    def irfft_defined(X, n=None):
        X = X.clone()
        X[..., 0] = X[..., 0].real.to(X.dtype)
        X[..., -1] = X[..., -1].real.to(X.dtype)
        return torch.fft.irfft(X, n=n, dim=-1)

    def plain_defined(*a, **k):
        real_irfft, dft.irfft = dft.irfft, irfft_defined
        try:
            return PK.pulse_responses_plain(*a, **k)
        finally:
            dft.irfft = real_irfft

    seen = []
    real = PK.pulse_responses_cuda

    def spy(*a, **k):
        seen.append((a, k))
        return real(*a, **k)

    PK.pulse_responses_cuda = spy
    try:
        S.pulse_train(**train)
    finally:
        PK.pulse_responses_cuda = real
    (a, k), = seen
    pk, p_seen = capture(_build, lambda: PK.pulse_responses_cuda(*a, **k))
    valid, ns = a[4], a[2]
    rels = {}
    for nm, fn in (("cuFFT's irfft", PK.pulse_responses_plain),
                   ("irfft as defined", plain_defined)):
        pp = fn(*a, **k)
        norm = pp.norm(dim=-1)
        live = valid & (norm > 0)
        rel = torch.zeros_like(norm)
        rel[live] = (pk - pp).norm(dim=-1)[live] / norm[live]
        rels[nm] = rel
        worst = rel.flatten().argsort()[-3:].tolist()
        log(f"pulse vs the plain chain with {nm}: row relative RMS max "
            f"{float(rel.max()):.2e}, median {float(rel[live].median()):.2e}"
            f"; worst rows (b, p, rel, ns, vuv_at, pt, |row|): "
            + "; ".join(f"({i // rel.shape[1]}, {i % rel.shape[1]}, "
                        f"{float(rel.flatten()[i]):.2e}, "
                        f"{int(ns.flatten()[i])}, "
                        f"{float(a[3].flatten()[i]):g}, "
                        f"{float(a[0].flatten()[i]):.4f}, "
                        f"{float(norm.flatten()[i]):.3e})" for i in worst))
    err = float((pk - pp).abs().max())
    pad_zero = bool((pk[~valid] == 0).all())
    zero_same = bool((pk[valid & (norm == 0)] == 0).all())
    quiet = list(a)
    quiet[7] = torch.zeros_like(a[7])
    g0 = PK.pulse_responses_cuda(*quiet, **k).abs().amax(-1) > 0
    w0 = plain_defined(*quiet, **k).abs().amax(-1) > 0
    gate_flips = int((g0 != w0).sum())
    n_real, total = int(valid.sum()), valid.numel()
    worst = float(rels["irfft as defined"].max())
    log(f"pulse: {tuple(pk.shape)}; {n_real} real pulses of {total} "
        f"({100 * n_real / total:.1f}%); row relative RMS max {worst:.2e} "
        f"(tol {PULSE_ROW_REL}, irfft as defined); max abs err {err:.3e}; "
        f"padded rows zero {pad_zero}, zero rows kept {zero_same}; "
        f"voicing-gate flips {gate_flips} (tol 0)")
    if worst > PULSE_ROW_REL or not pad_zero or not zero_same or gate_flips:
        raise AssertionError("pulse kernel disagrees with its plain version")
    del pp, g0, w0, quiet, rels
    ms = alone_ms(p_seen, 30)
    call = median_ms(torch, lambda: PK.pulse_responses_cuda(*a, **k), 10)
    plain = median_ms(torch, lambda: PK.pulse_responses_plain(*a, **k), 3)
    old = device_ms(torch, cycles_per_ms,
                    lambda: PK.pulse_responses_plain(*a, **k), 3)
    n = pk.shape[2]
    kb = n // 2 + 1
    # a real pulse reads its two rows of each spectral array and its noise
    # samples and writes its row; a padded pulse writes its zero row; every
    # pulse's five scalars are read.  Operations: three n-point and one
    # n/2-point complex FFT (5 m log2 m each) and ~8 per bin
    p_bytes = (n_real * (16 * kb + 4 * n)
               + 4 * int(ns[valid].clamp(max=n).sum())
               + (total - n_real) * 4 * n + 21 * total)
    lg = n.bit_length() - 1
    p_ops = n_real * (15 * n * lg + 5 * (n // 2) * (lg - 1) + 8 * kb)
    b = bound(p_bytes, p_ops)
    log(f"pulse: kernel alone {ms:.4f} ms, the plain chain (the design it "
        f"replaced) {old:.4f} ms device alone, {plain:.3f} ms with its "
        f"host; bytes needed {p_bytes / 1e6:.1f} MB, {p_ops / 1e9:.2f} GFLOP"
        f"  [{card}]")
    return dict(name="pulse", source="worldtpu_torch/csrc/pulse.cu",
                replaces="none (worldtpu/synthesis/synthesis.py, left to "
                         "XLA)",
                launches=counts["wt_pulse_resp"],
                launches_main=counts["wt_pulse_resp"], max_abs_err=err,
                ms=ms, call_ms=call, plain_ms=plain, bound=b,
                library_ms=None, old_design_ms=old,
                real_pulses=n_real, pulses=total)


def noise_row(torch, card, cycles_per_ms, key, start, count, fft):
    """The noise rows' kernel against its plain version on the card at a
    chunk step's rows [1, count, fft] (LongPipeline's Pmax), bit for bit;
    its device time alone, its call's, the plain version's; the kernels
    line's row."""
    from worldtpu_torch import _build
    from worldtpu_torch.ops import noise_kernel as NK
    from worldtpu_torch.synthesis import noise as N
    with torch.no_grad():
        nk, seen = capture(_build, lambda: N.indexed_noise(key, start, count,
                                                           fft))
        npl = N.indexed_noise_plain(key, start, count, fft)
        diff = nk != npl
        n_diff = int(diff.sum())
        err = float((nk - npl).abs().max())
        ms = device_ms(torch, cycles_per_ms, replayer(
            torch, _build, _build.library(), seen), 30)
        call = median_ms(torch, lambda: NK.noise_rows_cuda(
            key, start, count, fft), 10)
        plain = median_ms(torch, lambda: N.indexed_noise_plain(
            key, start, count, fft), 5)
        # one run a window: the chain's ~390 launches fill most of the
        # launch queue behind the sleep kernel
        old = device_ms(torch, cycles_per_ms, lambda: N.indexed_noise_plain(
            key, start, count, fft), 1)
    cols, rows = nk.numel(), nk.numel() // fft
    n_bytes = 4 * cols + 8 * start.numel() + 16
    tb = n_bytes / PEAK_BYTES_S * 1e3
    t_issue = NOISE_SASS_A_COLUMN * cols / PEAK_ISSUE_S * 1e3
    t_alu = NOISE_ALU_A_COLUMN * cols / PEAK_INT32_OPS_S * 1e3
    log(f"noise: {tuple(nk.shape)}; columns unequal to the plain version "
        f"{n_diff} (tol 0), max abs diff {err:.3e}; kernel alone {ms:.4f} ms,"
        f" call {call:.4f} ms, the plain chain (the design it replaced) "
        f"{old:.4f} ms device alone, {plain:.3f} ms with its host; "
        f"{NOISE_SASS_A_COLUMN * cols / 1e9:.3f} G instructions issued "
        f"({t_issue * 1e3:.2f} us at {PEAK_ISSUE_S / 1e12:.2f} T/s), "
        f"{NOISE_ALU_A_COLUMN * cols / 1e9:.3f} G on the integer ALU pipe "
        f"({t_alu * 1e3:.2f} us at {PEAK_INT32_OPS_S / 1e12:.2f} T/s), "
        f"{n_bytes / 1e6:.1f} MB written ({tb * 1e3:.2f} us)  [{card}]")
    if n_diff:
        raise AssertionError("the noise kernel's rows are not the plain "
                             "version's")
    return dict(name="noise", source="worldtpu_torch/csrc/noise.cu",
                replaces="none (worldtpu/synthesis/synthesis.py "
                         "indexed_noise, left to XLA)",
                launches=len(seen), max_abs_err=err, ms=ms, call_ms=call,
                plain_ms=plain, bound=max((tb, "bytes"),
                                          (t_issue, "instruction issue"),
                                          (t_alu, "integer ALU pipe")),
                library_ms=None, old_design_ms=old, rows=rows,
                unequal_columns=n_diff)


# the symbol of each kernel's __global__ function in csrc/ (one a launch)
KERNEL_SYMBOLS = {"wt_zc": "zc_kernel", "wt_refine_sums": "refine_kernel",
                  "wt_ola": "ola_kernel", "wt_extend": "extend_kernel",
                  "wt_contour_merge": "merge_kernel",
                  "wt_contour_smooth": "smooth_kernel",
                  "wt_pulse_resp": "pulse_kernel",
                  "wt_noise_rows": "noise_kernel", "wt_d4c": "d4c_kernel"}
# geometries run eagerly between a capture and its replay: more than any
# device constant cache holds (ops.numeric.device_cache, 32 at most)
EVICT_GEOMETRIES = 36


def traced_kernels(acts):
    """{C entry: device activities of its kernel} in a profiler trace."""
    return {k: sum(1 for a in acts if re.search(rf"(?<!\w){sym}\b", a[2]))
            for k, sym in KERNEL_SYMBOLS.items()}


def graph_constants(torch, dev, x, noise, kw, ck, want):
    """The captured program keeps the device constants it reads: (1) a
    second HarvestGeometry equal to the first, a new key, runs eagerly,
    then captures and replays; (2) after EVICT_GEOMETRIES other geometries
    ran eagerly (their constants push the captured call's out of every
    device constant cache), a replay of each program still gives the
    eager program's bits ``want``."""
    from worldtpu_torch.analysis import harvest as H
    from worldtpu_torch.parallel import batch_analyze, batch_wav_to_wav
    from worldtpu_torch.parallel import graphs as PG
    geo = kw["geo"]
    kw2 = dict(kw, geo=H.HarvestGeometry(geo.fs, geo.x_length,
                                         f0_floor=geo.f0_floor))
    n0 = len(PG.programs())
    outs = [batch_wav_to_wav(x, noise, **kw2) for _ in range(3)]
    same2 = all(torch.equal(u, v) for o in outs for u, v in zip(o, want))
    n_new = len(PG.programs()) - n0
    t0 = time.perf_counter()
    for i in range(EVICT_GEOMETRIES):
        n = 8192 + 512 * i
        batch_analyze(x[:1, :n].contiguous(),
                      geo=H.HarvestGeometry(geo.fs, n, f0_floor=40.0),
                      fs=geo.fs, fft_size=ck.fft_size,
                      max_half_window=ck.max_half_window)
    torch.cuda.synchronize()
    evict_s = time.perf_counter() - t0
    after = [batch_wav_to_wav(x, noise, **k) for k in (kw, kw2)]
    same_after = all(torch.equal(u, v) for o in after for u, v in zip(o, want))
    log(f"graph cache, a second equal geometry: eager, captured, replayed, "
        f"{n_new} new program, bit-equal to the eager program {same2}; "
        f"after {EVICT_GEOMETRIES} other geometries eagerly ({evict_s:.1f} "
        f"s), replays of both programs bit-equal {same_after}")
    if n_new != 1 or not same2 or not same_after:
        raise AssertionError("a captured program lost its device constants")


# ---- the contour chain's kernels (phases 3-6) ----

# kernel B against the blocked-matmul plain version, and the whole chain
# (kernels A and B) against the chain of plain versions: voicing identical,
# F0 within this (Hz): B's recursion rounds otherwise than the matmuls
CONTOUR_F0_ATOL = 1e-3
# a decision of kernel A that differs from its plain version on the card
# must lie within this relative distance of its threshold: the keep test
# c / mean < length, a merge's s1 > s2 (both sides sum the same float32
# values in another order)
KNIFE_REL = 1e-5


def sync_site(torch, fn):
    """Where fn first synchronizes the host (CUDA sync debug mode 'error'):
    the last frames of the traceback, or None."""
    import traceback
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        return "".join(traceback.format_exception(e)[-6:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return None


def chain_calls(torch, CDV, CK, cand, score, n_out, frame_period, grid_ms=1):
    """The contour chain on (cand, score) with the kernels, spied: (its F0,
    contour_merge's arguments and keywords, contour_smooth's arguments),
    and the same chain with the plain versions of both (on the same
    device): its F0."""
    seen = {}
    real_m, real_s = CK.contour_merge, CK.contour_smooth

    def spy_m(*a, **k):
        seen["merge"] = (a, k)
        return real_m(*a, **k)

    def spy_s(*a):
        seen["smooth"] = a
        return real_s(*a)

    with torch.no_grad():
        CK.contour_merge, CK.contour_smooth = spy_m, spy_s
        try:
            f0_k = CDV.fix_and_smooth(cand, score, n_out, frame_period,
                                      grid_ms=grid_ms)
        finally:
            CK.contour_merge, CK.contour_smooth = real_m, real_s
        CK.contour_merge = CK.contour_merge_plain
        CK.contour_smooth = CK.contour_smooth_plain
        try:
            f0_p = CDV.fix_and_smooth(cand, score, n_out, frame_period,
                                      grid_ms=grid_ms)
        finally:
            CK.contour_merge, CK.contour_smooth = real_m, real_s
    return f0_k, seen["merge"], seen["smooth"], f0_p


def merge_decisions(margs, grid, tr_k, tr_p):
    """Kernel A's decisions (trace tr_k) against a plain version's (tr_p)
    on the same arguments: (keep flips [(row, slot, c/mean, length)],
    merge flips [(row, step, kernel s1, s2, plain s1, s2)], rows whose keep
    masks differ).  c/mean is recomputed in float32 from the kernel's
    section sums, as the kernel computes it."""
    so = margs[9].cpu().numpy()
    n_sec = margs[5].cpu().numpy()
    S = margs[3].shape[1]
    ks, ps = tr_k["ssum"].cpu().numpy(), tr_p["ssum"].cpu().numpy()
    kk, pk = tr_k["keep"].cpu().numpy(), tr_p["keep"].cpu().numpy()
    c = np.float32(2200.0 / grid)
    keep_flips, merge_flips, rows = [], [], set()
    for b in range(len(n_sec)):
        m = np.float32(0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            for k in range(min(int(n_sec[b]), S)):
                ln = np.float32(so[b, k] - so[b, S + k])
                m = np.float32(m + ks[b, k]) / ln
                if kk[b, k] != pk[b, k]:
                    keep_flips.append((b, k, float(c / m), float(ln)))
                    rows.add(b)
    k1, k2 = tr_k["s1"].cpu().numpy(), tr_k["s2"].cpu().numpy()
    p1, p2 = tr_p["s1"].cpu().numpy(), tr_p["s2"].cpu().numpy()
    for b in range(len(n_sec)):
        if b in rows:
            continue
        for i in np.nonzero(~np.isnan(k1[b]) | ~np.isnan(p1[b]))[0]:
            if (k1[b, i] > k2[b, i]) != (p1[b, i] > p2[b, i]):
                merge_flips.append((b, int(i), float(k1[b, i]),
                                    float(k2[b, i]), float(p1[b, i]),
                                    float(p2[b, i])))
    return keep_flips, merge_flips, rows


def knife_edges(keep_flips, merge_flips):
    """The flips that do NOT lie within KNIFE_REL of their threshold."""
    bad = [f for f in keep_flips
           if not abs(f[2] - f[3]) <= KNIFE_REL * abs(f[3])]
    bad += [f for f in merge_flips
            if not (abs(f[2] - f[3]) <= KNIFE_REL * max(abs(f[2]), abs(f[3]))
                    and abs(f[4] - f[5])
                    <= KNIFE_REL * max(abs(f[4]), abs(f[5])))]
    return bad


def smooth_host_check(sargs, sm_k):
    """Kernel B's output against the host contour's float64 filteringF0
    (analysis/contour.py, the reference's operation order) rounded once,
    on every live section: (live sections, sections bit-equal, the
    longest section's frames)."""
    from worldtpu_torch.analysis import contour as HC
    from worldtpu_torch.ops import contour_kernel as CK
    f0, st, ed, n_sec = (a.cpu().numpy() for a in sargs)
    got = sm_k.cpu().numpy()
    lag = CK.LAG
    B, F = f0.shape
    n_all = n_eq = longest = 0
    for b in range(B):
        padded = np.zeros(F + 2 * lag)
        padded[lag:lag + F] = f0[b]
        for k in range(int(n_sec[b])):
            s_, e_ = int(st[b, k]), int(ed[b, k])
            host = HC._filtering_f0(padded, s_, e_)[s_:e_ + 1]
            n_eq += (got[b, s_ - lag:e_ - lag + 1].tobytes()
                     == host.astype(np.float32).tobytes())
            n_all += 1
            longest = max(longest, e_ - s_ + 1)
    return n_all, n_eq, longest


def smooth_trace(tr, n_sec):
    """Kernel B's trace over the live slots: the longest chain and all
    steps run, and how many sections hit each of SMOOTH_FLAGS."""
    from worldtpu_torch.ops import contour_kernel as CK
    t = tr.cpu().numpy()
    live = np.arange(t.shape[1])[None] < n_sec.cpu().numpy()[:, None]
    steps, flags = t[..., 0][live], t[..., 1][live]
    out = dict(longest_chain=int(steps.max()) if steps.size else 0,
               steps=int(steps.astype(np.int64).sum()))
    for name, bit in CK.SMOOTH_FLAGS.items():
        out[name] = int(((flags & bit) != 0).sum())
    return out


def contour_check(torch, label, cand, score, n_out, frame_period,
                  grid_ms=1, cycles_per_ms=None, old=None):
    """Kernels A and B on the contour chain of (cand, score) [B, F, S] on
    the card against their plain versions: A's section sums bit for bit
    against the CPU plain version on the downloaded arguments, its keep
    mask against the CPU plain version (identical) and the card's plain
    version (flips only at knife edges, each printed), its output equal
    to both plain versions' on every row without a flip, B bit-equal to
    the host float64 filter rounded once on every live section and within
    CONTOUR_F0_ATOL of its plain version, and the whole chain with both
    kernels against the chain of plain versions on the rows without a flip
    (voicing identical, F0 within CONTOUR_F0_ATOL).  Prints B's trace
    (chains run, shortcuts, full runs) and how A summed its sections.  A's
    row layout follows F; with ``cycles_per_ms`` each kernel's device time
    alone is measured too; with ``old`` (a baseline library holding PR
    11's contour.cu) contour_baseline runs as well.  Returns (merge args,
    merge keywords, smooth args, a dict of figures); raises on a failed
    gate."""
    from worldtpu_torch.analysis import contour_device as CDV
    from worldtpu_torch.ops import contour_kernel as CK
    f0_k, (margs, mkw), sargs, f0_p = chain_calls(
        torch, CDV, CK, cand, score, n_out, frame_period, grid_ms)
    grid = mkw["grid_ms"]
    B, F = margs[0].shape
    with torch.no_grad():
        out_k, tr_k = CK.contour_merge_cuda(*margs, grid_ms=grid,
                                            trace=True)
        out_p, tr_p = CK.contour_merge_plain(*margs, grid_ms=grid,
                                             trace=True)
        out_c, tr_c = CK.contour_merge_plain(*(a.cpu() for a in margs),
                                             grid_ms=grid, trace=True)
        sm_k, s_tr = CK.contour_smooth_cuda(*sargs, trace=True)
        sm_p = CK.contour_smooth_plain(*sargs)
    torch.cuda.synchronize()
    n_sec = margs[5]
    S = margs[3].shape[1]
    live = torch.arange(S, device=n_sec.device)[None] < n_sec[:, None]
    ssum_same = torch.equal(tr_k["ssum"].cpu(), tr_c["ssum"])
    kf_c, mf_c, rows_c = merge_decisions(margs, grid, tr_k, tr_c)
    kf_p, mf_p, rows_p = merge_decisions(margs, grid, tr_k, tr_p)
    bad = knife_edges(kf_c + kf_p, mf_c + mf_p)
    # a row with a flip may rightly differ; every other row must not
    flip_rows = sorted(rows_c | rows_p | {f[0] for f in mf_c + mf_p})
    other = torch.ones(B, dtype=torch.bool)
    other[flip_rows] = False
    o = other.to(out_k.device)
    out_same_c = torch.equal(out_k.cpu()[other], out_c[other])
    out_same_p = torch.equal(out_k[o], out_p[o])
    nv = int(live.sum())
    n_ch = int(tr_k["keep"].sum())
    contested = int((~torch.isnan(tr_k["s1"])).sum())
    n_ordered = int(tr_k["ordered"][live].sum())
    sm_v = torch.equal(sm_k > 0, sm_p > 0)
    sm_d = float((sm_k - sm_p).abs().max()) if F else 0.0
    ch_v = torch.equal(f0_k[o] > 0, f0_p[o] > 0)
    ch_d = float((f0_k - f0_p)[o].abs().max()) if o.any() else 0.0
    n_sm, n_host, longest = smooth_host_check(sargs, sm_k)
    st_ = smooth_trace(s_tr, sargs[3])
    variant = "shared" if F <= CK.MERGE_SHARED_MAX_F else "global"
    log(f"contour kernels, {label}: B={B} F={F} slots {S}, live sections "
        f"{nv}, kept {n_ch}, contested merges {contested}; kernel A "
        f"({variant} rows): section sums bit-equal to the CPU plain "
        f"version {ssum_same}, summed in parallel {nv - n_ordered}, in "
        f"frame order {n_ordered}; rows with a flip {flip_rows}; on the "
        f"other rows output equal to the CPU plain version "
        f"{out_same_c}, to the card's plain version {out_same_p}; keep "
        f"flips vs CPU {len(kf_c)}, vs card plain {len(kf_p)}; merge "
        f"flips vs CPU {len(mf_c)}, vs card plain {len(mf_p)} (gate: only "
        f"within {KNIFE_REL:g} of the threshold); kernel B vs plain: "
        f"voicing identical {sm_v}, max |d| {sm_d:.3e} Hz (tol "
        f"{CONTOUR_F0_ATOL}); whole chain vs the plain chain on the rows "
        f"without a flip: voicing identical {ch_v}, max |dF0| {ch_d:.3e} "
        f"Hz (tol {CONTOUR_F0_ATOL})")
    log(f"  {label}: kernel B bit-equal to the host float64 filter rounded "
        f"once on {n_host} of {n_sm} live sections (gate: all); the "
        f"longest section {longest} frames, the longest chain run "
        f"{st_['longest_chain']} steps ({st_['steps']} in all); shortcuts: "
        f"prefix orbit {st_['prefix_orbit']}, tail orbit "
        f"{st_['tail_orbit']}, backward cycle {st_['back_cycle']}; full "
        f"runs: prefix {st_['prefix_full']}, tail {st_['tail_full']}, "
        f"backward periodic stretch {st_['back_full']}")
    for f in kf_c + kf_p:
        log(f"  keep flip: row {f[0]} slot {f[1]}: c/mean {f[2]!r} against "
            f"length {f[3]!r}")
    for f in mf_c + mf_p:
        log(f"  merge flip: row {f[0]} step {f[1]}: kernel s1 {f[2]!r} s2 "
            f"{f[3]!r}; plain s1 {f[4]!r} s2 {f[5]!r}")
    times = ""
    if cycles_per_ms is not None:
        from worldtpu_torch import _build
        lib = _build.library()
        with torch.no_grad():
            _, a_seen = capture(_build, lambda: CK.contour_merge_cuda(
                *margs, grid_ms=grid))
            _, b_seen = capture(_build, lambda: CK.contour_smooth_cuda(
                *sargs))
        a_ms, b_ms = (device_ms(torch, cycles_per_ms, replayer(
            torch, _build, lib, seen_), 10) for seen_ in (a_seen, b_seen))
        ns = 1e6 * b_ms / max(st_["longest_chain"], 1)
        times = (f"; device time alone: merge {a_ms:.4f} ms, smoothing "
                 f"{b_ms:.4f} ms = {ns:.2f} ns a step of its longest chain")
        del a_seen, b_seen
    log(f"  {label}: kernel A {variant} rows{times}")
    if (not ssum_same or bad or kf_c or not out_same_c or not out_same_p
            or not sm_v or sm_d > CONTOUR_F0_ATOL or n_host != n_sm
            or not ch_v or ch_d > CONTOUR_F0_ATOL):
        raise AssertionError(f"contour kernels disagree with their plain "
                             f"versions ({label})")
    ab = {}
    if old is not None:
        ab = contour_baseline(torch, label, old, cand, score, n_out,
                              frame_period, grid_ms, margs, sargs, f0_k,
                              tr_k, cycles_per_ms)
    return margs, dict(mkw, grid_ms=grid), sargs, dict(
        live=nv, kept=n_ch, contested=contested, merge_flips=len(mf_p),
        smooth_err=sm_d, chain_err=ch_d, variant=variant, baseline=ab,
        trace=st_, longest=longest, ordered=n_ordered)


def contour_baseline(torch, label, old, cand, score, n_out, frame_period,
                     grid_ms, margs, sargs, f0_new, tr_new, cycles_per_ms):
    """8075e49's contour kernels (``old``, a baseline library) on the same
    chain: its F0 against the current kernels' chain F0, bit-equal on
    every row without a merge decision that differs between the two
    designs (each printed; only within KNIFE_REL of its threshold); with
    ``cycles_per_ms`` each kernel's device time alone, old and new in
    turns (old, new, new, old).  Returns {"merge old": [ms, ms], ...};
    raises on a failed gate."""
    from worldtpu_torch import _build
    from worldtpu_torch.analysis import contour_device as CDV
    from worldtpu_torch.ops import contour_kernel as CK
    real = _build.launch
    grid = grid_ms
    old_rows = old_merge_rows(torch, margs)

    def adapt(name, args):
        return old_contour_args(name, args, old_rows)

    def launch_old(name, device, *args):
        if name not in ("wt_contour_merge", "wt_contour_smooth"):
            return real(name, device, *args)
        with torch.cuda.device(device):
            err = getattr(old, name)(
                *_build.c_args(adapt(name, args)),
                torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"baseline {name}: CUDA launch failed ({err})")

    _build.launch = launch_old
    try:
        with torch.no_grad():
            f0_old = CDV.fix_and_smooth(cand, score, n_out, frame_period,
                                        grid_ms=grid_ms)
            _, tr_old = CK.contour_merge_cuda(*margs, grid_ms=grid,
                                              trace=True)
    finally:
        _build.launch = real
    torch.cuda.synchronize()
    kf, mf, rows = merge_decisions(margs, grid, tr_new, tr_old)
    flip_rows = sorted(rows | {f[0] for f in mf})
    other = torch.ones(f0_new.shape[0], dtype=torch.bool)
    other[flip_rows] = False
    o = other.to(f0_new.device)
    same = torch.equal(f0_new[o], f0_old[o])
    bad = knife_edges(kf, mf)
    log(f"  {label}: 8075e49's contour kernels (--baseline): section sums "
        f"bit-equal to the new ones "
        f"{torch.equal(tr_new['ssum'], tr_old['ssum'])}; rows with a "
        f"decision that differs {flip_rows} (keep {len(kf)}, merge "
        f"{len(mf)}; gate: only within {KNIFE_REL:g} of the threshold); "
        f"chain F0 bit-equal on the other rows {same}")
    for f in kf:
        log(f"  keep flip (new vs 8075e49): row {f[0]} slot {f[1]}: c/mean "
            f"{f[2]!r} against length {f[3]!r}")
    for f in mf:
        log(f"  merge flip (new vs 8075e49): row {f[0]} step {f[1]}: new s1 "
            f"{f[2]!r} s2 {f[3]!r}; 8075e49 s1 {f[4]!r} s2 {f[5]!r}")
    if not same or bad:
        raise AssertionError(f"the contour chain differs from 8075e49's "
                             f"({label})")
    times = {}
    if cycles_per_ms is not None:
        lib = _build.library()
        with torch.no_grad():
            _, a_seen = capture(_build, lambda: CK.contour_merge_cuda(
                *margs, grid_ms=grid))
            _, b_seen = capture(_build, lambda: CK.contour_smooth_cuda(
                *sargs))
        for turn in ("old", "new", "new", "old"):
            for nm, seen_ in (("merge", a_seen), ("smoothing", b_seen)):
                run = (replayer(torch, _build, old, seen_, adapt)
                       if turn == "old" else
                       replayer(torch, _build, lib, seen_))
                times.setdefault(f"{nm} {turn}", []).append(
                    device_ms(torch, cycles_per_ms, run, 10))
        log(f"  {label}: 8075e49's design vs this one, device time alone, in "
            f"turns (old, new, new, old): " + "; ".join(
                f"{k} {[round(v, 4) for v in vs]} ms"
                for k, vs in times.items()) + f"  [{card_line()}]")
        del a_seen, b_seen
    return times


def contour_rows(torch, cycles_per_ms, card, margs, mkw, sargs, counts):
    """The kernels line's rows of kernels A and B at the arguments the
    chain gave them: device time alone, call time, plain time, bound."""
    from worldtpu_torch import _build
    from worldtpu_torch.ops import contour_kernel as CK
    lib = _build.library()

    def alone(seen, n):
        return device_ms(torch, cycles_per_ms,
                         replayer(torch, _build, lib, seen), n)

    B, F = margs[0].shape
    S = margs[3].shape[1]
    n_sec = margs[5].clamp(max=S)
    n_on, so = margs[8], margs[9]
    live = torch.arange(S, device=n_sec.device)[None] < n_sec[:, None]
    with torch.no_grad():
        out, a_seen = capture(_build, lambda: CK.contour_merge_cuda(
            *margs, **mkw))
        a_ms = alone(a_seen, 20)
        a_call = median_ms(torch, lambda: CK.contour_merge_cuda(
            *margs, **mkw), 10)
        a_plain = median_ms(torch, lambda: CK.contour_merge_plain(
            *margs, **mkw), 3)
        sm, b_seen = capture(_build, lambda: CK.contour_smooth_cuda(*sargs))
        b_ms = alone(b_seen, 20)
        b_call = median_ms(torch, lambda: CK.contour_smooth_cuda(*sargs), 10)
        b_plain = median_ms(torch, lambda: CK.contour_smooth_plain(*sargs), 3)
        _, s_tr = CK.contour_smooth_cuda(*sargs, trace=True)
    # A reads each row of f0 and the two score shadows once and writes the
    # output; of each live section its run, walk counts and ends, and the
    # accepted prefixes of its two walks (values and scores)
    on = torch.cat([live, live], 1)
    steps = int(n_on[on].sum())
    a_bytes = 16 * B * F + 48 * int(live.sum()) + 8 * steps
    a_bound = bound(a_bytes, 2 * B * F)
    # B reads f0 and each live section's ends and writes the output; its
    # operations: the recursion steps this run's chains ran (the trace), 9
    # double operations a step, counted as float32 operations at the ratio
    # of the peaks.  The chain is latency, not work: the bound is bytes.
    n = F + 2 * CK.LAG
    s_st, s_n = sargs[1], sargs[3]
    s_live = torch.arange(s_st.shape[1], device=s_st.device)[None] \
        < s_n[:, None]
    tail = (n - s_st)[s_live]
    st_ = smooth_trace(s_tr, s_n)
    b_bound = bound(8 * B * F + 16 * int(s_live.sum()),
                    9 * st_["steps"] * PEAK_F32_FLOP_S / PEAK_F64_FLOP_S)
    longest = st_["longest_chain"]
    first = n + 2 * int(tail.max()) if tail.numel() else 0
    log(f"contour_merge: {int(live.sum())} live sections, {steps} accepted "
        f"walk steps read; device time alone {a_ms:.4f} ms, with its "
        f"wrapper {a_call:.4f} ms, plain {a_plain:.3f} ms, bound "
        f"{a_bound[0]:.5f} ms ({a_bound[1]})  [{card}]")
    log(f"contour_smooth: {int(s_live.sum())} live sections of a {n}-frame "
        f"padded contour; chain floor: the longest chain run {longest} "
        f"recursion steps ({st_['steps']} in all; 8075e49's design ran "
        f"{first} for its longest) = {1e6 * b_ms / max(longest, 1):.2f} ns "
        f"a step of the device time alone {b_ms:.4f} ms; with its wrapper "
        f"{b_call:.4f} ms, plain {b_plain:.3f} ms, bound {b_bound[0]:.5f} "
        f"ms ({b_bound[1]})  [{card}]")
    rows = []
    for name, ms, call, plain, bnd, entry, err, rep in (
            ("contour_merge", a_ms, a_call, a_plain, a_bound,
             "wt_contour_merge", 0.0, "worldtpu/analysis/contour_device.py"
             ":356"),
            ("contour_smooth", b_ms, b_call, b_plain, b_bound,
             "wt_contour_smooth",
             float((sm - CK.contour_smooth_plain(*sargs)).abs().max()),
             "worldtpu/analysis/contour_device.py:497")):
        rows.append(dict(
            name=name, source="worldtpu_torch/csrc/contour.cu",
            replaces=rep, launches=counts.get(entry, 0),
            launches_main=counts.get(entry, 0), max_abs_err=err, ms=ms,
            call_ms=call, plain_ms=plain, bound=bnd, library_ms=None))
    rows[0]["max_abs_err"] = float((out - CK.contour_merge_plain(
        *margs, **mkw)).abs().max())
    rows[1]["longest_chain"] = longest
    return rows


# ---- phase 8 ----

# the C entry of each kernel of the kernels line
C_ENTRY = {"zc": "wt_zc", "refine": "wt_refine_sums", "ola": "wt_ola",
           "pulse": "wt_pulse_resp", "noise": "wt_noise_rows",
           "d4c": "wt_d4c",
           "extend": "wt_extend", "zc_events": "wt_zc_events",
           "ola_f64": "wt_ola_f64", "seq_cumsum": "wt_seq_cumsum_f64",
           "contour_merge": "wt_contour_merge",
           "contour_smooth": "wt_contour_smooth"}
MAIN_KERNELS = ("wt_zc", "wt_refine_sums", "wt_ola", "wt_extend",
                "wt_contour_merge", "wt_contour_smooth", "wt_d4c",
                "wt_pulse_resp")
# the kernels of HarvestKernel.forward (the main path's but the analysis'
# and the synthesis')
SYNTHESIS_KERNELS = ("wt_ola", "wt_pulse_resp")
#: the kernels of a LongPipeline chunk step, one launch each
LONG_STEP_KERNELS = SYNTHESIS_KERNELS + ("wt_noise_rows", "wt_d4c")
#: the contour chain's kernels, one launch each a LongHarvest call on the
#: card
CONTOUR_KERNELS = ("wt_extend", "wt_contour_merge", "wt_contour_smooth")
HARVEST_KERNELS = tuple(k for k in MAIN_KERNELS
                        if k not in SYNTHESIS_KERNELS + ("wt_d4c",))
CORPUS_UTTS = 16          # bench.py config 5: 2 x its batch of 8

# float32 codec, card against CPU on the same input: the float32
# tolerances of tests/test_torch_codec.py (port against JAX)
F32_AP_DB_ATOL = 2e-5
F32_DEC_AP_RTOL = 5e-6
F32_CODED_SPEC_REL = 2e-5
F32_DEC_SPEC_RTOL = 1e-3
MCD_GATE_DB = 0.1         # ROADMAP.md's quality target, float64


def excess(got, want, rtol, atol):
    """max(|got - want| - (atol + rtol |want|)): <= 0 exactly where
    numpy.testing.assert_allclose(got, want, rtol, atol) passes."""
    return float((np.abs(got - want) - (atol + rtol * np.abs(want))).max())


def read_codec_dump(path, n_frames, n_bins):
    """A C++ codec dump t*.codec.gz (the layout tests/conftest.py reads):
    n_ap and n_dims as int32, then float64 coded aperiodicity [F, n_ap],
    decoded [F, K], coded envelope [F, n_dims], decoded [F, K]."""
    import gzip
    raw = gzip.open(path).read()
    n_ap, n_dims = (int(v) for v in np.frombuffer(raw[:8], "<i4"))
    out, o = {"n_ap": n_ap, "n_dims": n_dims}, 8
    for key, cols in (("coded_ap", n_ap), ("decoded_ap", n_bins),
                      ("coded_spec", n_dims), ("decoded_spec", n_bins)):
        out[key] = np.frombuffer(raw[o:o + 8 * n_frames * cols],
                                 "<f8").reshape(n_frames, cols).copy()
        o += 8 * n_frames * cols
    return out


def corpus_stream(torch, dev, card):
    """Phase 8(a): bench.py config 5's corpus shape through the port as a
    corpus user runs it: CORPUS_UTTS synthetic utterances written as
    16-bit wavs, io.corpus.iter_corpus (the C++ reader) in batches of
    BATCH padded to 4096 samples and 16 frames, one HarvestGeometry per
    padded length, batch_wav_to_wav (pitch x1.2, duration x1.25, static
    pulse capacity, noise from a seeded generator on the card), batch k's
    output copied to pinned memory without blocking and cut by
    slice_outputs while batch k+1 runs.  Gates its outputs, the kernels'
    launches and the reader; times a first pass, later passes with and
    without the overlap in turns, and HarvestKernel.compute_corpus beside
    compute_batch.  Returns the launches of the first pass (from 0)."""
    from bench import synth_utterance_diverse
    from worldtpu_torch import _build, constants as C, native
    from worldtpu_torch.analysis import harvest as H
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.io import corpus as CO, wav as W_
    from worldtpu_torch.parallel import graphs as PG
    from worldtpu_torch.parallel.batch import batch_wav_to_wav
    from worldtpu_torch.synthesis import synthesis as S

    ck = CheapTrickKernel(FS)
    t0 = time.perf_counter()
    if not native.corpus_reader_built():
        raise AssertionError("the C++ corpus reader did not build")
    log(f"corpus: C++ reader built in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as cdir:
        for i in range(CORPUS_UTTS):
            W_.wavwrite(pathlib.Path(cdir) / f"lj{i:03d}.wav",
                        synth_utterance_diverse(FS, i).astype(np.float64), FS)
        kw_it = dict(batch_size=BATCH, pad_to=4096, frames_to=16)
        listed = CO.load_corpus(cdir, **kw_it)
        audio_s = sum(float(b.lengths[b.valid].sum()) for b in listed) / FS
        want_len = [int((n - 1) * b.frame_period_ms / 1000.0 * FS) + 1
                    for b in listed for n in b.n_frames[b.valid]]
        log(f"corpus: {CORPUS_UTTS} utterances, {audio_s:.2f} s of audio, "
            f"{len(listed)} batches of {BATCH}, padded lengths "
            f"{[b.x.shape[1] for b in listed]}, frames "
            f"{[b.F for b in listed]}")
        gen = torch.Generator(device=dev).manual_seed(8)
        shapes = {}               # (T, F) -> geometry, sizes, noise

        def setup(b):
            key = (b.x.shape[1], b.F)
            if key not in shapes:
                g = H.HarvestGeometry(FS, key[0], f0_floor=40.0)
                ol = int((b.F - 1) * 0.005 * DUR * FS) + 1
                mp = S.capacity_max_pulses(ol, FS,
                                           f0_cap=C.DEFAULT_F0 * PITCH)
                shapes[key] = (g, ol, mp, S.make_noise(
                    gen, b.x.shape[0], mp, ck.fft_size, device=dev))
            return shapes[key]

        def stream(overlap):
            outs, f0s, ovfs, pending = [], [], [], None

            def finish(item):
                b, hy, hf, ho, done = item
                done.synchronize()
                outs.extend(b.slice_outputs(hy))
                f0s.append(hf.numpy().copy())
                ovfs.append(ho)

            for b in CO.iter_corpus(cdir, **kw_it):
                g, ol, mp, noise = setup(b)
                xb = torch.from_numpy(b.x).pin_memory().to(
                    dev, non_blocking=True)
                y, f0b, ovf = batch_wav_to_wav(
                    xb, noise, geo=g, fs=FS, fft_size=ck.fft_size,
                    max_half_window=ck.max_half_window,
                    frame_period_s=0.005 * DUR, out_length=ol,
                    max_pulses=mp, pitch_scale=PITCH, return_overflow=True)
                if not overlap:
                    outs.extend(b.slice_outputs(y))
                    f0s.append(f0b.cpu().numpy())
                    ovfs.append(ovf.cpu())
                    continue
                hy = torch.empty(y.shape, pin_memory=True)
                hy.copy_(y, non_blocking=True)
                hf = torch.empty(f0b.shape, pin_memory=True)
                hf.copy_(f0b, non_blocking=True)
                ho = torch.empty(ovf.shape, dtype=ovf.dtype, pin_memory=True)
                ho.copy_(ovf, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                if pending is not None:
                    finish(pending)
                pending = (b, hy, hf, ho, done)
            if pending is not None:
                finish(pending)
            return outs, f0s, ovfs

        def same_as_first(again, f0_again):
            return (len(again) == len(outs)
                    and all(np.array_equal(a, b) for a, b in zip(again, outs))
                    and all(np.array_equal(a, b)
                            for a, b in zip(f0_again, f0_first)))

        PG.clear()
        _build.launches.clear()
        native.corpus_reads = 0
        t0 = time.perf_counter()
        outs, f0_first, ovfs = stream(True)
        first_ms = (time.perf_counter() - t0) * 1000
        counts = dict(_build.launches)
        reads = native.corpus_reads
        rms = [float(np.sqrt(np.mean(o.astype(np.float64) ** 2)))
               for o in outs]
        log(f"corpus stream, first pass (geometry set-up and eager first "
            f"calls): {first_ms:.1f} ms; launches {counts}; batches read by "
            f"the C++ reader {reads} of {len(listed)}; {len(outs)} outputs, "
            f"lengths {[len(o) for o in outs]}, rms "
            f"{min(rms):.4f}-{max(rms):.4f}; pulse overflow "
            f"{[bool(o.any()) for o in ovfs]}  [{card}]")
        if (len(outs) != CORPUS_UTTS
                or [len(o) for o in outs] != want_len
                or not all(np.isfinite(o).all() for o in outs)
                or min(rms) <= 0.01):
            raise AssertionError("corpus stream outputs")
        if any(bool(o.any()) for o in ovfs):
            raise AssertionError("corpus stream: pulse capacity overflow")
        if reads != len(listed):
            raise AssertionError("the corpus stream did not read with the "
                                 "C++ reader")
        for k in MAIN_KERNELS:
            if counts.get(k, 0) != len(listed):
                raise AssertionError(f"kernel {k} launched {counts.get(k, 0)}"
                                     f" times by the corpus stream, not once "
                                     f"per batch")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, f0_again, _ = stream(True)
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1000
        n_prog = len(PG.programs())
        same = same_as_first(again, f0_again)
        _build.launches.clear()
        again, f0_again, _ = stream(True)
        torch.cuda.synchronize()
        rcounts = dict(_build.launches)
        same = same and same_as_first(again, f0_again)
        log(f"corpus stream, second pass (captures one program per padded "
            f"length): {capture_ms:.1f} ms, {n_prog} programs; a replayed "
            f"pass's launches {rcounts}; F0 and outputs of the replayed "
            f"passes bit-equal to the eager first pass {same}  [{card}]")
        if n_prog != len(listed) or not same or any(
                rcounts.get(k, 0) != len(listed) for k in MAIN_KERNELS):
            raise AssertionError("the corpus stream's replayed programs")
        walls = {"overlapped": [], "not overlapped": []}
        for mode in ("overlapped", "not overlapped") * 3:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again, f0_again, _ = stream(mode == "overlapped")
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) * 1000)
            if not same_as_first(again, f0_again):
                raise AssertionError("corpus stream outputs")
        med = {k: statistics.median(v) for k, v in walls.items()}
        log(f"corpus stream, steady passes (replayed) in turns (overlapped, "
            f"not, ...): "
            + "; ".join(f"{k} {[round(w, 1) for w in v]} ms, median "
                        f"{med[k]:.1f} ms = {audio_s / med[k] * 1000:.1f}x "
                        f"realtime" for k, v in walls.items())
            + f"; first pass {audio_s / first_ms * 1000:.1f}x  [{card}]")

        # HarvestKernel.compute_corpus over the same batches, padded to
        # one length (a HarvestKernel holds one geometry), against
        # compute_batch on each
        T1 = max(b.x.shape[1] for b in listed)
        xs = [np.pad(b.x, ((0, 0), (0, T1 - b.x.shape[1]))) for b in listed]
        hk = H.HarvestKernel(FS, T1, f0_floor=40.0, device=dev)

        def eager_batches():
            # HarvestKernel.forward's program, outside the graph cache
            with torch.no_grad():
                return [PG.eager(H._forward, (torch.tensor(
                    xb, device=dev),), geo=hk.geo, grid=1)[0].cpu().numpy()
                    for xb in xs]

        _build.launches.clear()
        f_e = eager_batches()
        e_counts = dict(_build.launches)
        want = [r for xb in xs for r in hk.compute_batch(xb)]  # captures
        _build.launches.clear()
        got = list(hk.compute_corpus(iter(xs)))
        r_counts = dict(_build.launches)
        same = len(got) == len(want) and all(
            np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            for a, b in zip(got, want))
        same_e = np.array_equal(np.stack([r[0] for r in got]),
                                np.concatenate(f_e).astype(np.float64))
        hw = {"compute_corpus": [], "compute_batch": [], "eager": []}
        for mode in ("eager", "compute_corpus", "compute_batch") * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "compute_corpus":
                list(hk.compute_corpus(iter(xs)))
            elif mode == "compute_batch":
                [hk.compute_batch(xb) for xb in xs]
            else:
                eager_batches()
            hw[mode].append(round((time.perf_counter() - t0) * 1000, 1))
        log(f"HarvestKernel on the corpus's {len(xs)} batches padded to "
            f"T={T1}, replayed: compute_corpus F0 equal to compute_batch's "
            f"bit for bit {same}, to the eager program's {same_e}; "
            f"launches of the eager program {e_counts}, of the replayed "
            f"compute_corpus {r_counts}; walls in turns {hw} ms  [{card}]")
        if not same or not same_e or e_counts != r_counts:
            raise AssertionError("compute_corpus disagrees with "
                                 "compute_batch or the eager program")
    return counts


def codec_on_card(torch, dev, card, cycles_per_ms, x, f0, geo, ck):
    """Phase 8(b): the codec in float64 on the C++ dumps of F64_FIXTURES
    at tests/test_codec.py's tolerances, and in float32 on the main path's
    B=8 spectrogram and aperiodicity (flattened to [B*F, K]) against the
    port's float32 codec on the CPU, with each function's device time."""
    from worldtpu_torch import codec as CODEC
    from worldtpu_torch.analysis.cheaptrick import cheaptrick_frames
    from worldtpu_torch.analysis.d4c import d4c_frames
    from worldtpu_torch.io import params as P_
    fixd = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures"
    f64 = torch.float64
    for nm in F64_FIXTURES:
        f0_ref, _, _ = P_.read_f0(str(fixd / f"{nm}.f0.gz"))
        spec_ref, meta = P_.read_spectral_envelope(str(fixd / f"{nm}.spec.gz"))
        ap_ref, _ = P_.read_aperiodicity(str(fixd / f"{nm}.ap.gz"))
        fsf, fft_f = int(meta["fs"]), meta["fft_size"]
        d = read_codec_dump(fixd / f"{nm}.codec.gz", len(f0_ref),
                            fft_f // 2 + 1)
        kw = dict(fs=fsf, fft_size=fft_f)
        g = lambda a: torch.as_tensor(a, dtype=f64, device=dev)  # noqa: E731
        outs = [CODEC.code_aperiodicity(g(ap_ref), **kw),
                CODEC.decode_aperiodicity(g(d["coded_ap"]), **kw),
                CODEC.code_spectral_envelope(g(spec_ref), n_dims=d["n_dims"],
                                             **kw),
                CODEC.decode_spectral_envelope(g(d["coded_spec"]),
                                               n_dims=d["n_dims"], **kw)]
        if any(o.device != dev or o.dtype != f64 for o in outs):
            raise AssertionError("the codec left the card or float64")
        ca, da, cs, ds = (o.cpu().numpy() for o in outs)
        rel_ds = float((np.abs(ds - d["decoded_spec"])
                        / (np.abs(d["decoded_spec"]) + 1e-20)).max())
        figs = {"coded ap": (excess(ca, d["coded_ap"], 1e-10, 1e-10),
                             np.abs(ca - d["coded_ap"]).max()),
                "decoded ap": (excess(da, d["decoded_ap"], 1e-10, 1e-12),
                               np.abs(da - d["decoded_ap"]).max()),
                "coded spec": (excess(cs, d["coded_spec"], 1e-9, 1e-10),
                               np.abs(cs - d["coded_spec"]).max())}
        n_ap = CODEC.get_number_of_aperiodicities(fsf)
        log(f"codec float64 on the card, {nm} ({len(f0_ref)} frames, n_ap "
            f"{n_ap} (dump {d['n_ap']}), n_dims {d['n_dims']}) vs the C++ "
            f"dump: " + ", ".join(f"{k} max abs {v[1]:.2e}" for k, v in
                                  figs.items())
            + f", decoded spec max rel {rel_ds:.2e} (tests/test_codec.py's "
            f"tolerances: ap 1e-10, spec 1e-9 / 1e-10, decoded spec 1e-8)")
        if (n_ap != d["n_ap"] or any(v[0] > 0 for v in figs.values())
                or not rel_ds < 1e-8):
            raise AssertionError(f"float64 codec on the card disagrees with "
                                 f"the C++ dump of {nm}")

    # float32 on the main path's analysis, card against CPU
    n_dims = 32                   # the fixtures' (the reference's default)
    kw = dict(fs=FS, fft_size=ck.fft_size)
    with torch.no_grad():
        tpos = torch.arange(geo.n_grid(), dtype=torch.float32, device=dev) \
            * (geo.frame_period / 1000.0)
        spec = cheaptrick_frames(x, f0, tpos, fs=FS, fft_size=ck.fft_size,
                                 max_half_window=ck.max_half_window)
        ap = d4c_frames(x, f0, tpos, fs=FS, fft_size_out=ck.fft_size)
    spec = spec.reshape(-1, spec.shape[-1]).contiguous()
    ap = ap.reshape(-1, ap.shape[-1]).contiguous()
    fns = {
        "code_aperiodicity": (CODEC.code_aperiodicity, ap, {}),
        "decode_aperiodicity": (CODEC.decode_aperiodicity,
                                CODEC.code_aperiodicity(ap, **kw), {}),
        "code_spectral_envelope": (CODEC.code_spectral_envelope, spec,
                                   {"n_dims": n_dims}),
        "decode_spectral_envelope": (
            CODEC.decode_spectral_envelope,
            CODEC.code_spectral_envelope(spec, n_dims=n_dims, **kw),
            {"n_dims": n_dims})}
    res, ms = {}, {}
    for nm, (fn, arg, extra) in fns.items():
        got = fn(arg, **kw, **extra)
        want = fn(arg.cpu(), **kw, **extra)
        if got.device != dev:
            raise AssertionError(f"{nm} left the card")
        res[nm] = (got.cpu().numpy(), want.numpy())
        _, n_sync = count_syncs(torch, lambda: fn(arg, **kw, **extra))
        if n_sync:
            raise AssertionError(f"{nm} synchronizes the host {n_sync} "
                                 f"times on the card")
        # few runs a window: each call launches tens of small kernels, and
        # the queue behind device_ms's sleep kernel holds only so many
        ms[nm] = device_ms(torch, cycles_per_ms,
                           lambda: fn(arg, **kw, **extra), 3)
    (ca, cac), (da, dac), (cs, csc), (ds, dsc) = res.values()
    flips = int(((da == 1.0).all(1) != (dac == 1.0).all(1)).sum())
    errs = {"code_aperiodicity": excess(ca, cac, 0, F32_AP_DB_ATOL),
            "decode_aperiodicity": excess(da, dac, F32_DEC_AP_RTOL, 0),
            "code_spectral_envelope": float(np.abs(cs - csc).max())
            - F32_CODED_SPEC_REL * float(np.abs(csc).max()),
            "decode_spectral_envelope": excess(ds, dsc, F32_DEC_SPEC_RTOL, 0)}

    def round_trip():
        return (CODEC.decode_aperiodicity(
            CODEC.code_aperiodicity(ap, **kw), **kw),
            CODEC.decode_spectral_envelope(CODEC.code_spectral_envelope(
                spec, n_dims=n_dims, **kw), n_dims=n_dims, **kw))
    rt_ms = wall_ms(torch, round_trip, 5)
    rt_ap, rt_sp = (t.cpu().numpy() for t in round_trip())
    cpu_ap = CODEC.decode_aperiodicity(CODEC.code_aperiodicity(
        ap.cpu(), **kw), **kw).numpy()
    cpu_sp = CODEC.decode_spectral_envelope(CODEC.code_spectral_envelope(
        spec.cpu(), n_dims=n_dims, **kw), n_dims=n_dims, **kw).numpy()
    log(f"codec float32 on the card, the main path's spectrogram and "
        f"aperiodicity {tuple(spec.shape)} (n_dims {n_dims}), each function "
        f"on the same input as the port's float32 codec on the CPU: "
        + ", ".join(f"{k} {ms[k]:.4f} ms device (over its tolerance by "
                    f"{errs[k]:.2e}: <= 0 passes)" for k in fns)
        + f"; unvoiced-rule flips {flips}; round trip {rt_ms:.2f} ms wall, "
        f"against the CPU's round trip: ap max rel "
        f"{float((np.abs(rt_ap - cpu_ap) / cpu_ap).max()):.2e}, spec max rel "
        f"{float((np.abs(rt_sp - cpu_sp) / cpu_sp).max()):.2e}  [{card}]")
    if flips or any(v > 0 for v in errs.values()):
        raise AssertionError("the float32 codec on the card disagrees with "
                             "the CPU")


def mcd_on_card(torch, dev, card):
    """Phase 8(c): mel-cepstral distortion (bench.quality_metrics) against
    the C++ spectrogram dumps: the card's float64 CheapTrick on its own
    float64 F0 and the card's float64 codec round trip (against the
    dump's decoded spectrogram), gated < MCD_GATE_DB; float32 F0 and
    CheapTrick on the card, reported."""
    from bench import quality_metrics
    from worldtpu_torch import api, codec as CODEC
    from worldtpu_torch.io import params as P_, wav as W_
    fixd = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures"
    f64 = torch.float64
    for nm in F64_FIXTURES:
        xf, fsf, _ = W_.wavread(str(fixd / f"{nm}.wav"))
        f0_ref, _, _ = P_.read_f0(str(fixd / f"{nm}.f0.gz"))
        spec_ref, meta = P_.read_spectral_envelope(str(fixd / f"{nm}.spec.gz"))
        d = read_codec_dump(fixd / f"{nm}.codec.gz", len(f0_ref),
                            meta["fft_size"] // 2 + 1)
        har = api.Harvest(fsf, api.HarvestOption(f0_floor=40.0), device=dev)
        ct = api.CheapTrick(fsf, device=dev)
        q = {}
        for dt, key in ((f64, "float64"), (torch.float32, "float32")):
            tp, f0_ = har.compute(xf, dtype=dt)
            sp = ct.compute(xf, tp, f0_, dtype=dt).cpu().numpy()
            q[key] = quality_metrics(f0_, f0_ref, sp, spec_ref)
        n = d["n_dims"]
        kw = dict(fs=fsf, fft_size=meta["fft_size"], n_dims=n)
        dec = CODEC.decode_spectral_envelope(CODEC.code_spectral_envelope(
            torch.as_tensor(spec_ref, dtype=f64, device=dev), **kw), **kw)
        dec = dec.cpu().numpy()
        q["codec"] = quality_metrics(f0_ref, f0_ref, dec, d["decoded_spec"])
        q["codec loss"] = quality_metrics(f0_ref, f0_ref, dec, spec_ref)
        log(f"MCD on the card against the C++ dumps, {nm}: float64 "
            f"Harvest + CheapTrick {q['float64']}, float64 codec round trip "
            f"against the dump's decoded spectrogram {q['codec']['mcd_db']} "
            f"dB (gates {MCD_GATE_DB} dB); reported: float32 Harvest + "
            f"CheapTrick {q['float32']}, the codec's own loss (round trip "
            f"against the spectrogram) {q['codec loss']['mcd_db']} dB  "
            f"[{card}]")
        if not (q["float64"]["mcd_db"] < MCD_GATE_DB
                and q["codec"]["mcd_db"] < MCD_GATE_DB):
            raise AssertionError(f"float64 MCD on {nm} is not under "
                                 f"{MCD_GATE_DB} dB")


# ---- phase 9 ----

LONG_S = 600              # one 10-minute recording
PARITY_S = 60             # its first minute, against the unchunked path
BOUND_S = 150             # its first 150 s: fills a 16-chunk Harvest batch
LONG_FLOOR = 40.0
LONG_CHUNK_FRAMES = 1000
HARVEST_CHUNK_MS, HARVEST_HALO_MS = 8000, 1000
LONG_SEED = 7
# chunked against unchunked, 100 ms windows: q99 of the relative error;
# and every windowed comparison's q90 (a noise desync past the midpoint)
PARITY_Q99, WINDOW_Q90 = 1e-3, 0.1
# tests/test_longform.py's chunked-against-unchunked F0 gates (Hz), on
# that test's own 60 s signal; on the recording's first minute, where the
# chunk windows' float32 rounding moves Harvest's knife-edge contour
# decisions (PERF.md, section 6), voicing agreement and the median F0
# difference
LONG_F0_RMSE, LONG_F0_MAX = 0.1, 5.0
REC_VOICING, REC_F0_MEDIAN = 0.99, 0.01
TEST_SIGNAL_S = 60.0
MEM_MARGIN = 0.05
# reserved memory of a replayed loop: its programs' pool holds one step's
# intermediates laid out by a pool that starts empty, so with more
# fragmentation than the eager loop's warm cache (1.1-2.5 eager working
# sets measured on the H100): at most RESERVE_POOL of them, and the
# allocator's rounding (2 MiB a large segment) within RESERVE_SLACK
RESERVE_POOL, RESERVE_SLACK = 3, 256 << 20


def n_steps(p, parallel):
    """Chunk steps a synthesis loop over plan p runs."""
    from worldtpu_torch.longaudio import PARALLEL_GROUP
    return -(-p.n_chunks // PARALLEL_GROUP) if parallel else p.n_chunks


def capture_counts(eager, steps):
    """The launches of a loop that captures its step, from an eager loop's
    over ``steps`` equal steps: one eager step more (the run a capture
    makes before it records; the replays count what it recorded)."""
    return {k: v + v // steps for k, v in eager.items()}


def reserve_limit(eager, work):
    """The bound of a replayed loop's peak reserved memory: the eager
    loops' peak plus RESERVE_POOL eager step working sets (its programs'
    pool) and RESERVE_SLACK."""
    return max(eager) + RESERVE_POOL * work + RESERVE_SLACK


def reserve_ok(replayed, limit):
    """Each replayed loop's peak within limit, and the second within the
    first's + RESERVE_SLACK (programs do not accumulate)."""
    return (max(replayed) <= limit
            and replayed[1] <= replayed[0] + RESERVE_SLACK)


def long_recording(seconds):
    """bench.synth_utterance_diverse(FS, i) for i = 0, 1, ... joined until
    ``seconds`` of audio, cut there: (float32 samples, the end sample of
    each utterance)."""
    from bench import synth_utterance_diverse
    parts, n = [], 0
    while n < seconds * FS:
        parts.append(synth_utterance_diverse(FS, len(parts)))
        n += len(parts[-1])
    return (np.concatenate(parts)[:int(seconds * FS)].astype(np.float32),
            np.cumsum([len(w) for w in parts]))


def long_utterance(fs, dur, seed=0):
    """tests/test_longform.py's 60 s test signal (harmonics of a slow F0
    sweep, a noise gap, a silent tail)."""
    n = int(fs * dur)
    t = np.arange(n) / fs
    f0 = 170 * 2 ** ((40 / 1200) * np.sin(2 * np.pi * 0.35 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    rng = np.random.RandomState(seed)
    x = np.zeros(n)
    for k in range(1, 12):
        x += np.sin(k * phase) / k
    x /= np.abs(x).max() * 1.4
    g0, g1 = int(0.42 * n), int(0.47 * n)
    x[g0:g1] = 0.003 * rng.randn(g1 - g0)
    x += 0.002 * rng.randn(n)
    x[-int(0.4 * fs):] = 0.0
    return x.astype(np.float32)


def windowed_rel(yc, yu):
    """Relative error of yc against yu in 100 ms windows, the floor a
    thousandth of the median window RMS (tests/test_longaudio.py)."""
    yc, yu = yc.astype(np.float64), yu.astype(np.float64)
    w = int(0.1 * FS)
    n = (len(yu) // w) * w
    dw = np.sqrt(((yc[:n] - yu[:n]).reshape(-1, w) ** 2).mean(axis=1))
    uw = np.sqrt((yu[:n].reshape(-1, w) ** 2).mean(axis=1))
    return dw / np.maximum(uw, np.median(uw) * 1e-3)


def long_audio(torch, dev, card, cycles_per_ms):
    """Phase 9: long audio on the card.  (a) the first PARITY_S s of the
    recording: LongHarvest against the unchunked HarvestKernel.compute
    (both the device contour chain), and LongPipeline.copy_synthesis against the unchunked CheapTrick, D4C
    and synthesis on its F0 with the same indexed_noise rows (pulses
    identical, windowed error); (b) the whole LONG_S s recording through
    LongPipeline.copy_synthesis (pitch x1.2, duration x1.25), sequential
    and parallel in turns, with its walls, the split of LongHarvest's, the
    host syncs per chunk, the kernels' launches, the device contour chain
    against the host chain on the recording's stitched candidates and the
    bounded device memory against the first BOUND_S s; (c) the OLA, zc and refine kernels
    against their plain versions at this path's shapes.  Returns the
    launches of the LONG_S s recording's eager calls (LongHarvest's zc,
    refine and contour kernels in its first sequential run, OLA in the eager sequential
    synthesis loop; from 0), and for phase
    10 the parity cut x60, its float32 LongHarvest F0 and the first
    BOUND_S s x150."""
    from worldtpu_torch import _build
    from worldtpu_torch import longaudio as LA
    from worldtpu_torch.analysis import harvest as H
    from worldtpu_torch.analysis.cheaptrick import cheaptrick_frames
    from worldtpu_torch.analysis.d4c import d4c_frames
    from worldtpu_torch.ops import ola_kernel, refine_kernel, zc_kernel
    from worldtpu_torch.parallel import graphs as PG
    from worldtpu_torch.synthesis import noise as N
    from worldtpu_torch.synthesis import synthesis as S

    t_phase = time.perf_counter()
    rec, ends = long_recording(LONG_S)
    n_utts = len(ends)
    lp = LA.LongPipeline(FS, f0_floor=LONG_FLOOR,
                         chunk_frames=LONG_CHUNK_FRAMES,
                         harvest_chunk_ms=HARVEST_CHUNK_MS,
                         harvest_halo_ms=HARVEST_HALO_MS, device=dev)
    lh = lp.harvest
    syn = dict(seed=LONG_SEED, pitch_scale=PITCH, duration_scale=DUR)
    log(f"long audio: {n_utts} utterances joined, {len(rec)} samples = "
        f"{len(rec) / FS:.1f} s ({rec.nbytes / 1e6:.1f} MB float32); "
        f"LongHarvest windows of {lh.Tc} samples every {lh.stride}, "
        f"{lh.n_chunks(len(rec))} chunks; synthesis chunks of "
        f"{LONG_CHUNK_FRAMES} frames")

    def peak_reset():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def gib(b):
        return b / 2 ** 30

    # ---- (a) parity at PARITY_S s ----
    # the whole utterances of the first PARITY_S s: a cut inside an
    # utterance would hand the chunked path's zero padding and the
    # unchunked path's own edge handling different last frames (the
    # boundary difference tests/test_longform.py keeps out with a silent
    # tail); and a length that is a multiple of the decimation ratio, as
    # the chunk windows are: the reference's decimation picks its samples
    # counting from the signal's end
    end = int(ends[ends <= PARITY_S * FS][-1])
    x60 = rec[:end - end % lh.geo.ratio]

    def f0_diff(a, b):
        both = (a > 0) & (b > 0)
        d = np.abs(a - b)[both]
        return dict(flips=int(((a > 0) != (b > 0)).sum()),
                    agree=float(((a > 0) == (b > 0)).mean()),
                    voiced=float(both.mean()),
                    rmse=float(np.sqrt(np.mean(d ** 2))),
                    median=float(np.median(d)), max=float(d.max()))

    def fmt(r):
        return (f"voiced {r['voiced']:.3f}, voicing flips {r['flips']} "
                f"(agreement {r['agree']:.5f}), F0 RMSE {r['rmse']:.2e} "
                f"Hz, median {r['median']:.2e} Hz, max {r['max']:.2e} Hz")

    def unchunked(x):
        """The unchunked stages with the host contour (what worldtpu's
        HarvestKernel.compute runs past 8,192 frames and what
        tests/test_longform.py holds LongHarvest to on the CPU)."""
        geo = H.HarvestGeometry(FS, len(x), f0_floor=LONG_FLOOR)
        with torch.no_grad():
            cu, su = (t[0].cpu().numpy().astype(np.float64)
                      for t in H.harvest_device_stages(
                          torch.tensor(x, device=dev)[None], geo=geo))
        return H.host_contour(cu, su, geo)

    def unchunked_card(x):
        """HarvestKernel.compute on the card: the unchunked stages with the
        device contour chain, the chain LongHarvest takes on the card."""
        return H.HarvestKernel(FS, len(x), f0_floor=LONG_FLOOR,
                               device=dev).compute(x)[0]

    # tests/test_longform.py's own signal, 60 s, at this rate and floor
    xs = long_utterance(FS, TEST_SIGNAL_S)
    f0s_ = lh.compute(xs)[0]
    rs = f0_diff(f0s_, unchunked_card(xs))
    rs_h = f0_diff(f0s_, unchunked(xs))
    log(f"(a) LongHarvest on tests/test_longform.py's {TEST_SIGNAL_S:g} s "
        f"signal vs the unchunked HarvestKernel.compute (the same device "
        f"contour chain): {fmt(rs)}; gates: flips 0, RMSE < {LONG_F0_RMSE} "
        f"Hz, max < {LONG_F0_MAX} Hz; vs the unchunked stages with the "
        f"host contour: {fmt(rs_h)}  [{card}]")
    if rs["flips"] or rs["rmse"] >= LONG_F0_RMSE or rs["max"] >= LONG_F0_MAX:
        raise AssertionError("LongHarvest disagrees with the unchunked "
                             "Harvest on tests/test_longform.py's signal")
    del xs

    lh.compute(x60)                              # warm-up
    peak_reset()
    t0 = time.perf_counter()
    f0c, tpc = lh.compute(x60)
    lh_s = time.perf_counter() - t0
    peak_lh = torch.cuda.max_memory_allocated()
    hk = H.HarvestKernel(FS, len(x60), f0_floor=LONG_FLOOR, device=dev)
    hk.compute(x60)
    peak_reset()
    t0 = time.perf_counter()
    f0d, tpu = hk.compute(x60)
    hk_s = time.perf_counter() - t0
    peak_hk = torch.cuda.max_memory_allocated()
    del hk
    f0u = unchunked(x60)
    rr = f0_diff(f0c, f0u)
    rd = f0_diff(f0c, f0d)
    rc = f0_diff(f0u, f0d)
    log(f"(a) LongHarvest on the first {len(x60) / FS:.2f} s "
        f"({np.sum(ends <= PARITY_S * FS)} whole utterances), {len(f0c)} "
        f"frames, against HarvestKernel.compute on the card (the same "
        f"float32 device contour chain): {fmt(rd)}; gates: agreement >= "
        f"{REC_VOICING}, median < {REC_F0_MEDIAN} Hz; against the "
        f"unchunked stages with the host contour: {fmt(rr)}; the two "
        f"contours on the same unchunked candidates: {fmt(rc)}; walls "
        f"{lh_s:.2f} s "
        f"chunked, {hk_s:.2f} s HarvestKernel.compute; peak device memory "
        f"{gib(peak_lh):.2f} GiB chunked, {gib(peak_hk):.2f} GiB "
        f"HarvestKernel.compute  [{card}]")
    if (f0c.shape != f0d.shape or not np.array_equal(tpc, tpu)
            or rd["agree"] < REC_VOICING or rd["median"] >= REC_F0_MEDIAN
            or rd["voiced"] < 0.3):
        raise AssertionError("LongHarvest disagrees with the unchunked "
                             "Harvest")

    lp.copy_synthesis(x60, **syn)                # warm-up
    t0 = time.perf_counter()
    yc, f0s = lp.copy_synthesis(x60, **syn)
    lp_s = time.perf_counter() - t0
    p = lp.plan(x60, f0s, DUR)
    fft = lp.fft_size
    with torch.no_grad():
        xt = torch.tensor(x60, device=dev)[None]
        f0t = torch.tensor(f0s.astype(np.float32), device=dev)[None]
        F = f0t.shape[1]
        # the main path's frame times (parallel.batch)
        tpos = torch.arange(F, dtype=torch.float32, device=dev) * 0.005
        spec = cheaptrick_frames(xt, f0t, tpos, fs=FS, fft_size=fft,
                                 max_half_window=lp.max_half_window)
        ap = d4c_frames(xt, f0t, tpos, fs=FS, fft_size_out=fft)
        mp = S.estimate_max_pulses(f0s.astype(np.float32), FS, fft,
                                   p.out_length)
        noise = N.indexed_noise(LONG_SEED, 0, mp, fft, device=dev)[None]
        yu, ovf = S.synthesis_frames_impl(
            f0t, spec, ap, noise, fs=FS, fft_size=fft, frame_period_s=p.fp_s,
            out_length=p.out_length, max_pulses=mp, return_overflow=True)
        yu = yu[0].cpu().numpy()
        idx, _, n_p, _, _, _ = S._time_base(f0t, FS, p.fp_s, p.out_length,
                                            FS / fft + 1.0, mp)
        carries, _, _ = LA._phase_prescan(p, dev, PG.eager)
        pos = []
        for k in range(p.n_chunks):
            pul = LA._pulse_table(p, torch.tensor([k], device=dev),
                                  carries[k:k + 1])
            pos.append((k * p.L + pul["idx"][0])[pul["own"][0]])
        pos = torch.cat(pos)
        n_p = int(n_p[0])
        same_pulses = len(pos) == n_p and torch.equal(pos, idx[0, :n_p])
        # the frame-blocked analysis against the unchunked one, frame by
        # frame
        n_diff = n_cmp = 0
        s_err = a_err = 0.0
        for k0 in range(0, p.n_chunks, LA.PARALLEL_GROUP):
            k1 = min(k0 + LA.PARALLEL_GROUP, p.n_chunks)
            sb, ab = LA._analysis(p, torch.arange(k0, k1, device=dev))
            for g, k in enumerate(range(k0, k1)):
                fr = torch.arange(p.flo[k], min(p.flo[k] + p.Fb, F),
                                  device=dev)
                ds = ((sb[g, fr - p.flo[k]] - spec[0, fr]).abs()
                      / spec[0, fr]).amax(1)
                da = (ab[g, fr - p.flo[k]] - ap[0, fr]).abs().amax(1)
                n_diff += int(((ds > 0) | (da > 0)).sum())
                n_cmp += len(fr)
                s_err = max(s_err, float(ds.max()))
                a_err = max(a_err, float(da.max()))
            del sb, ab
    rel = windowed_rel(yc, yu)
    q99, q90 = float(np.quantile(rel, 0.99)), float(np.quantile(rel, 0.9))
    log(f"(a) LongPipeline {len(x60) / FS:.2f} s ({p.n_chunks} chunks of {p.L} "
        f"samples, Pmax {p.Pmax}) vs unchunked CheapTrick + D4C + synthesis "
        f"on its F0 with the same noise rows: {n_p} pulses, positions "
        f"identical {same_pulses}; windowed relative error median "
        f"{float(np.median(rel)):.2e}, q90 {q90:.2e} (gate {WINDOW_Q90}), "
        f"q99 {q99:.2e} (gate {PARITY_Q99}), max {float(rel.max()):.2e}; "
        f"block analysis frames not bit-equal to the unchunked analysis "
        f"{n_diff} of {n_cmp} (spectrogram max rel {s_err:.2e}, "
        f"aperiodicity max abs {a_err:.2e}); wall {lp_s:.2f} s  [{card}]")
    if (not same_pulses or bool(ovf.any()) or len(yc) != p.out_length
            or q99 >= PARITY_Q99 or q90 >= WINDOW_Q90):
        raise AssertionError("LongPipeline disagrees with the unchunked "
                             "path")
    del xt, spec, ap, noise, idx

    # the OLA launches of one parallel group, for (c)
    seen = []
    real_ola = LA.overlap_add

    def spy(resp, starts, out_length, n_pulses):
        if not seen:
            seen.append((resp, starts, out_length, n_pulses))
        return real_ola(resp, starts, out_length, n_pulses)

    LA.overlap_add = spy
    try:
        lp.copy_synthesis(x60, parallel=True, **syn)
    finally:
        LA.overlap_add = real_ola

    # ---- (b) the whole recording ----
    # the synthesis loops replay captured chunk programs (and the prescan's
    # step) from a loop's second step on: each loop captures its own and
    # drops them at its end
    def run(x, parallel):
        peak_reset()
        t0 = time.perf_counter()
        y, f0 = lp.copy_synthesis(x, parallel=parallel, **syn)
        return y, f0, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()

    x150 = rec[:BOUND_S * FS]
    peak150 = {}
    for par in (False, True):
        _, _, w, peak150[par], rsv = run(x150, par)
        log(f"(b) {BOUND_S} s, {'parallel' if par else 'sequential'}: wall "
            f"{w:.2f} s, peak device memory {gib(peak150[par]):.3f} GiB, "
            f"reserved after the call {gib(rsv):.3f} GiB")
    walls = {False: [], True: []}
    peaks, outs, counts, reserved = {}, {}, {False: [], True: []}, {}
    for par in (False, True, True, False):
        _build.launches.clear()
        y, f0, w, pk, reserved[par] = run(rec, par)
        counts[par].append(dict(_build.launches))
        walls[par].append(w)
        peaks[par] = max(peaks.get(par, 0), pk)
        outs.setdefault(par, (y, f0))
    (ys, f0s6), (yp, f0p6) = outs[False], outs[True]
    rms = float(np.sqrt(np.mean(ys.astype(np.float64) ** 2)))
    rel = windowed_rel(yp, ys)
    q99b, q90b = float(np.quantile(rel, 0.99)), float(np.quantile(rel, 0.9))
    p6 = lp.plan(rec, f0s6, DUR)
    n_h = lh.n_chunks(len(rec))
    n_hb = -(-n_h // 16)
    for par, name in ((False, "sequential"), (True, "parallel")):
        med = statistics.median(walls[par])
        log(f"(b) {LONG_S} s, {name} (replayed): walls "
            f"{[round(v, 2) for v in walls[par]]} s (each captures its "
            f"loop's programs), median {med:.2f} s = {LONG_S / med:.1f}x "
            f"realtime; peak device memory {gib(peaks[par]):.3f} GiB, "
            f"reserved after the call {gib(reserved[par]):.3f} GiB; "
            f"launches (bookkeeping in the replays), first run "
            f"{counts[par][0]}, second {counts[par][1]}  [{card}]")
    log(f"(b) {LONG_S} s: output {len(ys)} samples ({len(ys) / FS:.1f} s), "
        f"rms {rms:.4f}, voiced {float((f0s6 > 0).mean()):.3f}; "
        f"{n_h} Harvest chunks in {n_hb} batches, {p6.n_chunks} synthesis "
        f"chunks of {p6.L} samples (Pmax {p6.Pmax}); F0 of the two modes "
        f"identical {np.array_equal(f0s6, f0p6)}; parallel vs sequential "
        f"windowed relative error q90 {q90b:.2e}, q99 {q99b:.2e}, max "
        f"{float(rel.max()):.2e}")
    if (not np.isfinite(ys).all() or not np.isfinite(yp).all() or rms < 0.01
            or not np.array_equal(f0s6, f0p6) or len(ys) != p6.out_length
            or q99b >= PARITY_Q99 or q90b >= WINDOW_Q90):
        raise AssertionError(f"{LONG_S} s long audio")
    # a run's launches: LongHarvest's zc and refine once a batch, its
    # contour chain's kernels once, OLA once a chunk (sequential) or a
    # group (parallel), and once more for the step program the run
    # captures (the eager call a capture makes before it records,
    # parallel/graphs.py)
    harvest_want = dict({"wt_zc": n_hb, "wt_refine_sums": n_hb},
                        **{k: 1 for k in CONTOUR_KERNELS})
    want = {False: dict(harvest_want, wt_ola=p6.n_chunks + 1,
                        wt_pulse_resp=p6.n_chunks + 1),
            True: dict(harvest_want,
                       wt_ola=-(-p6.n_chunks // LA.PARALLEL_GROUP) + 1,
                       wt_pulse_resp=-(-p6.n_chunks
                                       // LA.PARALLEL_GROUP) + 1)}
    for par in (False, True):
        for c in counts[par]:
            for k, v in want[par].items():
                if c.get(k, 0) != v:
                    raise AssertionError(f"{k}: {c.get(k, 0)} launches in "
                                         f"the {LONG_S} s run, not {v}")

    # the synthesis loops alone on the recording's plan: eager and
    # replayed in turns, outputs bit-equal, launches equal; each replayed
    # loop captures into a cache of its own (as copy_synthesis does), so
    # its reserved memory holds its programs: gated against the eager
    # loop's plus RESERVE_POOL eager step working sets and RESERVE_SLACK,
    # and the second replayed loop's against the first's (no program
    # outlives its loop)
    key = N.as_key(LONG_SEED)
    loop_walls, loop_same, loop_counts = {}, {}, {}
    for par, name in ((False, "sequential"), (True, "parallel")):
        loop = lp._parallel if par else lp._sequential
        w, ys_ = {"eager": [], "replayed": []}, {}
        rsv, held = {"eager": [], "replayed": []}, []
        for mode in ("eager", "replayed", "replayed", "eager"):
            _build.launches.clear()
            progs = PG.Programs(shared_pool=True)
            peak_reset()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with torch.no_grad():
                yl, _ = loop(p6, key, call=PG.eager if mode == "eager"
                             else progs.call)
            w[mode].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            rsv[mode].append(torch.cuda.max_memory_reserved())
            if mode == "eager":
                work = torch.cuda.max_memory_allocated() - base
            else:
                held = [(k[0].__name__, b)
                        for k, b in zip(progs.keys(), progs.held())]
            progs.clear()
            loop_counts[(par, mode)] = dict(_build.launches)
            ys_.setdefault(mode, yl)
        loop_walls[par] = w
        r_limit = reserve_limit(rsv["eager"], work)
        log(f"(b) {LONG_S} s synthesis loop, {name}: peak reserved device "
            f"memory eager {[round(gib(b), 3) for b in rsv['eager']]} GiB, "
            f"replayed {[round(gib(b), 3) for b in rsv['replayed']]} GiB "
            f"with its programs alive ("
            + ", ".join(f"{nm} {gib(b):.3f} GiB" for nm, b in held)
            + f" the pool each capture reserved, one shared pool); limit: "
            f"eager + {RESERVE_POOL} x one eager step's working set "
            f"{gib(work):.3f} GiB + {RESERVE_SLACK >> 20} MiB = "
            f"{gib(r_limit):.3f} GiB, the second replayed loop within the "
            f"first's + {RESERVE_SLACK >> 20} MiB  [{card}]")
        if not reserve_ok(rsv["replayed"], r_limit):
            raise AssertionError(f"the replayed {name} loop's programs "
                                 f"hold more than their bound")
        loop_same[par] = (np.array_equal(ys_["eager"], ys_["replayed"])
                          and np.array_equal(ys_["eager"][:p6.out_length]
                                             .astype(np.float32),
                                             outs[par][0]))
        log(f"(b) {LONG_S} s synthesis loop, {name}, eager and replayed in "
            f"turns: eager {[round(v, 3) for v in w['eager']]} s, replayed "
            f"{[round(v, 3) for v in w['replayed']]} s (medians "
            f"{statistics.median(w['eager']):.3f} / "
            f"{statistics.median(w['replayed']):.3f} s, "
            f"{1e3 * statistics.median(w['replayed']) / p6.n_chunks:.2f} ms "
            f"a chunk replayed); y bit-equal to the eager loop's and to the "
            f"replayed copy_synthesis {loop_same[par]}; launches eager "
            f"{loop_counts[(par, 'eager')]}, replayed "
            f"{loop_counts[(par, 'replayed')]} (gate: eager + one eager "
            f"step's, the capture's)  [{card}]")
        if (not loop_same[par] or loop_counts[(par, "replayed")]
                != capture_counts(loop_counts[(par, "eager")],
                                  n_steps(p6, par))):
            raise AssertionError(f"the replayed {name} synthesis loop")

    # one replayed chunk step under the profiler, and its parts alone
    # (CUDA events): where a replay's device time goes
    key_t = N.key_tensor(key, dev)
    ks = torch.arange(p6.n_chunks, device=dev)
    progs = PG.Programs(shared_pool=True)
    with torch.no_grad():
        c_, o_, _ = LA._phase_prescan(p6, dev)
        k_ = slice(p6.n_chunks // 2, p6.n_chunks // 2 + 1)

        def step():
            return progs.call(LA._step_program, (ks[k_], c_[k_], o_[k_],
                                                 key_t),
                              dtypes=LA._DTYPES, plan=p6)

        for _ in range(3):              # replayed by the third call
            step()
        s_wall, s_acts, _ = stage_profile(torch, step)
        progs.clear()
        part_ms = {
            "the noise rows (indexed_noise)": median_ms(
                torch, lambda: N.indexed_noise(key_t, o_[k_], p6.Pmax,
                                               p6.fft), 5),
            "the block analysis (CheapTrick + D4C)": median_ms(
                torch, lambda: LA._analysis(p6, ks[k_]), 5),
            "the pulse table": median_ms(
                torch, lambda: LA._pulse_table(p6, ks[k_], c_[k_]), 5)}
    s_busy = sum(a[1] for a in s_acts)
    by_kernel = collections.Counter()
    for _, ms, nm in s_acts:
        by_kernel[nm] += ms
    log(f"(b) one replayed chunk step ({LONG_CHUNK_FRAMES} frames, Pmax "
        f"{p6.Pmax}), profiled: wall {s_wall:.2f} ms, device busy "
        f"{s_busy:.2f} ms, {len(s_acts)} device activities; its parts "
        f"alone (CUDA events, eager): "
        + ", ".join(f"{k_} {v:.2f} ms" for k_, v in part_ms.items())
        + f"  [{card}]")
    for nm, ms in by_kernel.most_common(5):
        log(f"  device {ms:8.3f} ms  {nm[:100]}")
    # a replay's launch counts are what its capture recorded: the device
    # trace shows that the replayed step really ran the synthesis kernels
    s_tr = traced_kernels(s_acts)
    log(f"(b) our kernels in the replayed chunk step's device trace: {s_tr} "
        f"(gate: {', '.join(LONG_STEP_KERNELS)} once, no other)")
    if any(v != (k in LONG_STEP_KERNELS) for k, v in s_tr.items()):
        raise AssertionError("the replayed chunk step's device trace does "
                             "not show the OLA, pulse, noise and D4C "
                             "kernels once")
    noise = noise_row(torch, card, cycles_per_ms, key_t, o_[k_],
                      p6.Pmax, p6.fft)
    del c_, o_, ks

    # bounded memory: the bytes that grow with the recording are the input
    # (LongHarvest's padded copy and the plan's, which the chunk programs
    # read in place), the F0 tables and LongHarvest's stitched candidate
    # and score rows [F_total, S] (float32), which its contour chain reads
    # on the card
    def grow(x):
        pl = lp.plan(x, f0s6[:1 + int(1000 * len(x) / FS / 5.0)], DUR)
        rows = (lh.n_chunks(len(x)) * lh.chunk_ms + 1) \
            * lh.geo.max_candidates * 4 * 2
        return rows + nbytes(pl.x_dev, pl.f0_dev, pl.cf0_dev, pl.cvuv_dev,
                             pl.flo_dev, pl.a0_dev, pl.tpos_dev,
                             lh._windows(x, torch.float32)[0])
    extra = grow(rec) - grow(x150)
    for par, name in ((False, "sequential"), (True, "parallel")):
        limit = (peak150[par] + extra) * (1 + MEM_MARGIN)
        log(f"(b) bounded memory, {name}: peak {gib(peaks[par]):.3f} GiB at "
            f"{LONG_S} s against {gib(peak150[par]):.3f} GiB at {BOUND_S} s "
            f"+ {extra / 1e6:.1f} MB of input, F0 tables and stitched "
            f"candidate rows, + "
            f"{100 * MEM_MARGIN:.0f}%: limit {gib(limit):.3f} GiB (each "
            f"run's programs alive during it)")
        if peaks[par] > limit:
            raise AssertionError(f"device memory grows with the recording "
                                 f"({name})")

    # LongHarvest's wall split: device stages alone, with the stitching on
    # the device, and the device contour chain (F0 downloaded); then the
    # host chain on the same candidates, downloaded, against it
    xp, starts = lh._windows(rec, torch.float32)
    split = {"stages": [], "stages + stitching": [],
             "device contour chain": [], "download + host contour": []}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for b0 in range(0, len(starts), 16):
                rows = starts[b0:b0 + 16]
                H.harvest_device_stages(torch.stack(
                    [xp[s:s + lh.Tc] for s in rows]), geo=lh.geo)
        torch.cuda.synchronize()
        split["stages"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        c, s_ = lh._stitched(rec, torch.float32, 16, lh.device)
        torch.cuda.synchronize()
        split["stages + stitching"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        f0_dc, _ = lh._contour_on_card(c, s_, len(rec))
        split["device contour chain"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        f0_hc, _ = lh._contour(c.cpu(), s_.cpu(), len(rec))
        split["download + host contour"].append(time.perf_counter() - t0)
    n_cand = c.shape[0]
    del xp, c, s_
    rch = f0_diff(f0_dc, f0_hc)
    log(f"(b) LongHarvest {LONG_S} s split (walls, s): "
        + "; ".join(f"{k} {[round(v, 3) for v in vs]}"
                    for k, vs in split.items())
        + f"; the device chain against the host chain on the same "
        f"{n_cand} frames of candidates, F0 at {len(f0_dc)} frames: "
        f"{fmt(rch)}; gates: agreement >= "
        f"{REC_VOICING}, median < {REC_F0_MEDIAN} Hz  [{card}]")
    if rch["agree"] < REC_VOICING or rch["median"] >= REC_F0_MEDIAN:
        raise AssertionError("the device contour chain disagrees with the "
                             "host chain on the 600 s recording")

    # host syncs of the synthesis loops (CUDA sync debug mode): the
    # replayed loops read their overflow flags once, after the last replay
    with torch.no_grad():
        syncs = {}
        for par in (False, True):
            loop = lp._parallel if par else lp._sequential
            syncs[(par, "eager")] = count_syncs(
                torch, lambda: loop(p6, key, call=PG.eager))[1]
            progs = PG.Programs(shared_pool=True)
            loop(p6, key, call=progs.call)          # captures its programs
            syncs[(par, "replayed")] = count_syncs(
                torch, lambda: loop(p6, key, call=progs.call))[1]
            progs.clear()
    log(f"(b) host syncs of the synthesis loop over {p6.n_chunks} chunks: "
        + ", ".join(f"{'parallel' if par else 'sequential'} {mode} {n}"
                    for (par, mode), n in syncs.items())
        + " (gate: replayed, every step a replay of programs captured by "
          "a loop before, at most 1: the flags' read after the last "
          "replay)")
    if syncs[(False, "replayed")] > 1 or syncs[(True, "replayed")] > 1:
        raise AssertionError("the replayed synthesis loop syncs the host")
    del p6

    # ---- (c) kernels against their plain versions at this path's shapes
    resp, starts_, out_l, n_own = seen[0]
    ok_, o_seen = capture(_build, lambda: ola_kernel.overlap_add_cuda(
        resp, starts_, out_l, n_own))
    op = ola_kernel.overlap_add_plain(resp, starts_, out_l, n_own)
    oerr = float((ok_ - op).abs().max())
    obad = int(((ok_ - op).abs() > OLA_ATOL + OLA_RTOL * op.abs()).sum())
    o_ms = device_ms(torch, cycles_per_ms, replayer(torch, _build,
                                                    _build.library(), o_seen),
                     50)
    real = int(n_own.sum())
    o_bound = bound(real * resp.shape[2] * 4 + nbytes(starts_, ok_),
                    real * resp.shape[2])
    log(f"(c) ola on one parallel group: resp {tuple(resp.shape)} -> "
        f"{tuple(ok_.shape)}, {real} owned pulses; max abs err {oerr:.3e}, "
        f"out of tolerance {obad} (tol {OLA_ATOL} + {OLA_RTOL}*|y|); device "
        f"time alone {o_ms:.4f} ms, bound {o_bound[0]:.4f} ms "
        f"({o_bound[1]})  [{card}]")
    if obad:
        raise AssertionError("OLA kernel disagrees with its plain version "
                             "at the long-audio shapes")
    del seen, resp, ok_, op, o_seen

    xp, starts = lh._windows(rec, torch.float32)
    geo = lh.geo
    with torch.no_grad():
        xb = torch.stack([xp[s:s + lh.Tc] for s in starts[3:5]])
        y_dec = H.decimate_stage(xb, ratio=geo.ratio, y_length=geo.y_length)
        filt = H.band_filter(y_dec, geo)
        bounds_ = torch.as_tensor(geo.boundary_f0, dtype=torch.float32,
                                  device=dev)
        zargs = zc_kernel.geometry_args(geo)
        zk, z_seen = capture(_build, lambda: zc_kernel.band_candidates_cuda(
            filt, bounds_, **zargs))
        zp = zc_kernel.band_candidates_plain(filt, bounds_, **zargs)
        z_ms = device_ms(torch, cycles_per_ms, replayer(
            torch, _build, _build.library(), z_seen), 10)
        cand, _, _ = H.candidates_stage(y_dec, torch.zeros(2, device=dev),
                                        geo)
        tp1 = torch.arange(geo.f0_length, dtype=torch.float32,
                           device=dev) / 1000.0
        prep = refine_kernel.prepare(y_dec, cand, tp1, geo=geo,
                                     dedup_tol=H.REFINE_DEDUP_TOL)
        rk_args = prep["kernel_args"]
        rkw = dict(hwmax=geo.max_half_window, n_fft=geo.refine_fft)
        rk, r_seen = capture(_build, lambda: refine_kernel.spectral_sums_cuda(
            *rk_args, **rkw))
        rp = refine_kernel.spectral_sums_plain(*rk_args, **rkw)
        rerr = float((rk - rp).abs().max())
        rscale = float(rp.abs().max())
        fk, _ = refine_kernel.finish(rk, prep, geo=geo)
        fp, _ = refine_kernel.finish(rp, prep, geo=geo)
        fboth = (fk > 0) & (fp > 0)
        frel = float(((fk - fp).abs() / fp.clamp(min=1e-3))[fboth].max())
        fflips = int(((fk > 0) != (fp > 0)).sum())
        r_ms = device_ms(torch, cycles_per_ms, replayer(
            torch, _build, _build.library(), r_seen), 10)
    log(f"(c) zc on 2 LongHarvest windows: filt {tuple(filt.shape)} -> "
        f"{tuple(zk.shape)}, equal to the plain version {torch.equal(zk, zp)}"
        f" (tol 0), device time alone {z_ms:.4f} ms; refine: "
        f"{int(rk_args[4].sum())} active pairs, max abs err {rerr:.3e} of "
        f"max |sum| {rscale:.3e} (tol {REFINE_REL} rel), refined F0 max rel "
        f"{frel:.2e} (tol {REFINE_F0_REL}), flips {fflips} (tol 0), device "
        f"time alone {r_ms:.4f} ms  [{card}]")
    if (not torch.equal(zk, zp) or rerr > REFINE_REL * rscale
            or frel > REFINE_F0_REL or fflips):
        raise AssertionError("zc or refine disagrees with its plain version "
                             "at the long-audio shapes")
    log(f"phase 9 wall: {time.perf_counter() - t_phase:.1f} s")
    # the kernels line's launches come from eager calls (a replay's are
    # bookkeeping): LongHarvest's zc, refine and contour kernels in the
    # first sequential run, OLA in the eager sequential loop over the
    # recording's chunks
    long_counts = {k: counts[False][0].get(k, 0)
                   for k in ("wt_zc", "wt_refine_sums") + CONTOUR_KERNELS}
    for k in LONG_STEP_KERNELS:
        long_counts[k] = loop_counts[(False, "eager")].get(k, 0)
    return long_counts, dict(x60=x60, f0_x60=f0c, x150=x150, noise=noise)


# ---- phase 10 ----

GRID_FAST = 2             # the grid_ms fast mode's candidate grid (ms)
# tests/test_harvest.py's gates of GRID_MS = 2 against the C++ F0 on t16
# (vuv, RMSE Hz, median Hz); grid 2 against grid 1 on the main path's
# batch is reported beside them (the fast mode gives up voicing-boundary
# resolution, worldtpu/flags.py)
GRID_VUV, GRID_RMSE_HZ, GRID_MEDIAN_HZ = 0.96, 5.0, 0.2
# float64 LongHarvest against phase 9's float32 one on the same cut:
# phase 7's float64-against-float32 voicing gate, and the median |dF0|
F64_VOICING, F64_F0_MEDIAN_HZ = 0.97, 0.05


def grid_phase(torch, dev, card, cycles_per_ms, x, noise, kw, audio_s):
    """Phase 10(a): the main path (batch_wav_to_wav, phase 3's batch and
    arguments ``kw``) with grid_ms=2 against grid_ms=1: walls in turns,
    the wt.* stage table at grid 2, launches per batch, zc / refine /
    extend at the grid-2 shapes against their plain versions, F0 at grid 2
    against grid 1; and HarvestKernel(grid_ms=2) on t16 against the C++
    F0.  ``audio_s``: the batch's audio seconds, for the realtime factor.
    Returns the launches of one grid-2 batch (from 0)."""
    from worldtpu_torch import _build
    from worldtpu_torch.analysis import contour_device as CDV
    from worldtpu_torch.analysis import harvest as H
    from worldtpu_torch.io import params as P_, wav as W_
    from worldtpu_torch.ops import extend_kernel, refine_kernel, zc_kernel
    from worldtpu_torch.parallel import batch as PB, graphs as PG
    from worldtpu_torch.parallel.batch import batch_wav_to_wav

    t_phase = time.perf_counter()
    geo = kw["geo"]
    gk = geo.with_grid(GRID_FAST)
    B = x.shape[0]

    def run(grid):
        out = batch_wav_to_wav(x, noise, grid_ms=grid, **kw)
        torch.cuda.synchronize()
        return out

    _build.launches.clear()
    run(GRID_FAST)                    # a new key's first call: eager
    counts = dict(_build.launches)
    y2, f02, ovf2 = run(GRID_FAST)    # captured and replayed
    walls = {1: [], GRID_FAST: []}
    for g in (1, GRID_FAST, GRID_FAST, 1):
        walls[g].append(round(wall_ms(torch, lambda: run(g), 5), 3))
    _, f01, _ = run(1)
    y_np = y2.cpu().numpy()
    rms = float(np.sqrt(np.mean(y_np ** 2)))
    med = {g: statistics.median(v) for g, v in walls.items()}
    log(f"(a) grid_ms={GRID_FAST}: {gk.f0_length} candidate frames of "
        f"{GRID_FAST} ms (grid 1: {geo.f0_length}); launches per batch "
        f"{counts}; wall per batch, medians of 5 in turns (1, 2, 2, 1): "
        f"grid 1 {walls[1]} ms, grid 2 {walls[GRID_FAST]} ms; medians "
        f"{med[1]:.1f} / {med[GRID_FAST]:.1f} ms ({audio_s / med[1] * 1e3:.1f}"
        f"x / {audio_s / med[GRID_FAST] * 1e3:.1f}x realtime); output rms "
        f"{rms:.4f}  [{card}]")
    if (tuple(y_np.shape) != (B, kw["out_length"])
            or not np.isfinite(y_np).all() or rms < 0.01
            or bool(ovf2.any())):
        raise AssertionError("grid_ms=2 main path output")
    for k in MAIN_KERNELS:
        if counts.get(k, 0) != 1:
            raise AssertionError(f"grid_ms=2: {k} launched "
                                 f"{counts.get(k, 0)} times a batch, not "
                                 f"once")
    a, b = f02.cpu().numpy(), f01.cpu().numpy()
    both = (a > 0) & (b > 0)
    agree = float(((a > 0) == (b > 0)).mean())
    d = np.abs(a - b)[both]
    log(f"(a) F0 at grid 2 against grid 1 on the card: voicing agreement "
        f"{agree:.5f}, median |dF0| {float(np.median(d)):.3e} Hz, RMSE "
        f"{float(np.sqrt(np.mean(d ** 2))):.3f} Hz, max {float(d.max()):.2f}"
        f" Hz, voiced in both {float(both.mean()):.3f} (reported; t16's "
        f"gates below)")

    def run_eager(grid):
        # the program batch_wav_to_wav captures, called outside the cache
        with torch.no_grad():
            out = PB._wav_to_wav(x, noise, PG.scale_buffer(
                kw["pitch_scale"], x), grid_ms=grid, **{
                    k: v for k, v in kw.items() if k != "pitch_scale"})
        torch.cuda.synchronize()
        return out

    p_wall, acts, stages = stage_profile(torch, lambda: run_eager(GRID_FAST))
    busy = sum(a_[1] for a_ in acts)
    log(f"(a) profiled grid-2 main path, eager: wall {p_wall:.1f} ms "
        f"(profiler on), device busy {busy:.1f} ms = "
        f"{100 * busy / p_wall:.1f}%, {len(acts)} device activities  "
        f"[{card}]")
    for nm, (h_ms, d_ms) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        log(f"  stage {nm:18s} host {h_ms:8.3f} ms  device {d_ms:8.3f} ms")
    log(f"  sum of stages      host "
        f"{sum(v[0] for v in stages.values()):8.3f} ms  device "
        f"{sum(v[1] for v in stages.values()):8.3f} ms")

    lib = _build.library()

    def alone(seen, n):
        return device_ms(torch, cycles_per_ms,
                         replayer(torch, _build, lib, seen), n)

    with torch.no_grad():
        mean = torch.zeros(B, device=dev)
        y_dec = H.decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
        filt = H.band_filter(y_dec, gk)
        bounds_ = torch.as_tensor(gk.boundary_f0, dtype=torch.float32,
                                  device=dev)
        zargs = zc_kernel.geometry_args(gk)
        zk, z_seen = capture(_build, lambda: zc_kernel.band_candidates_cuda(
            filt, bounds_, **zargs))
        zp = zc_kernel.band_candidates_plain(filt, bounds_, **zargs)
        z_ms = alone(z_seen, 30)
        cand, _, _ = H.candidates_stage(y_dec, mean, gk)
        tp = torch.arange(gk.f0_length, dtype=torch.float32,
                          device=dev) * (GRID_FAST / 1000.0)
        prep = refine_kernel.prepare(y_dec, cand, tp, geo=gk,
                                     dedup_tol=H.REFINE_DEDUP_TOL)
        rk_args = prep["kernel_args"]
        rkw = dict(hwmax=gk.max_half_window, n_fft=gk.refine_fft)
        rk, r_seen = capture(_build, lambda: refine_kernel.spectral_sums_cuda(
            *rk_args, **rkw))
        rp = refine_kernel.spectral_sums_plain(*rk_args, **rkw)
        rerr = float((rk - rp).abs().max())
        rscale = float(rp.abs().max())
        fk, _ = refine_kernel.finish(rk, prep, geo=gk)
        fp, _ = refine_kernel.finish(rp, prep, geo=gk)
        fboth = (fk > 0) & (fp > 0)
        frel = float(((fk - fp).abs() / fp.clamp(min=1e-3))[fboth].max())
        fflips = int(((fk > 0) != (fp > 0)).sum())
        r_ms = alone(r_seen, 30)
        # the extend walk of the grid-2 contour chain: its own arguments
        hcand, hscore = H.harvest_device_stages(x, geo=geo, grid=GRID_FAST)
        seen = []
        real_walk = extend_kernel.extend_walk

        def spy(*a_, **k_):
            seen.append((a_, k_))
            return real_walk(*a_, **k_)

        extend_kernel.extend_walk = spy
        try:
            CDV.fix_and_smooth(hcand, hscore, geo.n_grid(), geo.frame_period,
                               grid_ms=GRID_FAST)
        finally:
            extend_kernel.extend_walk = real_walk
        wargs, wkw = seen[0]
        ek, e_seen = capture(_build, lambda: extend_kernel.extend_walk_cuda(
            *wargs, **wkw))
        ep = extend_kernel.extend_walk_plain(*wargs, **wkw)
        e_same = all(torch.equal(a_, b_) for a_, b_ in zip(ek, ep))
        e_ms = alone(e_seen, 100)
    log(f"(a) kernels at the grid-2 shapes against their plain versions: zc "
        f"filt {tuple(filt.shape)} -> {tuple(zk.shape)} (grid_hz "
        f"{zargs['grid_hz']:g}), equal {torch.equal(zk, zp)} (tol 0), "
        f"device time alone {z_ms:.4f} ms; refine {int(rk_args[4].sum())} "
        f"active pairs in {gk.f0_length} frames, max abs err {rerr:.3e} of "
        f"max |sum| {rscale:.3e} (tol {REFINE_REL} rel), refined F0 max rel "
        f"{frel:.2e} (tol {REFINE_F0_REL}), flips {fflips} (tol 0), "
        f"{r_ms:.4f} ms; extend {len(seen)} walk call, ext_lim "
        f"{wkw['ext_lim']} (E = {wkw['ext_lim'] + 1}), miss_lim "
        f"{wkw['miss_lim']}, {tuple(ek[2].shape)} walks, longest "
        f"{int(ek[2].max())} steps, equal in vals/scs/n_on/so {e_same} (tol "
        f"0), {e_ms:.4f} ms  [{card}]")
    if (not torch.equal(zk, zp) or rerr > REFINE_REL * rscale
            or frel > REFINE_F0_REL or fflips or not e_same
            or len(seen) != 1
            or (wkw["ext_lim"], wkw["miss_lim"]) != (50, 2)):
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the grid-2 shapes")
    del filt, zk, zp, cand, prep, rk, rp, hcand, hscore, seen

    fixd = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures"
    x16, fs16, _ = W_.wavread(str(fixd / "t16.wav"))
    gold, _, _ = P_.read_f0(str(fixd / "t16.f0.gz"))
    hk = H.HarvestKernel(fs16, len(x16), device=dev, grid_ms=GRID_FAST)
    hk.compute(x16)
    t0 = time.perf_counter()
    f16, _ = hk.compute(x16)
    h_ms = (time.perf_counter() - t0) * 1000
    ref = gold[:len(f16)]
    vb = (f16 > 0) & (ref > 0)
    vuv = float(np.mean((f16 > 0) == (ref > 0)))
    rmse = float(np.sqrt(np.mean((f16[vb] - ref[vb]) ** 2)))
    medv = float(np.median(np.abs(f16[vb] - ref[vb])))
    log(f"(a) HarvestKernel(grid_ms=2).compute on t16 against the C++ F0: "
        f"vuv {vuv:.4f} (gate > {GRID_VUV}), RMSE {rmse:.3f} Hz (gate < "
        f"{GRID_RMSE_HZ}), median {medv:.4f} Hz (gate < {GRID_MEDIAN_HZ}); "
        f"{h_ms:.1f} ms  [{card}]")
    if not (vuv > GRID_VUV and rmse < GRID_RMSE_HZ
            and medv < GRID_MEDIAN_HZ):
        raise AssertionError("grid 2 on t16 outside tests/test_harvest.py's "
                             "gates")
    log(f"phase 10(a) wall: {time.perf_counter() - t_phase:.1f} s")
    return counts


def long_audio_f64(torch, dev, card, cycles_per_ms, x60, f0_32, x150,
                   old=None, dadd=None, cases=None):
    """Phase 10(b): float64 long audio on the card.  One LongHarvest
    window's peak memory; on phase 9's parity cut x60,
    LongPipeline.copy_synthesis(dtype=torch.float64) sequential and
    parallel (walls, LongHarvest's split, peaks; F0 against phase 9's
    float32 LongHarvest f0_32 of the cut, parallel against sequential);
    the OLA kernel's double instantiation and the sequential cumulative
    sum at the chunk shapes against their plain versions (its largest
    launch through cumsum_case, with ``old`` a baseline library in turns,
    ``dadd`` the add latency (measured here when None), the figures
    appended to ``cases``); x150 sequential (wall, realtime factor, bounded
    memory).  Returns the launches of the eager sequential synthesis loop
    over x60's chunks (from 0)."""
    from worldtpu_torch import _build
    from worldtpu_torch import longaudio as LA
    from worldtpu_torch.analysis import longform as LF
    from worldtpu_torch.ops import ola_kernel, seqsum
    from worldtpu_torch.parallel import graphs as PG
    from worldtpu_torch.synthesis import noise as N

    t_phase = time.perf_counter()
    f64 = torch.float64
    lp = LA.LongPipeline(FS, f0_floor=LONG_FLOOR,
                         chunk_frames=LONG_CHUNK_FRAMES,
                         harvest_chunk_ms=HARVEST_CHUNK_MS,
                         harvest_halo_ms=HARVEST_HALO_MS, device=dev)
    lh = lp.harvest
    syn = dict(seed=LONG_SEED, pitch_scale=PITCH, duration_scale=DUR,
               dtype=f64)
    x60 = x60.astype(np.float64)
    x150 = x150.astype(np.float64)

    def peak_reset():
        """Reset the peak; return the bytes allocated now (the earlier
        phases' tensors and caches, under every later peak)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def gib(b):
        return b / 2 ** 30

    # one window of the float64 LongHarvest: the peak that sizes its batch
    lh.compute(x60[:lh.stride], dtype=f64)
    base = peak_reset()
    lh.compute(x60[:lh.stride], dtype=f64)
    peak1 = torch.cuda.max_memory_allocated()
    m64 = LF.MAX_BATCH[f64]
    log(f"(b) float64 LongHarvest, one window of {lh.Tc} samples: peak "
        f"device memory {gib(peak1):.3f} GiB, {gib(peak1 - base):.3f} GiB "
        f"above the {gib(base):.3f} GiB held before it; batches of "
        f"MAX_BATCH[float64] = {m64} windows (float32: "
        f"{LF.MAX_BATCH[torch.float32]})  [{card}]")

    # the cut through the pipeline, both modes; LongHarvest timed in its
    # parts (its stages synchronized at their end, so no download overlaps
    # them), the OLA launches of the first chunk and of the first parallel
    # group kept for the kernel checks
    lp.copy_synthesis(x60[:12 * FS], **syn)          # warm-up: plans
    split = collections.Counter()
    real_s, real_c, real_h = LF.harvest_device_stages, lh._stitched, \
        lh._contour

    def timed(name, fn, sync=False):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            split[name] += time.perf_counter() - t0
            return out
        return call

    ola_seen = {}                  # the first chunk's, the first group's
    real_ola = LA.overlap_add

    def ola_spy(resp, starts, out_length, n_pulses):
        ola_seen.setdefault("group" if resp.shape[0] > 1 else "chunk",
                            (resp, starts, out_length, n_pulses))
        return real_ola(resp, starts, out_length, n_pulses)

    mem = {}

    def harvest_peak(fn):
        """fn (LongHarvest's stages and downloads), recording the peak up
        to its end and resetting it, so that the run's last peak is the
        analysis' and synthesis'."""
        def call(*a, **k):
            out = fn(*a, **k)
            torch.cuda.synchronize()
            mem["harvest"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            return out
        return call

    def run_peak():
        """(the run's peak, LongHarvest's, the rest's) after a run."""
        rest = torch.cuda.max_memory_allocated()
        return max(mem["harvest"], rest), mem["harvest"], rest

    out, walls, peaks, splits, parts = {}, {}, {}, {}, {}
    LF.harvest_device_stages = timed("stages", real_s, sync=True)
    lh._stitched = timed("stitching", harvest_peak(real_c))
    lh._contour = timed("host contour", real_h)
    LA.overlap_add = ola_spy
    try:
        for par in (False, True):
            split.clear()
            peak_reset()
            t0 = time.perf_counter()
            out[par] = lp.copy_synthesis(x60, parallel=par, **syn)
            walls[par] = time.perf_counter() - t0
            peaks[par], *parts[par] = run_peak()
            splits[par] = dict(split)
    finally:
        LF.harvest_device_stages = real_s
        del lh._stitched, lh._contour
        LA.overlap_add = real_ola
    dur = len(x60) / FS
    n_w = lh.n_chunks(len(x60))
    for par, name in ((False, "sequential"), (True, "parallel")):
        sp = splits[par]
        rest = walls[par] - sp["stitching"] - sp["host contour"]
        log(f"(b) float64 LongPipeline, {dur:.2f} s, {name}: wall "
            f"{walls[par]:.2f} s = {dur / walls[par]:.2f}x realtime; "
            f"LongHarvest ({n_w} windows in {-(-n_w // m64)} batches): "
            f"device stages {sp['stages']:.3f} s, downloads and stitching "
            f"{sp['stitching'] - sp['stages']:.3f} s, host contour "
            f"{sp['host contour']:.3f} s; the rest (analysis and synthesis)"
            f" {rest:.3f} s; peak device memory {gib(peaks[par]):.3f} GiB "
            f"({gib(peaks[par] - base):.3f} above the window run's base; "
            f"LongHarvest {gib(parts[par][0]):.3f}, analysis and synthesis "
            f"{gib(parts[par][1]):.3f})  [{card}]")
    (ys, f0s), (yp, f0p) = out[False], out[True]
    a, b = f0s, f0_32 * PITCH
    both = (a > 0) & (b > 0)
    agree = float(((a > 0) == (b > 0)).mean())
    d = np.abs(a - b)[both] / PITCH
    rel = windowed_rel(yp, ys)
    q99, q90 = float(np.quantile(rel, 0.99)), float(np.quantile(rel, 0.9))
    rms = float(np.sqrt(np.mean(ys ** 2)))
    log(f"(b) float64 F0 against phase 9's float32 LongHarvest of the cut: "
        f"voicing agreement {agree:.5f} (gate >= {F64_VOICING}), median "
        f"|dF0| {float(np.median(d)):.3e} Hz (gate < {F64_F0_MEDIAN_HZ}), "
        f"RMSE {float(np.sqrt(np.mean(d ** 2))):.3f} Hz, max "
        f"{float(d.max()):.2f} Hz; parallel against sequential: F0 identical "
        f"{np.array_equal(f0s, f0p)}, windowed relative error q90 {q90:.2e} "
        f"(gate {WINDOW_Q90}), q99 {q99:.2e} (gate {PARITY_Q99}), max "
        f"{float(rel.max()):.2e}; output {len(ys)} samples, rms {rms:.4f}")
    if (agree < F64_VOICING or not float(np.median(d)) < F64_F0_MEDIAN_HZ
            or not np.array_equal(f0s, f0p) or q99 >= PARITY_Q99
            or q90 >= WINDOW_Q90 or ys.dtype != np.float64
            or not np.isfinite(ys).all() or rms < 0.01):
        raise AssertionError("float64 long audio on the card")

    # the synthesis loops alone on the cut's plan: eager and replayed in
    # turns (float64 steps: wt_seq_cumsum_f64 and wt_ola_f64 on the
    # device), outputs bit-equal, launches equal, host syncs
    # (each replayed loop's programs in a cache of its own, as
    # copy_synthesis keeps them; reserved memory gated as in phase 9)
    key = N.as_key(LONG_SEED)
    pl60 = lp.plan(x60, f0s, DUR, f64)
    for par, name in ((False, "sequential"), (True, "parallel")):
        loop = lp._parallel if par else lp._sequential
        w, ys_, cs = {"eager": [], "replayed": []}, {}, {}
        rsv, held = {"eager": [], "replayed": []}, []
        for mode in ("eager", "replayed", "replayed", "eager"):
            _build.launches.clear()
            progs = PG.Programs(shared_pool=True)
            base = peak_reset()
            t0 = time.perf_counter()
            with torch.no_grad():
                yl, _ = loop(pl60, key, call=PG.eager if mode == "eager"
                             else progs.call)
            w[mode].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            rsv[mode].append(torch.cuda.max_memory_reserved())
            if mode == "eager":
                work = torch.cuda.max_memory_allocated() - base
            else:
                held = [(k_[0].__name__, b)
                        for k_, b in zip(progs.keys(), progs.held())]
            progs.clear()
            cs[mode] = dict(_build.launches)
            ys_.setdefault(mode, yl)
        if not par:
            f64_counts = cs["eager"]
        with torch.no_grad():
            progs = PG.Programs(shared_pool=True)
            loop(pl60, key, call=progs.call)        # captures its programs
            _, n_sync = count_syncs(torch,
                                    lambda: loop(pl60, key, call=progs.call))
            progs.clear()
        same = (np.array_equal(ys_["eager"], ys_["replayed"])
                and np.array_equal(ys_["eager"][:pl60.out_length],
                                   out[par][0]))
        r_limit = reserve_limit(rsv["eager"], work)
        log(f"(b) float64 synthesis loop, {dur:.2f} s, {name}, eager and "
            f"replayed in turns: eager {[round(v, 3) for v in w['eager']]} "
            f"s, replayed {[round(v, 3) for v in w['replayed']]} s "
            f"({pl60.n_chunks} chunks); y bit-equal to the eager loop's and "
            f"to the replayed copy_synthesis {same}; launches eager "
            f"{cs['eager']}, replayed {cs['replayed']} (gate: eager + one "
            f"eager step's, the capture's); host syncs of a "
            f"replayed loop {n_sync} (gate: at most 1, the flags' read after "
            f"the last replay); peak reserved device memory eager "
            f"{[round(gib(b), 3) for b in rsv['eager']]} GiB, replayed "
            f"{[round(gib(b), 3) for b in rsv['replayed']]} GiB ("
            + ", ".join(f"{nm} {gib(b):.3f} GiB" for nm, b in held)
            + f" the pool each capture reserved), limit {gib(r_limit):.3f} "
            f"GiB (eager + {RESERVE_POOL} x one eager step's working set "
            f"{gib(work):.3f} GiB + {RESERVE_SLACK >> 20} MiB; the second "
            f"replayed loop within the first's + {RESERVE_SLACK >> 20} MiB)"
            f"  [{card}]")
        if (not same or n_sync > 1
                or not reserve_ok(rsv["replayed"], r_limit)
                or cs["replayed"] != capture_counts(cs["eager"],
                                                    n_steps(pl60, par))):
            raise AssertionError(f"the replayed float64 {name} synthesis "
                                 f"loop")
    del pl60

    # ---- OLA double and the sequential cumsum at the chunk shapes ----
    with torch.no_grad():
        lines = []
        for resp, starts_, out_l, n_own in ola_seen.values():
            ok_, o_seen = capture(_build, lambda: ola_kernel.overlap_add_cuda(
                resp, starts_, out_l, n_own))
            op = ola_kernel.overlap_add_plain(resp, starts_, out_l, n_own)
            err = float((ok_ - op).abs().max())
            scale = float(op.abs().max())
            o_ms = device_ms(torch, cycles_per_ms, replayer(
                torch, _build, _build.library(), o_seen), 50)
            lines.append(f"resp {tuple(resp.shape)} -> {tuple(ok_.shape)}, "
                         f"{int(n_own.sum())} owned pulses, max abs err "
                         f"{err:.3e} of max |y| {scale:.3e} (tol "
                         f"{OLA_F64_REL} relative), {o_ms:.4f} ms")
            if o_seen[0][0] != "wt_ola_f64" or err > OLA_F64_REL * scale:
                raise AssertionError("the float64 OLA kernel disagrees with "
                                     "its plain version at the chunk shapes")
        p = lp.plan(x60, f0s, DUR, f64)
        k = p.n_chunks // 2
        carries, ords, _ = LA._phase_prescan(p, dev)
        _, c_seen = capture(_build, lambda: LA._chunk_step(
            p, torch.tensor([k], device=dev), carries[k:k + 1],
            ords[k:k + 1], N.as_key(LONG_SEED)))
        torch.cuda.synchronize()
        c_seen = [c for c in c_seen if c[0] == "wt_seq_cumsum_f64"]
        shapes = []
        for _, _, (cx, cout, n_rows, n) in c_seen:
            want = np.cumsum(cx.cpu().numpy().reshape(n_rows, n), axis=-1)
            got = cout.cpu().numpy().reshape(n_rows, n)
            shapes.append((n_rows, n))
            if not bits_equal(got, want):
                raise AssertionError(f"the sequential cumulative sum "
                                     f"disagrees with numpy.cumsum at "
                                     f"{(n_rows, n)}")
        big = max(c_seen, key=lambda c: c[2][2] * c[2][3])
        xs_t = big[2][0]
        plain_same = torch.equal(seqsum.cumsum_sequential_plain(xs_t),
                                 seqsum.cumsum_sequential_cuda(xs_t))
        lib = _build.library()
        big_case = cumsum_case(
            torch, cycles_per_ms, lib, old, big,
            dadd or dadd_latency(torch, lib, dev),
            "(b) a float64 chunk step's largest launch", 20)
        if cases is not None:
            cases.append(big_case)
        # one replayed float64 chunk step (the same chunk) under the
        # profiler: a replay's launch counts are what its capture recorded,
        # the device trace shows the kernels it really ran
        progs = PG.Programs(shared_pool=True)
        key_t = N.key_tensor(key, dev)
        ks = torch.tensor([k], device=dev)

        def step():
            return progs.call(LA._step_program, (ks, carries[k:k + 1],
                                                 ords[k:k + 1], key_t),
                              dtypes=LA._DTYPES, plan=p)
        for _ in range(3):              # replayed by the third call
            step()
        f_wall, f_acts, _ = stage_profile(torch, step)
        progs.clear()
    # every __global__ of csrc/seq_cumsum.cu that the entry launches (its
    # instantiations by chunk), once a launch
    f_tr = {nm: sum(1 for a in f_acts if re.search(pat, a[2]))
            for nm, pat in (("wt_ola_f64", r"ola_kernel<double>"),
                            ("wt_seq_cumsum_f64",
                             r"(?<!\w)seq_cumsum_kernel<\d+>"))}
    f_busy = sum(a[1] for a in f_acts)
    log(f"(b) one replayed float64 chunk step, profiled: wall {f_wall:.2f} "
        f"ms, device busy {f_busy:.2f} ms, {len(f_acts)} device activities;"
        f" in its device trace {f_tr} (gate: wt_ola_f64 once, "
        f"wt_seq_cumsum_f64 {len(c_seen)} times, an eager step's launches)"
        f"  [{card}]")
    if f_tr["wt_ola_f64"] != 1 or f_tr["wt_seq_cumsum_f64"] != len(c_seen):
        raise AssertionError("the replayed float64 chunk step's device "
                             "trace does not show its kernels")
    log("(b) OLA double at the float64 chunk shapes (a chunk, a parallel "
        "group): " + "; ".join(lines) + f"  [{card}]")
    log(f"(b) seq_cumsum: {len(c_seen)} launches of one float64 chunk step, "
        f"shapes {sorted(set(shapes))}: each equal to numpy.cumsum of its "
        f"input True (tol 0); the largest {big[2][2:]} equal to the plain "
        f"version {plain_same}, {big_case['ms']:.4f} ms device time alone  "
        f"[{card}]")
    if len(c_seen) < 2 or not plain_same:
        raise AssertionError("the sequential cumulative sum at the float64 "
                             "chunk shapes")
    del ola_seen, p, carries, ords, c_seen, big, xs_t, ks, key_t

    # ---- the first 150 s, sequential: bounded memory ----
    def grow(x, f0):
        # the plan's tables (the chunk programs read them in place) and
        # LongHarvest's padded copy
        pl = lp.plan(x, f0, DUR, f64)
        return nbytes(pl.x_dev, pl.f0_dev, pl.cf0_dev, pl.cvuv_dev,
                      pl.flo_dev, pl.a0_dev, pl.tpos_dev,
                      lh._windows(x, f64)[0])

    _build.launches.clear()
    peak_reset()
    lh._stitched = harvest_peak(real_c)
    try:
        t0 = time.perf_counter()
        y150, f150 = lp.copy_synthesis(x150, **syn)
        w150 = time.perf_counter() - t0
    finally:
        del lh._stitched
    peak150, *parts150 = run_peak()
    counts = dict(_build.launches)
    extra = grow(x150, f150) - grow(x60, f0s)
    limit = (peaks[False] + extra) * (1 + MEM_MARGIN)
    n_h = lh.n_chunks(len(x150))
    p150 = lp.plan(x150, f150, DUR, f64)
    p60 = lp.plan(x60, f0s, DUR, f64)
    log(f"(b) float64 {len(x150) / FS:.1f} s, sequential: wall {w150:.2f} "
        f"s = {len(x150) / FS / w150:.2f}x realtime; peak device memory "
        f"{gib(peak150):.3f} GiB (LongHarvest {gib(parts150[0]):.3f}, "
        f"analysis and synthesis {gib(parts150[1]):.3f}) against "
        f"{gib(peaks[False]):.3f} GiB at "
        f"{dur:.2f} s + {extra / 1e6:.1f} MB of input and F0 tables, + "
        f"{100 * MEM_MARGIN:.0f}%: limit {gib(limit):.3f} GiB; "
        f"{n_h} Harvest windows in {-(-n_h // m64)} batches, "
        f"{p150.n_chunks} synthesis chunks of Pmax {p150.Pmax} pulse slots "
        f"({p60.Pmax} at {dur:.2f} s: the bound follows the highest F0); "
        f"launches {counts} (one more OLA than chunks: the eager step of "
        f"the loop's capture; replays counted as recorded); "
        f"{len(x150) / FS:.0f} s and not {LONG_S} s: float64 runs at a few "
        f"times realtime  [{card}]")
    if (peak150 > limit or not np.isfinite(y150).all()
            or len(y150) != p150.out_length
            or counts.get("wt_ola_f64", 0) != p150.n_chunks + 1
            or counts.get("wt_seq_cumsum_f64", 0) < p150.n_chunks
            or any(k_ in counts for k_ in MAIN_KERNELS)):
        raise AssertionError("float64 long audio, bounded memory")
    log(f"phase 10(b) wall: {time.perf_counter() - t_phase:.1f} s")
    return f64_counts


# ---- phase 11 ----

MESH_RANKS = 4            # gloo ranks sharing cuda:0
MESH_LAYOUTS = ((4, 1), (2, 2), (1, 4))
MESH_JOIN_S = 420         # every rank exits within this, or the phase fails
MESH_COLLECTIVE_S = 120   # torch.distributed timeout of a rank's calls
# the mesh path against the single-card path where a kernel sees other
# rows or a GEMM other columns (worldtpu's tests/test_parallel.py): F0
# within 1e-4 Hz with identical voicing (:152-176), 160-sample short-time
# RMS within 0.02 (:179-216); float64 copy-synthesis at rtol 1e-9, atol
# 1e-12 (:37-64)
MESH_F0_ATOL, MESH_RMS_ATOL = 1e-4, 0.02
MESH_F64_RTOL, MESH_F64_ATOL = 1e-9, 1e-12
MESH_F64_REPS = 4         # t22 rows of the float64 copy-synthesis case


def f64_copy_syn_case(torch, dev):
    """Phase 11's float64 copy-synthesis inputs (tests/test_parallel.py's
    case: t22 with its C++ F0, frames padded to a multiple of 2, the same
    noise row for every utterance) as numpy, and the keywords of
    batch_copy_synthesis."""
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.io import params as P_, wav as W_
    from worldtpu_torch.synthesis import synthesis as S
    fixd = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures"
    x22, fs22, _ = W_.wavread(str(fixd / "t22.wav"))
    f0, _, _ = P_.read_f0(str(fixd / "t22.f0.gz"))
    F = len(f0)
    Fp = F + F % 2
    f0p = np.zeros((MESH_F64_REPS, Fp))
    f0p[:, :F] = f0
    ck = CheapTrickKernel(fs22)
    out = int((Fp - 1) * 0.005 * fs22) + 1
    mp = S.default_max_pulses(out, fs22)
    gen = torch.Generator(device=dev).manual_seed(3)
    noise = torch.randn((1, mp, ck.fft_size), generator=gen,
                        dtype=torch.float64, device=dev)
    arrays = dict(x=np.tile(np.asarray(x22, np.float64),
                            (MESH_F64_REPS, 1)),
                  f0=f0p, tpos=np.arange(Fp) * 0.005,
                  noise=noise.expand(MESH_F64_REPS, -1, -1).cpu().numpy())
    kw = dict(fs=fs22, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window, frame_period_s=0.005,
              out_length=out, max_pulses=mp)
    return arrays, kw


def f64_excess(got, want):
    """max over elements of |got - want| - (MESH_F64_ATOL + MESH_F64_RTOL
    |want|) (> 0: outside the float64 tolerance), and the max relative
    error."""
    d = np.abs(got - want)
    return (float((d - MESH_F64_ATOL - MESH_F64_RTOL * np.abs(want)).max()),
            float((d / np.maximum(np.abs(want), 1e-300)).max()))


def pulse_spy(LA, sink):
    """Wrap longaudio._pulse_table so that each call appends the global
    output samples of its owned pulses to ``sink``; returns the original
    to restore."""
    real = LA._pulse_table

    def spy(p, k, carry):
        pul = real(p, k, carry)
        pos = (k * p.L)[:, None] + pul["idx"]
        sink.append(pos[pul["own"]].cpu())
        return pul

    LA._pulse_table = spy
    return real


def mesh_rank(rank, d):
    """One of phase 11's gloo ranks (``chip_smoke.py --mesh-rank R
    --mesh-dir D``): the mesh paths on cuda:0, each result held against the
    single-card references in D; what it measured goes to D/rank{R}.json."""
    t_rank = time.perf_counter()
    import torch
    root = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from worldtpu_torch import _build, constants as C
    from worldtpu_torch import longaudio as LA
    from worldtpu_torch.analysis import harvest as H
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.ops import refine_kernel, zc_kernel
    from worldtpu_torch.parallel import batch as PB
    from worldtpu_torch.parallel import distributed as PD
    from worldtpu_torch.synthesis import synthesis as S
    cfg = json.loads((d / "config.json").read_text())
    ref = {k: np.load(d / f"{k}.npy") for k in cfg["arrays"]}
    dev = PD.init_distributed(
        backend="gloo", init_method=f"file://{d / 'store'}",
        world_size=MESH_RANKS, rank=rank, device="cuda:0",
        timeout=MESH_COLLECTIVE_S)
    barrier = torch.distributed.barrier
    _build.library()
    torch.cuda.reset_peak_memory_stats()
    res = dict(rank=rank)
    x = torch.tensor(ref["x"], device=dev)
    T = x.shape[1]
    geo = H.HarvestGeometry(FS, T, f0_floor=40.0)
    ck = CheapTrickKernel(FS)
    n_grid = geo.n_grid()
    out_len = int((n_grid - 1) * 0.005 * DUR * FS) + 1
    mp = S.capacity_max_pulses(out_len, FS, f0_cap=C.DEFAULT_F0 * PITCH)
    noise = S.make_noise(torch.Generator(device=dev).manual_seed(0), BATCH,
                         mp, ck.fft_size, device=dev)
    if float(noise.double().sum()) != cfg["noise_sum"]:
        raise AssertionError("the rank's noise is not the main path's")
    kw = dict(geo=geo, fs=FS, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window,
              frame_period_s=0.005 * DUR, out_length=out_len, max_pulses=mp,
              pitch_scale=PITCH, return_overflow=True)
    meshes = {lay: PB.make_mesh(*lay) for lay in MESH_LAYOUTS}
    res["degraded_3x1"] = list(PB.make_mesh(3, 1).shape)
    zargs = zc_kernel.geometry_args(geo)
    for lay, mesh in meshes.items():
        r = res[str(lay)] = dict(coord=mesh.get_coordinate())
        nd = lay[0]
        bl = BATCH // nd
        rows = slice(mesh.get_local_rank("data") * bl,
                     (mesh.get_local_rank("data") + 1) * bl)

        def call(mesh=mesh):
            out = PB.batch_wav_to_wav(x, noise, mesh=mesh, **kw)
            torch.cuda.synchronize()
            return out

        def single():
            out = PB.batch_wav_to_wav(x, noise, **kw)
            torch.cuda.synchronize()
            return out

        barrier()
        call()                                   # warm-up: first calls
        barrier()
        _build.launches.clear()
        y, f0, ovf = call()
        r["launches"] = dict(_build.launches)
        y, f0 = y.to_local().cpu().numpy(), f0.to_local().cpu().numpy()
        f0_ref = ref["f0"][rows]
        r["ovf"] = bool(ovf.to_local().any())
        r["voicing_same"] = bool(np.array_equal(f0 > 0, f0_ref > 0))
        r["f0_equal"] = bool(np.array_equal(f0, f0_ref))
        r["f0_max_diff"] = float(np.abs(f0 - f0_ref).max())
        r["y_equal"] = bool(np.array_equal(y, ref["y"][rows]))
        r["rms_max_diff"] = float(np.abs(short_time_rms(y) - short_time_rms(
            ref["y"][rows])).max())
        r["finite"] = bool(np.isfinite(y).all())
        # the stages, and the zc and refine launches at this rank's shard
        # shapes against their plain versions
        (cand, score), seen = capture(
            _build, lambda: PB.batch_harvest_device_stages(
                x, geo=geo, mesh=mesh))
        torch.cuda.synchronize()
        cand = cand.to_local().cpu().numpy()
        score = score.to_local().cpu().numpy()
        r["stages_equal"] = bool(
            np.array_equal(cand, ref["cand"][rows])
            and np.array_equal(score, ref["score"][rows]))
        r["stages_max_diff"] = float(max(
            np.abs(cand - ref["cand"][rows]).max(),
            np.abs(score - ref["score"][rows]).max()))
        for name, _, a in seen:
            if name == "wt_zc":
                filt, bounds, out = a[0], a[1], a[3]
                zp = zc_kernel.band_candidates_plain(filt, bounds, **zargs)
                r["zc"] = dict(shape=list(filt.shape),
                               equal=bool(torch.equal(out, zp)),
                               nonzero=int((out > 0).sum()))
            elif name == "wt_refine_sums":
                seg, delta, hw, gbin, na, out = a[0], a[1], a[2], a[3], \
                    a[4], a[7]
                rp = refine_kernel.spectral_sums_plain(
                    seg, delta, hw, gbin, na, hwmax=geo.max_half_window,
                    n_fft=geo.refine_fft)
                r["refine"] = dict(frames=seg.shape[0],
                                   pairs=int(na.sum()),
                                   err=float((out - rp).abs().max()),
                                   scale=float(rp.abs().max()))
        del seen
        _, r["syncs"] = count_syncs(torch, lambda: PB.batch_wav_to_wav(
            x, noise, mesh=mesh, **kw))
        walls = {"single": [], "mesh": []}
        for mode in ("single", "mesh", "mesh", "single"):
            barrier()
            walls[mode].append(wall_ms(torch, call if mode == "mesh"
                                       else single, 5))
        r["walls"] = walls

    # float64 copy-synthesis under (2, 2)
    m22 = meshes[(2, 2)]
    arrays, f64kw = f64_copy_syn_case(torch, dev)
    dl = m22.get_local_rank("data")
    bl = MESH_F64_REPS // 2
    xg, f0g, ng = PD.process_local_batch(m22, [
        arrays[k][dl * bl:(dl + 1) * bl] for k in ("x", "f0", "noise")])
    barrier()
    _build.launches.clear()
    y64, spec64, ap64 = PB.batch_copy_synthesis(
        xg, f0g, torch.tensor(arrays["tpos"], device=dev), ng, mesh=m22,
        **f64kw)
    torch.cuda.synchronize()
    r64 = res["f64"] = dict(launches=dict(_build.launches))
    rows = slice(dl * bl, (dl + 1) * bl)
    for key, got in (("y", y64), ("spec", spec64), ("ap", ap64)):
        r64[key] = f64_excess(got.to_local().cpu().numpy(),
                              ref[f"f64_{key}"][rows])
    full = PD.gather_rows(y64).cpu().numpy()
    r64["gathered_equal"] = bool(np.array_equal(
        full[rows], y64.to_local().cpu().numpy()))

    # LongPipeline(mesh=) on phase 9's cut
    lp = LA.LongPipeline(FS, f0_floor=LONG_FLOOR,
                         chunk_frames=LONG_CHUNK_FRAMES,
                         harvest_chunk_ms=HARVEST_CHUNK_MS,
                         harvest_halo_ms=HARVEST_HALO_MS, device=dev)
    syn = dict(seed=LONG_SEED, pitch_scale=PITCH, duration_scale=DUR)
    pulses = []
    real = pulse_spy(LA, pulses)
    try:
        barrier()
        _build.launches.clear()
        t0 = time.perf_counter()
        yl, f0l = lp.copy_synthesis(ref["x60"], mesh=m22, **syn)
        wl = time.perf_counter() - t0
    finally:
        LA._pulse_table = real
    res["long"] = dict(wall_s=wl, launches=dict(_build.launches),
                       n_chunks=lp.plan(ref["x60"], f0l, DUR).n_chunks)
    np.savez(d / f"long{rank}.npz", y=yl, f0=f0l,
             pulses=torch.cat(pulses).numpy())
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["seconds"] = time.perf_counter() - t_rank
    barrier()
    (d / f"rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


def mesh_phase(torch, dev, card, x, noise, kw, x60):
    """Phase 11: the mesh paths.  (a) an NCCL world of this process alone,
    mesh (1, 1): batch_wav_to_wav bit-equal to the single-card call, each
    kernel launched once; (b) MESH_RANKS gloo ranks on cuda:0, spawned
    once, each with meshes (2, 2) and (1, 4): the main path against the
    single-card references, zc and refine at their shard shapes against
    their plain versions, make_mesh(3, 1) degrading, float64
    batch_copy_synthesis; (c) LongPipeline.copy_synthesis(mesh=) over the
    ranks on phase 9's cut x60 against this process's sequential and
    parallel runs.  Returns each C entry's launches per rank in one (2, 2)
    batch and the (2, 2) float64 copy-synthesis."""
    import torch.distributed as dist

    from worldtpu_torch import _build
    from worldtpu_torch import longaudio as LA
    from worldtpu_torch.analysis import harvest as H
    from worldtpu_torch.parallel import batch as PB
    from worldtpu_torch.parallel import distributed as PD
    from worldtpu_torch.parallel import graphs as PG
    from worldtpu_torch.synthesis import noise as N
    from worldtpu_torch.synthesis import synthesis as S
    t_phase = time.perf_counter()
    with torch.no_grad():
        y_s, f0_s, _ = PB.batch_wav_to_wav(x, noise, **kw)
        cand_s, score_s = H.harvest_device_stages(x, geo=kw["geo"])

    # ---- (a) NCCL, a world of one, mesh (1, 1) ----
    PD.init_distributed()
    try:
        backend = dist.get_backend()
        m11 = PB.make_mesh(1, 1)

        def call():
            out = PB.batch_wav_to_wav(x, noise, mesh=m11, **kw)
            torch.cuda.synchronize()
            return out

        def single():
            out = PB.batch_wav_to_wav(x, noise, **kw)
            torch.cuda.synchronize()
            return out

        call()
        _build.launches.clear()
        y1, f01, _ = call()
        c11 = dict(_build.launches)
        same = (torch.equal(y1.to_local(), y_s)
                and torch.equal(f01.to_local(), f0_s))
        _, n11 = count_syncs(torch, lambda: PB.batch_wav_to_wav(
            x, noise, mesh=m11, **kw))
        walls = {"single": [], "mesh": []}
        for mode in ("single", "mesh", "mesh", "single"):
            walls[mode].append(round(wall_ms(
                torch, call if mode == "mesh" else single, 5), 2))
    finally:
        dist.destroy_process_group()
    log(f"11(a) {backend}, a world of one, mesh (1, 1): batch_wav_to_wav "
        f"F0 and y bit-equal to the single-card call {same}; launches "
        f"{c11}; host syncs {n11}; wall per batch, medians of 5 in turns: "
        f"single {walls['single']} ms, mesh {walls['mesh']} ms  [{card}]")
    if not same or any(c11.get(k, 0) != 1 for k in MAIN_KERNELS):
        raise AssertionError("mesh (1, 1) is not the single-card path")

    # what moves y on a shard of rows (the (4, 1) layout: 2 rows a rank):
    # each stage of the copy-synthesis on the first 2 rows against the
    # whole batch's rows, and cuFFT's batched rfft on 2 x F rows against
    # 8 x F
    with torch.no_grad():
        tp = torch.arange(f0_s.shape[1], dtype=torch.float32, device=dev) \
            * (kw["geo"].frame_period / 1000.0)
        akw = dict(fs=kw["fs"], fft_size=kw["fft_size"],
                   frame_period_s=kw["frame_period_s"],
                   out_length=kw["out_length"], max_pulses=kw["max_pulses"])
        parts = {}
        for rows in (slice(0, BATCH), slice(0, 2)):
            spec, ap = PB._analysis(x[rows], f0_s[rows].contiguous(), tp,
                                    fs=kw["fs"], fft_size=kw["fft_size"],
                                    max_half_window=kw["max_half_window"])
            parts[rows.stop] = (spec[:2], ap[:2])
        spec8, ap8 = parts[BATCH]
        y_of8 = S.synthesis_frames_impl(f0_s[:2].contiguous(), spec8, ap8,
                                        noise[:2], **akw)
        r = torch.randn(BATCH * f0_s.shape[1], kw["fft_size"], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
        n2 = 2 * f0_s.shape[1]
        rfft_same = torch.equal(torch.fft.rfft(r[:n2]),
                                torch.fft.rfft(r)[:n2])
    log(f"11 rows of a shard (2 of {BATCH}) against the whole batch, on the "
        f"batch's F0: spectrogram bit-equal "
        f"{torch.equal(parts[2][0], spec8)} (max |d| "
        f"{float((parts[2][0] - spec8).abs().max()):.3e}), aperiodicity "
        f"{torch.equal(parts[2][1], ap8)} (max |d| "
        f"{float((parts[2][1] - ap8).abs().max()):.3e}); synthesis on the "
        f"same spectra bit-equal to the batch's rows "
        f"{torch.equal(y_of8, y_s[:2])}; cuFFT rfft of {n2} rows bit-equal "
        f"to the same rows of a {BATCH * f0_s.shape[1]}-row batch "
        f"{rfft_same}  [{card}]")
    del parts, spec8, ap8, y_of8, r

    # ---- (b), (c): gloo ranks on cuda:0 ----
    arrays, f64kw = f64_copy_syn_case(torch, dev)
    with torch.no_grad():
        yr, sr, ar = PB.batch_copy_synthesis(
            *(torch.tensor(arrays[k], device=dev)
              for k in ("x", "f0", "tpos", "noise")), **f64kw)
    refs = dict(x=x.cpu().numpy(), f0=f0_s.cpu().numpy(),
                y=y_s.cpu().numpy(), cand=cand_s.cpu().numpy(),
                score=score_s.cpu().numpy(), x60=x60,
                f64_y=yr.cpu().numpy(), f64_spec=sr.cpu().numpy(),
                f64_ap=ar.cpu().numpy())
    del yr, sr, ar, cand_s, score_s
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        d = pathlib.Path(td)
        for k, v in refs.items():
            np.save(d / f"{k}.npy", v)
        (d / "config.json").write_text(json.dumps(dict(
            arrays=sorted(refs), noise_sum=float(noise.double().sum()))))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--mesh-rank", str(r), "--mesh-dir", td],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(MESH_RANKS)]
        errs = []
        try:
            for r, p in enumerate(procs):
                left = MESH_JOIN_S - (time.perf_counter() - t0)
                try:
                    _, err = p.communicate(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"mesh rank {r} did not finish "
                                         f"within {MESH_JOIN_S} s")
                errs.append(err)
                if p.returncode != 0:
                    raise AssertionError(f"mesh rank {r} exited "
                                         f"{p.returncode}:\n{err[-4000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        ranks_s = time.perf_counter() - t0
        res = [json.loads((d / f"rank{r}.json").read_text())
               for r in range(MESH_RANKS)]
        longs = [dict(np.load(d / f"long{r}.npz")) for r in range(MESH_RANKS)]

    fails = []
    for lay in MESH_LAYOUTS:
        key = str(tuple(lay))
        rs = [q[key] for q in res]
        nt = lay[1]
        log(f"11(b) mesh {lay}, {MESH_RANKS} gloo ranks on cuda:0, "
            f"coordinates {[q['coord'] for q in rs]}: launches per rank "
            f"{[q['launches'] for q in rs]}")
        log(f"  stages (candidates, scores) bit-equal to the single-card "
            f"stages {[q['stages_equal'] for q in rs]} (max diff "
            f"{max(q['stages_max_diff'] for q in rs):.3e}); F0 bit-equal "
            f"{[q['f0_equal'] for q in rs]}, max |dF0| "
            f"{max(q['f0_max_diff'] for q in rs):.3e} Hz (gate "
            f"{MESH_F0_ATOL}), voicing identical "
            f"{all(q['voicing_same'] for q in rs)}; y bit-equal "
            f"{[q['y_equal'] for q in rs]}, short-time RMS max diff "
            f"{max(q['rms_max_diff'] for q in rs):.3e} (gate "
            f"{MESH_RMS_ATOL})")
        log(f"  zc at the shard shapes {[q['zc']['shape'] for q in rs]}: "
            f"equal to its plain version {[q['zc']['equal'] for q in rs]} "
            f"(tol 0); refine on slabs of {[q['refine']['frames'] for q in rs]}"
            f" frames ({[q['refine']['pairs'] for q in rs]} active pairs): "
            f"max abs err / max |sum| "
            f"{max(q['refine']['err'] / q['refine']['scale'] for q in rs):.2e}"
            f" (tol {REFINE_REL})")
        log(f"  wall per batch (host clock, ranks sharing one card: the "
            f"mesh code's overhead, not scaling), medians of 5 in turns "
            f"single/mesh/mesh/single, per rank: "
            + "; ".join(f"r{i} single {[round(w, 1) for w in q['walls']['single']]}"
                        f" mesh {[round(w, 1) for w in q['walls']['mesh']]}"
                        for i, q in enumerate(rs))
            + f" ms; host syncs per batch {[q['syncs'] for q in rs]}  "
            f"[{card}]")
        for q in rs:
            if (q["ovf"] or not q["finite"] or not q["voicing_same"]
                    or q["f0_max_diff"] > MESH_F0_ATOL
                    or q["rms_max_diff"] > MESH_RMS_ATOL
                    or not q["zc"]["equal"]
                    or q["refine"]["err"] > REFINE_REL * q["refine"]["scale"]
                    or any(q["launches"].get(k, 0) != 1
                           for k in MAIN_KERNELS)):
                fails.append(f"mesh {lay} rank {rs.index(q)}: {q}")
    deg = [q["degraded_3x1"] for q in res]
    f64 = [q["f64"] for q in res]
    log(f"11(b) make_mesh(3, 1) on {MESH_RANKS} ranks: {deg}; float64 "
        f"batch_copy_synthesis on t22 x{MESH_F64_REPS} under (2, 2): max "
        f"relative error of y, spec, ap per rank "
        f"{[[round(q[k][1], 14) for k in ('y', 'spec', 'ap')] for q in f64]}"
        f" (gate rtol {MESH_F64_RTOL}, atol {MESH_F64_ATOL}); launches "
        f"{[q['launches'] for q in f64]}; gather_rows equal "
        f"{[q['gathered_equal'] for q in f64]}; peak device memory per rank "
        f"{[round(q['peak_gib'], 3) for q in res]} GiB; rank walls "
        f"{[round(q['seconds'], 1) for q in res]} s  [{card}]")
    for q in f64:
        if (any(q[k][0] > 0 for k in ("y", "spec", "ap"))
                or q["launches"].get("wt_ola_f64", 0) < 1
                or not q["gathered_equal"]):
            fails.append(f"float64 copy-synthesis: {q}")
    if any(v != [4, 1] for v in deg):
        fails.append(f"make_mesh(3, 1) gave {deg}")

    # (c) against this process's sequential and parallel runs
    lp = LA.LongPipeline(FS, f0_floor=LONG_FLOOR,
                         chunk_frames=LONG_CHUNK_FRAMES,
                         harvest_chunk_ms=HARVEST_CHUNK_MS,
                         harvest_halo_ms=HARVEST_HALO_MS, device=dev)
    syn = dict(seed=LONG_SEED, pitch_scale=PITCH, duration_scale=DUR)
    ys, f0s = lp.copy_synthesis(x60, **syn)
    # the sequential run's pulses, from its eager loop (a replay runs no
    # Python to spy on)
    pulses = []
    real = pulse_spy(LA, pulses)
    try:
        with torch.no_grad():
            lp._sequential(lp.plan(x60, f0s, DUR), N.as_key(LONG_SEED),
                           call=PG.eager)
    finally:
        LA._pulse_table = real
    yp, _ = lp.copy_synthesis(x60, parallel=True, **syn)
    pos_s = torch.cat(pulses).numpy()
    ym = longs[0]["y"]
    same_y = all(np.array_equal(q["y"], ym) for q in longs)
    same_f0 = all(np.array_equal(q["f0"], f0s) for q in longs)
    pos_m = np.sort(np.concatenate([q["pulses"] for q in longs]))
    same_pulses = np.array_equal(pos_m, pos_s)
    rel = windowed_rel(ym, ys)
    q99, q90 = float(np.quantile(rel, 0.99)), float(np.quantile(rel, 0.9))
    lq = [q["long"] for q in res]
    log(f"11(c) LongPipeline.copy_synthesis(mesh=(2, 2)) on the first "
        f"{len(x60) / FS:.2f} s: {lq[0]['n_chunks']} chunks over "
        f"{MESH_RANKS} ranks; every rank's y equal {same_y}, F0 equal to "
        f"the sequential run's {same_f0}; {len(pos_m)} pulses, identical "
        f"to the sequential run's {same_pulses}; windowed relative error "
        f"against sequential q99 {q99:.2e} (gate {PARITY_Q99}), q90 "
        f"{q90:.2e} (gate {WINDOW_Q90}); bit-equal to parallel=True "
        f"{np.array_equal(ym, yp)} (max |d| "
        f"{float(np.abs(ym - yp).max()):.3e}); launches per rank "
        f"{[q['launches'] for q in lq]}; walls {[round(q['wall_s'], 2) for q in lq]}"
        f" s  [{card}]")
    if (not (same_y and same_f0 and same_pulses) or q99 >= PARITY_Q99
            or q90 >= WINDOW_Q90 or lq[0]["n_chunks"] != 12):
        fails.append("LongPipeline(mesh=) disagrees with the sequential "
                     "run")
    log(f"phase 11 wall: {time.perf_counter() - t_phase:.1f} s (the ranks "
        f"{ranks_s:.1f} s)")
    if fails:
        raise AssertionError("phase 11:\n" + "\n".join(fails))
    per_rank = []
    for q in res:
        c = collections.Counter(q[str((2, 2))]["launches"])
        c.update(q["f64"]["launches"])
        per_rank.append(c)
    return {k: [c.get(k, 0) for c in per_rank]
            for k in set().union(*per_rank)}


if __name__ == "__main__":
    sys.exit(main())
