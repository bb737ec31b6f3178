"""Command-line interface of the port: analyze / synthesize / copy-syn.

The flags of ``worldtpu.cli`` (the reference demo's workflow, wav ->
Harvest -> CheapTrick -> D4C -> [F0 scale / formant warp] -> Synthesis ->
wav, with byte-compatible parameter files), with ``--device`` in place of
``--platform``:

    python -m worldtpu_torch.cli copy-syn in.wav out.wav --f32 [--fused]
    python -m worldtpu_torch.cli analyze in.wav prefix --f32
    python -m worldtpu_torch.cli synthesize prefix out.wav --f32

``--device`` is ``cuda`` by default and the CLI raises when no CUDA device
is present rather than running on the CPU; ``--device cpu`` runs the plain
PyTorch versions of the kernels.  Only the float32 path is ported: without
``--f32`` (or ``--fused``, which implies it) the CLI raises
NotImplementedError.  Files go through the numpy-only ``worldtpu.io.wav``,
``worldtpu.io.params`` and ``worldtpu.metrics``, which import no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys
import time

import numpy as np
import torch


class _Run:
    """Per-invocation state: the device, and the metrics recorder when
    --metrics-json is given."""

    def __init__(self, device, metrics):
        self.device = device
        self.metrics = metrics

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, label, fn, *args, stage=None, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.sync()
        dt = time.perf_counter() - t0
        print(f"\t {label}:\t{dt * 1000:.3f} [msec]")
        if self.metrics is not None and stage:
            self.metrics.add(stage, dt)
        return out


def _analyze(run, x, fs, frame_period, f0_floor, dtype):
    from worldtpu_torch import api

    print("\nF0 estimation (Harvest)")
    t0 = time.perf_counter()
    harvest = api.Harvest(fs, api.HarvestOption(frame_period=frame_period,
                                                f0_floor=f0_floor),
                          device=run.device)
    harvest._kernel(len(x))
    print(f"\t initialize:\t{(time.perf_counter() - t0) * 1000:.3f} [msec]")
    tpos, f0 = run.timed("compute", harvest.compute, x, dtype=dtype,
                         stage="harvest")

    print("\nSpectral envelope estimation (CheapTrick)")
    t0 = time.perf_counter()
    cheaptrick = api.CheapTrick(fs, device=run.device)
    print(f"\t initialize:\t{(time.perf_counter() - t0) * 1000:.3f} [msec]")
    spec = run.timed("compute", cheaptrick.compute, x, tpos, f0, dtype=dtype,
                     stage="cheaptrick")

    print("\nAperiodicity estimation (D4C)")
    t0 = time.perf_counter()
    d4c = api.D4C(fs, device=run.device)
    print(f"\t initialize:\t{(time.perf_counter() - t0) * 1000:.3f} [msec]")
    ap = run.timed("compute", d4c.compute, x, tpos, f0,
                   cheaptrick.fft_size, dtype=dtype, stage="d4c")
    return (tpos, f0, spec.cpu().numpy(), ap.cpu().numpy(),
            cheaptrick.fft_size)


def _modify(run, f0, spec, fs, fft_size, f0_scale, formant_scale):
    """Reference ParameterModification (test/test.cpp:201-243): F0 scale
    and formant warp of the spectral envelope."""
    from worldtpu_torch.ops.interp import interp1
    f0 = f0 * f0_scale
    if formant_scale == 1.0:
        return f0, spec
    k = fft_size // 2 + 1
    freq1 = torch.as_tensor(formant_scale * np.arange(k) / fft_size * fs,
                            dtype=torch.float32, device=run.device)
    freq2 = torch.as_tensor(np.arange(k) / fft_size * fs,
                            dtype=torch.float32, device=run.device)
    logsp = torch.log(torch.as_tensor(spec, dtype=torch.float32,
                                      device=run.device))
    out = torch.exp(interp1(freq1, logsp, freq2)).cpu().numpy()
    if formant_scale < 1.0:
        cut = int(fft_size / 2.0 * formant_scale)
        out[:, cut:] = out[:, cut - 1:cut]
    return f0, out


def _synthesize(run, f0, spec, ap, fs, fft_size, frame_period, dtype,
                seed=0):
    from worldtpu_torch import api
    print("\nSynthesis")
    out_length = int((len(f0) - 1) * frame_period / 1000.0 * fs) + 1
    t0 = time.perf_counter()
    syn = api.Synthesis(fs, fft_size, frame_period, device=run.device)
    print(f"\t initialize:\t{(time.perf_counter() - t0) * 1000:.3f} [msec]")
    y = run.timed("compute", syn.compute, f0, spec, ap, out_length,
                  seed=seed, dtype=dtype, stage="synthesis")
    return y.cpu().numpy()


def _run_fused(run, args, x, fs, profile_region):
    """--fused: analysis (and copy-syn resynthesis) through api.World."""
    from worldtpu.io import params, wav
    from worldtpu_torch import api

    world = api.World(fs, frame_period=args.frame_period,
                      f0_floor=args.f0_floor, device=run.device)
    t0 = time.perf_counter()
    with profile_region():
        if args.command == "analyze" or args.formant_scale != 1.0:
            tpos, f0, spec, ap = world.analyze(x, pitch_scale=args.f0_scale)
            if args.command == "analyze":
                print(f"\nfused analyze:\t"
                      f"{(time.perf_counter() - t0) * 1000:.3f} [msec]")
                params.write_f0(args.output + ".f0", f0, args.frame_period)
                params.write_spectral_envelope(
                    args.output + ".spec", spec, fs, args.frame_period,
                    world.fft_size)
                params.write_aperiodicity(
                    args.output + ".ap", ap, fs, args.frame_period,
                    world.fft_size)
                print(f"wrote {args.output}.{{f0,spec,ap}}")
                return 0
            # the formant warp works on the spectra: warp, then synthesize
            f0, spec = _modify(run, f0, spec, fs, world.fft_size, 1.0,
                               args.formant_scale)
            y = _synthesize(run, f0, spec, ap, fs, world.fft_size,
                            args.frame_period, torch.float32, args.seed)
        else:
            y, f0 = world.copy_synthesis(x, pitch_scale=args.f0_scale,
                                         seed=args.seed)
    print(f"\nfused copy-syn:\t{(time.perf_counter() - t0) * 1000:.3f} "
          f"[msec]")
    wav.wavwrite(args.output, y, fs)
    print(f"wrote {args.output}")
    return 0


def _parser():
    p = argparse.ArgumentParser(prog="worldtpu_torch")
    p.add_argument("command", choices=["analyze", "synthesize", "copy-syn"])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--frame-period", type=float, default=5.0)
    p.add_argument("--f0-floor", type=float, default=40.0,
                   help="Harvest f0 floor (the reference demo uses 40)")
    p.add_argument("--f0-scale", type=float, default=1.0)
    p.add_argument("--formant-scale", type=float, default=1.0)
    p.add_argument("--f32", action="store_true",
                   help="float32 compute (the only path ported; without "
                        "it the float64 path raises NotImplementedError)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="compute device (default cuda; raises without a "
                        "CUDA device)")
    p.add_argument("--seed", type=int, default=0,
                   help="synthesis noise seed (torch.Generator)")
    p.add_argument("--metrics-json", default=None,
                   help="write per-stage structured metrics (wall_s, rtf, "
                        "frames) as one JSON document to this path")
    p.add_argument("--fused", action="store_true",
                   help="analysis (and copy-syn resynthesis) in one call "
                        "per utterance (api.World) instead of per-stage "
                        "calls; implies --f32, prints one combined timing")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (CPU and CUDA "
                        "activities, Chrome trace format) of the compute "
                        "region to DIR/trace.json")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    device = torch.device(args.device)
    if not (args.f32 or args.fused):
        from worldtpu_torch.analysis.harvest import F64_NOT_PORTED
        raise NotImplementedError(F64_NOT_PORTED)
    dtype = torch.float32

    from worldtpu.io import params, wav

    metrics = None
    if args.metrics_json:
        from worldtpu.metrics import MetricsRecorder
        metrics = MetricsRecorder()
    run = _Run(device, metrics)

    @contextlib.contextmanager
    def profile_region():
        if not args.profile:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
            run.sync()
        out = pathlib.Path(args.profile)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        print(f"wrote torch.profiler trace to {out / 'trace.json'}")

    if args.command in ("analyze", "copy-syn"):
        x, fs, nbit = wav.wavread(args.input)
        print("File information")
        print(f"Sampling : {fs} [Hz] {nbit} [Bit]")
        print(f"Length {len(x)} [sample]")
        print(f"Length {len(x) / fs} [sec]")
        if args.fused:
            return _run_fused(run, args, x, fs, profile_region)
        with profile_region():
            tpos, f0, spec, ap, fft_size = _analyze(
                run, x, fs, args.frame_period, args.f0_floor, dtype)
            if args.command == "copy-syn":
                f0, spec = _modify(run, f0, spec, fs, fft_size,
                                   args.f0_scale, args.formant_scale)
                y = _synthesize(run, f0, spec, ap, fs, fft_size,
                                args.frame_period, dtype, args.seed)
        if args.command == "analyze":
            params.write_f0(args.output + ".f0", f0, args.frame_period)
            params.write_spectral_envelope(
                args.output + ".spec", spec, fs, args.frame_period, fft_size)
            params.write_aperiodicity(
                args.output + ".ap", ap, fs, args.frame_period, fft_size)
            print(f"\nwrote {args.output}.{{f0,spec,ap}}")
            return 0
        wav.wavwrite(args.output, y, fs)
        print(f"\nwrote {args.output}")
        if metrics is not None:
            metrics.audio_s = len(x) / fs
            for m in metrics.entries:
                m.audio_s = metrics.audio_s
                m.frames = len(f0)
            metrics.emit_json(args.metrics_json)
            print(f"wrote {args.metrics_json}")
        return 0

    # synthesize from parameter files
    f0, tpos, fp = params.read_f0(args.input + ".f0")
    spec, meta = params.read_spectral_envelope(args.input + ".spec")
    ap, _ = params.read_aperiodicity(args.input + ".ap")
    fs, fft_size = meta["fs"], meta["fft_size"]
    with profile_region():
        f0, spec = _modify(run, f0, spec, fs, fft_size,
                           args.f0_scale, args.formant_scale)
        y = _synthesize(run, f0, spec, ap, fs, fft_size, fp, dtype,
                        args.seed)
    wav.wavwrite(args.output, y, fs)
    print(f"\nwrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
