"""Public facades of the port, mirroring ``worldtpu.api`` (and through it
the reference classes): option structs with the same names and defaults,
``Harvest``, ``CheapTrick``, ``D4C``, ``Synthesis``, and ``World`` for the
fused analysis / copy-synthesis path.

Differences from the JAX facades:

  - every facade takes an explicit ``device`` ("cuda", "cpu" or a
    torch.device) and computes there; nothing moves to the CPU on its own;
  - synthesis noise comes from a ``torch.Generator`` or a ``seed`` in place
    of a JAX key.  The generator's state is restored before every regrow of
    the pulse capacity, so a result depends only on the inputs and the seed;
  - ``dtype`` defaults to float32, the production path, where the JAX
    facades default to float64; ``dtype=torch.float64`` takes the parity
    path with the reference's literal semantics, on the facade's device
    (its strictly sequential steps run on the host or in one-thread
    kernels).  ``CheapTrick.compute`` and ``D4C.compute`` pass the
    reference's randn() dithers (``analysis.dither``) through to it;
  - ``CheapTrick``, ``D4C`` and ``Synthesis`` return tensors on the device;
    ``Harvest`` and ``World`` return numpy arrays, as in JAX;
  - ``Harvest`` and ``World`` take ``grid_ms``, Harvest's candidate-grid
    period (default 1, the reference's), where ``worldtpu`` reads the
    ``WORLDTPU_GRID_MS`` environment knob: k > 1 is the float32 fast mode
    (every per-frame stage on 1/k of the frames); float64 with k > 1
    raises ValueError.  It is a keyword of the facade, not a field of
    ``HarvestOption``, which mirrors the reference's struct.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from worldtpu_torch import constants as C
from worldtpu_torch.analysis import harvest as _harvest
from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
from worldtpu_torch.analysis.d4c import d4c_frames
from worldtpu_torch.ops.fftutil import (f0_floor_for_cheaptrick,
                                        fft_size_for_cheaptrick)
from worldtpu_torch.parallel import batch as _batch
from worldtpu_torch.synthesis import synthesis as _syn


@dataclasses.dataclass
class HarvestOption:
    """Reference HarvestOption (src/harvest.cpp:52-56).  The port computes
    the refine window, so ``use_cos_table`` must stay False."""
    f0_floor: float = C.FLOOR_F0
    f0_ceil: float = C.CEIL_F0
    frame_period: float = 5.0
    target_fs: float = 8000.0
    channels_in_octave: float = 40.0
    use_cos_table: bool = False


@dataclasses.dataclass
class CheapTrickOption:
    """Reference CheapTrickOption (src/cheaptrick.cpp:22-24)."""
    q1: float = -0.15
    f0_floor: float = C.FLOOR_F0
    fft_size: int = 0  # 0 = from f0_floor


@dataclasses.dataclass
class D4COption:
    """Reference D4COption (src/d4c.cpp:31-33)."""
    threshold: float = C.THRESHOLD


def _generator(generator, seed, device):
    """(generator, its starting state): the caller's generator, or a new
    one on device seeded with seed."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return generator, generator.get_state()


class Harvest:
    """F0 estimation (reference include/harvest.hpp)."""

    def __init__(self, fs: int, option: Optional[HarvestOption] = None, *,
                 device, grid_ms: int = 1):
        self.fs = fs
        self.option = option or HarvestOption()
        if self.option.use_cos_table:
            raise ValueError("use_cos_table=True is not supported by the "
                             "port (its refine window is computed)")
        _harvest.check_grid(torch.float32, grid_ms)
        self.grid_ms = grid_ms
        self.device = torch.device(device)
        self._kernels = {}

    def get_samples(self, fs: int, x_length: int,
                    frame_period: Optional[float] = None) -> int:
        fp = frame_period if frame_period is not None \
            else self.option.frame_period
        return int(1000.0 * x_length / fs / fp) + 1

    def _kernel(self, x_length: int) -> _harvest.HarvestKernel:
        if x_length not in self._kernels:
            o = self.option
            self._kernels[x_length] = _harvest.HarvestKernel(
                self.fs, x_length, f0_floor=o.f0_floor, f0_ceil=o.f0_ceil,
                frame_period=o.frame_period, target_fs=o.target_fs,
                channels_in_octave=o.channels_in_octave, device=self.device,
                grid_ms=self.grid_ms)
        return self._kernels[x_length]

    def compute(self, x, dtype=torch.float32):
        """Returns (temporal_positions [F], f0 [F]) as numpy arrays."""
        f0, tpos = self._kernel(len(x)).compute(x, dtype=dtype)
        return tpos, f0


class CheapTrick:
    """Spectral envelope (reference include/cheaptrick.hpp)."""

    def __init__(self, fs: int, option: Optional[CheapTrickOption] = None, *,
                 device):
        self.fs = fs
        self.option = option or CheapTrickOption()
        self.device = torch.device(device)
        fft = self.option.fft_size or fft_size_for_cheaptrick(
            fs, self.option.f0_floor)
        self._kernel = CheapTrickKernel(fs, fft_size=fft,
                                        f0_floor=self.option.f0_floor,
                                        q1=self.option.q1)
        self.fft_size = fft
        self.f0_floor = f0_floor_for_cheaptrick(fs, fft)

    @staticmethod
    def get_fft_size_for_cheaptrick(fs: int,
                                    f0_floor: float = C.FLOOR_F0) -> int:
        return fft_size_for_cheaptrick(fs, f0_floor)

    @staticmethod
    def get_f0_floor_for_cheaptrick(fs: int, fft_size: int) -> float:
        return f0_floor_for_cheaptrick(fs, fft_size)

    @torch.no_grad()
    def compute(self, x, temporal_positions, f0, dtype=torch.float32,
                window_dither=None, spectrum_dither=None):
        """Returns the spectrogram [F, fft_size//2+1] (power) on the
        device.  ``window_dither`` [F, 2*max_half_window+1] and
        ``spectrum_dither`` [F, K] are the float64 parity dithers of
        ``analysis.dither.cheaptrick_dither``."""
        _harvest.check_dtype(dtype)
        x, f0, tpos = (_harvest.as_tensor(v, self.device, dtype)
                       for v in (x, f0, temporal_positions))
        dither = {k: _harvest.as_tensor(v, self.device, dtype)[None]
                  for k, v in (("window_dither", window_dither),
                               ("spectrum_dither", spectrum_dither))
                  if v is not None}
        return self._kernel(x[None], f0[None], tpos, **dither)[0]


class D4C:
    """Band aperiodicity (reference include/d4c.hpp)."""

    def __init__(self, fs: int, option: Optional[D4COption] = None, *,
                 device):
        self.fs = fs
        self.option = option or D4COption()
        self.device = torch.device(device)

    @torch.no_grad()
    def compute(self, x, temporal_positions, f0, fft_size,
                dtype=torch.float32, **dithers):
        """Returns the aperiodicity [F, fft_size//2+1] on the device.
        ``dithers``: the float64 parity dithers ``lt_dither``,
        ``c1_dither``, ``c2_dither``, ``h_dither`` of ``analysis.dither``,
        one row per frame."""
        _harvest.check_dtype(dtype)
        x, f0, tpos = (_harvest.as_tensor(v, self.device, dtype)
                       for v in (x, f0, temporal_positions))
        dithers = {k: _harvest.as_tensor(v, self.device, dtype)[None]
                   for k, v in dithers.items() if v is not None}
        return d4c_frames(x[None], f0[None], tpos, fs=self.fs,
                          fft_size_out=fft_size,
                          threshold=self.option.threshold, **dithers)[0]


class Synthesis:
    """Waveform synthesis (reference include/synthesis.hpp)."""

    def __init__(self, fs: int, fft_size: int, frame_period: float,
                 f0_ceil: float = C.CEIL_F0, *, device):
        self.fs = fs
        self.fft_size = fft_size
        self.frame_period = frame_period      # milliseconds, like the ctor
        self.f0_ceil = f0_ceil
        self.device = torch.device(device)

    @torch.no_grad()
    def compute(self, f0, spectrogram, aperiodicity, out_length, *, seed=0,
                generator=None, noise=None, dtype=torch.float32,
                max_pulses=None):
        """Returns y [out_length] on the device.

        Noise: standard normal rows from ``generator`` (default a new one
        seeded with ``seed``), or an explicit [max_pulses, fft_size] array
        (for float64 parity with the reference: ``synthesis.parity_noise``).
        A pulse count above the capacity regrows it (doubling, up to the
        reference's bound) with the generator restored to its starting
        state; with explicit noise it raises OverflowError instead."""
        _harvest.check_dtype(dtype)
        d = self.device
        caller_noise = noise is not None
        if caller_noise:
            noise = _harvest.as_tensor(noise, d, dtype)
            if max_pulses is None:
                max_pulses = noise.shape[0]
            if tuple(noise.shape) != (max_pulses, self.fft_size):
                raise ValueError(f"noise shape {tuple(noise.shape)} != "
                                 f"{(max_pulses, self.fft_size)}")
        f0_np = np.asarray(f0.cpu() if isinstance(f0, torch.Tensor) else f0,
                           np.float64)
        if max_pulses is None:
            max_pulses = _syn.estimate_max_pulses(f0_np, self.fs,
                                                  self.fft_size, out_length)
        hard = _syn.default_max_pulses(
            out_length, self.fs, f0_ceil=max(self.f0_ceil,
                                             float(np.max(f0_np))))
        gen, state = _generator(generator, seed, d)
        f0_t, sp, ap = (_harvest.as_tensor(v, d, dtype)
                        for v in (f0, spectrogram, aperiodicity))
        while True:
            if not caller_noise:
                gen.set_state(state)
                noise = _syn.make_noise(gen, 1, max_pulses, self.fft_size,
                                        dtype=dtype, device=d)[0]
            y, overflowed = _syn.synthesis_frames(
                f0_t, sp, ap, noise, fs=self.fs, fft_size=self.fft_size,
                frame_period_s=self.frame_period / 1000.0,
                out_length=out_length, max_pulses=max_pulses,
                return_overflow=True)
            if not bool(overflowed):
                return y
            if max_pulses >= hard or caller_noise:
                raise OverflowError(
                    f"pulse count exceeds max_pulses={max_pulses} (hard "
                    f"bound {hard}); pass a larger max_pulses")
            max_pulses = min(hard, max_pulses * 2)


class World:
    """The reference demo's workflow (Harvest -> CheapTrick -> D4C
    [-> Synthesis]) as one batched call per utterance (parallel.batch); in
    float32 F0 never leaves the device.  ``grid_ms``: Harvest's
    candidate-grid period (see ``Harvest``)."""

    def __init__(self, fs: int, *, frame_period: float = 5.0,
                 f0_floor: float = C.FLOOR_F0, f0_ceil: float = C.CEIL_F0,
                 device, grid_ms: int = 1):
        self.fs = fs
        self.frame_period = frame_period
        self.f0_floor = f0_floor
        self.f0_ceil = f0_ceil
        self.device = torch.device(device)
        # CheapTrick keeps its default floor whatever the Harvest floor,
        # as the reference demo does
        self._cheaptrick = CheapTrick(fs, device=device)
        self.fft_size = self._cheaptrick.fft_size
        self._harvest = Harvest(fs, HarvestOption(
            f0_floor=f0_floor, f0_ceil=f0_ceil, frame_period=frame_period),
            device=device, grid_ms=grid_ms)
        self.grid_ms = grid_ms

    def analyze(self, x, pitch_scale: float = 1.0, dtype=torch.float32):
        """wav -> (temporal_positions, f0, spectrogram, aperiodicity) as
        numpy arrays."""
        _harvest.check_dtype(dtype)
        hk = self._harvest._kernel(len(x))
        ck = self._cheaptrick._kernel
        f0, spec, ap = _batch.batch_analyze(
            _harvest.as_tensor(x, self.device, dtype)[None], geo=hk.geo,
            fs=self.fs,
            fft_size=self.fft_size, max_half_window=ck.max_half_window,
            pitch_scale=pitch_scale, grid_ms=self.grid_ms)
        tpos = np.arange(f0.shape[1]) * (self.frame_period / 1000.0)
        return (tpos, f0[0].cpu().numpy(), spec[0].cpu().numpy(),
                ap[0].cpu().numpy())

    def copy_synthesis(self, x, *, pitch_scale: float = 1.0,
                       duration_scale: float = 1.0, seed=0, generator=None,
                       dtype=torch.float32):
        """wav -> (y, f0) as numpy arrays: analysis and resynthesis with
        optional pitch and duration modification.  The pulse capacity
        starts at the static bound and doubles on overflow up to the
        reference's bound, the noise generator restored each time."""
        _harvest.check_dtype(dtype)
        hk = self._harvest._kernel(len(x))
        ck = self._cheaptrick._kernel
        F = hk.get_samples()
        fp_s = self.frame_period / 1000.0 * duration_scale
        out_length = int((F - 1) * fp_s * self.fs) + 1
        mp = _syn.capacity_max_pulses(out_length, self.fs)
        hard = _syn.default_max_pulses(out_length, self.fs,
                                       f0_ceil=self.f0_ceil * pitch_scale)
        gen, state = _generator(generator, seed, self.device)
        xb = _harvest.as_tensor(x, self.device, dtype)[None]
        while True:
            gen.set_state(state)
            noise = _syn.make_noise(gen, 1, mp, self.fft_size, dtype=dtype,
                                    device=self.device)
            y, f0, ovf = _batch.batch_wav_to_wav(
                xb, noise, geo=hk.geo, fs=self.fs, fft_size=self.fft_size,
                max_half_window=ck.max_half_window, frame_period_s=fp_s,
                out_length=out_length, max_pulses=mp,
                pitch_scale=pitch_scale, return_overflow=True,
                grid_ms=self.grid_ms)
            if not bool(ovf[0]):
                return y[0].cpu().numpy(), f0[0].cpu().numpy()
            if mp >= hard:
                raise OverflowError(
                    f"pulse count exceeds max_pulses={mp} (hard bound "
                    f"{hard}); pass a larger pitch-scaled capacity")
            mp = min(hard, mp * 2)
