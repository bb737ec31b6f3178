"""Long-audio Harvest: overlap-save chunking of the F0 pipeline.

Port of worldtpu/analysis/longform.py.  The single-utterance Harvest
geometry is static in the input length, and the device contour chain lays
its sections out as [F/7, F], so memory grows as F^2 on a long recording.
Here the signal is cut into fixed windows (chunk + a halo on each side),
batches of windows run the device stages (decimate -> band candidates ->
refine -> prune: the zc and refine kernels on the card) at ONE geometry,
the per-frame candidate and score rows are stitched on the 1 ms grid at
chunk boundaries, and the host contour (``analysis.contour``) runs once
over the whole recording.  Every stage has finite temporal support
(decimation IIR decay, filter taps, zero-crossing intervals <= 1/f0_floor,
refine windows <= 3/f0_floor, +-1 frame pruning), so a ~1 s halo
reproduces interior frames to float32 noise.  float64 runs the parity
path's stages (``harvest._stages_f64``: the circular-FFT band filter, dense
zero crossings, the dense refine; no kernel) on each batch of windows with
mean 0, as ``worldtpu``'s float64 LongHarvest does.

Chunk boundaries sit on a grid where the sample index and the decimation
grid align (u ms with fs*u/1000 an integer divisible by the decimation
ratio), so each chunk's decimated samples coincide with the whole-signal
decimation away from its edges.
"""

from __future__ import annotations

import numpy as np
import torch

from worldtpu_torch import constants as C
from worldtpu_torch.analysis import contour
from worldtpu_torch.analysis.harvest import (
    HarvestGeometry, as_tensor, check_dtype, harvest_device_stages)

#: windows per batch of device stages, by dtype.  float32: 16 windows of
#: 10 s at 22.05 kHz peak at 9-12 GiB on an H100 (PERF.md, section 5).
#: float64: one such window takes 2.43 GiB on an H100 (the float64 pruning
#: compares every pair of the 126 slots of its 10,001 frames) and a batch
#: grows linearly with its windows, so 4 (9.72 GiB) stay near the float32
#: batch's peak
MAX_BATCH = {torch.float32: 16, torch.float64: 4}


def _grid_unit_ms(fs, ratio):
    """Smallest unit u (ms) such that u ms is an integer sample count
    divisible by the decimation ratio."""
    for u in (1, 2, 4, 5, 8, 10, 20, 25, 40, 50, 100, 125, 200, 250, 500,
              1000):
        s = fs * u
        if s % 1000 == 0 and (s // 1000) % ratio == 0:
            return u
    raise ValueError(f"no chunk grid for fs={fs}, ratio={ratio}")


def _matlab_round_np(x):
    return np.where(x > 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(int)


class LongHarvest:
    """Chunked Harvest for arbitrarily long single utterances, on
    ``device``.  One geometry (chunk_ms + 2*halo_ms of audio) serves any
    input length; device memory is O(max_batch chunks), not O(recording)."""

    def __init__(self, fs, *, chunk_ms=8000, halo_ms=1000, frame_period=5.0,
                 f0_floor=C.FLOOR_F0, f0_ceil=C.CEIL_F0,
                 channels_in_octave=40.0, device):
        ratio = max(1, min(12, int(fs / 8000.0 + 0.5)))
        u = _grid_unit_ms(fs, ratio)
        self.chunk_ms = ((chunk_ms + u - 1) // u) * u
        self.halo_ms = ((halo_ms + u - 1) // u) * u
        self.fs = fs
        self.frame_period = frame_period
        tc_ms = self.chunk_ms + 2 * self.halo_ms
        self.Tc = tc_ms * fs // 1000
        self.stride = self.chunk_ms * fs // 1000
        self.halo_samples = self.halo_ms * fs // 1000
        self.device = torch.device(device)
        # the 1 ms candidate grid is the geometry's (grid_ms 1): chunk
        # stitching joins frame ranges on the reference grid
        self.geo = HarvestGeometry(
            fs, self.Tc, f0_floor=f0_floor, f0_ceil=f0_ceil,
            frame_period=frame_period,
            channels_in_octave=channels_in_octave)

    def n_chunks(self, n):
        return max(1, -(-n // self.stride))

    def compute(self, x, dtype=torch.float32, max_batch=None):
        """F0 for one long utterance x [n] (numpy or tensor) in ``dtype``
        (float32, or float64: the parity path's stages).  Returns
        (f0 [n_out], tpos [n_out]) as float64 numpy, with
        n_out = 1 + 1000*n/fs/frame_period, like HarvestKernel.compute.
        ``max_batch``: windows per batch of device stages (default
        MAX_BATCH of the dtype)."""
        n = int(x.shape[0])
        check_dtype(dtype)
        cand, score = self._candidates(x, dtype,
                                       max_batch or MAX_BATCH[dtype])
        return self._contour(cand, score, n)

    def _windows(self, x, dtype):
        """(the zero-padded signal on the device, each window's start)."""
        n = int(x.shape[0])
        n_chunks = self.n_chunks(n)
        P = n_chunks * self.stride
        # chunk 0 has no left halo, so its window alone needs Tc samples;
        # later windows end at P + halo
        xd = as_tensor(x, self.device, dtype)
        xp = torch.zeros(max(self.Tc, P + self.halo_samples), dtype=dtype,
                         device=self.device)
        xp[:n] = xd
        # chunk k window: k=0 -> [0, Tc); k>=1 -> [k*stride - halo, +Tc)
        starts = [0] + [k * self.stride - self.halo_samples
                        for k in range(1, n_chunks)]
        return xp, starts

    def _candidates(self, x, dtype, max_batch):
        """The stitched 1 ms (candidates, scores) [F_total, S] (float64
        numpy) of the whole recording.  Batch k+1's device stages are
        enqueued before batch k's download is waited on; on the card each
        batch goes to pinned memory by a non-blocking copy behind an
        event."""
        xp, starts = self._windows(x, dtype)
        g = self.geo
        n_chunks = len(starts)
        S = g.max_candidates
        F_total = n_chunks * self.chunk_ms + 1
        c_all = np.zeros((F_total, S))
        s_all = np.zeros((F_total, S))

        def land(b0, finish):
            cand, score = finish()
            # stitch kept frame ranges: chunk 0 keeps global 1-ms frames
            # [0, chunk_ms + halo_ms), chunk k keeps
            # [k*chunk_ms + halo_ms, (k+1)*chunk_ms + halo_ms)
            for i in range(len(cand)):
                k = b0 + i
                if k == 0:
                    glo, llo = 0, 0
                else:
                    glo = k * self.chunk_ms + self.halo_ms
                    llo = 2 * self.halo_ms
                ghi = min((k + 1) * self.chunk_ms + self.halo_ms, F_total)
                c_all[glo:ghi] = cand[i, llo:llo + ghi - glo]
                s_all[glo:ghi] = score[i, llo:llo + ghi - glo]

        mean = torch.zeros((max_batch,), dtype=dtype, device=self.device)
        pending = None
        for b0 in range(0, n_chunks, max_batch):
            rows = starts[b0:b0 + max_batch]
            xb = torch.stack([xp[s:s + self.Tc] for s in rows])
            queued = (b0, self._enqueue(xb, mean[:len(rows)], g))
            if pending is not None:
                land(*pending)
            pending = queued
        land(*pending)
        return c_all, s_all

    def _enqueue(self, xb, mean, geo):
        """Start the device stages of the windows xb [B, Tc]; returns a
        function that waits for them and gives (cand, score) [B, F, S] as
        numpy."""
        with torch.no_grad():
            out = harvest_device_stages(xb, mean, geo=geo)
        done = None
        if xb.device.type != "cpu":
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in out]
            for h, t in zip(host, out):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            out = host

        def finish():
            if done is not None:
                done.synchronize()
            return tuple(t.numpy() for t in out)
        return finish

    def _contour(self, cand, score, n):
        """The host contour over the stitched grid and the pick of the
        frame period: (f0 [n_out], tpos [n_out]) float64 numpy."""
        best = contour.fix_f0_contour(cand, score)
        f0_1ms = contour.smooth_f0_contour(best)
        n_out = 1 + int(1000.0 * n / self.fs / self.frame_period)
        tpos = np.arange(n_out) * self.frame_period / 1000.0
        pick = np.minimum(len(cand) - 1, _matlab_round_np(tpos * 1000.0))
        return f0_1ms[pick], tpos
