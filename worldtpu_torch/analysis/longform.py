"""Long-audio Harvest: overlap-save chunking of the F0 pipeline.

Port of worldtpu/analysis/longform.py.  The single-utterance Harvest
geometry is static in the input length, and the contour chain's plain
versions lay its sections out as [sections, F], so their memory grows as
F^2 on a long recording.  Here the signal is cut into fixed windows
(chunk + a halo on each side), batches of windows run the device stages
(decimate -> band candidates -> refine -> prune: the zc and refine kernels
on the card) at ONE geometry, the per-frame candidate and score rows are
stitched on the 1 ms grid at chunk boundaries, and one contour chain runs
over the whole recording (host ranges ``wt.long.harvest`` and
``wt.long.contour``).  Where the chain runs follows the input: float32 on
the card stitches the rows into two [F, S] tensors on the device and runs
the device chain (``contour_device.contour_grid``: the extend, merge and
smoothing kernels, whose memory is linear in F) under the ``contour``
stage's marks, then downloads the 1 ms F0 and picks the frame period's
frames on the host, as the host chain does; every other input (float64, and
every CPU tensor) stitches the rows on the host (in pinned memory when the
windows run on the card) and runs the host chain (``analysis.contour``) on
them in float64, as ``worldtpu``'s LongHarvest does.  One stitching
serves both, the route naming where its rows go.  Every
stage has finite temporal support (decimation IIR decay, filter taps,
zero-crossing intervals <= 1/f0_floor, refine windows <= 3/f0_floor, +-1
frame pruning), so a ~1 s halo reproduces interior frames to float32
noise.  float64 runs the parity path's stages (``harvest._stages_f64``:
the circular-FFT band filter, dense zero crossings, the dense refine; no
kernel) on each batch of windows with mean 0, as ``worldtpu``'s float64
LongHarvest does.

Chunk boundaries sit on a grid where the sample index and the decimation
grid align (u ms with fs*u/1000 an integer divisible by the decimation
ratio), so each chunk's decimated samples coincide with the whole-signal
decimation away from its edges.
"""

from __future__ import annotations

import numpy as np
import torch

from worldtpu_torch import constants as C
from worldtpu_torch.analysis import contour, contour_device
from worldtpu_torch.analysis.harvest import (
    HarvestGeometry, as_tensor, check_dtype, harvest_device_stages)
from worldtpu_torch.ops.contour_kernel import LAG, smooth_chunk
from worldtpu_torch.tracing import long_span, stage

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
    input length.  float32 on the card keeps the recording's stitched
    candidate rows and the device chain's [F] rows there: its device
    memory grows with the recording (about 1.1 MB a second of audio, so
    an 80 GB card holds about 20 h: PERF.md, section 7), and the
    smoothing kernel takes up to about 27 h (``compute`` refuses a longer
    recording before its stages run).  Every other route holds
    O(max_batch chunks) on the device."""

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
        MAX_BATCH of the dtype).

        float32 on a CUDA device keeps the candidates on the card and runs
        the device contour chain there; float64, and any input on the CPU,
        runs the host chain.  On the card a recording whose padded 1 ms
        contour is past the smoothing kernel's longest (about 98 million
        frames, 27 h: ``contour_kernel.smooth_chunk``) raises ValueError
        before any stage runs."""
        n = int(x.shape[0])
        check_dtype(dtype)
        batch = max_batch or MAX_BATCH[dtype]
        on_card = dtype == torch.float32 and self.device.type == "cuda"
        if on_card:
            f_total = self.n_chunks(n) * self.chunk_ms + 1
            smooth_chunk(f_total + 2 * LAG)
        with long_span("harvest"):
            cand, score = self._stitched(
                x, dtype, batch, self.device if on_card
                else torch.device("cpu"))
        with long_span("contour"):
            if on_card:
                return self._contour_on_card(cand, score, n)
            return self._contour(cand, score, n)

    def _kept(self, k, f_total):
        """(global start, local start, global end) of the 1 ms frames
        window k contributes: chunk 0 keeps global frames
        [0, chunk_ms + halo_ms), chunk k keeps
        [k*chunk_ms + halo_ms, (k+1)*chunk_ms + halo_ms), both clipped to
        f_total."""
        if k == 0:
            glo, llo = 0, 0
        else:
            glo = k * self.chunk_ms + self.halo_ms
            llo = 2 * self.halo_ms
        return glo, llo, min((k + 1) * self.chunk_ms + self.halo_ms,
                             f_total)

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

    def _stitched(self, x, dtype, max_batch, into):
        """The stitched 1 ms (candidates, scores) [F_total, S] in ``dtype``
        on the device ``into``: each batch of windows runs its device
        stages where the windows lie, and its kept frame ranges are copied
        in.  Nothing waits for the device until every batch is enqueued:
        on the card batch k+1's stages queue behind batch k's copies.  Rows
        on the host filled from the card are pinned, copied into without
        blocking and waited for once at the end, so the card holds
        O(max_batch windows)."""
        xp, starts = self._windows(x, dtype)
        n_chunks = len(starts)
        F_total = n_chunks * self.chunk_ms + 1
        pin = into.type == "cpu" and xp.device.type != "cpu"
        # the kept ranges tile [0, F_total), so every row is written
        cand, score = (torch.empty(
            (F_total, self.geo.max_candidates), dtype=dtype, device=into,
            pin_memory=pin) for _ in range(2))

        def place(b0, c, sc):
            for i in range(c.shape[0]):
                glo, llo, ghi = self._kept(b0 + i, F_total)
                cand[glo:ghi].copy_(c[i, llo:llo + ghi - glo],
                                    non_blocking=True)
                score[glo:ghi].copy_(sc[i, llo:llo + ghi - glo],
                                     non_blocking=True)

        with torch.no_grad():
            for b0 in range(0, n_chunks, max_batch):
                xb = torch.stack([xp[s:s + self.Tc]
                                  for s in starts[b0:b0 + max_batch]])
                place(b0, *harvest_device_stages(xb, geo=self.geo))
        if pin:
            torch.cuda.current_stream(xp.device).synchronize()
        return cand, score

    def _contour_on_card(self, cand, score, n):
        """The device contour chain over the stitched tensors [F_total, S]
        under the ``contour`` stage, its 1 ms F0 downloaded once, and the
        host chain's pick of the frame period: (f0 [n_out], tpos [n_out])
        float64 numpy."""
        with torch.no_grad(), stage("contour", cand.device):
            f0_1ms = contour_device.contour_grid(cand[None], score[None],
                                                 grid_ms=1)[0]
        return self._pick(f0_1ms.cpu().numpy().astype(np.float64), n)

    def _contour(self, cand, score, n):
        """The host contour over the stitched CPU tensors [F_total, S], in
        float64, and the pick of the frame period: (f0 [n_out],
        tpos [n_out]) float64 numpy."""
        best = contour.fix_f0_contour(cand.double().numpy(),
                                      score.double().numpy())
        return self._pick(contour.smooth_f0_contour(best), n)

    def _pick(self, f0_1ms, n):
        """The nearest 1 ms frame of each frame period's time, in float64
        (exact at any length): (f0 [n_out], tpos [n_out])."""
        n_out = 1 + int(1000.0 * n / self.fs / self.frame_period)
        tpos = np.arange(n_out) * self.frame_period / 1000.0
        pick = np.minimum(len(f0_1ms) - 1, _matlab_round_np(tpos * 1000.0))
        return f0_1ms[pick], tpos
