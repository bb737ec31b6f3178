"""Harvest F0 refinement (stage D) for the f32 production path, with the
spectral sums in the CUDA kernel ``csrc/refine.cu``.

Port of worldtpu/ops/refine_kernel.py::refine_stage_pallas.  Torch does
the compaction (active candidates sorted ascending, near-duplicates within
``dedup_tol`` dropped, at most CAP per frame), the edge-padded frame
segments, the per-candidate window/bin parameters and the
instantaneous-frequency finishing math; the kernel (or its plain version
``spectral_sums_plain`` for CPU tensors) computes only the six-harmonic
DFT sums.  Refined candidates come back compacted (active slots lead each
frame row, zero-padded to S), as on the TPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn
from torch.profiler import record_function

from worldtpu_torch import constants as C
from worldtpu_torch import _build
from worldtpu_torch.ops.numeric import (device_cache, device_kind,
                                        matlab_round, rdiv)

CAP = 64  # refined-slot capacity per frame (observed active max ~37)

#: frames per chunk of the plain version by device (bounds its
#: [n, CAP, W] temporaries: ~40 MB per chunk on the CPU, ~1 GB on a GPU)
_PLAIN_FRAMES = {"cpu": 32, "cuda": 512}


def refine_stage(y, cand, tpos, *, geo, dedup_tol=0.0):
    """Refine candidates cand [B, F, S] against the decimated signal
    y [B, L] at frame times tpos [F].  Returns (refined, score) [B, F, S]."""
    with record_function("wt.refine_prepare"):
        prep = prepare(y, cand, tpos, geo=geo, dedup_tol=dedup_tol)
    with record_function("wt.refine_sums"):
        sums = spectral_sums(*prep["kernel_args"],
                             hwmax=geo.max_half_window, n_fft=geo.refine_fft)
    with record_function("wt.refine_finish"):
        return finish(sums, prep, geo=geo)


def prepare(y, cand, tpos, *, geo, dedup_tol=0.0):
    """Compaction, segments and per-candidate parameters.  Returns a dict
    with ``kernel_args`` (the positional inputs of ``spectral_sums``) and
    what ``finish`` needs."""
    B, F, S = cand.shape
    dt = y.dtype
    dev = y.device
    fs_a = float(geo.actual_fs)
    hwmax = geo.max_half_window
    n_fft = geo.refine_fft

    # -- compaction, ascending f0 (groups of similar window widths) --
    inf = torch.full((), math.inf, dtype=dt, device=dev)
    cand_s = torch.sort(torch.where(cand > 0.0, cand, inf), dim=-1).values
    if S < CAP:
        cand_s = Fn.pad(cand_s, (0, CAP - S), value=math.inf)
    if dedup_tol > 0.0:
        # near-duplicates (the +-3-frame overlap copies) refine to the same
        # attractor: keep one representative per dedup_tol cluster
        prev = cand_s[..., :-1]
        dup = torch.cat([torch.zeros_like(cand_s[..., :1], dtype=torch.bool),
                         (cand_s[..., 1:] - prev) <= dedup_tol * prev], -1)
        dup = dup & torch.isfinite(cand_s)
        cand_s = torch.sort(torch.where(dup, inf, cand_s), dim=-1).values
    n_active = torch.isfinite(cand_s).sum(-1).clamp(max=CAP)      # [B, F]
    cand_c = cand_s[..., :CAP]
    cand_c = torch.where(torch.isfinite(cand_c), cand_c,
                         torch.zeros((), dtype=dt, device=dev))
    valid = torch.arange(CAP, device=dev) < n_active[..., None]
    # inactive dummy = f0_ceil: finite math, narrowest window
    f0c = torch.where(valid, cand_c,
                      torch.full((), float(geo.f0_ceil), dtype=dt,
                                 device=dev))

    # -- per-candidate window and harmonic-bin parameters --
    hw = (rdiv(1.5 * fs_a, f0c) + 1.0).to(torch.int32)
    w_len = 2 * hw + 1
    fft_index = 2 + (torch.log(w_len.to(dt)) / C.LOG2).to(torch.int32)
    fft_p = torch.bitwise_left_shift(torch.ones_like(fft_index),
                                     fft_index).to(dt)
    h = torch.arange(6, device=dev)
    idx_h = matlab_round(f0c[..., None] * fft_p[..., None] / fs_a
                         * (h + 1.0))                          # [B, F, CAP, 6]
    ratio = n_fft // fft_p.to(torch.int32)
    gbin = (idx_h * ratio[..., None]).clamp(0, n_fft // 2)

    # -- frame segments (edge-replicated) and window-phase offsets --
    origin = matlab_round(tpos * fs_a + 0.001)                 # [F]
    W = 2 * hwmax + 1
    pad_lo = hwmax + 1
    ypad = Fn.pad(y[:, None, :], (pad_lo, hwmax + W),
                  mode="replicate")[:, 0]
    starts = (origin - 1 - hwmax + pad_lo).long()
    seg = ypad.unfold(-1, W, 1)[:, starts]                     # [B, F, W]
    delta = (origin - 1 - hwmax).to(dt) - tpos * fs_a          # [F]

    N = B * F
    kernel_args = (seg.reshape(N, W).contiguous(),
                   delta.expand(B, F).reshape(N).contiguous(),
                   hw.reshape(N, CAP).contiguous(),
                   gbin.to(torch.int32).reshape(N, CAP, 6).contiguous(),
                   n_active.to(torch.int32).reshape(N).contiguous())
    return dict(kernel_args=kernel_args, f0c=f0c, valid=valid, idx_h=idx_h,
                fft_p=fft_p, S=S)


def finish(sums, prep, *, geo):
    """Instantaneous-frequency finishing math (harvest.cpp:907-939) on the
    kernel's sums [B*F, CAP, 24] -> (refined, score) [B, F, S]."""
    f0c, valid, idx_h, fft_p, S = (prep[k] for k in
                                   ("f0c", "valid", "idx_h", "fft_p", "S"))
    B, F, _ = f0c.shape
    dt = f0c.dtype
    dev = f0c.device
    fs_a = float(geo.actual_fs)
    h = torch.arange(6, device=dev)
    sums = sums.reshape(B, F, CAP, 4, 6)
    sm_re, sm_im = sums[..., 0, :], sums[..., 1, :]
    sd_re, sd_im = sums[..., 2, :], sums[..., 3, :]

    n_harm = torch.clamp(rdiv(fs_a / 2.0, f0c).to(torch.int32), max=6)
    power = sm_re ** 2 + sm_im ** 2
    num_i = sm_re * sd_im - sm_im * sd_re
    base_freq = idx_h.to(dt) * fs_a / fft_p[..., None]
    zero = torch.zeros((), dtype=dt, device=dev)
    instf = torch.where(power == 0.0, zero,
                        base_freq + num_i / power * fs_a / (2.0 * C.PI))
    amp = torch.sqrt(power)
    hmask = (h < n_harm[..., None]).to(dt)
    numer = torch.sum(amp * instf * hmask, dim=-1)
    denom = torch.sum(amp * (h + 1.0) * hmask, dim=-1)
    refined = numer / (denom + C.MY_SAFE_GUARD_MINIMUM)
    dev_sum = torch.sum(torch.abs(instf / (h + 1.0) - f0c[..., None])
                        / f0c[..., None] * hmask, dim=-1)
    score = rdiv(1.0, dev_sum / n_harm.clamp(min=1)
                 + C.MY_SAFE_GUARD_MINIMUM)

    bad = ((refined < geo.f0_floor) | (refined > geo.f0_ceil)
           | (score < 2.5) | ~valid)
    refined = torch.where(bad, zero, refined)
    score = torch.where(bad, zero, score)
    if S >= CAP:
        return Fn.pad(refined, (0, S - CAP)), Fn.pad(score, (0, S - CAP))
    return refined[..., :S], score[..., :S]


@device_cache(maxsize=8)
def _twiddles(n_fft, device):
    """[2, n_fft] cos/sin of 2*pi*k/n_fft in f32 (the exactly reduced
    phases of the refine DFT), made once per size and device."""
    a = (2.0 * C.PI / n_fft) * torch.arange(n_fft, dtype=torch.float32,
                                            device=device)
    return torch.stack([torch.cos(a), torch.sin(a)]).contiguous()


def spectral_sums(seg, delta, hw, gbin, n_active, *, hwmax, n_fft):
    """Six-harmonic DFT sums per compacted candidate.

    Args:
        seg: [N, W] frame segments, W = 2*hwmax+1 (sample m of frame n is
            y[origin_n - 1 - hwmax + m], edge-replicated).
        delta: [N] window phase offset of sample 0, in samples.
        hw: [N, CAP] int32 half windows.
        gbin: [N, CAP, 6] int32 harmonic bins on the n_fft grid.
        n_active: [N] int32 count of active (leading) slots.

    Returns:
        [N, CAP, 24] float32: index c*6 + h for c in (main re, main im,
        diff re, diff im); slots at or beyond n_active are zero.
    """
    if device_kind(seg) == "cpu":
        return spectral_sums_plain(seg, delta, hw, gbin, n_active,
                                   hwmax=hwmax, n_fft=n_fft)
    return spectral_sums_cuda(seg, delta, hw, gbin, n_active,
                              hwmax=hwmax, n_fft=n_fft)


def spectral_sums_plain(seg, delta, hw, gbin, n_active, *, hwmax, n_fft):
    """Dense torch version: the full [frames, CAP, W] window slabs, in
    chunks of frames."""
    tw = _twiddles(n_fft, seg.device)
    n = _PLAIN_FRAMES[device_kind(seg)]
    out = [_plain_chunk(seg[i:i + n], delta[i:i + n], hw[i:i + n],
                        gbin[i:i + n], n_active[i:i + n], hwmax, n_fft, tw)
           for i in range(0, seg.shape[0], n)]
    return torch.cat(out, dim=0)


def _plain_chunk(seg, delta, hw, gbin, n_active, hwmax, n_fft, tw):
    n, W = seg.shape
    dev = seg.device
    hw = hw.clamp(max=hwmax)
    m = torch.arange(W, device=dev)
    wlf = (2 * hw + 1).to(torch.float32)[..., None]           # [n, CAP, 1]
    two_pi = 2.0 * C.PI

    def window(mm):
        t2 = two_pi * (mm.to(torch.float32) + delta[:, None, None]) / wlf
        c = torch.cos(t2)
        w = 0.42 + 0.5 * c + 0.08 * (2.0 * c * c - 1.0)
        inw = torch.abs(mm - hwmax) <= hw[..., None]
        return torch.where(inw, w, torch.zeros((), device=dev))

    mw = window(m)                                            # [n, CAP, W]
    dw = -(window(m + 1) - window(m - 1)) * 0.5
    dw = torch.where(torch.abs(m - hwmax) <= hw[..., None], dw,
                     torch.zeros((), device=dev))
    active = (torch.arange(hw.shape[1], device=dev)
              < n_active[:, None])[..., None]
    main = torch.where(active, seg[:, None, :] * mw, 0.0)
    diff = torch.where(active, seg[:, None, :] * dw, 0.0)
    parts = [[], [], [], []]
    for h in range(6):
        k = (gbin[..., h:h + 1].to(torch.int64) * m) % n_fft  # [n, CAP, W]
        c, s = tw[0][k], tw[1][k]
        parts[0].append(torch.sum(main * c, -1))
        parts[1].append(-torch.sum(main * s, -1))
        parts[2].append(torch.sum(diff * c, -1))
        parts[3].append(-torch.sum(diff * s, -1))
    return torch.cat([torch.stack(p, -1) for p in parts], -1)


#: shared memory the kernel may give its twiddle table (8 * n_fft bytes):
#: the H100's 227 KB per block
_TWIDDLE_BYTES = 227 * 1024


def check_refine_geometry(n_fft, W):
    """Raise ValueError unless the kernel's int32 phase reduction
    (g * m) & (n_fft - 1) is exact and its twiddle table fits: n_fft a
    power of two, (n_fft / 2) * W < 2**31 (bins g <= n_fft / 2, samples
    m < W), 8 * n_fft bytes of shared memory."""
    if n_fft < 2 or n_fft & (n_fft - 1):
        raise ValueError(f"n_fft {n_fft} is not a power of two")
    if (n_fft // 2) * W >= 2 ** 31:
        raise ValueError(f"(n_fft/2) * W = {(n_fft // 2) * W} >= 2**31")
    if 8 * n_fft > _TWIDDLE_BYTES:
        raise ValueError(f"n_fft {n_fft}: twiddle table above "
                         f"{_TWIDDLE_BYTES} bytes of shared memory")


def spectral_sums_cuda(seg, delta, hw, gbin, n_active, *, hwmax, n_fft):
    """Launch ``wt_refine_sums``: warps over the flat list of active
    (frame, slot) pairs, located through the device cumsum of n_active."""
    N, W = seg.shape
    check_refine_geometry(n_fft, W)
    _build.check_tensor(seg, "seg", torch.float32)
    if W < 2 * hwmax + 1:
        raise ValueError(f"seg width {W} < 2*hwmax+1 = {2 * hwmax + 1}")
    cap = hw.shape[1]
    dev = seg.device
    _build.check_tensor(delta, "delta", torch.float32, (N,), dev)
    _build.check_tensor(hw, "hw", torch.int32, (N, cap), dev)
    _build.check_tensor(gbin, "gbin", torch.int32, (N, cap, 6), dev)
    _build.check_tensor(n_active, "n_active", torch.int32, (N,), dev)
    tw = _twiddles(n_fft, dev)
    offs = torch.cumsum(n_active, 0, dtype=torch.int32)
    out = torch.empty((N, cap, 24), dtype=torch.float32, device=dev)
    _build.launch("wt_refine_sums", dev, seg, delta, hw, gbin, n_active, offs,
                  tw, out, N, cap, W, hwmax, n_fft)
    return out
