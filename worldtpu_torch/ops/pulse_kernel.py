"""Per-pulse impulse responses of the synthesis — wrapper of the CUDA kernel
``csrc/pulse.cu`` and its plain PyTorch version.

No TPU kernel stands behind it: the JAX package leaves the pulse responses
(worldtpu/synthesis/synthesis.py ``pulse_responses``) to XLA.  As a chain
of PyTorch operations every step runs over the whole static pulse capacity
[B, P, fft] (doubled to [B, 2P, fft] for the minimum phase and the inverse
FFT) and writes its result to device memory; most of those rows are
padding that ``torch.where(valid, ...)`` zeroes at the end.  The kernel
computes a real pulse's response in shared memory from its two spectral
rows and its noise, and writes a zero row for a padded one.

A CPU tensor takes the plain version, and so does float64 on either
device: the parity path needs the literal cosine grid and the FFT
library's float64 bits that its C++ parity tests hold.  A float32 CUDA
tensor launches the kernel.
"""

from __future__ import annotations

import torch

from worldtpu_torch import _build
from worldtpu_torch import constants as C
from worldtpu_torch.ops import dft, trig
from worldtpu_torch.ops.fftutil import minimum_phase
from worldtpu_torch.ops.numeric import device_cache, device_kind

#: FFT sizes the kernel is instantiated for (``csrc/pulse.cu``)
KERNEL_FFT_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)


def dc_remover(fft_size, dtype=torch.float32, device=None):
    """Half raised-cosine DC remover normalized so the mirrored kernel sums
    to 1 (reference getDCRemover); returns the first half."""
    half = fft_size // 2
    i = torch.arange(half, dtype=dtype, device=device)
    v = 0.5 - 0.5 * torch.cos(2.0 * C.PI / (1.0 + fft_size) * (i + 1.0))
    return v / (torch.sum(v) * 2.0)


def pulse_responses(pt, shift, ns, vuv_at, valid, spectrogram, aperiodicity,
                    noise, *, fs, fft_size, frame_offset=0):
    """Per-pulse impulse responses [B, P, fft_size]; rows past ``valid``
    are zero.  The arguments are ``synthesis.pulse_responses``'."""
    dt = spectrogram.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"spectrogram: expected float32 or float64, got "
                         f"{dt}")
    kind = device_kind(spectrogram)
    tensors = dict(pt=pt, shift=shift, ns=ns, vuv_at=vuv_at, valid=valid,
                   aperiodicity=aperiodicity, noise=noise)
    if isinstance(frame_offset, torch.Tensor):
        tensors["frame_offset"] = frame_offset
    for name, t in tensors.items():
        if t.device != spectrogram.device:
            raise ValueError(f"{name}: on {t.device}, spectrogram on "
                             f"{spectrogram.device}")
    if kind == "cpu" or dt == torch.float64:
        return pulse_responses_plain(
            pt, shift, ns, vuv_at, valid, spectrogram, aperiodicity, noise,
            fs=fs, fft_size=fft_size, frame_offset=frame_offset)
    return pulse_responses_cuda(
        pt.contiguous(), shift.contiguous(), ns.contiguous(),
        vuv_at.contiguous(), valid.contiguous(), spectrogram.contiguous(),
        aperiodicity.contiguous(), noise.to(dt).contiguous(), fs=fs,
        fft_size=fft_size, frame_offset=frame_offset)


def pulse_responses_plain(pt, shift, ns, vuv_at, valid, spectrogram,
                          aperiodicity, noise, *, fs, fft_size,
                          frame_offset=0):
    """The batched chain: every step over the whole [B, P] pulse axis."""
    dt = spectrogram.dtype
    dev = spectrogram.device
    K = fft_size // 2 + 1
    half = fft_size // 2
    B, F, _ = spectrogram.shape
    P = pt.shape[1]
    off = (frame_offset[:, None] if isinstance(frame_offset, torch.Tensor)
           else frame_offset)

    # ---- per-pulse envelope / aperiodic ratio (reference :346-393) ----
    fl = (torch.floor(pt).to(torch.int32) - off).clamp(0, F - 1).long()
    ce = (torch.ceil(pt).to(torch.int32) - off).clamp(0, F - 1).long()
    w = (pt - torch.floor(pt))[..., None]
    same = (fl == ce)[..., None]

    def rows(a, i):
        return a.gather(1, i[..., None].expand(B, P, K))

    sp = torch.abs(spectrogram)
    spec = torch.where(same, rows(sp, fl),
                       (1.0 - w) * rows(sp, fl) + w * rows(sp, ce))
    apc = torch.clamp(aperiodicity, 0.001, 0.999999999999)
    ap = torch.where(same, rows(apc, fl),
                     (1.0 - w) * rows(apc, fl) + w * rows(apc, ce)) ** 2

    # ---- periodic + aperiodic responses, one batched minimum phase ----
    per_on = (vuv_at > 0.5) & (ap[..., 0] <= 0.999)
    log_per = torch.log(spec * (1.0 - ap) + C.MY_SAFE_GUARD_MINIMUM) / 2.0
    log_ap = torch.where((vuv_at != 0.0)[..., None],
                         torch.log(spec * ap) / 2.0, torch.log(spec) / 2.0)
    mp_both = minimum_phase(torch.cat([log_per, log_ap], dim=1))
    mp_per, mp_ap = mp_both[:, :P], mp_both[:, P:]

    coeff = (2.0 * C.PI * fs / fft_size) * shift
    if dt == torch.float64:      # parity path: the literal cosine grid
        re2 = torch.cos(coeff[..., None]
                        * torch.arange(K, dtype=dt, device=dev))
    else:
        # seed-and-rotate cos; the 2-term combine can overshoot |1| by an ulp
        re2 = torch.clamp(trig.cos_affine(coeff, torch.zeros_like(coeff), K),
                          -1.0, 1.0)
    im2 = torch.sqrt(1.0 - re2 * re2)  # |sin|: the reference's :452 quirk
    phase = torch.complex(re2, -im2)

    j = torch.arange(fft_size, device=dev)
    nmask = j < ns[..., None]
    nz = noise.to(dt) * nmask
    nmean = torch.sum(nz, -1, keepdim=True) / ns.clamp(min=1)[..., None]
    nz = torch.where(nmask, nz - nmean, torch.zeros((), dtype=dt, device=dev))
    nspec = dft.rfft(nz)

    both = dft.irfft(torch.cat([mp_per * phase, mp_ap * nspec], dim=1),
                     n=fft_size) * fft_size
    both = torch.roll(both, half, dims=-1)  # fftshift
    per, aper = both[:, :P], both[:, P:]
    dc = torch.sum(per[..., half:], dim=-1, keepdim=True)
    dcr = dc_remover(fft_size, dt, dev)
    per = torch.cat([-dc * dcr, per[..., half:] - dc * dcr], dim=-1)
    per = torch.where(per_on[..., None], per, torch.zeros((), dtype=dt,
                                                          device=dev))

    resp = (per * torch.sqrt(ns.to(dt))[..., None] + aper) / fft_size
    return torch.where(valid[..., None], resp, torch.zeros((), dtype=dt,
                                                           device=dev))


@device_cache(maxsize=8)
def _twiddles(fft_size, device):
    """[fft_size, 2] exp(-2 pi i m / fft_size) as (cos, sin) pairs, computed
    in float64 and rounded once to float32; made once per size and
    device."""
    a = (2.0 * C.PI / fft_size) * torch.arange(fft_size, dtype=torch.float64,
                                               device=device)
    return torch.stack([torch.cos(a), -torch.sin(a)], -1).to(
        torch.float32).contiguous()


@device_cache(maxsize=8)
def _dc_table(fft_size, device):
    """``dc_remover`` in float32 on device, made once per size."""
    return dc_remover(fft_size, torch.float32, device).contiguous()


def pulse_responses_cuda(pt, shift, ns, vuv_at, valid, spectrogram,
                         aperiodicity, noise, *, fs, fft_size,
                         frame_offset=0):
    """Launch ``wt_pulse_resp``: one block a pulse; a padded pulse's block
    writes its zero row and ends."""
    if fft_size not in KERNEL_FFT_SIZES:
        raise ValueError(f"fft_size {fft_size}: the kernel takes "
                         f"{KERNEL_FFT_SIZES}")
    _build.check_tensor(spectrogram, "spectrogram", torch.float32)
    if spectrogram.dim() != 3:
        raise ValueError(f"spectrogram: expected [B, F, K], got "
                         f"{tuple(spectrogram.shape)}")
    B, F, K = spectrogram.shape
    if K != fft_size // 2 + 1:
        raise ValueError(f"spectrogram: {K} bins, fft_size {fft_size} "
                         f"needs {fft_size // 2 + 1}")
    dev = spectrogram.device
    P = pt.shape[1] if pt.dim() == 2 else -1
    _build.check_tensor(pt, "pt", torch.float32, (B, P), dev)
    _build.check_tensor(shift, "shift", torch.float32, (B, P), dev)
    _build.check_tensor(ns, "ns", torch.int64, (B, P), dev)
    _build.check_tensor(vuv_at, "vuv_at", torch.float32, (B, P), dev)
    _build.check_tensor(valid, "valid", torch.bool, (B, P), dev)
    _build.check_tensor(aperiodicity, "aperiodicity", torch.float32,
                        (B, F, K), dev)
    _build.check_tensor(noise, "noise", torch.float32, (B, P, fft_size), dev)
    if isinstance(frame_offset, torch.Tensor):
        _build.check_tensor(frame_offset, "frame_offset", torch.int64, (B,),
                            dev)
        fo, off0 = frame_offset, 0
    else:
        fo, off0 = None, int(frame_offset)
    out = torch.empty((B, P, fft_size), dtype=torch.float32, device=dev)
    coeff = 2.0 * C.PI * fs / fft_size
    _build.launch("wt_pulse_resp", dev, pt, shift, ns, vuv_at, valid,
                  spectrogram, aperiodicity, noise, fo,
                  _twiddles(fft_size, dev), _dc_table(fft_size, dev), out,
                  B, P, F, fft_size, off0, coeff)
    return out
