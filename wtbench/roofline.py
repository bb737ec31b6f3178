"""Peaks of the card and the work of the kernels whose roofline share the
benchmark reports, counted from the cell's shapes.

Peaks: NVIDIA's H100 SXM data sheet at its 700 W limit, dense, without
sparsity: 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the tensor
cores.  A card set below 700 W (``nvidia-smi``'s power.limit) reaches less.
"""

from __future__ import annotations

from wtbench.reference.analysis.harvest import HarvestGeometry
from wtbench import trace

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def bound_s(n_bytes, n_ops):
    """The least time the card takes for n_bytes and n_ops float32
    operations: the larger of the two."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_FLOP_S)


def zc_work(B, T, cfg):
    """(bytes, operations) of Harvest's zero-crossing stage on a [B, T]
    batch: the band signals [B, bands, L] read once, each band's bound
    read once, the candidates [B, bands, F] written once (float32); per
    sample two differences and four sign tests, per frame and crossing
    type the interpolation (~12 operations).  The same count whatever
    implements the stage."""
    geo = HarvestGeometry(cfg["fs"], T, f0_floor=cfg["f0_floor"],
                          f0_ceil=cfg["f0_ceil"],
                          frame_period=cfg["frame_period_ms"])
    nb, L, F = geo.n_channels, geo.y_length, geo.f0_length
    n_bytes = 4 * (B * nb * L + nb + B * nb * F)
    n_ops = B * nb * (6 * (L - 1) + 48 * F)
    return n_bytes, n_ops


#: the zc kernel's name in the trace: "void (anonymous namespace)::
#: zc_kernel<true>(float const*, ...)", one instantiation by event layout
ZC_KERNEL = "::zc_kernel<"


def zc_share(result):
    """The zc kernel's share of its roofline over a run's traced pass, in
    %: the least time of the zc work of every launch (``zc_work`` at the
    launch's batch shape) over the kernel's device time in the trace.
    Launches are matched to batches by the program's launch counter;
    without the counter, or when the trace holds another number of
    launches, there is nothing to read (None)."""
    tr, traced = result.get("trace"), result.get("traced")
    if tr is None or traced is None or not hasattr(traced, "zc"):
        return None
    seconds, n = trace.kernel_s(tr, ZC_KERNEL)
    if not n or n != sum(k for _, k in traced.zc):
        return None
    cfg, B = result["config"], result["batch_size"]
    least = sum(k * bound_s(*zc_work(B, T, cfg)) for T, k in traced.zc)
    return 100.0 * least / seconds
