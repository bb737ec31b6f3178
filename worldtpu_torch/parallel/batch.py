"""Batched entry points: copy-synthesis and the one-pass wav -> wav main
path over [B, T] padded utterances, on one device or over a ('data',
'time') mesh of ranks.

Port of worldtpu/parallel/batch.py.  Batches are padded: utterances to a
common T (zero samples) and a common F (zero = unvoiced frames); callers
slice outputs back to their true lengths.  The dtype of ``x`` selects the
path: float32 the production one, float64 the parity one
(``harvest.harvest_parity`` and the float64 branches of the analysis and
synthesis, without dither).

``mesh`` (``make_mesh``: a torch DeviceMesh named ('data', 'time'), one
rank per position; every rank of the mesh calls the function):

  data — utterances split over the 'data' ranks (no collective).
  time — inside a data shard: Harvest's band stage over a stratified band
         subset (band g on time rank g % nt), then its refinement over a
         slab of ceil(F / nt) frames; CheapTrick and D4C over F / nt
         frames.  Each stage's results are all-gathered over 'time'
         (raw candidates, refined candidates and scores, spectrogram and
         aperiodicity), and what reads neighbouring bands or frames
         (detection, the prune, the contour chain, synthesis) runs on the
         whole axis in every time rank of the data shard.

Inputs are global tensors (the same on every rank; each rank takes its
data shard's rows) or DTensors placed (Shard(0), Replicate()) on the mesh
(``distributed.process_local_batch``).  Outputs are DTensors placed
(Shard(0), Replicate()), the counterpart of JAX's NamedSharding(P("data",
None)): each rank holds its data shard's rows; ``distributed.gather_rows``
gives the global array on any backend (``DTensor.full_tensor()`` of CUDA
DTensors crashed gloo ranks, torch 2.11).  The kernels see plain
local tensors.  With one time rank the mesh path runs the single-device
stages' operations on each data shard, so a (1, 1) mesh gives the
single-device result bit for bit.

float64 under a mesh: the port's float64 Harvest is the parity path
(``harvest_parity``: the host int-truncated mean and contour), not JAX's
float64 device stages, and it runs whole on each data shard: the time
ranks of a data row compute the same F0.  CheapTrick, D4C and synthesis
shard over frames as in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn
from torch.profiler import record_function

from worldtpu_torch.analysis import harvest as _hv
from worldtpu_torch.analysis.cheaptrick import cheaptrick_frames
from worldtpu_torch.analysis.d4c import d4c_frames
from worldtpu_torch.ops import refine_kernel as _refine
from worldtpu_torch.ops import zc_kernel as _zc
from worldtpu_torch.ops.numeric import device_cache
from worldtpu_torch.parallel import graphs as _graphs
from worldtpu_torch.synthesis import synthesis as _syn

MESH_DIMS = ("data", "time")


class MeshConfigError(ValueError):
    """Requested mesh shape does not match the available ranks."""


def mesh_shape(n_ranks, n_data=None, n_time=1):
    """The (n_data, n_time) of make_mesh over n_ranks ranks: the request,
    or data-only over every rank when n_data * n_time does not cover
    them (frame-axis sharding is an optimization, data parallelism is the
    contract)."""
    if n_ranks < 1:
        raise MeshConfigError("no ranks available for mesh construction")
    if n_data is None:
        n_data = n_ranks // max(n_time, 1)
    if n_data * n_time != n_ranks:
        n_data, n_time = n_ranks, 1
    return n_data, n_time


def make_mesh(n_data=None, n_time=1, device_type=None):
    """A ('data', 'time') DeviceMesh of shape ``mesh_shape(world size,
    n_data, n_time)`` over every rank of the world, on ``device_type``
    (default: the rank's device's, ``distributed.rank_device``).  With no
    process group yet, ``distributed.init_distributed`` first makes one
    (a world of this process alone unless the environment names one), as
    JAX's make_mesh works in one process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from worldtpu_torch.parallel import distributed as _dist
    if not dist.is_available():
        raise MeshConfigError("torch.distributed is not available")
    if not dist.is_initialized():
        _dist.init_distributed(device=device_type)
    shape = mesh_shape(dist.get_world_size(), n_data, n_time)
    if device_type is None:
        device_type = _dist.rank_device().type
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_DIMS)


def _time_coords(mesh):
    """(n_time, this rank's time index) of a ('data', 'time') mesh."""
    if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
        raise ValueError(f"expected a mesh with dims {MESH_DIMS}, got "
                         f"{mesh.mesh_dim_names}")
    return mesh.size(1), mesh.get_local_rank("time")


def _local(a, mesh):
    """This rank's rows of ``a``: a DTensor's local tensor (placed (Shard
    (0), Replicate()) on a mesh of this shape), or the data shard's rows
    of a global tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(a, DTensor):
        if (tuple(a.placements) != (Shard(0), Replicate())
                or tuple(a.device_mesh.shape) != tuple(mesh.shape)):
            raise ValueError(f"expected a DTensor placed (Shard(0), "
                             f"Replicate()) on a {tuple(mesh.shape)} mesh, "
                             f"got {a.placements} on "
                             f"{tuple(a.device_mesh.shape)}")
        return a.to_local()
    nd = mesh.size(0)
    if a.shape[0] % nd:
        raise ValueError(f"batch of {a.shape[0]} does not split over "
                         f"{nd} data ranks")
    bl = a.shape[0] // nd
    d = mesh.get_local_rank("data")
    return a[d * bl:(d + 1) * bl]


def _global(t, mesh):
    """This rank's rows as the DTensor placed (Shard(0), Replicate())."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor.from_local(t, mesh, [Shard(0), Replicate()],
                              run_check=False)


def _gather_time(t, mesh, axis):
    """The shards along ``axis`` of every time rank, joined in rank order
    (t itself with one time rank)."""
    from worldtpu_torch.parallel.distributed import all_gather
    if mesh.size(1) == 1:
        return t
    return torch.cat(list(all_gather(t, mesh, "time")), dim=axis)


def batch_copy_synthesis(x, f0, tpos, noise, *, fs, fft_size,
                         max_half_window, frame_period_s, out_length,
                         max_pulses, mesh=None, return_overflow=False):
    """Analysis from given F0 (CheapTrick + D4C) and resynthesis.

    Args:
        x: [B, T] padded waveforms.
        f0: [B, F] padded F0 contours (0 = unvoiced/padding).
        tpos: [F] frame times (s).
        noise: [B, max_pulses, fft_size] synthesis noise.
        mesh: optional ('data', 'time') mesh: utterances over 'data', the
            analysis' frames over 'time' (F a multiple of its size), then
            the frame axis gathered over 'time' for the synthesis of each
            data shard.  Outputs are then DTensors.

    Returns:
        (y [B, out_length], spec [B, F, K], ap [B, F, K]); with
        ``return_overflow`` a trailing [B] bool of pulse-bound overflows.
    """
    if mesh is None:
        spec, ap = _analysis(x, f0, tpos, fs=fs, fft_size=fft_size,
                             max_half_window=max_half_window)
        y, ovf = _syn.synthesis_frames_impl(
            f0, spec, ap, noise, fs=fs, fft_size=fft_size,
            frame_period_s=frame_period_s, out_length=out_length,
            max_pulses=max_pulses, return_overflow=True)
        return (y, spec, ap, ovf) if return_overflow else (y, spec, ap)
    outs = _copy_synthesis_local(
        _local(x, mesh), _local(f0, mesh), tpos, _local(noise, mesh),
        mesh=mesh, fs=fs, fft_size=fft_size,
        max_half_window=max_half_window, frame_period_s=frame_period_s,
        out_length=out_length, max_pulses=max_pulses)
    outs = tuple(_global(o, mesh) for o in outs)
    return outs if return_overflow else outs[:3]


def _copy_synthesis_local(x, f0, tpos, noise, *, mesh, fs, fft_size,
                          max_half_window, frame_period_s, out_length,
                          max_pulses):
    """One data shard's copy-synthesis with the analysis split over the
    time ranks: (y, spec, ap, overflow) of the shard's rows."""
    nt, t = _time_coords(mesh)
    F = f0.shape[1]
    if F % nt:
        raise ValueError(f"{F} frames do not split over {nt} time ranks; "
                         f"pad F0 with unvoiced frames")
    fl = F // nt
    fr = slice(t * fl, (t + 1) * fl)
    spec, ap = _analysis(x, f0[:, fr].contiguous(), tpos[fr], fs=fs,
                         fft_size=fft_size, max_half_window=max_half_window)
    spec, ap = _gather_time(torch.stack([spec, ap]), mesh, axis=2)
    y, ovf = _syn.synthesis_frames_impl(
        f0, spec, ap, noise, fs=fs, fft_size=fft_size,
        frame_period_s=frame_period_s, out_length=out_length,
        max_pulses=max_pulses, return_overflow=True)
    return y, spec, ap, ovf


@torch.no_grad()
def batch_wav_to_wav(x, noise, *, geo, fs, fft_size, max_half_window,
                     frame_period_s, out_length, max_pulses, pitch_scale=1.0,
                     return_overflow=False, grid_ms=1, mesh=None):
    """The main path: [B, T] wavs -> Harvest F0 (float32: with the device
    contour chain) -> pitch scaling -> CheapTrick + D4C -> synthesis ->
    [B, out_length] wavs.  Duration modification is the synthesis
    frame_period_s.  ``grid_ms`` is Harvest's candidate-grid period
    (float32; ``analysis.harvest.HarvestKernel``).  ``mesh``: Harvest as
    ``batch_harvest_f0`` and the rest as ``batch_copy_synthesis`` under the
    mesh (F0 padded with unvoiced frames to a multiple of the time ranks;
    they synthesize nothing inside out_length); outputs are DTensors.
    Without a mesh, float32 CUDA input runs as a captured CUDA graph from
    the second call of a shape on (``parallel.graphs``); the mesh path runs
    eagerly.

    Returns (y, f0 [B, n_grid]), plus a [B] bool of pulse-bound overflows
    with ``return_overflow`` (size max_pulses with
    synthesis.capacity_max_pulses and check it)."""
    if mesh is None:
        return _graphs.call(
            _wav_to_wav, (x, noise), pitch_scale, geo=geo, fs=fs,
            fft_size=fft_size, max_half_window=max_half_window,
            frame_period_s=frame_period_s, out_length=out_length,
            max_pulses=max_pulses, return_overflow=return_overflow,
            grid_ms=grid_ms)
    x_l = _local(x, mesh)
    n_grid = geo.n_grid()
    f0 = _harvest_f0_local(x_l, geo, n_grid, mesh, grid_ms)
    f0 = _scale(f0, _graphs.scale_buffer(pitch_scale, x_l))
    f0_p = Fn.pad(f0, (0, (-n_grid) % mesh.size(1)))
    y, _, _, ovf = _copy_synthesis_local(
        x_l, f0_p, _frame_times(f0_p.shape[1], geo, x_l),
        _local(noise, mesh), mesh=mesh, fs=fs, fft_size=fft_size,
        max_half_window=max_half_window, frame_period_s=frame_period_s,
        out_length=out_length, max_pulses=max_pulses)
    outs = tuple(_global(o, mesh) for o in (y, f0, ovf))
    return outs if return_overflow else outs[:2]


def _wav_to_wav(x, noise, scale, *, geo, fs, fft_size, max_half_window,
                frame_period_s, out_length, max_pulses, return_overflow,
                grid_ms):
    """batch_wav_to_wav on one device, the pitch scale a 0-d tensor."""
    f0, tpos = _scaled_f0(x, geo, scale, grid_ms)
    y, _, _, ovf = batch_copy_synthesis(
        x, f0, tpos, noise, fs=fs, fft_size=fft_size,
        max_half_window=max_half_window, frame_period_s=frame_period_s,
        out_length=out_length, max_pulses=max_pulses, return_overflow=True)
    return (y, f0, ovf) if return_overflow else (y, f0)


@torch.no_grad()
def batch_analyze(x, *, geo, fs, fft_size, max_half_window, pitch_scale=1.0,
                  grid_ms=1, mesh=None):
    """Analysis in one call: [B, T] wavs -> (f0 [B, n_grid], spec
    [B, n_grid, K], ap [B, n_grid, K]) — Harvest (with the device contour
    chain, on the ``grid_ms`` candidate grid), pitch scaling, CheapTrick and
    D4C on the scaled F0.  ``mesh``: Harvest as ``batch_harvest_f0``, the
    analysis over 'data' only (as JAX's), DTensor outputs.  Without a mesh,
    float32 CUDA input runs as a captured CUDA graph from the second call of
    a shape on, as ``batch_wav_to_wav``."""
    if mesh is None:
        return _graphs.call(_analyze, (x,), pitch_scale, geo=geo, fs=fs,
                            fft_size=fft_size,
                            max_half_window=max_half_window, grid_ms=grid_ms)
    x_l = _local(x, mesh)
    n_grid = geo.n_grid()
    f0 = _harvest_f0_local(x_l, geo, n_grid, mesh, grid_ms)
    f0 = _scale(f0, _graphs.scale_buffer(pitch_scale, x_l))
    spec, ap = _analysis(x_l, f0, _frame_times(n_grid, geo, x_l), fs=fs,
                         fft_size=fft_size, max_half_window=max_half_window)
    return tuple(_global(o, mesh) for o in (f0, spec, ap))


def _analyze(x, scale, *, geo, fs, fft_size, max_half_window, grid_ms):
    """batch_analyze on one device, the pitch scale a 0-d tensor."""
    f0, tpos = _scaled_f0(x, geo, scale, grid_ms)
    spec, ap = _analysis(x, f0, tpos, fs=fs, fft_size=fft_size,
                         max_half_window=max_half_window)
    return f0, spec, ap


@torch.no_grad()
def batch_harvest_device_stages(x, *, geo, mesh, grid_ms=1):
    """Harvest's stages (decimate -> band filter -> zc candidates ->
    detection and overlap -> refinement -> prune) of x [B, T] under the
    mesh: (candidates, scores) [B, F, S] as DTensors, F =
    geo.with_grid(grid_ms).f0_length, the single-device
    ``harvest_device_stages`` with mean 0.

    float32 (the counterpart of worldtpu's batch_harvest_device_stages):
    each rank filters and runs the zc kernel on the stratified band subset
    of its time index (global bands t, t + nt, ...; the band axis padded
    to nt * ceil(Nb / nt) with zero rows of bound 1.0, which give no
    candidate), all-gathers the raw candidates over 'time' in global band
    order, detects and overlaps on the whole band axis, runs the refine
    kernel on its slab of ceil(F / nt) frames (compaction is per frame, so
    a slab compacts as the whole does), all-gathers the refined candidates
    and scores, and prunes every frame (the prune reads neighbouring
    frames).  Every band keeps the taps and bank width of its
    single-device filter group.  float64: the parity stages on the data
    shard, not split over 'time'."""
    cand, score = _stages_local(_local(x, mesh), geo, mesh, grid_ms)
    return _global(cand, mesh), _global(score, mesh)


@torch.no_grad()
def batch_harvest_f0(x, *, geo, n_out, mesh, grid_ms=1):
    """Full Harvest under the mesh: x [B, T] -> F0 [B, n_out] as a DTensor.
    float32: ``batch_harvest_device_stages`` and the device contour chain
    (the extend kernel) on each data shard; float64: ``harvest_parity`` on
    each data shard (n_out must be geo.n_grid())."""
    f0 = _harvest_f0_local(_local(x, mesh), geo, n_out, mesh, grid_ms)
    return _global(f0, mesh)


def _harvest_f0_local(x, geo, n_out, mesh, grid):
    """F0 [B_local, n_out] of one data shard's rows."""
    _hv.check_grid(x.dtype, grid)
    if x.dtype == torch.float64:
        if n_out != geo.n_grid():
            raise ValueError(f"float64 Harvest gives geo.n_grid() = "
                             f"{geo.n_grid()} frames, not {n_out}")
        return _hv.harvest_parity(x, geo=geo)
    from worldtpu_torch.analysis import contour_device as CDV
    cand, score = _stages_local(x, geo, mesh, grid)
    with record_function("wt.contour"):
        return CDV.fix_and_smooth(cand, score, n_out, geo.frame_period,
                                  grid_ms=grid)


@device_cache(maxsize=16)
def _band_shard(geo, t, nt, device):
    """Time rank t's stratified band subset of the geometry (nt time
    ranks): (its real bands as a tuple, or None for all of them; the
    number of zero rows padding it; the bounds [rows] float32 on device,
    1.0 on the padding, or None for all bands)."""
    Nb = geo.n_channels
    if nt == 1:
        return None, 0, None
    nbl = -(-Nb // nt)
    bands = tuple(range(t, Nb, nt))
    bounds = np.ones(nbl, np.float32)
    bounds[:len(bands)] = np.asarray(geo.boundary_f0, np.float32)[
        list(bands)]
    return bands, nbl - len(bands), torch.as_tensor(bounds, device=device)


def _stages_local(x, geo, mesh, grid):
    """One data shard's (candidates, scores) [B_local, F, S], the band and
    frame stages split over the time ranks (float32)."""
    _hv.check_grid(x.dtype, grid)
    if x.dtype == torch.float64:
        return _hv.harvest_device_stages(
            x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device),
            geo=geo)
    nt, t = _time_coords(mesh)
    geo_k = geo.with_grid(grid)
    F = geo_k.f0_length
    with record_function("wt.decimate"):
        y = _hv.decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    bands, n_pad, bounds = _band_shard(geo_k, t, nt, x.device)
    with record_function("wt.band_filter"):
        filt = _hv.band_filter(y, geo_k, bands)
        if n_pad:
            filt = torch.cat([filt, filt.new_zeros(
                (filt.shape[0], n_pad, filt.shape[2]))], dim=1)
    with record_function("wt.zc"):
        raw = _zc.band_candidates(filt, geo_k, bounds)
    with record_function("wt.detect_overlap"):
        # gathered rows are (time rank t, row j) <-> global band t + j*nt
        raw = _gather_time(raw[:, :, None], mesh, axis=2)
        raw = raw.reshape(raw.shape[0], -1, F)[:, :geo.n_channels]
        cand = _hv._overlap_candidates(_hv._detect_candidates(raw, geo_k))
    fl = -(-F // nt)
    tpos = torch.arange(F, dtype=x.dtype, device=x.device) \
        * (geo_k.grid_ms / 1000.0)
    fr = slice(t * fl, (t + 1) * fl)
    cand_s = Fn.pad(cand, (0, 0, 0, nt * fl - F))[:, fr].contiguous()
    ref, sco = _refine.refine_stage(
        y, cand_s, Fn.pad(tpos, (0, nt * fl - F))[fr], geo=geo_k,
        dedup_tol=_hv.REFINE_DEDUP_TOL)
    ref, sco = _gather_time(torch.stack([ref, sco]), mesh, axis=2)
    return _hv.prune_compacted(ref[:, :F], sco[:, :F])


def _frame_times(n, geo, x):
    """[n] frame times at the frame period, in x's dtype and device."""
    return torch.arange(n, dtype=x.dtype, device=x.device) \
        * (geo.frame_period / 1000.0)


def _scale(f0, scale):
    """F0 times the 0-d pitch-scale tensor, in f0's dtype (one float32
    product, the bits of f0 * a Python float)."""
    return (f0 * scale).to(f0.dtype)


def _scaled_f0(x, geo, scale, grid_ms):
    """Harvest F0 [B, n_grid] of x [B, T] on the grid_ms candidate grid
    times the 0-d pitch-scale tensor, and the frame times [n_grid]."""
    n_grid = geo.n_grid()
    mean = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    f0 = _hv.harvest_device_full(x, mean, geo=geo, n_out=n_grid,
                                 grid=grid_ms)
    return _scale(f0, scale), _frame_times(n_grid, geo, x)


def _analysis(x, f0, tpos, *, fs, fft_size, max_half_window):
    """CheapTrick and D4C of x [B, T] at F0 [B, F]: (spec, ap)."""
    with record_function("wt.cheaptrick"):
        spec = cheaptrick_frames(x, f0, tpos, fs=fs, fft_size=fft_size,
                                 max_half_window=max_half_window)
    with record_function("wt.d4c"):
        ap = d4c_frames(x, f0, tpos, fs=fs, fft_size_out=fft_size)
    return spec, ap


def pad_batch(waves, fs, frame_period_ms=5.0):
    """Pad 1-D waveforms to a [B, T] numpy batch + frame geometry.

    Returns (x [B, T], lengths, n_frames_per_utt, F, out_length)."""
    lengths = np.array([len(w) for w in waves])
    T = int(lengths.max())
    B = len(waves)
    x = np.zeros((B, T), dtype=np.asarray(waves[0]).dtype)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    n_frames = (1000.0 * lengths / fs / frame_period_ms).astype(int) + 1
    F = int(n_frames.max())
    out_length = int((F - 1) * frame_period_ms / 1000.0 * fs) + 1
    return x, lengths, n_frames, F, out_length
