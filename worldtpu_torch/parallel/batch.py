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
local tensors.  Each entry point has one body, which the single-device
call runs with ``harvest.WHOLE`` and the mesh call on each data shard
with the ``harvest.Split`` of its time ranks; with one time rank that
split adds no operation, so a (1, 1) mesh gives the single-device result
bit for bit by construction.

float64 under a mesh: the port's float64 Harvest is the parity path
(``harvest_parity``: the host int-truncated mean and contour), not JAX's
float64 device stages, and it runs whole on each data shard: the time
ranks of a data row compute the same F0.  CheapTrick, D4C and synthesis
shard over frames as in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from worldtpu_torch import codec as _codec
from worldtpu_torch.analysis import harvest as _hv
from worldtpu_torch.analysis.cheaptrick import cheaptrick_frames
from worldtpu_torch.analysis.d4c import d4c_frames
from worldtpu_torch.parallel import graphs as _graphs
from worldtpu_torch.synthesis import synthesis as _syn
from worldtpu_torch.tracing import stage

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


def _time_split(mesh):
    """The ``harvest.Split`` of one data shard's work over the time ranks
    of a ('data', 'time') mesh, the parts joined by all-gathers over
    'time'."""
    from worldtpu_torch.parallel.distributed import all_gather
    if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
        raise ValueError(f"expected a mesh with dims {MESH_DIMS}, got "
                         f"{mesh.mesh_dim_names}")

    def join(t, axis):
        return torch.cat(list(all_gather(t, mesh, "time")), dim=axis)
    return _hv.Split(mesh.size(1), mesh.get_local_rank("time"), join)


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
    kw = dict(fs=fs, fft_size=fft_size, max_half_window=max_half_window,
              frame_period_s=frame_period_s, out_length=out_length,
              max_pulses=max_pulses)
    if mesh is None:
        outs = _copy_synthesis(x, f0, tpos, noise, **kw)
    else:
        outs = tuple(_global(o, mesh) for o in _copy_synthesis(
            _local(x, mesh), _local(f0, mesh), tpos, _local(noise, mesh),
            split=_time_split(mesh), **kw))
    return outs if return_overflow else outs[:3]


def _copy_synthesis(x, f0, tpos, noise, *, fs, fft_size, max_half_window,
                    frame_period_s, out_length, max_pulses,
                    split=_hv.WHOLE):
    """One data shard's copy-synthesis with the analysis' frames divided
    by ``split``: (y, spec, ap, overflow) of the shard's rows."""
    if f0.shape[1] % split.parts:
        raise ValueError(f"{f0.shape[1]} frames do not split over "
                         f"{split.parts} time ranks; pad F0 with unvoiced "
                         f"frames")
    spec, ap = _analysis(x, split.slab(f0, 1), split.slab(tpos, 0), fs=fs,
                         fft_size=fft_size, max_half_window=max_half_window)
    spec, ap = split.join_all((spec, ap), 1)
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
    kw = dict(geo=geo, fs=fs, fft_size=fft_size,
              max_half_window=max_half_window, frame_period_s=frame_period_s,
              out_length=out_length, max_pulses=max_pulses,
              return_overflow=return_overflow, grid_ms=grid_ms)
    if mesh is None:
        return _graphs.call(_wav_to_wav, (x, noise), pitch_scale, **kw)
    x_l = _local(x, mesh)
    return tuple(_global(o, mesh) for o in _wav_to_wav(
        x_l, _local(noise, mesh), _graphs.scale_buffer(pitch_scale, x_l),
        split=_time_split(mesh), **kw))


def _wav_to_wav(x, noise, scale, *, geo, fs, fft_size, max_half_window,
                frame_period_s, out_length, max_pulses, return_overflow,
                grid_ms, split=_hv.WHOLE):
    """batch_wav_to_wav of one data shard, the pitch scale a 0-d tensor,
    Harvest and the analysis' frames divided by ``split``."""
    n_grid = geo.n_grid()
    f0 = _scale(_hv.harvest_device_full(x, geo=geo, n_out=n_grid,
                                        grid=grid_ms, split=split), scale)
    f0_p = split.pad(f0, 1)
    y, _, _, ovf = _copy_synthesis(
        x, f0_p, _frame_times(f0_p.shape[1], geo, x), noise, fs=fs,
        fft_size=fft_size, max_half_window=max_half_window,
        frame_period_s=frame_period_s, out_length=out_length,
        max_pulses=max_pulses, split=split)
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
    kw = dict(geo=geo, fs=fs, fft_size=fft_size,
              max_half_window=max_half_window, grid_ms=grid_ms)
    if mesh is None:
        return _graphs.call(_analyze, (x,), pitch_scale, **kw)
    x_l = _local(x, mesh)
    return tuple(_global(o, mesh) for o in _analyze(
        x_l, _graphs.scale_buffer(pitch_scale, x_l), split=_time_split(mesh),
        **kw))


def _analyze(x, scale, *, geo, fs, fft_size, max_half_window, grid_ms,
             split=_hv.WHOLE):
    """batch_analyze of one data shard, the pitch scale a 0-d tensor,
    Harvest divided by ``split`` and the analysis whole."""
    n_grid = geo.n_grid()
    f0 = _scale(_hv.harvest_device_full(x, geo=geo, n_out=n_grid,
                                        grid=grid_ms, split=split), scale)
    spec, ap = _analysis(x, f0, _frame_times(n_grid, geo, x), fs=fs,
                         fft_size=fft_size, max_half_window=max_half_window)
    return f0, spec, ap


@torch.no_grad()
def batch_features(x, *, geo, fs, fft_size, max_half_window, n_dims,
                   pitch_scale=1.0, grid_ms=1, mesh=None):
    """WORLD acoustic features in one call: [B, T] wavs -> (f0 [B, n_grid],
    coded spectral envelope [B, n_grid, n_dims], coded aperiodicity
    [B, n_grid, n_ap]) -- ``batch_analyze``'s analysis, then
    ``codec.code_spectral_envelope`` and ``codec.code_aperiodicity`` on its
    frames (n_ap = ``codec.get_number_of_aperiodicities(fs)``).  The
    [B, n_grid, K] envelope and aperiodicity stay inside the call.
    ``mesh``: the same body on each data shard, as ``batch_analyze``'s,
    DTensor outputs.  Without a mesh, float32 CUDA input runs as a captured
    CUDA graph from the second call of a shape on, as
    ``batch_wav_to_wav``."""
    kw = dict(geo=geo, fs=fs, fft_size=fft_size,
              max_half_window=max_half_window, n_dims=n_dims,
              grid_ms=grid_ms)
    if mesh is None:
        return _graphs.call(_features, (x,), pitch_scale, **kw)
    x_l = _local(x, mesh)
    return tuple(_global(o, mesh) for o in _features(
        x_l, _graphs.scale_buffer(pitch_scale, x_l), split=_time_split(mesh),
        **kw))


def _features(x, scale, *, geo, fs, fft_size, max_half_window, n_dims,
              grid_ms, split=_hv.WHOLE):
    """batch_features of one data shard: ``_analyze``, then the codec on
    its [B * F, K] frames."""
    f0, spec, ap = _analyze(x, scale, geo=geo, fs=fs, fft_size=fft_size,
                            max_half_window=max_half_window, grid_ms=grid_ms,
                            split=split)
    B, F, K = spec.shape
    with stage("codec", x.device):
        mcep = _codec.code_spectral_envelope(
            spec.reshape(B * F, K), fs=fs, fft_size=fft_size, n_dims=n_dims)
        bap = _codec.code_aperiodicity(ap.reshape(B * F, K), fs=fs,
                                       fft_size=fft_size)
    return f0, mcep.reshape(B, F, n_dims), bap.reshape(B, F, -1)


@torch.no_grad()
def batch_harvest_device_stages(x, *, geo, mesh, grid_ms=1):
    """Harvest's stages (decimate -> band filter -> zc candidates ->
    detection and overlap -> refinement -> prune) of x [B, T] under the
    mesh: (candidates, scores) [B, F, S] as DTensors, F =
    geo.with_grid(grid_ms).f0_length: ``harvest_device_stages`` of each
    data shard, divided over the time ranks (the counterpart of
    worldtpu's batch_harvest_device_stages).

    float32: each rank filters and runs the zc kernel on the stratified
    band subset of its time index (global bands t, t + nt, ...),
    all-gathers the raw candidates over 'time', runs the refine kernel on
    its slab of ceil(F / nt) frames and all-gathers the refined
    candidates and scores.  float64: the parity stages on the data shard,
    not split over 'time'."""
    cand, score = _hv.harvest_device_stages(
        _local(x, mesh), geo=geo, grid=grid_ms, split=_time_split(mesh))
    return _global(cand, mesh), _global(score, mesh)


@torch.no_grad()
def batch_harvest_f0(x, *, geo, n_out, mesh, grid_ms=1):
    """Full Harvest under the mesh: x [B, T] -> F0 [B, n_out] as a DTensor.
    float32: ``batch_harvest_device_stages`` and the device contour chain
    (the extend kernel) on each data shard; float64: ``harvest_parity`` on
    each data shard (n_out must be geo.n_grid())."""
    return _global(_hv.harvest_device_full(
        _local(x, mesh), geo=geo, n_out=n_out, grid=grid_ms,
        split=_time_split(mesh)), mesh)


def _frame_times(n, geo, x):
    """[n] frame times at the frame period, in x's dtype and device."""
    return torch.arange(n, dtype=x.dtype, device=x.device) \
        * (geo.frame_period / 1000.0)


def _scale(f0, scale):
    """F0 times the 0-d pitch-scale tensor, in f0's dtype (one float32
    product, the bits of f0 * a Python float)."""
    return (f0 * scale).to(f0.dtype)


def _analysis(x, f0, tpos, *, fs, fft_size, max_half_window):
    """CheapTrick and D4C of x [B, T] at F0 [B, F]: (spec, ap)."""
    with stage("cheaptrick", x.device):
        spec = cheaptrick_frames(x, f0, tpos, fs=fs, fft_size=fft_size,
                                 max_half_window=max_half_window)
    with stage("d4c", x.device):
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
