"""Multi-process runtime entry: torch.distributed and a ('data', 'time')
device mesh over every rank.

Port of worldtpu/parallel/distributed.py.  One process per GPU, each
launched by ``torchrun --nproc-per-node N``, calls::

    from worldtpu_torch.parallel import init_distributed, global_mesh
    init_distributed()                  # torchrun's environment variables
    mesh = global_mesh(n_time=2)

and passes ``mesh`` to ``batch_wav_to_wav``, ``batch_copy_synthesis``,
``batch_analyze``, ``batch_harvest_f0`` or ``LongPipeline.copy_synthesis``.
Each rank loads its own utterances; ``process_local_batch`` joins them
into arrays sharded over the mesh's 'data' axis (the counterpart of
``jax.make_array_from_process_local_data``).

Collectives.  The port makes one kind of collective call, ``all_gather``
(``torch.distributed.all_gather`` over one mesh dimension), on tensors of
the rank's device, whatever the backend.  NCCL, the default on the card,
takes one rank per GPU.  Several ranks that share one card (NCCL refuses
them: "Duplicate GPU detected") take ``backend="gloo"``: gloo accepts
CUDA tensors in ``all_gather`` and passes them through host memory itself
(measured with four ranks on one H100, torch 2.11), so the port moves no
tensor to the host for it.  ``DTensor.full_tensor()`` of a CUDA DTensor
over gloo ranks crashed the processes in that measurement (a
segmentation fault in every rank); ``gather_rows`` gives the global array
of the port's outputs through ``all_gather`` on any backend.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

#: this process's device, set by init_distributed
_device = None


def init_distributed(backend=None, init_method=None, world_size=None,
                     rank=None, device=None, timeout=None):
    """Start torch.distributed for this process (idempotent) and select
    its device; returns the device.

    With torchrun's variables set (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and no arguments,
    they define the world (``init_method`` "env://").  ``init_method``,
    ``world_size`` and ``rank`` name it explicitly (e.g. "file:///path" or
    "tcp://host:port").  With neither, the world is this process alone (a
    store in its own memory: no port, no file), which is what a
    single-process run of the mesh entry points needs.

    ``device``: the rank's device, by default ``cuda:{LOCAL_RANK %
    torch.cuda.device_count()}`` (so ranks on a one-card machine share
    cuda:0); "cpu" for CPU ranks.  A CUDA device is made current.
    ``backend``: "nccl" for a CUDA device and "gloo" for the CPU unless
    given; ranks that share a card pass "gloo".  ``timeout`` (seconds)
    bounds the rendezvous and every collective.

    A second call only selects the device again.  Any other error of
    ``torch.distributed.init_process_group`` is raised: unlike
    ``worldtpu``'s version, which logs it and carries on because a lone
    JAX process has no coordinator to reach, a lone process here gets its
    own world above, so an error means a misconfigured launch.
    """
    global _device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError("no CUDA device; pass device='cpu' for "
                                   "ranks on the CPU")
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", 0)) % n)
        torch.cuda.set_device(device)
    _device = device
    if dist.is_initialized():
        return device
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    if (init_method is None and world_size is None
            and "WORLD_SIZE" not in os.environ):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank, **kw)
    return device


def rank_device():
    """This rank's device: init_distributed's, else the current CUDA
    device (the port computes on the card unless told otherwise)."""
    if _device is not None:
        return _device
    return torch.device("cuda", torch.cuda.current_device())


def global_mesh(n_data=None, n_time=1):
    """('data', 'time') mesh over every rank of the world (``make_mesh``
    after ``init_distributed``): degrades to data-only when n_data *
    n_time does not cover the world."""
    from worldtpu_torch.parallel.batch import make_mesh
    return make_mesh(n_data=n_data, n_time=n_time)


def process_local_batch(mesh, global_batch_arrays):
    """Join process-local numpy batches into arrays sharded over 'data'.

    Each rank passes the rows [B_local, ...] of its data shard (ranks of
    one data row, which differ only in their 'time' coordinate, pass the
    same rows); the result is a tuple of DTensors [B_local * n_data, ...]
    with placements (Shard(0), Replicate()), each rank's rows on its
    device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dev = rank_device()
    return tuple(DTensor.from_local(torch.as_tensor(np.asarray(a),
                                                    device=dev),
                                    mesh, [Shard(0), Replicate()],
                                    run_check=False)
                 for a in global_batch_arrays)


def all_gather(t, mesh, dim):
    """The tensors ``t`` of every rank along mesh dimension ``dim``
    ("data" or "time"), stacked in that dimension's rank order: [n, *t.shape]
    (t itself, unsqueezed, when the dimension has one rank: no
    collective)."""
    n = mesh.size(mesh.mesh_dim_names.index(dim))
    t = t.contiguous()
    if n == 1:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.get_group(dim))
    return torch.stack(parts)


def gather_rows(t):
    """The global array of a DTensor placed (Shard(0), Replicate()) on a
    ('data', 'time') mesh, as a plain tensor on this rank's device: its
    local rows gathered over 'data' (``all_gather``; ``full_tensor()``
    does the same through DTensor's own collectives)."""
    parts = all_gather(t.to_local(), t.device_mesh, "data")
    return parts.reshape(-1, *parts.shape[2:])
