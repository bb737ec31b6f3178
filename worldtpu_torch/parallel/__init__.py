"""Batched (utterance-axis) entry points and multi-rank parallelism.

  batch       — the batch programs, on one device or over a ('data',
                'time') DeviceMesh of ranks
  distributed — the torch.distributed entry (init_distributed,
                global_mesh, process_local_batch)
  graphs      — the captured CUDA graphs of the single-device batch
                programs (``graphs.clear()`` drops them)

Lazy attribute table so `worldtpu_torch.parallel.init_distributed()`
works without importing the batch programs first.
"""

_LAZY = {
    "make_mesh": ("worldtpu_torch.parallel.batch", "make_mesh"),
    "MeshConfigError": ("worldtpu_torch.parallel.batch", "MeshConfigError"),
    "batch_copy_synthesis": ("worldtpu_torch.parallel.batch",
                             "batch_copy_synthesis"),
    "batch_wav_to_wav": ("worldtpu_torch.parallel.batch",
                         "batch_wav_to_wav"),
    "batch_analyze": ("worldtpu_torch.parallel.batch", "batch_analyze"),
    "batch_features": ("worldtpu_torch.parallel.batch", "batch_features"),
    "batch_harvest_device_stages": ("worldtpu_torch.parallel.batch",
                                    "batch_harvest_device_stages"),
    "batch_harvest_f0": ("worldtpu_torch.parallel.batch",
                         "batch_harvest_f0"),
    "init_distributed": ("worldtpu_torch.parallel.distributed",
                         "init_distributed"),
    "global_mesh": ("worldtpu_torch.parallel.distributed", "global_mesh"),
    "process_local_batch": ("worldtpu_torch.parallel.distributed",
                            "process_local_batch"),
    "gather_rows": ("worldtpu_torch.parallel.distributed", "gather_rows"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(
        f"module 'worldtpu_torch.parallel' has no attribute {name!r}")
