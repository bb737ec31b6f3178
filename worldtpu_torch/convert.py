"""Carry the vocoder's static state from the JAX package into the port.

The vocoder has no learned weights; its parameters are the static Harvest
geometry (from which the filter-bank tables are derived) and the
synthesis noise array.  These helpers let tests and tools feed both
packages identical inputs without importing JAX here: callers pass plain
python/numpy values.
"""

from __future__ import annotations

import numpy as np
import torch

from worldtpu_torch.analysis.harvest import HarvestGeometry

#: derived-state fields of the JAX geometry that are not geometry
_SKIP = ("_grid_cache",)


def geometry_from_worldtpu(fields: dict) -> HarvestGeometry:
    """The port's HarvestGeometry from ``vars(geo)`` of a JAX
    ``worldtpu.analysis.harvest.HarvestGeometry``.  The geometry is rebuilt
    from its constructor arguments and checked field by field.  Raises
    ValueError for a geometry with ``use_cos_table`` set: the port has no
    table-lookup refine window, so it would compute a different result."""
    if fields["use_cos_table"]:
        raise ValueError("use_cos_table=True is not supported by the port "
                         "(its refine window is computed, not looked up)")
    geo = HarvestGeometry(
        fields["fs"], fields["x_length"], f0_floor=fields["f0_floor"],
        f0_ceil=fields["f0_ceil"], frame_period=fields["frame_period"],
        target_fs=fields["target_fs"],
        channels_in_octave=fields["channels_in_octave"])
    for key, val in fields.items():
        if key in _SKIP:
            continue
        mine = getattr(geo, key)
        same = (np.array_equal(mine, val) if isinstance(val, np.ndarray)
                else mine == val)
        if not same:
            raise ValueError(f"geometry field {key}: {val!r} != {mine!r}")
    return geo


def noise_from_numpy(arr, device) -> torch.Tensor:
    """A synthesis noise array [B, max_pulses, fft_size] (or
    [max_pulses, fft_size]) as a float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(arr, np.float32), device=device)
