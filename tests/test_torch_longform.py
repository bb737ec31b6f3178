"""The port's long-audio Harvest (worldtpu_torch.analysis.longform) against
worldtpu's, both on the CPU.

JAX runs its production refine semantics through the Pallas refine kernel
in interpret mode (on the CPU it would otherwise take the dense refine,
which has no dedup and a different slot cap), as tests/test_torch_slice.py
does; the port runs its plain kernel versions.  Inputs follow
tests/test_longform.py's _long_utterance at 16 kHz, short enough for the
tier-1 run.  Gates: tests/test_longform.py's, tightened for port against
JAX (the same chunking on both sides): identical voicing, F0 RMSE < 0.01 Hz
and max < 0.5 Hz on frames voiced in both."""

import numpy as np
import pytest
import torch

from test_longform import _long_utterance
from worldtpu.analysis import harvest as H
from worldtpu.analysis import longform as JL
from worldtpu_torch import convert
from worldtpu_torch.analysis import longform as TL

torch.set_num_threads(1)

FS_ALL = (8000, 16000, 22050, 24000, 44100, 48000)


@pytest.mark.parametrize("fs", FS_ALL)
def test_grid_unit_and_chunk_geometry_match_jax(fs):
    ratio = max(1, min(12, int(fs / 8000.0 + 0.5)))
    assert TL._grid_unit_ms(fs, ratio) == JL._grid_unit_ms(fs, ratio)
    kw = dict(chunk_ms=7777, halo_ms=999, f0_floor=40.0)
    j = JL.LongHarvest(fs, **kw)
    t = TL.LongHarvest(fs, device="cpu", **kw)
    for name in ("chunk_ms", "halo_ms", "Tc", "stride", "halo_samples"):
        assert getattr(t, name) == getattr(j, name), name
    # the window geometry, field for field (geometry_from_worldtpu checks
    # the JAX fields against the port's rebuilt geometry)
    g = convert.geometry_from_worldtpu(vars(j.kern.geo))
    for name, val in vars(g).items():
        assert np.array_equal(val, getattr(t.geo, name)), name


def _compare(monkeypatch, fs, x, x_port=None, max_batch=16, **kw):
    monkeypatch.setattr(H, "_use_refine_kernel_default",
                        lambda: "interpret")
    f0j, tpj = JL.LongHarvest(fs, **kw).compute(x)
    f0t, tpt = TL.LongHarvest(fs, device="cpu", **kw).compute(
        x if x_port is None else x_port, max_batch=max_batch)
    assert f0t.dtype == tpt.dtype == np.float64
    np.testing.assert_array_equal(tpt, tpj)
    assert f0t.shape == f0j.shape == (1 + int(1000 * len(x) / fs / 5.0),)
    # voicing decisions agree everywhere
    assert np.array_equal(f0t > 0, f0j > 0)
    both = (f0t > 0) & (f0j > 0)
    assert both.mean() > 0.6
    d = np.abs(f0t[both] - f0j[both])
    rmse = float(np.sqrt(np.mean(d ** 2)))
    assert rmse < 0.01, f"rmse {rmse} Hz"
    assert d.max() < 0.5, f"max diff {d.max()} Hz"


def test_long_harvest_matches_jax_multi_chunk(monkeypatch):
    """Two chunks, in two batches of one window: batch 2 is enqueued before
    batch 1 lands."""
    fs = 16000
    x = _long_utterance(fs, 3.0, seed=2)
    lh = TL.LongHarvest(fs, chunk_ms=1500, device="cpu")
    assert lh.n_chunks(len(x)) == 2
    _compare(monkeypatch, fs, x, max_batch=1, chunk_ms=1500, halo_ms=750)


def test_long_harvest_matches_jax_single_chunk(monkeypatch):
    """Input no longer than one chunk (the single-chunk path), given to the
    port as a tensor."""
    fs = 16000
    x = _long_utterance(fs, 1.5, seed=1)
    assert TL.LongHarvest(fs, chunk_ms=1500, device="cpu").n_chunks(
        len(x)) == 1
    _compare(monkeypatch, fs, x, x_port=torch.tensor(x), chunk_ms=1500,
             halo_ms=750)


def test_long_harvest_float16_raises():
    """A dtype Harvest does not compute in (float16) raises; float64
    LongHarvest is ported (tests/test_torch_longaudio_f64.py)."""
    lh = TL.LongHarvest(16000, device="cpu")
    with pytest.raises(ValueError, match="unsupported dtype"):
        lh.compute(np.zeros(16000, np.float32), dtype=torch.float16)
