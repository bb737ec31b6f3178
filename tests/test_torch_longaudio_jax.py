"""The port's LongPipeline whole (LongHarvest, frame-blocked analysis,
carried synthesis) against worldtpu's, both on the CPU, with the same key.

Gates: tests/test_longaudio.py's _assert_waveforms_match plus q90 < 0.1
of the 100 ms windowed relative error (ADVICE r5: the median misses a
noise desync that starts past the midpoint).  worldtpu's jitted chunk step
may place a knife-edge pulse apart from its own unchunked synthesis;
tests/test_torch_longaudio.py holds the port to worldtpu's unchunked path
as well."""

import jax
import numpy as np

from test_longform import _long_utterance
from test_torch_longaudio import FS, _assert_match
from worldtpu import longaudio as JLA
from worldtpu.analysis import harvest as H
from worldtpu_torch import convert
from worldtpu_torch import longaudio as TLA


def test_long_pipeline_matches_jax(monkeypatch):
    """Both pipelines whole on one utterance with the same key; JAX's
    Harvest refines with its production semantics (the Pallas refine in
    interpret mode).  The default F0 floor keeps the CPU's plain refine
    short."""
    monkeypatch.setattr(H, "_use_refine_kernel_default",
                        lambda: "interpret")
    x = _long_utterance(FS, 3.0, seed=3)
    kw = dict(chunk_frames=230, harvest_chunk_ms=1500, harvest_halo_ms=750)
    key = jax.random.PRNGKey(7)
    yj, f0j = JLA.LongPipeline(FS, **kw).copy_synthesis(x, key=key)
    yt, f0t = TLA.LongPipeline(FS, device="cpu", **kw).copy_synthesis(
        x, seed=convert.key_from_worldtpu(np.asarray(key)))
    assert yt.dtype == np.float32 and yt.shape == yj.shape
    assert np.array_equal(f0t > 0, f0j > 0)
    both = f0t > 0
    assert np.abs(f0t[both] - f0j[both]).max() < 0.5
    assert np.isfinite(yt).all()
    _assert_match(yt, yj)
