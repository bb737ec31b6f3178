"""The port's long-audio Harvest (worldtpu_torch.analysis.longform) against
worldtpu's, both on the CPU.

JAX runs its production refine semantics through the Pallas refine kernel
in interpret mode (on the CPU it would otherwise take the dense refine,
which has no dedup and a different slot cap), as tests/test_torch_slice.py
does; the port runs its plain kernel versions.  Inputs follow
tests/test_longform.py's _long_utterance at 16 kHz, short enough for the
tier-1 run.  Gates: tests/test_longform.py's, tightened for port against
JAX (the same chunking on both sides): identical voicing, F0 RMSE < 0.01 Hz
and max < 0.5 Hz on frames voiced in both.

The card's route (float32 on a CUDA device: the rows stitched on the
device, the device contour chain) is held here on CPU tensors: the one
stitching against each window's kept rows placed by hand, the route each
input takes, the device chain's plain versions against the host chain on the
same candidates, its nearest-frame pick against the host chain's, and its
refusal of a recording past the smoothing kernel's longest.  The kernels
themselves on whole recordings (120 s, and 72 min past the smoothing
kernel's former 2048 x 2048 frames): ``tests/test_wtbench_long.py``'s
``cuda`` cases."""

import types

import numpy as np
import pytest
import torch

from test_longform import _long_utterance
from worldtpu.analysis import harvest as H
from worldtpu.analysis import longform as JL
from worldtpu_torch import convert
from worldtpu_torch.analysis import contour_device as CDV
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.analysis import longform as TL
from worldtpu_torch.ops import contour_kernel as CK
from wtbench import speech

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


# -- the card's route, on CPU tensors ----------------------------------------

FS_CARD = 22050


def _stand_in_stages():
    """Harvest's device stages with the refinement left out: the port's
    decimation, band filter, zero crossings and candidate overlap, each
    candidate scored by its agreement with the frame's median candidate,
    then the pruning; memoized on each window's samples.  (The plain
    refine takes ~20 s a 3 s window on one CPU thread; the stages are held
    to JAX's by the tests above.)  Its candidates are float32, as the
    card's are."""
    memo = {}

    def stages(x, mean_y=None, *, geo, grid=1):
        outs = []
        for row in x:
            key = row.numpy().tobytes()
            if key not in memo:
                y = TH.decimate_stage(row[None], ratio=geo.ratio,
                                      y_length=geo.y_length)
                cand, _, _ = TH.candidates_stage(y, torch.zeros(1), geo)
                on = cand > 0
                med = torch.where(on, cand, float("nan")).nanmedian(
                    -1, keepdim=True).values
                score = torch.where(
                    on, 1.0 / (1.0 + 20.0 * (cand / med - 1.0).abs()), 0.0)
                memo[key] = TH.remove_unreliable_stage(cand, score)
            outs.append(memo[key])
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))
    return stages


@pytest.fixture(scope="module")
def stitched():
    """A 20.5 s speech recording at 22.05 kHz through LongHarvest's 2 s
    chunks with 0.5 s halos in batches of 2 windows: 11 windows (chunk 0,
    interior chunks, a clipped last chunk; the last batch one window),
    stitched on CPU tensors, and the stand-in stages it ran."""
    stages = _stand_in_stages()
    mp = pytest.MonkeyPatch()
    mp.setattr(TL, "harvest_device_stages", stages)
    try:
        n = int(20.5 * FS_CARD)
        x = speech.utterances(FS_CARD, [n], 2 ** 31 + 2020, "cpu")[0]
        x = x.astype(np.float32) / np.float32(32768.0)
        lh = TL.LongHarvest(FS_CARD, chunk_ms=2000, halo_ms=500,
                            f0_floor=40.0, device="cpu")
        rows = lh._stitched(x, torch.float32, 2, torch.device("cpu"))
    finally:
        mp.undo()
    return dict(lh=lh, n=n, x=x, rows=rows, stages=stages)


def test_stitching_tiles_the_grid(stitched):
    """The stitched rows against each window's kept rows placed by hand,
    bit for bit, in candidates and scores: window 0 is the recording's
    first Tc samples and keeps frames [0, chunk + halo); window k starts
    halo samples before chunk k and keeps its frames [2 halo, 2 halo +
    chunk), globally [k chunk + halo, (k + 1) chunk + halo), the last
    clipped to the grid.  The kept ranges tile the grid once each (the
    rows start uninitialized)."""
    lh, n, x = stitched["lh"], stitched["n"], stitched["x"]
    c_st, s_st = stitched["rows"]
    assert lh.n_chunks(n) == 11
    F_total = 11 * lh.chunk_ms + 1
    assert lh._kept(10, F_total)[2] == F_total < 11 * lh.chunk_ms \
        + lh.halo_ms
    assert c_st.dtype == s_st.dtype == torch.float32
    assert c_st.shape == s_st.shape == (F_total, lh.geo.max_candidates)
    chunk, halo = lh.chunk_ms * FS_CARD // 1000, lh.halo_ms * FS_CARD // 1000
    xp = np.zeros(11 * chunk + halo, np.float32)
    xp[:n] = x
    c_hand, s_hand = torch.zeros_like(c_st), torch.zeros_like(s_st)
    times = np.zeros(F_total, int)
    for k in range(11):
        lo = 0 if k == 0 else k * chunk - halo
        w = torch.from_numpy(xp[lo:lo + lh.Tc])[None]
        assert w.shape[1] == lh.Tc
        c, s = stitched["stages"](w, geo=lh.geo)
        g0 = 0 if k == 0 else k * lh.chunk_ms + lh.halo_ms
        g1 = min((k + 1) * lh.chunk_ms + lh.halo_ms, F_total)
        l0 = 0 if k == 0 else 2 * lh.halo_ms
        c_hand[g0:g1], s_hand[g0:g1] = c[0, l0:l0 + g1 - g0], \
            s[0, l0:l0 + g1 - g0]
        times[g0:g1] += 1
    assert (times == 1).all()
    assert torch.equal(c_st, c_hand) and torch.equal(s_st, s_hand)
    assert (c_hand > 0).any(dim=1).double().mean() > 0.5


def test_device_chain_against_the_host_chain(stitched):
    """The device chain (its plain versions on the CPU) against the host
    chain over the same stitched rows: the same tpos, voicing equal on at
    least 99.9% of the frames (any flipped frame printed) and the F0 of
    frames voiced on both within 1e-6 relative in the median and 1e-4 at
    most: fix steps 1, 3 and 4 compare and fill in float32 there, in
    float64 here, on the same float32 candidates."""
    lh, n = stitched["lh"], stitched["n"]
    f0_host, tp_host = lh._contour(*stitched["rows"], n)
    f0_card, tp_card = lh._contour_on_card(*stitched["rows"], n)
    assert f0_card.dtype == tp_card.dtype == np.float64
    assert np.array_equal(tp_card, tp_host)
    assert f0_card.shape == f0_host.shape == (1 + int(1000 * n / FS_CARD
                                                      / 5.0),)
    flip = np.nonzero((f0_card > 0) != (f0_host > 0))[0]
    print("flipped frames:", flip.tolist())
    assert 1.0 - len(flip) / len(f0_host) >= 0.999
    both = (f0_card > 0) & (f0_host > 0)
    assert both.mean() > 0.5
    rel = np.abs(f0_card[both] - f0_host[both]) / f0_host[both]
    assert np.median(rel) < 1e-6 and rel.max() < 1e-4, (np.median(rel),
                                                         rel.max())


@pytest.mark.parametrize("device, dtype, into, chain", [
    ("cpu", torch.float32, "cpu", "host"), ("cpu", torch.float64, "cpu",
                                            "host"),
    ("cuda", torch.float64, "cpu", "host"), ("cuda", torch.float32, "cuda",
                                             "card")])
def test_route_follows_device_and_dtype(monkeypatch, device, dtype, into,
                                        chain):
    """float32 on a CUDA device stitches the rows on the device and runs
    the device chain; float64 on either device and float32 on the CPU
    stitch them on the host (pinned when the windows run on the card) and
    run the host chain.  The stitching and both chains are spies, so no
    device is touched."""
    calls = []

    def stitching(self, x, dtype_, max_batch, into_):
        calls.append(f"stitching into {into_.type}")
        return "c", "s"

    def spy(name):
        def fn(self, *args):
            calls.append(name)
            return "f0", "tpos"
        return fn
    monkeypatch.setattr(TL.LongHarvest, "_stitched", stitching)
    monkeypatch.setattr(TL.LongHarvest, "_contour", spy("host chain"))
    monkeypatch.setattr(TL.LongHarvest, "_contour_on_card",
                        spy("card chain"))
    lh = TL.LongHarvest(16000, device=device)
    assert lh.compute(np.zeros(32000, np.float32), dtype=dtype) \
        == ("f0", "tpos")
    assert calls == [f"stitching into {into}", f"{chain} chain"]


@pytest.mark.parametrize("frame_period", [5.0, 10.0])
def test_device_pick_equals_the_host_pick(monkeypatch, frame_period):
    """The card route's nearest-frame pick picks the host chain's frames
    at these frame periods on a contour of 10 million 1 ms frames (the
    chain's own float32 times, ``contour_device.fix_and_smooth``, pick
    others from frame 8,192,030 on): the chain's steps are replaced by
    identities over a ramp, so its output is its pick."""
    F = 10_000_000
    ramp = torch.arange(F, dtype=torch.float32)[None]
    monkeypatch.setattr(CDV, "search_f0_base", lambda c, s: ramp)
    for name in ("fix_step1", "fix_step2", "fix_step3", "fix_step4",
                 "smooth_f0_contour"):
        monkeypatch.setattr(CDV, name, lambda f0, *a, **k: f0)
    rows = torch.zeros(1, 1).expand(F, 1)
    lh = TL.LongHarvest(16000, frame_period=frame_period, device="cpu")
    f0, tpos = lh._contour_on_card(rows, rows, 16 * F)
    want = np.minimum(F - 1, TL._matlab_round_np(tpos * 1000.0))
    assert F - 1 - frame_period < want[-1] <= F - 1
    assert len(f0) == 1 + int(F / frame_period)
    assert np.array_equal(f0, want)


def test_card_route_refuses_past_the_smoothing_kernels_longest(
        monkeypatch):
    """On the card a recording whose padded 1 ms contour is past the
    smoothing kernel's longest (``contour_kernel.smooth_chunk``, about
    27 h) raises ValueError before any stage runs; the longest it takes
    goes on to the stages.  Only the length is read: no audio is made."""
    calls = []
    monkeypatch.setattr(TL.LongHarvest, "_stitched",
                        lambda self, *a: calls.append("stages") or (0, 0))
    monkeypatch.setattr(TL.LongHarvest, "_contour_on_card",
                        lambda self, *a: calls.append("chain") or (0, 0))
    lh = TL.LongHarvest(16000, device="cuda")

    def fits(n_chunks):
        try:
            CK.smooth_chunk(n_chunks * lh.chunk_ms + 1 + 2 * CK.LAG)
            return True
        except ValueError:
            return False
    lo, hi = 1, 10 ** 6                    # fits(lo), not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    assert 26 * 3600 * 1000 < lo * lh.chunk_ms < 28 * 3600 * 1000
    longest = lo * lh.stride
    with pytest.raises(ValueError, match="longest"):
        lh.compute(types.SimpleNamespace(shape=(longest + 1,)))
    assert calls == []
    lh.compute(types.SimpleNamespace(shape=(longest,)))
    assert calls == ["stages", "chain"]
