"""The port's ('data', 'time') mesh paths (worldtpu_torch.parallel:
make_mesh, the mesh= branches of the batch entry points,
batch_harvest_device_stages / batch_harvest_f0, distributed.py,
LongPipeline's mesh=) on four gloo ranks on the CPU.

The ranks are subprocesses of tests/torch_mesh_worker.py, started once for
the module: they meet at a FileStore in a temporary directory (no port to
contend for under xdist), read their inputs from an .npz written here with
numpy, and write what they hold to one .npz each; every rank joins within
RANK_TIMEOUT_S or the module's tests fail.  The single-rank references
(the port without a mesh) and JAX's own mesh functions (on four of the
eight virtual devices of tests/conftest.py) run in this process; the
JAX test comes first so that it overlaps the ranks' work.
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from test_longform import _long_utterance
from test_torch_longaudio import _assert_match, _contour, _windowed_rel
from worldtpu.analysis import harvest as H
from worldtpu.analysis.cheaptrick import CheapTrickKernel
from worldtpu.parallel import batch as JB
from worldtpu.synthesis import synthesis as S
from worldtpu_torch import longaudio as TLA
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.parallel import batch as TB
from worldtpu_torch.parallel import distributed as TD

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(__file__).resolve().parent / "torch_mesh_worker.py"
WORLD = 4
RANK_TIMEOUT_S = 240
LONG_FS, LONG_CHUNK = 16000, 51


def _short_time_rms(y, w=160):
    n = (y.shape[-1] // w) * w
    return np.sqrt(np.mean(y[..., :n].reshape(*y.shape[:-1], -1, w) ** 2,
                           -1))


def _inputs():
    """Every rank's inputs, made here with numpy."""
    f16, f22 = load_fixture("t16"), load_fixture("t22")
    x16 = np.tile(np.asarray(f16.x, np.float32), (4, 1))
    x16[1] *= 0.5
    x16[3] *= 0.25
    x22 = np.tile(np.asarray(f22.x, np.float32), (2, 1))
    x22[1] *= 0.6
    ck = CheapTrickKernel(f22.fs)
    # float64 copy-synthesis: the C++ F0, frames padded to a multiple of 2
    F = len(f22.f0)
    Fp = F + F % 2
    cs_f0 = np.zeros((2, Fp))
    cs_f0[:, :F] = f22.f0
    cs_out = int((Fp - 1) * 0.005 * f22.fs) + 1
    cs_mp = S.default_max_pulses(cs_out, f22.fs)
    rs = np.random.RandomState(0)
    cs_noise = np.tile(rs.randn(1, cs_mp, ck.fft_size), (2, 1, 1))
    n_grid = 1 + int(1000.0 * x22.shape[1] / f22.fs / 5.0)
    w_out = int((n_grid - 1) * 0.00625 * f22.fs) + 1
    w_mp = S.capacity_max_pulses(w_out, f22.fs, f0_cap=600.0)
    w_noise = rs.randn(2, w_mp, ck.fft_size).astype(np.float32)
    lx = _long_utterance(LONG_FS, 3.0, seed=6)
    lf0, ltpos = _contour(len(lx), LONG_FS)
    return dict(
        fs16=f16.fs, x16=x16, fs22=f22.fs, fft22=ck.fft_size,
        mhw22=ck.max_half_window, x22=x22,
        cs_x=np.tile(np.asarray(f22.x, np.float64), (2, 1)), cs_f0=cs_f0,
        cs_tpos=np.arange(Fp) * 0.005, cs_out=cs_out, cs_mp=cs_mp,
        cs_noise=cs_noise, w_x=x22, w_out=w_out, w_mp=w_mp,
        w_noise=w_noise, l_fs=LONG_FS, l_x=lx, l_f0=lf0, l_tpos=ltpos,
        l_chunk=LONG_CHUNK,
        plb=np.arange(4 * 6, dtype=np.float32).reshape(4, 6))


class _Ranks:
    """The WORLD rank processes and, once they have all exited 0, their
    .npz outputs by rank."""

    def __init__(self, d):
        self.dir = d
        self.inp = _inputs()
        np.savez(d / "inputs.npz", **self.inp)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT), os.environ.get("PYTHONPATH", "")]))
        self.t0 = time.monotonic()
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(WORLD),
             str(d / "store"), str(d)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        self._out = None

    def out(self):
        if self._out is None:
            for r, p in enumerate(self.procs):
                left = RANK_TIMEOUT_S - (time.monotonic() - self.t0)
                try:
                    _, err = p.communicate(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    self.close()
                    pytest.fail(f"rank {r} did not finish within "
                                f"{RANK_TIMEOUT_S} s")
                if p.returncode != 0:
                    self.close()
                    pytest.fail(f"rank {r} exited {p.returncode}:\n"
                                f"{err[-3000:]}")
            self._out = [dict(np.load(self.dir / f"rank{r}.npz"))
                         for r in range(WORLD)]
        return self._out

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = _Ranks(tmp_path_factory.mktemp("mesh"))
    yield run
    run.close()


def _rows(outs, key, coord_rank_of_data):
    """The global rows of ``key`` from the ranks at time index 0 of each
    data row (rank 2d under (2, 2)), after checking that the other time
    rank of that data row holds the same rows."""
    rows = []
    for d, r in enumerate(coord_rank_of_data):
        a = outs[r][key]
        np.testing.assert_array_equal(outs[r + 1][key], a)
        rows.append(a)
    return np.concatenate(rows)


def test_batch_wav_to_wav_mesh_matches_jax(ranks, monkeypatch):
    """The port's batch_wav_to_wav under a (2, 2) gloo mesh against
    worldtpu's under a (2, 2) mesh of four virtual devices, t22 x2, pitch
    x1.2, duration x1.25: tests/test_torch_slice.py's gates (voicing
    agreement >= 0.99, F0 within 0.05 Hz on frames voiced in both,
    160-sample short-time RMS within 0.02).  JAX refines with its Pallas
    refine in interpret mode (its production semantics)."""
    inp = ranks.inp
    x, fs = inp["w_x"], int(inp["fs22"])
    geo = H.HarvestGeometry(fs, x.shape[1], f0_floor=40.0)
    monkeypatch.setattr(H, "_use_refine_kernel_default",
                        lambda: "interpret")
    jmesh = JB.make_mesh(2, 2, devices=jax.devices()[:4])
    yj, f0j = JB.batch_wav_to_wav(
        jnp.asarray(x), jnp.asarray(inp["w_noise"]), geo=geo, fs=fs,
        fft_size=int(inp["fft22"]), max_half_window=int(inp["mhw22"]),
        frame_period_s=0.00625, out_length=int(inp["w_out"]),
        max_pulses=int(inp["w_mp"]), mesh=jmesh, pitch_scale=1.2)
    yj, f0j = np.asarray(yj), np.asarray(f0j)
    out = ranks.out()
    for r in range(WORLD):      # every rank holds the global arrays
        np.testing.assert_array_equal(out[r]["w22_f0"], out[0]["w22_f0"])
        np.testing.assert_array_equal(out[r]["w22_y"], out[0]["w22_y"])
    yt, f0t = out[0]["w22_y"], out[0]["w22_f0"]
    assert yt.shape == yj.shape and f0t.shape == f0j.shape
    assert not out[0]["w22_ovf"].any()
    vj, vt = f0j > 0, f0t > 0
    assert (vj == vt).mean() >= 0.99
    assert vj.sum() > 0.3 * vj.size
    np.testing.assert_allclose(f0t[vj & vt], f0j[vj & vt], atol=0.05)
    np.testing.assert_allclose(_short_time_rms(yt), _short_time_rms(yj),
                               atol=0.02)
    assert np.sqrt(np.mean(yt ** 2)) > 0.01


def test_mesh_shape():
    """make_mesh's factorization: the request when it covers the ranks,
    else data-only over all of them; no ranks raise MeshConfigError."""
    assert TB.mesh_shape(4, 2, 2) == (2, 2)
    assert TB.mesh_shape(4, 1, 4) == (1, 4)
    assert TB.mesh_shape(4, None, 2) == (2, 2)
    assert TB.mesh_shape(4) == (4, 1)
    assert TB.mesh_shape(4, 3, 1) == (4, 1)
    assert TB.mesh_shape(8, 2, 3) == (8, 1)
    with pytest.raises(TB.MeshConfigError):
        TB.mesh_shape(0)



def test_make_mesh_over_ranks(ranks):
    """Over four ranks: (2, 2), (1, 4), (3, 1) degraded to (4, 1),
    n_time=2 alone to (2, 2), global_mesh(n_time=4) to (1, 4); rank r sits
    at (r // 2, r % 2) of the (2, 2) mesh."""
    out = ranks.out()
    for r in range(WORLD):
        assert out[r]["mesh_shapes"].tolist() == [[2, 2], [1, 4], [4, 1],
                                                  [2, 2], [1, 4]]
        assert out[r]["coord22"].tolist() == [r // 2, r % 2]


def test_batch_wav_to_wav_mesh_4x1(ranks):
    """batch_wav_to_wav under (4, 1), make_mesh's default data-only
    layout (t22 x2 tiled to four rows: one utterance a rank, no time
    split) against the single-device call on t22 x2: F0 within 1e-4 Hz
    with identical voicing and short-time RMS within 0.02 (the gates of
    the other layouts)."""
    inp, out = ranks.inp, ranks.out()
    x = torch.tensor(inp["w_x"])
    geo = TH.HarvestGeometry(int(inp["fs22"]), x.shape[1], f0_floor=40.0)
    y1, f01, ovf1 = TB.batch_wav_to_wav(
        x, torch.tensor(inp["w_noise"]), geo=geo, fs=int(inp["fs22"]),
        fft_size=int(inp["fft22"]), max_half_window=int(inp["mhw22"]),
        frame_period_s=0.00625, out_length=int(inp["w_out"]),
        max_pulses=int(inp["w_mp"]), pitch_scale=1.2, return_overflow=True)
    for r in range(WORLD):
        np.testing.assert_array_equal(out[r]["w41_f0"], out[0]["w41_f0"])
        np.testing.assert_array_equal(out[r]["w41_y"], out[0]["w41_y"])
    f0, y = out[0]["w41_f0"], out[0]["w41_y"]
    ref_f0, ref_y = np.tile(f01.numpy(), (2, 1)), np.tile(y1.numpy(), (2, 1))
    assert f0.shape == ref_f0.shape and y.shape == ref_y.shape
    assert not out[0]["w41_ovf"].any() and not ovf1.any()
    np.testing.assert_array_equal(f0 > 0, ref_f0 > 0)
    assert (f0 > 0).mean() > 0.3
    np.testing.assert_allclose(f0, ref_f0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(_short_time_rms(y), _short_time_rms(ref_y),
                               atol=0.02)


def test_process_local_batch_round_trip(ranks):
    """Each data row's ranks pass their two rows; the DTensor's local rows
    are theirs, and full_tensor() and gather_rows give the whole batch."""
    out, plb = ranks.out(), ranks.inp["plb"]
    for r in range(WORLD):
        d = r // 2
        np.testing.assert_array_equal(out[r]["plb_local"],
                                      plb[2 * d:2 * d + 2])
        np.testing.assert_array_equal(out[r]["plb_full"], plb)
        np.testing.assert_array_equal(out[r]["plb_rows"], plb)


def test_init_distributed_world_of_one(monkeypatch):
    """Without torchrun's variables or arguments: a world of this process
    alone; a second call changes nothing; global_mesh is (1, 1) and
    process_local_batch's DTensor gives back its rows."""
    import torch.distributed as dist
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    try:
        assert TD.init_distributed(device="cpu") == torch.device("cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert TD.init_distributed(device="cpu") == torch.device("cpu")
        assert dist.get_world_size() == 1
        mesh = TD.global_mesh(n_time=2)      # degrades to data-only
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "time")
        xb = np.arange(32, dtype=np.float32).reshape(4, 8)
        (g,) = TD.process_local_batch(mesh, [xb])
        assert tuple(g.shape) == (4, 8)
        np.testing.assert_array_equal(g.full_tensor().numpy(), xb)
        np.testing.assert_array_equal(TD.gather_rows(g).numpy(), xb)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def t16_head():
    """Two 0.51 s rows of t16 (511 frames of the 1 ms grid, 152 bands)
    and their single-device stages."""
    f = load_fixture("t16")
    x = np.asarray(f.x, np.float32)
    x = torch.tensor(np.stack([x[:8160], 0.5 * x[4000:12160]]))
    geo = TH.HarvestGeometry(f.fs, x.shape[1])
    return x, geo, TH.harvest_device_stages(x, geo=geo)


@pytest.mark.parametrize("parts", [2, 3])
def test_split_stages_equal_the_whole(t16_head, parts):
    """harvest_device_stages divided into ``parts`` parts (2: the frame
    slabs padded; 3: the band subsets and the frame slabs padded), each in
    a thread of its own whose ``join`` concatenates every part's tensor
    across a barrier, against ``WHOLE`` bit for bit in every part: the
    division the mesh's time ranks make, without ranks or collectives."""
    x, geo, (want_c, want_s) = t16_head
    barrier = threading.Barrier(parts, timeout=RANK_TIMEOUT_S)
    slots, got, errors = [None] * parts, [None] * parts, []

    def run(p):
        def join(t, axis):
            slots[p] = t
            barrier.wait()
            out = torch.cat(slots, dim=axis)
            barrier.wait()
            return out
        try:
            got[p] = TH.harvest_device_stages(
                x, geo=geo, split=TH.Split(parts, p, join))
        except BaseException as e:
            errors.append(e)
            barrier.abort()
            raise
    threads = [threading.Thread(target=run, args=(p,))
               for p in range(parts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=RANK_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert (want_c > 0).sum() > 500
    for c, s in got:
        assert torch.equal(c, want_c) and torch.equal(s, want_s)


def test_batch_harvest_device_stages_bitwise(ranks):
    """Harvest's stages under (2, 2) on t16 x4 (rows x, 0.5x, x, 0.25x;
    worldtpu's tests/test_parallel.py:79-100): candidates and scores equal
    to the port's single-device stages of each utterance bit for bit (each
    rank computed one utterance's; rows are independent)."""
    out = ranks.out()
    cand = _rows(out, "stages_cand", (0, 2))
    score = _rows(out, "stages_score", (0, 2))
    ref_c = np.concatenate([out[r]["stages_ref_cand"] for r in range(4)])
    ref_s = np.concatenate([out[r]["stages_ref_score"] for r in range(4)])
    assert cand.shape == ref_c.shape == (4, 3001, 105)
    assert (ref_c > 0).sum() > 1000
    np.testing.assert_array_equal(cand, ref_c)
    np.testing.assert_array_equal(score, ref_s)


@pytest.fixture(scope="module")
def single22(ranks):
    """The port's single-device F0 and analysis of the t22 x2 batch."""
    inp = ranks.inp
    x = torch.tensor(inp["x22"])
    geo = TH.HarvestGeometry(int(inp["fs22"]), x.shape[1], f0_floor=40.0)
    return TB.batch_analyze(x, geo=geo, fs=int(inp["fs22"]),
                            fft_size=int(inp["fft22"]),
                            max_half_window=int(inp["mhw22"]),
                            pitch_scale=1.2)


def test_batch_harvest_f0_mesh(ranks, single22):
    """batch_harvest_f0 under (2, 2) on t22 x2 against the single-device
    Harvest: within 1e-4 Hz (worldtpu's gate, :152-176), same voicing."""
    f0 = _rows(ranks.out(), "f0", (0, 2))
    ref = (single22[0] / 1.2).numpy()
    assert f0.shape == ref.shape
    np.testing.assert_array_equal(f0 > 0, ref > 0)
    np.testing.assert_allclose(f0, ref, rtol=0, atol=1e-4)


def test_batch_analyze_mesh(ranks, single22):
    """batch_analyze under (2, 2) (Harvest's stages over 'time', the
    analysis over 'data') against the single-device call: F0 within
    1e-4 Hz, the spectrogram and aperiodicity within 1e-5 relative of
    their largest value (float32)."""
    out = ranks.out()
    for key, ref, tol in (("analyze_f0", single22[0], 1e-4),
                          ("analyze_spec", single22[1], None),
                          ("analyze_ap", single22[2], None)):
        got, ref = _rows(out, key, (0, 2)), ref.numpy()
        assert got.shape == ref.shape
        atol = tol if tol is not None else 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_batch_copy_synthesis_f64_mesh(ranks):
    """float64 batch_copy_synthesis under (2, 2) on t22 x2 with the C++
    F0 (worldtpu's tests/test_parallel.py:37-64), inputs as DTensors:
    against the single-device call at rtol 1e-9, atol 1e-12; identical
    rows give identical outputs."""
    inp, out = ranks.inp, ranks.out()
    y1, spec1, ap1 = TB.batch_copy_synthesis(
        torch.tensor(inp["cs_x"][:1]), torch.tensor(inp["cs_f0"][:1]),
        torch.tensor(inp["cs_tpos"]), torch.tensor(inp["cs_noise"][:1]),
        fs=int(inp["fs22"]), fft_size=int(inp["fft22"]),
        max_half_window=int(inp["mhw22"]), frame_period_s=0.005,
        out_length=int(inp["cs_out"]), max_pulses=int(inp["cs_mp"]))
    y = _rows(out, "cs_y", (0, 2))
    assert y.shape == (2, int(inp["cs_out"])) and y.dtype == np.float64
    np.testing.assert_array_equal(y[1], y[0])
    np.testing.assert_array_equal(out[3]["cs_y_global"], y)
    for key, ref in (("cs_y", y1), ("cs_spec", spec1), ("cs_ap", ap1)):
        np.testing.assert_allclose(_rows(out, key, (0, 2))[0],
                                   ref[0].numpy(), rtol=1e-9, atol=1e-12)


def test_batch_wav_to_wav_mesh_1x4(ranks):
    """batch_wav_to_wav under (1, 4) (every rank one data shard, bands
    and frames over four time ranks) against (2, 2): F0 within 1e-4 Hz
    with identical voicing, short-time RMS within 0.02 (worldtpu's
    :179-216)."""
    out = ranks.out()
    f4, f2 = out[0]["w14_f0"], out[0]["w22_f0"]
    np.testing.assert_array_equal(f4 > 0, f2 > 0)
    np.testing.assert_allclose(f4, f2, rtol=0, atol=1e-4)
    np.testing.assert_allclose(_short_time_rms(out[0]["w14_y"]),
                               _short_time_rms(out[0]["w22_y"]), atol=0.02)


def test_long_pipeline_mesh(ranks, monkeypatch):
    """LongPipeline.copy_synthesis(mesh=) over four ranks (12 chunks,
    three a rank): every rank returns the same y, equal bit for bit to
    parallel=True and within the long-audio gates of the sequential run
    (tests/test_torch_longaudio.py)."""
    inp, out = ranks.inp, ranks.out()
    lp = TLA.LongPipeline(LONG_FS, f0_floor=40.0, chunk_frames=LONG_CHUNK,
                          harvest_chunk_ms=1500, harvest_halo_ms=750,
                          device="cpu")
    contour = (inp["l_f0"], inp["l_tpos"])
    lp.harvest.compute = lambda x, dtype=None: contour
    x = inp["l_x"]
    assert lp.plan(x, contour[0]).n_chunks == 12
    yp, f0p = lp.copy_synthesis(x, seed=7, parallel=True)
    ys, _ = lp.copy_synthesis(x, seed=7)
    for r in range(WORLD):
        np.testing.assert_array_equal(out[r]["long_f0"], f0p)
        np.testing.assert_array_equal(out[r]["long_y"], out[0]["long_y"])
    ym = out[0]["long_y"]
    np.testing.assert_array_equal(ym, yp)
    _assert_match(ym, ys)
    assert float(np.quantile(_windowed_rel(ym, ys), 0.99)) < 1e-3

