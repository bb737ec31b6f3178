"""One rank of tests/test_torch_mesh.py: the port's mesh entry points on
gloo ranks on the CPU.

    python tests/torch_mesh_worker.py RANK WORLD_SIZE STORE DIR

The ranks meet at the FileStore STORE, read their inputs from
DIR/inputs.npz (written by the test module with numpy) and write what
they hold to DIR/rank{RANK}.npz; the test module compares.  Imports only
worldtpu_torch (and numpy, torch), never jax or worldtpu.
"""

import json
import sys
import time

import numpy as np
import torch

TIMEOUT_S = 300


def _stages_case(inp, mesh, out):
    """batch_harvest_device_stages under (2, 2) on t16 x4, and this rank's
    share of the single-device reference: row RANK of the batch."""
    from worldtpu_torch.analysis import harvest as H
    from worldtpu_torch.parallel import batch as B
    x = torch.tensor(inp["x16"])
    geo = H.HarvestGeometry(int(inp["fs16"]), x.shape[1])
    cand, score = B.batch_harvest_device_stages(x, geo=geo, mesh=mesh)
    out["stages_cand"] = cand.to_local().numpy()
    out["stages_score"] = score.to_local().numpy()
    r = torch.distributed.get_rank()
    rc, rs = H.harvest_device_stages(x[r:r + 1], geo=geo)
    out["stages_ref_cand"] = rc.numpy()
    out["stages_ref_score"] = rs.numpy()


def _geo22(inp, x):
    from worldtpu_torch.analysis import harvest as H
    return H.HarvestGeometry(int(inp["fs22"]), x.shape[1], f0_floor=40.0)


def _f0_case(inp, mesh, out):
    """batch_harvest_f0 and batch_analyze under (2, 2) on t22 x4."""
    from worldtpu_torch.parallel import batch as B
    x = torch.tensor(inp["x22"])
    geo = _geo22(inp, x)
    f0 = B.batch_harvest_f0(x, geo=geo, n_out=geo.n_grid(), mesh=mesh)
    out["f0"] = f0.to_local().numpy()
    f0a, spec, ap = B.batch_analyze(
        x, geo=geo, fs=int(inp["fs22"]), fft_size=int(inp["fft22"]),
        max_half_window=int(inp["mhw22"]), pitch_scale=1.2, mesh=mesh)
    out["analyze_f0"] = f0a.to_local().numpy()
    out["analyze_spec"] = spec.to_local().numpy()
    out["analyze_ap"] = ap.to_local().numpy()


def _copy_syn_case(inp, mesh, out):
    """float64 batch_copy_synthesis under (2, 2) on t22 x2 with the C++
    F0, its inputs as DTensors (process_local_batch)."""
    from worldtpu_torch.parallel import batch as B
    from worldtpu_torch.parallel import distributed as D
    d = mesh.get_local_rank("data")
    x, f0, noise = (inp[k][d:d + 1] for k in ("cs_x", "cs_f0", "cs_noise"))
    xg, f0g, ng = D.process_local_batch(mesh, [x, f0, noise])
    y, spec, ap = B.batch_copy_synthesis(
        xg, f0g, torch.tensor(inp["cs_tpos"]), ng, fs=int(inp["fs22"]),
        fft_size=int(inp["fft22"]), max_half_window=int(inp["mhw22"]),
        frame_period_s=0.005, out_length=int(inp["cs_out"]),
        max_pulses=int(inp["cs_mp"]), mesh=mesh)
    out["cs_y"] = y.to_local().numpy()
    out["cs_spec"] = spec.to_local().numpy()
    out["cs_ap"] = ap.to_local().numpy()
    out["cs_y_global"] = D.gather_rows(y).numpy()


def _wav_to_wav_case(inp, mesh, out, tag, tiles=1):
    """batch_wav_to_wav on t22 x2 (its rows and noise tiled ``tiles``
    times), pitch x1.2, duration x1.25."""
    from worldtpu_torch.parallel import batch as B
    x = torch.tensor(np.tile(inp["w_x"], (tiles, 1)))
    geo = _geo22(inp, x)
    y, f0, ovf = B.batch_wav_to_wav(
        x, torch.tensor(np.tile(inp["w_noise"], (tiles, 1, 1))), geo=geo,
        fs=int(inp["fs22"]),
        fft_size=int(inp["fft22"]), max_half_window=int(inp["mhw22"]),
        frame_period_s=0.00625, out_length=int(inp["w_out"]),
        max_pulses=int(inp["w_mp"]), pitch_scale=1.2, return_overflow=True,
        mesh=mesh)
    out[f"{tag}_y"] = y.full_tensor().numpy()
    out[f"{tag}_f0"] = f0.full_tensor().numpy()
    out[f"{tag}_ovf"] = ovf.full_tensor().numpy()


def _long_case(inp, mesh, out):
    """LongPipeline.copy_synthesis(mesh=) on a 3 s utterance whose Harvest
    gives the analytic contour."""
    from worldtpu_torch import longaudio as LA
    lp = LA.LongPipeline(int(inp["l_fs"]), f0_floor=40.0,
                         chunk_frames=int(inp["l_chunk"]),
                         harvest_chunk_ms=1500, harvest_halo_ms=750,
                         device="cpu")
    contour = (inp["l_f0"], inp["l_tpos"])
    lp.harvest.compute = lambda x, dtype=None: contour
    y, f0 = lp.copy_synthesis(inp["l_x"], seed=7, mesh=mesh)
    out["long_y"] = y
    out["long_f0"] = f0


def main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    from worldtpu_torch.parallel import batch as B
    from worldtpu_torch.parallel import distributed as D
    inp = dict(np.load(f"{out_dir}/inputs.npz"))
    out, secs = {}, {}
    D.init_distributed(backend="gloo", init_method=f"file://{store}",
                       world_size=world, rank=rank, device="cpu",
                       timeout=TIMEOUT_S)
    D.init_distributed(device="cpu")             # a second call
    meshes = {"m22": B.make_mesh(2, 2), "m14": B.make_mesh(1, 4),
              "m31": B.make_mesh(3, 1), "m_t2": B.make_mesh(n_time=2),
              "global": D.global_mesh(n_time=4)}
    out["mesh_shapes"] = np.array([m.shape for m in meshes.values()])
    m22 = meshes["m22"]
    out["coord22"] = np.array(m22.get_coordinate())
    d = m22.get_local_rank("data")
    (g,) = D.process_local_batch(m22, [inp["plb"][2 * d:2 * d + 2]])
    out["plb_local"] = g.to_local().numpy()
    out["plb_full"] = g.full_tensor().numpy()
    out["plb_rows"] = D.gather_rows(g).numpy()
    for name, fn in (("stages", _stages_case), ("f0", _f0_case),
                     ("copy_syn", _copy_syn_case),
                     ("w2w", lambda i, m, o: _wav_to_wav_case(
                         i, m, o, "w22")),
                     ("w2w_14", lambda i, m, o: _wav_to_wav_case(
                         i, meshes["m14"], o, "w14")),
                     ("w2w_41", lambda i, m, o: _wav_to_wav_case(
                         i, meshes["m31"], o, "w41", tiles=2)),
                     ("long", _long_case)):
        t0 = time.perf_counter()
        fn(inp, m22, out)
        secs[name] = round(time.perf_counter() - t0, 2)
    torch.distributed.barrier()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    print(json.dumps({"rank": rank, "seconds": secs}), file=sys.stderr)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
