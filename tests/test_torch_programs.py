"""The port's device programs on the CPU.

The float64 Harvest stages read nothing back to the host (the condition
of running them on the card without a synchronisation): refine_stage_f64
and _stages_f64 run with the host reads patched to raise, and still
match JAX's float64 refine_stage at rtol 1e-9.  LongPipeline's chunk step
takes its chunk index as an int64 tensor (JAX's traced ``k``): it equals,
bit for bit, the step that slices the plan's tables by host ints and
detects its pulses on host-int chunk offsets, in both dtypes, for one
chunk and for a parallel group filled up with repeats of the last chunk.
A loop's programs are keyed on its plan and dropped at its end.  The
replays themselves run on the card
(tests/test_torch_cuda.py, ``cuda``-marked)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from test_longform import _long_utterance
from test_torch_longaudio import _contour
from worldtpu.analysis import harvest as H
from worldtpu_torch import constants as TC
from worldtpu_torch import convert
from worldtpu_torch import longaudio as TLA
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.analysis.cheaptrick import cheaptrick_frames
from worldtpu_torch.analysis.d4c import d4c_frames
from worldtpu_torch.ops.interp import interp1
from worldtpu_torch.ops.ola_kernel import overlap_add
from worldtpu_torch.parallel import graphs as TG
from worldtpu_torch.synthesis import noise as TN
from worldtpu_torch.synthesis import synthesis as TS

torch.set_num_threads(1)

FS = 16000
HOST_READS = ((torch, "nonzero"), (torch.Tensor, "nonzero"),
              (torch.Tensor, "item"), (torch.Tensor, "tolist"),
              (torch.Tensor, "__bool__"), (torch.Tensor, "__int__"),
              (torch.Tensor, "__float__"))


@pytest.fixture
def no_host_reads(monkeypatch):
    """Every way the stages could read a tensor back to the host
    raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a host read inside the device stages")
    for owner, name in HOST_READS:
        monkeypatch.setattr(owner, name, refuse)


@pytest.fixture(scope="module")
def t22_head():
    """t22's first 0.36 s, decimated, its geometry and its float64
    candidates (computed before the patch)."""
    f = load_fixture("t22")
    x = np.asarray(f.x[:int(0.36 * f.fs)], np.float64)
    geo = H.HarvestGeometry(f.fs, len(x), f0_floor=40.0)
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    ty = TH.decimate_stage(torch.tensor(x)[None], ratio=geo.ratio,
                           y_length=geo.y_length)
    tt = torch.arange(geo.f0_length, dtype=torch.float64) / 1000.0
    zero = torch.zeros(1, dtype=torch.float64)
    tc, _, _ = TH.candidates_stage(ty, zero, tgeo)
    return x, geo, tgeo, ty, tt, tc


def test_f64_refine_makes_no_host_read(t22_head, no_host_reads):
    """refine_stage_f64 with every host read refused, against JAX's
    float64 refine_stage (rtol 1e-9, voicing identical)."""
    x, geo, tgeo, ty, tt, tc = t22_head
    tr, ts = TH.refine_stage_f64(ty, tc, tt, geo=tgeo)
    jy = H.decimate_stage(jnp.asarray(x), ratio=geo.ratio,
                          y_length=geo.y_length)
    jt = jnp.arange(geo.f0_length, dtype=jnp.float64) / 1000.0
    jr, js = H.refine_stage(jy, jnp.asarray(tc[0].numpy()), jt, geo=geo)
    assert (np.asarray(jr) > 0).sum() > 100
    np.testing.assert_array_equal(tr[0].numpy() > 0, np.asarray(jr) > 0)
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr), rtol=1e-9)
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js), rtol=1e-6)


def test_f64_stages_make_no_host_read(t22_head, no_host_reads):
    """_stages_f64 (candidates, refine, prune) with every host read
    refused, on a batch of two: each row equal to the stages of that
    utterance alone, and its refine to JAX's (rtol 1e-9)."""
    x, geo, tgeo, ty, tt, tc = t22_head
    y2 = torch.cat([ty, 0.5 * ty])
    zero = torch.zeros(2, dtype=torch.float64)
    cand, score = TH._stages_f64(y2, zero, tgeo)
    assert cand.shape == (2, geo.f0_length, geo.max_candidates)
    for b in range(2):
        c1, s1 = TH._stages_f64(y2[b:b + 1], zero[:1], tgeo)
        assert torch.equal(cand[b:b + 1], c1)
        assert torch.equal(score[b:b + 1], s1)
    jy = H.decimate_stage(jnp.asarray(x), ratio=geo.ratio,
                          y_length=geo.y_length)
    jt = jnp.arange(geo.f0_length, dtype=jnp.float64) / 1000.0
    jr, js = H.refine_stage(jy, jnp.asarray(tc[0].numpy()), jt, geo=geo)
    jp, _ = H.remove_unreliable_stage(jr, js)
    np.testing.assert_array_equal(cand[0].numpy() > 0, np.asarray(jp) > 0)
    np.testing.assert_allclose(cand[0].numpy(), np.asarray(jp), rtol=1e-9)


# ---------------------------------------------------------------------------
# LongPipeline's chunk step with a device chunk index
# ---------------------------------------------------------------------------

def _int_timebase(p, k0, k1, carry):
    """The chunked time base of chunks k0..k1-1 with the chunk's first
    output sample, the frame count and the output length as host ints
    (the eager step before the chunk index became a tensor)."""
    dt = p.cf0_dev.dtype
    n = p.L + p.slack
    G = k1 - k0
    o0 = torch.tensor([k * p.L for k in range(k0, k1)])
    s = torch.arange(n)
    if dt == torch.float64:
        flo = torch.tensor(p.flo[k0:k1])[:, None]
        knots = flo + torch.arange(p.Fb + 1)
        coarse_t = (torch.arange(p.Fb + 1, dtype=dt) * p.fp_s).expand(G, -1)
        t_loc = (o0[:, None] + s).to(dt) / p.fs - flo.to(dt) * p.fp_s
        f0i = interp1(coarse_t, p.cf0_dev[knots], t_loc)
        vuvi = interp1(coarse_t, p.cvuv_dev[knots], t_loc)
    else:
        t = (o0[:, None] + s).to(dt) / p.fs
        kn = torch.clamp((t / p.fp_s).to(torch.int32) + 1, 1,
                         p.F_total).long()
        sf = (t - (kn.to(dt) * p.fp_s - p.fp_s)) / p.fp_s
        f0i = p.cf0_dev[kn - 1] + sf * (p.cf0_dev[kn] - p.cf0_dev[kn - 1])
        vuvi = p.cvuv_dev[kn - 1] + sf * (p.cvuv_dev[kn]
                                          - p.cvuv_dev[kn - 1])
    vuvi = (vuvi > 0.5).to(dt)
    f0i = torch.where(vuvi == 0.0, torch.full((), TC.DEFAULT_F0, dtype=dt),
                      f0i)
    step = (f0i / p.fs * 4294967296.0 + 0.5).to(torch.int64)
    fbits = (carry[:, None] + torch.cumsum(step, dim=1)) & 0xFFFFFFFF
    wrap = ((fbits[:, 1:] < fbits[:, :-1])
            & (o0[:, None] + s[:-1] + 1 <= p.out_length - 1))
    # each row's wraps by nonzero (the host reads the dynamic-size
    # reference does), the fill the last local sample
    idx = torch.full((G, p.Pmax), n - 1, dtype=torch.int64)
    n_wrap = wrap.sum(1)
    for g in range(G):
        pos = torch.nonzero(wrap[g])[:, 0][:p.Pmax]
        idx[g, :len(pos)] = pos
    n_det = n_wrap.clamp(max=p.Pmax)
    own = (torch.arange(p.Pmax) < n_det[:, None]) & (
        idx < torch.clamp(p.out_length - o0, max=p.L)[:, None])
    n_own = own.sum(1)
    frac = fbits.to(dt) / 4294967296.0
    f_lo = frac.gather(1, idx)
    f_hi = frac.gather(1, (idx + 1).clamp(max=n - 1))
    nxt = torch.minimum(torch.arange(p.Pmax) + 1,
                        (n_det - 1)[:, None]).clamp(min=0)
    return dict(idx=idx, own=own, n_own=n_own, carry_out=fbits[:, p.L - 1],
                overflowed=(n_wrap > p.Pmax) | (n_own == p.Pmax),
                shift=(1.0 - f_lo) / (f_hi + 1.0 - f_lo) / p.fs,
                ns=torch.where(own, idx.gather(1, nxt) - idx, 0),
                vuv_at=vuvi.gather(1, idx),
                pt=(o0[:, None] + idx).to(dt) / p.fs / p.fp_s)


def _int_step(p, k0, k1, carry, ord0, key):
    """The chunk step of chunks k0..k1-1 with its tables sliced by host
    ints, its time base on host-int chunk offsets (``_int_timebase``) and
    the noise key as host words."""
    ks = range(k0, k1)
    x_blk = torch.stack([p.x_dev[p.a0[k] + p.halo:p.a0[k] + p.halo + p.A]
                         for k in ks])
    f0_blk = torch.stack([p.f0_dev[p.flo[k]:p.flo[k] + p.Fb] for k in ks])
    a0 = torch.tensor(p.a0[k0:k1])
    tpos = p.tpos_dev[k0:k1]
    spec = cheaptrick_frames(x_blk, f0_blk, tpos, fs=p.fs, fft_size=p.fft,
                             max_half_window=p.max_half_window,
                             sample_offset=a0)
    ap = d4c_frames(x_blk, f0_blk, tpos, fs=p.fs, fft_size_out=p.fft,
                    sample_offset=a0)
    pul = _int_timebase(p, k0, k1, carry)
    noise = TN.indexed_noise(key, ord0, p.Pmax, p.fft, dtype=spec.dtype)
    resp = TS.pulse_responses(pul["pt"], pul["shift"], pul["ns"],
                              pul["vuv_at"], pul["own"], spec, ap, noise,
                              fs=p.fs, fft_size=p.fft,
                              frame_offset=torch.tensor(p.flo[k0:k1]))
    buf = overlap_add(resp.contiguous(), pul["idx"].to(torch.int32),
                      p.L + p.fft, pul["n_own"])
    return buf, pul["carry_out"], ord0 + pul["n_own"], pul["overflowed"]


@pytest.fixture(scope="module")
def plans():
    """A 2 s utterance's chunk plans in both dtypes, with the prescan's
    entry states."""
    x = _long_utterance(FS, 2.0, seed=4)
    f0, _ = _contour(len(x))
    out = {}
    for dt in (torch.float32, torch.float64):
        lp = TLA.LongPipeline(FS, f0_floor=40.0, chunk_frames=60,
                              device="cpu")
        p = lp.plan(x.astype(np.float64) if dt == torch.float64 else x,
                    f0 * 1.2, 1.25, dt)
        carries, ords, ovf = TLA._phase_prescan(p, torch.device("cpu"))
        assert not bool(ovf.any()) and p.n_chunks >= 5
        out[dt] = (p, carries, ords)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("group", ["one", "padded"])
def test_chunk_step_device_index_equals_int_index(plans, dtype, group):
    """_step_program (the replayed program's body) with the chunk index,
    carry, ordinal and noise key as tensors equals the host-int step bit
    for bit: one chunk (G = 1), and the parallel mode's last group filled
    up with repeats of the last chunk (its real rows)."""
    p, carries, ords = plans[dtype]
    key = TN.as_key(11)
    if group == "one":
        k0, k1 = 2, 3
        ks = torch.tensor([2])
    else:
        k0, k1 = p.n_chunks - 2, p.n_chunks
        ks = torch.tensor([k0, k0 + 1, k0 + 1, k0 + 1])
    got = TG.eager(TLA._step_program, (ks, carries[ks], ords[ks],
                                       TN.key_tensor(key, "cpu")), plan=p)
    want = _int_step(p, k0, k1, carries[k0:k1], ords[k0:k1], key)
    n = k1 - k0
    assert got[0].dtype == dtype and got[0].shape[0] == len(ks)
    assert float(got[0][:n].abs().max()) > 0.0
    for g, w in zip(got, want):
        assert torch.equal(g[:n], w)


def test_chunk_programs_are_keyed_on_the_plan(plans):
    """A chunk program's key holds the recording's plan itself (identity:
    two plans of one recording are two keys) and the per-call tensors
    (chunk index, carry, ordinal, key) by shape alone; the plan's tables
    are its own, unpadded."""
    p, carries, ords = plans[torch.float32]
    q = TLA.LongPipeline(FS, f0_floor=40.0, chunk_frames=60,
                         device="cpu").plan(p.x_dev[p.halo:].numpy(),
                                            np.ones(p.F_total), 1.25)
    key = TN.key_tensor(11, "cpu")

    def k_of(plan, k):
        ks = torch.tensor([k])
        return TG.make_key(TLA._step_program,
                           (ks, carries[ks], ords[ks], key), {"plan": plan})
    assert k_of(p, 0) == k_of(p, 3)
    assert k_of(p, 0) != k_of(q, 0)
    assert hash(p) == object.__hash__(p) and p != q
    assert p.flo_dev.shape[0] == p.tpos_dev.shape[0] == p.n_chunks
    assert torch.equal(p.flo_dev, torch.tensor(p.flo))
    assert p.f0_dev.shape[0] == p.F_total + p.Fb


@pytest.mark.parametrize("parallel", [False, True], ids=["seq", "par"])
def test_loop_programs_live_as_long_as_the_loop(plans, parallel,
                                                monkeypatch):
    """A synthesis loop called without a cache keeps its programs (the
    chunk step's, and the prescan step's in the parallel mode) in a
    graphs.Programs cache of its own with one shared pool, keyed on its
    plan, and drops them at its end; its output is the eager loop's.
    (Capture stubbed with a replay that runs the function: the cache's
    bookkeeping, on the CPU.)"""
    monkeypatch.setattr(TLA, "PARALLEL_GROUP", 2)
    p, _, _ = plans[torch.float32]
    caches = []

    class Prog:
        def __init__(self, fn, static):
            self.fn, self.static = fn, static

        def replay(self, tensors, scale):
            return self.fn(*tensors, **self.static)

    def capture(fn, tensors, scale, static, pool):
        assert pool == "pool" and static == {"plan": p}
        return Prog(fn, static)

    real_clear = TG.Programs.clear

    def clear(self):
        caches.append((self.shared_pool, [k[0] for k in self.keys()]))
        real_clear(self)

    monkeypatch.setattr(TG, "capturable", lambda tensors, dtypes: True)
    monkeypatch.setattr(TG, "_capture", capture)
    monkeypatch.setattr(TG.Programs, "clear", clear)
    monkeypatch.setattr(TG.torch.cuda, "graph_pool_handle", lambda: "pool")
    lp = TLA.LongPipeline(FS, f0_floor=40.0, chunk_frames=60, device="cpu")
    loop = lp._parallel if parallel else lp._sequential
    y, ovf = loop(p, TN.as_key(3))
    want = ([TLA._prescan_program, TLA._step_program] if parallel
            else [TLA._step_program])
    assert caches == [(True, want)]
    y_e, ovf_e = loop(p, TN.as_key(3), call=TG.eager)
    assert np.array_equal(y, y_e) and torch.equal(ovf, ovf_e)
    assert len(caches) == 1 and TG.programs() == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_chunk_programs_make_no_host_transfer(plans, dtype, monkeypatch):
    """The chunk step's and the prescan step's programs read nothing back
    to the host and upload nothing from it (a captured CUDA graph can hold
    neither): with every such call refused they run through.  The float64
    cumulative sum's plain version (numpy, the CPU's stand-in for its
    kernel) is replaced by torch.cumsum for the check."""
    from worldtpu_torch.ops import seqsum
    p, carries, ords = plans[dtype]
    ks = torch.tensor([1, 2])
    args = (ks, carries[ks], ords[ks], TN.key_tensor(11, "cpu"))
    TG.eager(TLA._step_program, args, plan=p)              # fills caches

    def refuse(*a, **k):
        raise AssertionError("a host transfer inside a chunk program")
    monkeypatch.setattr(seqsum, "cumsum_sequential_plain",
                        lambda x: torch.cumsum(x, -1))
    for owner, name in HOST_READS + ((torch, "as_tensor"), (torch, "tensor"),
                                     (torch, "from_numpy"),
                                     (torch.Tensor, "numpy"),
                                     (torch.Tensor, "cpu")):
        monkeypatch.setattr(owner, name, refuse)
    buf, carry, ordn, ovf = TG.eager(TLA._step_program, args, plan=p)
    TLA._prescan_program(ks[:1], carries[:1], ords[:1], plan=p)
    monkeypatch.undo()
    assert buf.shape == (2, p.L + p.fft) and not bool(ovf.any())


def test_graph_cache_without_scale_and_with_a_pool(monkeypatch):
    """A graphs.Programs cache with a shared pool, called with no pitch
    scale: the first call runs eagerly, the second runs eagerly once more
    (the warm-up) and captures with the cache's pool and no scale buffer,
    later calls replay, a second key captures with the same pool; clear()
    drops the programs and the pool;
    graphs.eager runs the function as call would, outside any cache.
    (Capture and replay stubbed: the cache's bookkeeping, on the CPU.)"""
    seen, pools = [], iter(["pool-1", "pool-2"])

    class Prog:
        held = 5

        def replay(self, tensors, scale):
            seen.append(("replay", scale))
            return ("replayed",)

    def fn(x, *, tag):
        seen.append(("eager", tag))
        return (x + 1,)

    def capture(fn_, tensors, scale, static, pool):
        seen.append(("capture", scale, pool))
        return Prog()

    monkeypatch.setattr(TG, "capturable",
                        lambda tensors, dtypes: dtypes == TLA._DTYPES)
    monkeypatch.setattr(TG, "_capture", capture)
    monkeypatch.setattr(TG.torch.cuda, "graph_pool_handle",
                        lambda: next(pools))
    x = torch.zeros(2)
    progs = TG.Programs(shared_pool=True)
    outs = [progs.call(fn, (x,), dtypes=TLA._DTYPES, tag=1)
            for _ in range(3)]
    assert seen == [("eager", 1), ("eager", 1), ("capture", None, "pool-1"),
                    ("replay", None), ("replay", None)]
    assert outs[1:] == [("replayed",)] * 2
    assert torch.equal(outs[0][0], x + 1)
    for _ in range(2):
        progs.call(fn, (x,), dtypes=TLA._DTYPES, tag=2)
    assert seen[-2] == ("capture", None, "pool-1")
    assert len(progs.keys()) == 2 and progs.held() == [5, 5]
    assert TG.programs() == []                  # not the global cache
    assert torch.equal(TG.eager(fn, (x,), dtypes=TLA._DTYPES, tag=2)[0],
                       x + 1)
    progs.call(fn, (x,), tag=3)             # float32 only: stays eager
    assert seen[-1] == ("eager", 3) and len(progs.keys()) == 2
    progs.clear()
    assert progs.keys() == [] and progs._pool is None
    for _ in range(2):
        progs.call(fn, (x,), dtypes=TLA._DTYPES, tag=1)
    assert seen[-2] == ("capture", None, "pool-2")
