"""The port's extend walk on the CPU (its plain version) against the JAX
package's Pallas extend kernel in interpret mode, and the batched fix_step3
around it against JAX's fix_step3 with that kernel.  Inputs are made with
numpy from seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import (TIE_CANDS, check_extend_edge_case,
                             extend_edge_case, extend_tie_case)
from worldtpu.analysis import contour_device as CD
from worldtpu.ops.extend_kernel import extend_walk as j_extend_walk
from worldtpu_torch.analysis import contour_device as TCD
from worldtpu_torch.ops import extend_kernel as TE

torch.set_num_threads(1)


def _table(F, S, seed):
    """Candidates around a smooth F0 track plus scattered ones; some rows
    repeat a value (score max over equal values, equal-error ties), and a
    run of empty rows forces misses."""
    r = np.random.RandomState(seed)
    t = np.arange(F)
    f0 = 140 + 50 * np.sin(2 * np.pi * t / 300 + seed)
    cand = np.zeros((F, S), np.float32)
    score = np.zeros((F, S), np.float32)
    for f in range(F):
        k = r.randint(0, S + 1)
        cand[f, :k] = f0[f] * np.exp(0.25 * r.randn(k))
        score[f, :k] = r.uniform(0, 40, k)
        if k > 0 and r.rand() < 0.7:
            cand[f, r.randint(k)] = f0[f] * (1 + 0.01 * r.randn())
        if k > 2 and r.rand() < 0.2:
            cand[f, k - 1] = cand[f, 0]
    gap = r.randint(50, F - 60)
    cand[gap:gap + 8] = 0.0
    return cand, score, f0


def _walks(F, W, f0, seed, ext_lim):
    r = np.random.RandomState(10 + seed)
    origin = r.randint(1, F - 1, W)
    shift = np.where(np.arange(W) % 2 == 0, 1, -1)
    limit = np.where(shift > 0, np.minimum(origin + ext_lim, F - 2),
                     np.maximum(origin - ext_lim, 1))
    live = r.rand(W) < 0.85
    tmp0 = (f0[origin] * (1 + 0.02 * r.randn(W))).astype(np.float32)
    tmp0[::7] = 0.0                      # no reference yet: ref F0 1.0
    return origin, shift, live, np.abs(limit - origin), tmp0


def _plain_vs_pallas(cand, score, origin, shift, live, dist, tmp0, **kw):
    """The plain walk on the CPU against the Pallas kernel in interpret
    mode, utterance by utterance: n_on and so equal, the values and scores
    of the ON steps equal (NaN where the other has NaN), zeros after.
    Returns the plain walk's results and the Pallas n_on per utterance."""
    B, F, S = cand.shape
    E = kw["ext_lim"] + 1
    vals, scs, n_on, so = TE.extend_walk(
        torch.tensor(cand), torch.tensor(score), torch.tensor(origin),
        torch.tensor(shift), torch.tensor(live), torch.tensor(dist),
        torch.tensor(tmp0), **kw)
    assert vals.shape == scs.shape == (B, origin.shape[1], E)
    j_n = []
    for b in range(B):
        packed = np.zeros((F, 256), np.float32)
        packed[:, :S] = cand[b]
        packed[:, 128:128 + S] = score[b]
        jv, js, jn, jso = j_extend_walk(
            jnp.asarray(packed), jnp.asarray(origin[b]),
            jnp.asarray(shift[b]), jnp.asarray(live[b]),
            jnp.asarray(dist[b]), jnp.asarray(tmp0[b]), interpret=True,
            **kw)
        jv, js, jn = np.asarray(jv), np.asarray(js), np.asarray(jn)
        np.testing.assert_array_equal(n_on[b].numpy(), jn)
        np.testing.assert_array_equal(so[b].numpy(), np.asarray(jso))
        for w in range(origin.shape[1]):
            n = jn[w]
            np.testing.assert_array_equal(vals[b, w, :n].numpy(), jv[w, :n])
            np.testing.assert_array_equal(scs[b, w, :n].numpy(), js[w, :n])
        assert torch.all(vals[b][torch.arange(E) >= n_on[b][:, None]] == 0)
        j_n.append(jn)
    return (vals, scs, n_on, so), j_n


@pytest.mark.parametrize("S,ext_lim,miss_lim", [(13, 100, 4),
                                                (128, 40, 2)])
def test_extend_walk_plain_matches_pallas_interpret(S, ext_lim, miss_lim):
    F, W, B = 400, 24, 2
    tabs = [_table(F, S, b) for b in range(B)]
    walks = [_walks(F, W, f0, b, ext_lim) for b, (_, _, f0) in
             enumerate(tabs)]
    cand = np.stack([c for c, _, _ in tabs])
    score = np.stack([s for _, s, _ in tabs])
    origin, shift, live, dist, tmp0 = (np.stack(a) for a in zip(*walks))
    kw = dict(ext_lim=ext_lim, miss_lim=miss_lim, allowed_range=0.18)
    _, j_n = _plain_vs_pallas(cand, score, origin, shift, live, dist, tmp0,
                              **kw)
    E = ext_lim + 1
    stops = full = 0
    for b, jn in enumerate(j_n):
        stops += int(((jn < np.minimum(dist[b] + 1, E)) & live[b]).sum())
        full += int((jn == E).sum())
        assert (jn[~live[b]] == 0).all()
    # the cases the walk has: stopped by misses, run to ext_lim, dead
    assert stops > 0 and full > 0 and not live.all()


@pytest.mark.parametrize("S", [13, 45, 128])
def test_extend_walk_edge_cases_match_pallas_interpret(S):
    """The walk's edge cases the CUDA kernel must keep (a NaN in a row,
    ties on the least error, a miss scored by zero-candidate slots, a stop
    at miss_lim on the last allowed step, distance 0, S not a multiple of
    32): the plain walk equals the Pallas kernel and reaches each case."""
    args, kw = extend_edge_case(S)
    out, _ = _plain_vs_pallas(*args, **kw)
    check_extend_edge_case(*(t.numpy() for t in out))


def test_extend_walk_ties_of_distinct_distances():
    """Two candidates at different distances from the reference whose
    errors round to the same float: the plain walk and the Pallas kernel
    both keep the later slot.  S = 128: below it the Pallas kernel's zero
    pad slots (error 1 < allowed_range 2.5 here) would win the step."""
    args, kw = extend_tie_case(128)
    out, _ = _plain_vs_pallas(*args, **kw)
    assert out[0][0, :, 0].tolist() == [TIE_CANDS[1], TIE_CANDS[0]]


def _contour_batch(F, S, seeds):
    out = []
    for seed in seeds:
        r = np.random.RandomState(seed)
        t = np.arange(F)
        f0 = 150 + 60 * np.sin(2 * np.pi * t / 500 + seed)
        voiced = np.sin(2 * np.pi * t / (300 + 100 * seed)) > -0.4
        for _ in range(6):
            a = r.randint(0, F - 30)
            voiced[a:a + r.randint(2, 25)] = False
        cand = np.zeros((F, S), np.float32)
        score = np.zeros((F, S), np.float32)
        for f in range(F):
            k = r.randint(1, S)
            cand[f, 1:k] = f0[f] * np.exp(0.3 * r.randn(k - 1))
            score[f, 1:k] = r.uniform(0.1, 30, k - 1)
            if voiced[f]:
                cand[f, 0] = f0[f] * (1 + 0.003 * r.randn())
                score[f, 0] = 20 + 50 * r.rand()
        out.append((cand, score))
    return (np.stack([c for c, _ in out]), np.stack([s for _, s in out]))


def test_fix_step3_matches_jax_extend_kernel():
    """The batched fix_step3 (extend walk through extend_walk) against
    JAX's fix_step3 with its Pallas extend kernel in interpret mode:
    selection and copying only, so exact."""
    cand, score = _contour_batch(900, 21, (0, 1, 2))
    tc, ts = torch.tensor(cand), torch.tensor(score)
    s2 = TCD.fix_step2(TCD.fix_step1(TCD.search_f0_base(tc, ts), 0.008), 6)
    s3 = TCD.fix_step3(s2, tc, ts, 0.18)
    assert not torch.equal(s3, s2)          # the walks extended something
    for b in range(3):
        ref = CD.fix_step3(jnp.asarray(s2[b].numpy()), jnp.asarray(cand[b]),
                           jnp.asarray(score[b]), 0.18,
                           use_extend_kernel="interpret")
        np.testing.assert_array_equal(s3[b].numpy(), np.asarray(ref))


def test_extend_walk_cuda_checks_inputs():
    """The CUDA wrapper validates device and dtypes before any launch."""
    z = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TE.extend_walk_cuda(torch.zeros((1, 5, 3)), torch.zeros((1, 5, 3)),
                            z, z, z.bool(), z, torch.zeros((1, 2)),
                            ext_lim=4, miss_lim=2, allowed_range=0.18)
