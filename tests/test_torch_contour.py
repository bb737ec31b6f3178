"""The port's batched device contour chain against the JAX one (f32) on
synthetic candidate slabs made with numpy from seeds: several utterances
per batch, so the masked batch loops (extend walk, section means, merge)
run with different section counts per row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldtpu.analysis import contour_device as CD
from worldtpu_torch.analysis import contour_device as TCD

torch.set_num_threads(1)


def _synth_candidates(F, S, seed):
    r = np.random.RandomState(seed)
    cand = np.zeros((F, S))
    score = np.zeros((F, S))
    t = np.arange(F)
    f0 = 150 + 60 * np.sin(2 * np.pi * t / 500 + seed)
    voiced = np.sin(2 * np.pi * t / (300 + 100 * seed)) > -0.4
    for _ in range(6):
        a = r.randint(0, F - 30)
        voiced[a:a + r.randint(2, 25)] = False
    for f in range(F):
        if not voiced[f]:
            if r.rand() < 0.2:
                k = r.randint(1, 4)
                cand[f, :k] = r.uniform(60, 500, k)
                score[f, :k] = r.uniform(0.1, 3, k)
            continue
        k = r.randint(1, min(8, S))
        cand[f, 0] = f0[f] * (1 + 0.003 * r.randn())
        score[f, 0] = 20 + r.rand() * 50
        cand[f, 1:k] = f0[f] * np.exp(0.3 * r.randn(k - 1))
        score[f, 1:k] = r.uniform(0.1, 30, k - 1)
    return cand.astype(np.float32), score.astype(np.float32)


def _batch(F, S, seeds):
    cs = [_synth_candidates(F, S, s) for s in seeds]
    return (np.stack([c for c, _ in cs]), np.stack([s for _, s in cs]))


@pytest.mark.parametrize("F,seeds", [(900, (0, 1, 2)), (1500, (3, 4))])
def test_fix_and_smooth_matches_jax(F, seeds):
    cand, score = _batch(F, 21, seeds)
    n_out = 1 + (F - 1) // 5
    out = TCD.fix_and_smooth(torch.tensor(cand), torch.tensor(score), n_out,
                             5.0).numpy()
    for b in range(len(seeds)):
        ref = np.asarray(CD.fix_and_smooth(jnp.asarray(cand[b]),
                                           jnp.asarray(score[b]), n_out, 5.0))
        np.testing.assert_array_equal(out[b] > 0, ref > 0)
        # f32 smoothing matmuls in another order: 1e-3 Hz
        np.testing.assert_allclose(out[b], ref, atol=1e-3)


def test_fix_steps_match_jax():
    cand, score = _batch(800, 14, (5, 6))
    tc, ts = torch.tensor(cand), torch.tensor(score)
    base = TCD.search_f0_base(tc, ts)
    s1 = TCD.fix_step1(base, 0.008)
    s2 = TCD.fix_step2(s1, 6)
    s3 = TCD.fix_step3(s2, tc, ts, 0.18)
    s4 = TCD.fix_step4(s3, 9)
    for b in range(2):
        jb = CD.search_f0_base(jnp.asarray(cand[b]), jnp.asarray(score[b]))
        j1 = CD.fix_step1(jb, 0.008)
        j2 = CD.fix_step2(j1, 6)
        j3 = CD.fix_step3(j2, jnp.asarray(cand[b]), jnp.asarray(score[b]),
                          0.18)
        j4 = CD.fix_step4(j3, 9)
        for mine, ref in ((base, jb), (s1, j1), (s2, j2), (s3, j3),
                          (s4, j4)):
            # selection steps copy candidate values: exact; the gap fill
            # interpolates in f32
            np.testing.assert_allclose(mine[b].numpy(), np.asarray(ref),
                                       rtol=1e-6)


def test_contour_all_unvoiced():
    cand = torch.zeros((2, 300, 7))
    score = torch.zeros((2, 300, 7))
    out = TCD.fix_and_smooth(cand, score, 61, 5.0)
    assert out.shape == (2, 61) and torch.all(out == 0)


def test_smooth_matches_jax():
    rng = np.random.RandomState(7)
    f0 = np.zeros((2, 700), np.float32)
    f0[0, 50:300] = 120 + 5 * rng.randn(250)
    f0[0, 400:650] = 200 + 5 * rng.randn(250)
    f0[1, 10:690] = 90 + 3 * rng.randn(680)
    out = TCD.smooth_f0_contour(torch.tensor(f0)).numpy()
    for b in range(2):
        ref = np.asarray(CD.smooth_f0_contour(jnp.asarray(f0[b])))
        np.testing.assert_allclose(out[b], ref, atol=1e-3)
