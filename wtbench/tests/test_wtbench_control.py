"""The control and the planted spectral fault on the card: the reference
computed with TF32 matrix products, or with D4C's aperiodicity 3 dB higher,
in the program's place, fails the cell's comparison, at a size a test run
holds (three seeds, a shortened stretch); the reference against itself
passes.  Run on a machine
with an NVIDIA GPU: ``python -m pytest wtbench/tests -m cuda``."""

import pytest
import torch

from wtbench import compare, control, harness as Hn

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def judged(workload, seed, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control runs on the card)")
    cell = control.workload(workload)
    cfg = Hn.config(cell["config"])
    mix = dict(Hn.traffic(cell["traffic"]), utterances=48)
    ctx = Hn.Context(workload=cell, config=cfg, traffic=mix, seed=seed,
                     device=torch.device("cuda", 0), trace=False)
    return Hn.judge(compare.numbers(control.corpus_pairs(ctx, fault),
                                    cfg["fs"]), Hn.limits(workload))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["tf32", "ap3db"])
@pytest.mark.parametrize("workload", ["ljspeech-22k.corpus",
                                      "vctk-48k.corpus"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_and_faults_are_not_correct(workload, seed, fault):
    correct, rows = judged(workload, seed, fault)
    assert not correct, rows


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ljspeech-22k.corpus",
                                      "vctk-48k.corpus"])
def test_reference_against_itself_is_correct(workload):
    correct, rows = judged(workload, SEEDS[0], "none")
    assert correct, rows
    got = {n: v for n, v, _ in rows}
    # F0 is exact run to run; y's overlap-add sums with the card's atomics
    assert got["f0_vuv_err"] == got["f0_rel_med"] == 0.0, rows
    assert got["y_env_rel"] < 1e-6 and got["y_lsd_db"] < 1e-3, rows
