"""How ``correct`` is decided, on the CPU at a small size: the program (its
plain versions on the CPU) equals the reference bit for bit, so a sound run
reads 0 on every number; the harness's runs with the timed path broken
underneath come out not correct, once for each fault a corpus cell can
have: half of the batch left out, and an answer altered where it is
produced."""

import numpy as np
import pytest
import torch

from wtbench import harness as Hn

SEED = 2**31 + 4242


def small():
    cfg = dict(Hn.config("ljspeech-22k"), length_mean_s=0.45,
               clips_per_length_s=1000)
    mix = dict(Hn.traffic("corpus"), utterances=6, batch_size=2)
    return Hn.Context(workload={"name": "ljspeech-22k.corpus"}, config=cfg,
                      traffic=mix, seed=SEED, device=torch.device("cpu"),
                      trace=False)


@pytest.fixture(scope="module")
def corpus_cell(tmp_path_factory):
    from wtbench.entries import corpus as CE
    tempdir, CE.tempfile.tempdir = CE.tempfile.tempdir, str(
        tmp_path_factory.mktemp("tmp"))
    try:
        torch.set_num_threads(2)
        ctx = small()
        drv = Hn.entry(ctx.traffic["entry"])
        yield ctx, drv, drv.setup(ctx)
    finally:
        CE.tempfile.tempdir = tempdir


def run(ctx, drv, st, seconds=0.5):
    st = dict(st, kept=type(st["kept"])(list))
    res = drv.window(ctx, st, seconds)
    numbers = drv.check(ctx, st, res)
    return Hn.judge(numbers, Hn.limits(ctx.workload["name"])), numbers


def test_sound_run_equals_the_reference(corpus_cell):
    ctx, drv, st = corpus_cell
    (correct, rows), numbers = run(ctx, drv, st)
    assert all(v == 0.0 for _, v in numbers), numbers
    assert correct, rows


def altered(fn):
    """The batch entry with one answer altered where it is produced: the
    first row computed at a pitch one percent higher."""
    def wrap(x, noise, *, pitch_scale=1.0, **kw):
        y, f0, ovf = fn(x, noise, pitch_scale=pitch_scale, **kw)
        y2, f02, _ = fn(x, noise, pitch_scale=pitch_scale * 1.01, **kw)
        return torch.cat([y2[:1], y[1:]]), torch.cat([f02[:1], f0[1:]]), ovf
    return wrap


def half_left_out(fn):
    """The batch entry computing half of the batch: the other rows' outputs
    left as zeros."""
    def wrap(x, noise, **kw):
        h = x.shape[0] // 2 or 1
        y, f0, ovf = fn(x[:h], noise[:h], **kw)
        pad = lambda t: torch.cat([t, torch.zeros_like(t[:1]).expand(
            x.shape[0] - h, *t.shape[1:])])
        return pad(y), pad(f0), pad(ovf)
    return wrap


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
def test_broken_runs_are_not_correct(fault, corpus_cell, monkeypatch):
    """Each fault a corpus cell can have."""
    ctx, drv, st = corpus_cell
    import worldtpu_torch.parallel.batch as PB
    breaks = {"altered": altered, "half_left_out": half_left_out}[fault]
    monkeypatch.setattr(PB, "batch_wav_to_wav", breaks(PB.batch_wav_to_wav))
    (correct, rows), _ = run(ctx, drv, st)
    assert not correct, rows
    assert np.isfinite([v for _, v, _ in rows if v is not None]).all()


@pytest.mark.parametrize("fault", ["none", "ap3db"])
def test_planted_spectral_fault_is_not_correct(fault):
    """The reference with D4C's aperiodicity 3 dB higher in the program's
    place (``control.py --fault ap3db``) fails the comparison: the
    log-spectral distance sees what the envelope does not."""
    from wtbench import compare, control
    torch.set_num_threads(2)
    ctx = small()
    pairs = control.corpus_pairs(ctx, fault)
    correct, rows = Hn.judge(compare.numbers(pairs, ctx.config["fs"]),
                             Hn.limits(ctx.workload["name"]))
    assert correct == (fault == "none"), rows
    if fault == "ap3db":
        got = {n: v for n, v, _ in rows}
        limit = Hn.limits(ctx.workload["name"])
        assert got["y_env_rel"] <= limit["y_env_rel"]
        assert got["y_lsd_db"] > limit["y_lsd_db"]
