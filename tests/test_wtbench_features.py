"""The feature cell (``ljspeech-22k-tts.features``) on the CPU at a small
size: its entry (``wtbench/entries/corpus_features.py``), its comparison
(``wtbench/compare_features.py``), its controls
(``wtbench/control_features.py``), the plain codec reference
(``wtbench/reference/codec.py``) and the codec stage's reader.

The program (its plain versions on the CPU) against the reference reads 0
on the F0 numbers and the codec's float32 rounding on the coded ones, and
comes out correct; the harness's runs come out not correct with half of
each batch left out, with one answer at a 1% higher pitch, and with the
reference computed otherwise in the program's place (ap3db, the float16
FFT fault), while the reference against itself reads 0.  The reference
codec is tied to the JAX package's codec and to the C++ codec's dumps.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from wtbench import compare_features as CF
from wtbench import control_features as CTL
from wtbench import generate as G, harness as Hn, stages, trace as T
from wtbench.entries import corpus_features as FE
from wtbench.reference import codec as RC

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "ljspeech-22k-tts.features"
SEED = 2**31 + 2323


def small(seed=SEED):
    """The cell at six 0.3 s clips in batches of two."""
    cfg = dict(Hn.config("ljspeech-22k-tts"), length_mean_s=0.3,
               clips_per_length_s=1000)
    mix = dict(Hn.traffic("features"), utterances=6, batch_size=2)
    return Hn.Context(workload={"name": CELL}, config=cfg, traffic=mix,
                      seed=seed, device=torch.device("cpu"), trace=False)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    from wtbench.entries import corpus as CE
    tempdir, CE.tempfile.tempdir = CE.tempfile.tempdir, str(
        tmp_path_factory.mktemp("tmp"))
    try:
        ctx = small()
        yield ctx, FE.setup(ctx)
    finally:
        CE.tempfile.tempdir = tempdir


def run(ctx, st, seconds=0.5):
    st = dict(st, kept=type(st["kept"])(list))
    res = FE.window(ctx, st, seconds)
    numbers = FE.check(ctx, st, res)
    return Hn.judge(numbers, Hn.limits(CELL)), numbers, res


def test_sound_run_matches_the_reference(cell):
    """F0 equal to the reference's; the coded frames apart by the two
    codecs' float32 roundings (an FFT against a cosine sum); correct."""
    ctx, st = cell
    (correct, rows), numbers, res = run(ctx, st)
    got = dict(numbers)
    assert got["length_mismatch"] == 0 and got["f0_vuv_err"] == 0
    assert got["f0_rel_med"] == 0
    assert 0 < got["mcep_rms_med"] < 1e-6 and got["bap_db_med"] < 1e-5
    assert correct, rows
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["e2e"]["rtf"] > 0


def altered(fn):
    """The entry point with the first row computed at a pitch one percent
    higher."""
    def wrap(x, *, pitch_scale=1.0, **kw):
        a = fn(x, pitch_scale=pitch_scale, **kw)
        b = fn(x, pitch_scale=pitch_scale * 1.01, **kw)
        return tuple(torch.cat([v[:1], u[1:]]) for u, v in zip(a, b))
    return wrap


def half_left_out(fn):
    """The entry point computing half of the batch, the other rows'
    outputs left as zeros."""
    def wrap(x, **kw):
        h = x.shape[0] // 2 or 1
        outs = fn(x[:h], **kw)
        return tuple(torch.cat([t, torch.zeros_like(t[:1]).expand(
            x.shape[0] - h, *t.shape[1:])]) for t in outs)
    return wrap


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
def test_broken_runs_are_not_correct(fault, cell, monkeypatch):
    ctx, st = cell
    import worldtpu_torch.parallel.batch as PB
    breaks = {"altered": altered, "half_left_out": half_left_out}[fault]
    monkeypatch.setattr(PB, "batch_features", breaks(PB.batch_features))
    (correct, rows), _, _ = run(ctx, st)
    assert not correct, rows
    assert np.isfinite([v for _, v, _ in rows if v is not None]).all()


@pytest.mark.parametrize("fault", ["none", "ap3db", "fft16"])
def test_planted_faults_are_not_correct(fault):
    """The reference against itself reads 0 on every number; with D4C's
    aperiodicity 3 dB higher it fails the coded aperiodicity alone; with
    CheapTrick's and D4C's FFTs at float16's precision it fails the coded
    envelope."""
    ctx = small()
    numbers = CF.numbers(CTL.feature_pairs(ctx, fault))
    correct, rows = Hn.judge(numbers, Hn.limits(CELL))
    got, limit = dict(numbers), Hn.limits(CELL)
    assert correct == (fault == "none"), rows
    if fault == "none":
        assert all(v == 0 for v in got.values()), got
    elif fault == "ap3db":
        assert got["bap_db_med"] > limit["bap_db_med"]
        assert got["mcep_rms_med"] == 0 and got["f0_rel_med"] == 0
    else:
        assert got["mcep_rms_med"] > limit["mcep_rms_med"]
        assert got["f0_rel_med"] == 0


def test_comparison_counts_a_shorter_or_non_finite_answer():
    f0 = np.array([0.0, 120.0, 121.0])
    mc, ba = np.ones((3, 4)), -np.ones((3, 2))
    good = (f0, f0, mc, mc, ba, ba)
    short = (f0[:2], f0, mc[:2], mc, ba[:2], ba)
    nan = (f0, f0, mc * np.nan, mc, ba, ba)
    got = dict(CF.numbers([good, short, nan]))
    assert got["length_mismatch"] == 2
    assert got["f0_vuv_err"] == 0 and got["mcep_rms_med"] == 0
    assert dict(CF.numbers([short]))["f0_vuv_err"] is None


def test_half_rounding_is_float16s_within_its_range():
    x = torch.randn(50000, generator=torch.Generator().manual_seed(3)) * 300
    assert torch.equal(CTL._half(x), x.half().float())
    big = torch.tensor([1e12, -3e9])
    assert torch.allclose(CTL._half(big), big, rtol=2 ** -11, atol=0)
    assert torch.isfinite(CTL._half(big)).all()


@pytest.mark.parametrize("name", ["t16", "t22", "t48"])
def test_reference_codec_against_jax_and_cpp(name):
    """The reference codec in float32 on the fixtures' analysis against
    ``worldtpu.codec`` in float32 and against the C++ codec's float64
    dumps, at tests/test_torch_codec.py's float32 tolerances (coded
    envelope 2e-5 of its largest magnitude, coded aperiodicity 2e-5 dB):
    WORLD's scale of the DCT, its mel axis and its band sampling."""
    import jax.numpy as jnp
    from conftest import load_fixture
    from worldtpu import codec as J
    f = load_fixture(name)
    kw = dict(fs=f.fs, fft_size=f.fft_size)
    spec, ap = f.spec.astype(np.float32), f.ap.astype(np.float32)
    assert RC.n_aperiodicities(f.fs) == f.n_ap
    cs = RC.code_spectral_envelope(torch.tensor(spec), n_dims=f.ndim_se,
                                   **kw).numpy()
    ca = RC.code_aperiodicity(torch.tensor(ap), **kw).numpy()
    assert cs.dtype == np.float32 and ca.shape == f.coded_ap.shape
    for want_s, want_a in (
            (np.asarray(J.code_spectral_envelope(
                jnp.asarray(spec), n_dims=f.ndim_se, **kw)),
             np.asarray(J.code_aperiodicity(jnp.asarray(ap), **kw))),
            (f.coded_spec, f.coded_ap)):
        assert np.abs(cs - want_s).max() <= 2e-5 * np.abs(want_s).max()
        np.testing.assert_allclose(ca, want_a, rtol=0, atol=2e-5)


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_new_benchmark_files_import_no_jax_and_the_reference_no_program():
    files = [ROOT / "wtbench" / p for p in (
        "reference/codec.py", "compare_features.py", "control_features.py",
        "entries/corpus_features.py", "metrics/codec.device_ms.replay.py")]
    for path in files:
        assert not _imports(path) & {"jax", "jaxlib", "worldtpu"}, path
    assert not _imports(files[0]) & {"worldtpu_torch"}


def test_checked_batches_share_one_padded_length():
    """At the cell's sizes the stretch pads to three lengths; the checked
    batches are one length's first, second and a later batch, drawn from
    the seed."""
    cfg, mix = Hn.config("ljspeech-22k-tts"), Hn.traffic("features")
    batches = G.corpus_batches(G.corpus_lengths(cfg, mix), cfg, mix)
    lengths = sorted({b[2] for b in batches})
    assert len(batches) == 64 and len(lengths) == 3
    for seed in (1, 2**40 + 9, 7):
        ks = FE.checked_batches(batches, seed)
        same = [k for k, b in enumerate(batches)
                if b[2] == batches[ks[0]][2]]
        assert ks[:2] == same[:2] and ks[2] in same[2:]


def test_configuration_and_cell_entries():
    """The configuration's codec sizes are WORLD's at 22,050 Hz and
    Merlin's 60; BENCHMARK.json names it with its file and the cell with
    its metrics, each new name within the harness's limits."""
    cfg = Hn.config("ljspeech-22k-tts")
    assert RC.n_aperiodicities(cfg["fs"]) == cfg["n_ap"] == 2
    assert cfg["n_dims"] == cfg["published"]["mgc_dims"] == 60
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}["ljspeech-22k-tts"]
    assert conf["file"] == "wtbench/configs/ljspeech-22k-tts.json"
    assert conf["source"] == cfg["source"] and len(conf["source"]) <= 200
    assert set(conf["reduced"]) == set(cfg["reduced"]) == {"clips"}
    cell_ = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell_["chips"] == 1 and len(cell_["why"]) <= 200
    names = {m["name"] for m in Hn.cell_metrics(bench, CELL, True)}
    assert "codec.device_ms.replay" in names
    assert "synthesis.device_ms.replay" not in names
    assert {m["name"] for m in Hn.cell_metrics(bench, CELL, False)} == {
        "rtf.replay", "setup_s"}
    for m in Hn.cell_metrics(bench, CELL, True):
        assert (ROOT / "wtbench" / "metrics" / f"{m['name']}.py").exists()


def _trace(with_codec):
    ms = 1_000_000
    dev = [("wt_mark_d4c_in", 1 * ms, 1 * ms + 1), ("d4c_op", 2 * ms, 3 * ms),
           ("wt_mark_d4c_out", 3 * ms, 3 * ms + 1)]
    if with_codec:
        dev += [("wt_mark_codec_in", 4 * ms, 4 * ms + 1),
                ("rfft", 5 * ms, 5 * ms + 500_000),
                ("wt_mark_codec_out", 6 * ms, 6 * ms + 1)]
    host = [("wtbench.window", 0, 10 * ms)]
    return T.Trace(dev, host, *T.window_bounds(host))


def test_codec_reader():
    """The codec's device ms a batch between its marks; None in a trace
    without them (a program without the stage) or without a trace."""
    reader = Hn.load_module(ROOT / "wtbench" / "metrics"
                            / "codec.device_ms.replay.py")
    traced = type("Traced", (), {"batches": 2})()
    got = reader.read({"trace": _trace(True), "traced": traced})
    assert got == pytest.approx(0.25)
    assert reader.read({"trace": _trace(False), "traced": traced}) is None
    assert reader.read({}) is None
    assert stages.device_ms({"trace": _trace(True), "traced": traced},
                            ("d4c",)) == pytest.approx(0.5)
