"""The port's own copies of the JAX package's numpy-only modules against the
originals: WAV and parameter files byte for byte, the host F0 contour and
its C smoothing helper bit for bit, the metrics JSON; and the CLI and the host contour branch of
HarvestKernel in a process where JAX and ``worldtpu`` cannot be imported."""

import gzip
import json
import pathlib
import shutil
import struct
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from worldtpu import metrics as jmetrics
from worldtpu import native as jnative
from worldtpu.analysis import contour as jcontour
from worldtpu.io import params as jparams
from worldtpu.io import wav as jwav
from worldtpu_torch import metrics as tmetrics
from worldtpu_torch import native as tnative
from worldtpu_torch.analysis import contour as tcontour
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.io import params as tparams
from worldtpu_torch.io import wav as twav

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).parent.parent
FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def _signal(seed, n=4000):
    rng = np.random.RandomState(seed)
    x = 0.5 * np.sin(np.arange(n) * 0.03) + 0.3 * rng.randn(n)
    x[:7] = [1.2, -1.3, 0.999999, -1.0, 32767 / 32768, 0.0, -0.0]
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_wavwrite_byte_identical(tmp_path, seed):
    """16-bit writes (clipping included) are byte-identical; each package
    reads back the other's file to the same samples."""
    x = _signal(seed)
    a, b = tmp_path / "j.wav", tmp_path / "t.wav"
    jwav.wavwrite(str(a), x, 22050)
    twav.wavwrite(str(b), x, 22050)
    assert a.read_bytes() == b.read_bytes()
    ya, fsa, na = twav.wavread(str(a))
    yb, fsb, nb = jwav.wavread(str(b))
    assert (fsa, na) == (fsb, nb) == (22050, 16)
    np.testing.assert_array_equal(ya, yb)
    assert twav.get_audio_length(str(a)) == jwav.get_audio_length(str(b))
    assert twav.wav_info(str(a)) == jwav.wav_info(str(b)) == (len(x), 22050,
                                                              16)
    with pytest.raises(ValueError, match="16-bit"):
        twav.wavwrite(str(b), x, 22050, nbit=24)


@pytest.mark.parametrize("nbit", [8, 24])
def test_wavread_other_depths(tmp_path, nbit):
    """8- and 24-bit PCM decode as the original does."""
    rng = np.random.RandomState(nbit)
    raw = rng.randint(0, 256, size=300 * (nbit // 8)).astype(np.uint8)
    path = tmp_path / "d.wav"
    nbytes = nbit // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + raw.size) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000,
                                      16000 * nbytes, nbytes, nbit))
        f.write(b"data" + struct.pack("<I", raw.size) + raw.tobytes())
    ya, fsa, na = twav.wavread(str(path))
    yb, fsb, nb = jwav.wavread(str(path))
    assert (fsa, na) == (fsb, nb) == (16000, nbit)
    np.testing.assert_array_equal(ya, yb)


def _write_kind(mod, kind, path, rng):
    if kind in ("f0", "f0_text"):
        f0 = np.where(rng.rand(50) > 0.3, 100 + 100 * rng.rand(50), 0.0)
        mod.write_f0(str(path), f0, 5.0, text=(kind == "f0_text"))
        return
    mat = rng.rand(12, 513) + 1e-6
    write = (mod.write_spectral_envelope if kind == "spec"
             else mod.write_aperiodicity)
    write(str(path), mat, 22050, 5.0, 1024)


def _read_kind(mod, kind, path):
    if kind == "f0":
        return mod.read_f0(str(path))
    if kind == "spec":
        return mod.read_spectral_envelope(str(path))
    return mod.read_aperiodicity(str(path))


@pytest.mark.parametrize("kind", ["f0", "f0_text", "spec", "ap"])
def test_params_files_byte_identical(tmp_path, kind):
    """F0, spectral envelope and aperiodicity files (binary, and text for
    F0) are byte-identical; each reads the other's file, plain and
    gzipped, to the same values and header."""
    a, b = tmp_path / "j.bin", tmp_path / "t.bin"
    _write_kind(jparams, kind, a, np.random.RandomState(7))
    _write_kind(tparams, kind, b, np.random.RandomState(7))
    assert a.read_bytes() == b.read_bytes()
    if kind == "f0_text":
        return
    for src in (a, b):
        gz = pathlib.Path(str(src) + ".gz")
        with open(src, "rb") as fi, gzip.open(gz, "wb") as fo:
            shutil.copyfileobj(fi, fo)
        for path in (src, gz):
            ra, rb = _read_kind(jparams, kind, path), _read_kind(tparams,
                                                                 kind, path)
            np.testing.assert_array_equal(ra[0], rb[0])
            if kind == "f0":
                np.testing.assert_array_equal(ra[1], rb[1])
                assert ra[2] == rb[2] == 5.0
            else:
                assert ra[1] == rb[1]
    for tag in ("NOF ", "FP  ", "FFT ", "FS  "):
        assert (tparams.get_header_information(str(b), tag)
                == jparams.get_header_information(str(a), tag))


@pytest.mark.parametrize("compress", [False, True])
def test_npz_identical(tmp_path, compress):
    """save_npz stores the same members byte for byte (the zip headers
    carry a time stamp); load_npz reads the other's file to the same
    values and Python types."""
    rng = np.random.RandomState(3)
    kw = dict(f0=rng.rand(2, 40), spectrogram=rng.rand(2, 40, 65),
              aperiodicity=rng.rand(2, 40, 65), fs=16000, frame_period=5.0,
              fft_size=128, compress=compress)
    a, b = tmp_path / "j.npz", tmp_path / "t.npz"
    jparams.save_npz(str(a), **kw)
    tparams.save_npz(str(b), **kw)
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist()
        for n in za.namelist():
            assert za.read(n) == zb.read(n), n
    la, lb = tparams.load_npz(str(a)), jparams.load_npz(str(b))
    assert set(la) == set(lb)
    for k in la:
        assert type(la[k]) is type(lb[k]), k
        np.testing.assert_array_equal(la[k], lb[k])


def _random_candidates(seed, F=900, S=8):
    """Candidate/score tables with a wandering voiced track, gaps, rivals
    and unvoiced stretches (float64, as HarvestKernel's host chain gets
    them)."""
    rng = np.random.RandomState(seed)
    t = np.arange(F)
    track = 140 + 40 * np.sin(2 * np.pi * t / 300.0) + rng.randn(F) * 0.3
    cand = rng.uniform(40, 800, (F, S))
    cand[:, rng.randint(S)] = track
    score = rng.uniform(0, 3, (F, S))
    score[np.abs(cand - track[:, None]) < 1e-9] += 4.0
    off = rng.rand(F) < 0.02
    for s0 in rng.randint(0, F - 40, 6):
        off[s0:s0 + rng.randint(3, 40)] = True
    cand[off] = 0.0
    score[off] = 0.0
    cand[rng.rand(F, S) < 0.2] = 0.0
    return cand, score


def _assert_contours_equal(cand, score):
    best_j = jcontour.fix_f0_contour(cand, score)
    best_t = tcontour.fix_f0_contour(cand, score)
    np.testing.assert_array_equal(best_t, best_j)
    sm_j = jcontour.smooth_f0_contour(best_j)
    sm_t = tcontour.smooth_f0_contour(best_t)
    np.testing.assert_array_equal(sm_t, sm_j)
    return best_t, sm_t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contour_equal_random(seed):
    """fix_f0_contour and smooth_f0_contour equal the originals exactly
    on seeded random candidate/score tables."""
    best, sm = _assert_contours_equal(*_random_candidates(seed))
    assert (best > 0).mean() > 0.3 and (sm > 0).sum() > 0


def test_contour_equal_t22_candidates():
    """... and on the device-stage candidates of the t22 fixture (the port's
    f32 stages on the CPU, widened to float64 as compute_batch does)."""
    x, fs, _ = twav.wavread(str(FIXTURES / "t22.wav"))
    geo = TH.HarvestGeometry(fs, len(x), f0_floor=40.0)
    with torch.no_grad():
        cand, score = TH.harvest_device_stages(
            torch.tensor(x, dtype=torch.float32)[None], geo=geo)
    cand = cand[0].numpy().astype(np.float64)
    score = score[0].numpy().astype(np.float64)
    best, _ = _assert_contours_equal(cand, score)
    assert (best > 0).mean() > 0.3


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_f0_helper_equals_python_loop(seed):
    """The port's C smoothing helper gives the bits of the module's Python
    loop and of the original C helper, on a padded voiced section."""
    rng = np.random.RandomState(seed)
    x = np.zeros(3000)
    x[300:2700] = 150 + 30 * np.sin(np.arange(2400) / 97.0) \
        + rng.randn(2400)
    b, a = tcontour._SMOOTH_B, tcontour._SMOOTH_A
    out = tnative.filter_f0(x, b, a)
    assert out is not None, "the C helper did not build"
    np.testing.assert_array_equal(
        out, tcontour._biquad_pass(tcontour._biquad_pass(x)))
    np.testing.assert_array_equal(out, jnative.filter_f0(x, b, a))


def test_metrics_json_equal(tmp_path):
    """MetricsRecorder emits the same JSON document."""
    docs = []
    for mod in (jmetrics, tmetrics):
        rec = mod.MetricsRecorder(audio_s=2.5)
        rec.add("harvest", 0.125, frames=501)
        rec.add("synthesis", 0.0625, pulses=300, audio_s=1.0)
        rec.add("cheaptrick", 0.03125)
        path = tmp_path / f"{mod.__name__}.json"
        s = rec.emit_json(str(path))
        assert path.read_text() == s + "\n"
        docs.append(s)
    assert docs[0] == docs[1]
    d = json.loads(docs[1])
    assert d["stages"][0]["rtf"] == 20.0 and d["total_wall_s"] == 0.21875


def test_cli_and_host_contour_without_worldtpu(tmp_path):
    """In a process where ``jax`` and ``worldtpu`` cannot be imported, the
    CLI analyzes t22 on the CPU (--f32) and HarvestKernel.compute_batch
    runs the host contour chain (HOST_CONTOUR_FRAMES lowered below the
    input's frames).  The files match what the JAX package's readers see,
    and the host F0 equals the original contour on the same candidates."""
    pre = str(tmp_path / "p")
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['worldtpu'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from worldtpu_torch.analysis import harvest as TH\n"
        "from worldtpu_torch.io import wav\n"
        f"x, fs, _ = wav.wavread({str(FIXTURES / 't22.wav')!r})\n"
        "x = x[:8000]\n"
        "TH.HOST_CONTOUR_FRAMES = 0\n"
        "hk = TH.HarvestKernel(fs, len(x), f0_floor=40.0, device='cpu')\n"
        "f0, tpos = hk.compute_batch(np.stack([x, 0.6 * x]))[0]\n"
        "from worldtpu_torch import native\n"
        "assert native._LIB is not None  # smoothed by the port's helper\n"
        f"np.save({pre + '_hk.npy'!r}, f0)\n"
        f"sys.argv = ['cli', 'analyze', {str(FIXTURES / 't22.wav')!r}, "
        f"{pre!r}, '--f32', '--device', 'cpu', '--metrics-json', "
        f"{pre + '.json'!r}]\n"
        "try:\n"
        "    runpy.run_module('worldtpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.startswith(('jax.', 'worldtpu.')))\n"
        "assert not bad, bad\n"
        "assert sys.modules['jax'] is None and sys.modules['worldtpu'] is None\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin:/usr/local/bin",
                            "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stdout[-2000:] + r.stderr[-2000:]
    f0, _, fp = jparams.read_f0(pre + ".f0")
    spec, meta = jparams.read_spectral_envelope(pre + ".spec")
    ap, _ = jparams.read_aperiodicity(pre + ".ap")
    assert fp == 5.0 and meta["fs"] == 22050
    assert spec.shape == ap.shape == (len(f0), meta["fft_size"] // 2 + 1)
    assert (f0 > 0).mean() > 0.3
    # the host F0 of the subprocess: the original contour on the same
    # candidates
    x, fs, _ = jwav.wavread(str(FIXTURES / "t22.wav"))
    x = x[:8000].astype(np.float32)
    geo = TH.HarvestGeometry(fs, len(x), f0_floor=40.0)
    with torch.no_grad():
        cand, score = TH.harvest_device_stages(
            torch.tensor(np.stack([x, 0.6 * x])), geo=geo)
    grid = jcontour.smooth_f0_contour(jcontour.fix_f0_contour(
        cand[0].numpy().astype(np.float64),
        score[0].numpy().astype(np.float64)))
    tpos = np.arange(geo.n_grid()) * geo.frame_period / 1000.0
    pick = np.minimum(geo.f0_length - 1,
                      np.floor(tpos * 1000.0 + 0.5).astype(np.int64))
    np.testing.assert_array_equal(np.load(pre + "_hk.npy"), grid[pick])
