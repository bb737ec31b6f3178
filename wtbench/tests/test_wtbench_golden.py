"""A second witness for the reference: the frozen copy's Harvest F0, and its
CheapTrick envelope and D4C aperiodicity given the C++ F0, against the C++
WORLD dumps the repository keeps (``tests/fixtures/t22.*`` at 22,050 Hz and
``t48.*`` at 48 kHz, the configurations' rates), at the configurations'
analysis settings: frame period 5 ms, Harvest floor 40 Hz, ceiling 800 Hz,
CheapTrick at its default floor (fft 1024 and 2048).  The reference runs in
float32 and the dumps are float64; the limits are a few times what the
copy reads (F0 relative RMS 1.3e-5 and 7.8e-4, log-envelope RMS 2.0e-5 and
1.0e-3, aperiodicity RMS 6.7e-6 and 4.9e-5)."""

import gzip
import pathlib
import struct
import wave

import numpy as np
import pytest
import torch

from wtbench import reference as R
from wtbench.reference.analysis import harvest as H
from wtbench.reference.analysis.cheaptrick import cheaptrick_frames
from wtbench.reference.analysis.d4c import d4c_frames

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"


def read_wav(name):
    with wave.open(str(FIXTURES / f"{name}.wav")) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        return pcm / 32768.0, w.getframerate()


def read_f0(name):
    """The C++ F0 (tools/parameterio's layout: magic, count at 8, frame
    period at 16, values from 24)."""
    raw = gzip.open(FIXTURES / f"{name}.f0.gz").read()
    assert raw[:4] == b"F0  "
    (nof,) = struct.unpack("<i", raw[8:12])
    (fp,) = struct.unpack("<d", raw[16:24])
    return np.frombuffer(raw[24:24 + 8 * nof], "<f8"), fp


def read_matrix(name, ext, magic):
    """A C++ envelope or aperiodicity dump: [frames, fft/2 + 1], fft."""
    raw = gzip.open(FIXTURES / f"{name}.{ext}.gz").read()
    assert raw[:4] == magic
    (nof,) = struct.unpack("<i", raw[8:12])
    (fft,) = struct.unpack("<i", raw[28:32])
    k = fft // 2 + 1
    return np.frombuffer(raw[48:48 + 8 * nof * k], "<f8").reshape(nof, k), fft


@pytest.mark.parametrize("name,fs,f0_lim,sp_lim,ap_lim", [
    ("t22", 22050, 1e-4, 1e-4, 5e-5),
    ("t48", 48000, 3e-3, 5e-3, 3e-4),
])
def test_reference_agrees_with_the_cpp_dumps(name, fs, f0_lim, sp_lim,
                                             ap_lim):
    torch.set_num_threads(2)
    x, rate = read_wav(name)
    f0_cpp, fp = read_f0(name)
    assert rate == fs and fp == 5.0
    xt = torch.tensor(x, dtype=torch.float32)[None]
    geo = H.HarvestGeometry(fs, x.size, f0_floor=40.0, f0_ceil=800.0,
                            frame_period=fp)
    f0 = H.harvest_device_full(xt, torch.zeros(1), geo=geo,
                               n_out=len(f0_cpp))[0].double().numpy()
    v, v_cpp = f0 > 0, f0_cpp > 0
    assert np.array_equal(v, v_cpp)
    assert v.sum() > len(v) // 4
    rel = (f0[v] - f0_cpp[v]) / f0_cpp[v]
    assert np.sqrt(np.mean(rel ** 2)) < f0_lim

    spec_cpp, fft = read_matrix(name, "spec", b"SPEC")
    ap_cpp, _ = read_matrix(name, "ap", b"AP  ")
    sz = R.sizes(fs, x.size, frame_period_ms=fp, duration_scale=1.0)
    assert fft == sz["fft_size"]
    f0t = torch.tensor(f0_cpp, dtype=torch.float32)[None]
    tpos = torch.arange(len(f0_cpp), dtype=torch.float32) * (fp / 1000.0)
    spec = cheaptrick_frames(xt, f0t, tpos, fs=fs, fft_size=fft,
                             max_half_window=sz["max_half_window"])[0]
    ap = d4c_frames(xt, f0t, tpos, fs=fs, fft_size_out=fft)[0]
    d = np.log(spec.double().numpy()) - np.log(spec_cpp)
    assert np.sqrt(np.mean(d ** 2)) < sp_lim
    assert np.sqrt(np.mean((ap.double().numpy() - ap_cpp) ** 2)) < ap_lim
