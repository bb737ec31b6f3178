"""Byte-compatible readers/writers for the reference's parameter files.

The port's own copy of ``worldtpu/io/params.py`` (numpy only, unchanged in
behaviour; ``tests/test_torch_io.py`` holds the files byte for byte).

Format (reference tools/parameterio.cpp:16-56,60-244): 4-byte
magic "F0  " / "SPEC" / "AP  ", then tagged fields — ("NOF ", i32),
("FP  ", f64), and for SPEC/AP also ("FFT ", i32), ("NOD ", i32),
("FS  ", i32) — followed by raw little-endian float64 frames.  NOD == 0 means
the full fft_size/2 + 1 bins.

Files ending in .gz are transparently decompressed on read.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np


def _open_read(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def write_f0(path, f0, frame_period, temporal_positions=None, text=False):
    """Binary (default) or text F0 file (reference WriteF0 text_flag,
    tools/parameterio.cpp:60-88)."""
    f0 = np.ascontiguousarray(f0, dtype="<f8")
    if text:
        if temporal_positions is None:
            temporal_positions = np.arange(len(f0)) * frame_period / 1000.0
        with open(path, "w") as f:
            for t, v in zip(temporal_positions, f0):
                f.write(f"{t:.5f} {v:.5f}\r\n")
        return
    with open(path, "wb") as f:
        f.write(b"F0  ")
        f.write(b"NOF " + struct.pack("<i", len(f0)))
        f.write(b"FP  " + struct.pack("<d", frame_period))
        f.write(f0.tobytes())


def read_f0(path):
    """Returns (f0 [F], temporal_positions [F], frame_period)."""
    with _open_read(path) as f:
        data = f.read()
    if data[:4] != b"F0  ":
        raise ValueError(f"{path}: bad F0 magic")
    (nof,) = struct.unpack("<i", data[8:12])
    (fp,) = struct.unpack("<d", data[16:24])
    f0 = np.frombuffer(data[24:24 + 8 * nof], "<f8").copy()
    tpos = np.arange(nof) / 1000.0 * fp
    return f0, tpos, fp


def _write_matrix(path, magic, mat, fs, frame_period, fft_size, nod=0):
    mat = np.ascontiguousarray(mat, dtype="<f8")
    with open(path, "wb") as f:
        f.write(magic)
        f.write(b"NOF " + struct.pack("<i", mat.shape[0]))
        f.write(b"FP  " + struct.pack("<d", frame_period))
        f.write(b"FFT " + struct.pack("<i", fft_size))
        f.write(b"NOD " + struct.pack("<i", nod))
        f.write(b"FS  " + struct.pack("<i", fs))
        f.write(mat.tobytes())


def _read_matrix(path, magic):
    with _open_read(path) as f:
        data = f.read()
    if data[:4] != magic:
        raise ValueError(f"{path}: bad magic {data[:4]!r} != {magic!r}")
    (nof,) = struct.unpack("<i", data[8:12])
    (fp,) = struct.unpack("<d", data[16:24])
    (fft_size,) = struct.unpack("<i", data[28:32])
    (nod,) = struct.unpack("<i", data[36:40])
    (fs,) = struct.unpack("<i", data[44:48])
    ndim = fft_size // 2 + 1 if nod == 0 else nod
    mat = np.frombuffer(data[48:48 + 8 * nof * ndim], "<f8")
    return mat.reshape(nof, ndim).copy(), dict(
        fs=fs, frame_period=fp, fft_size=fft_size, nod=nod)


def get_header_information(path, parameter):
    """Scan a parameter file for a 4-char tag and return its value
    (reference GetHeaderInformation, tools/parameterio.cpp:120-145).
    "FP  " returns float; other tags return ints (as float, like the C)."""
    tag = parameter if isinstance(parameter, bytes) else parameter.encode()
    with _open_read(path) as f:
        data = f.read(120)
    pos = 0
    for _ in range(13):
        if data[pos:pos + 4] == tag:
            if tag == b"FP  ":
                return struct.unpack("<d", data[pos + 4:pos + 12])[0]
            return float(struct.unpack("<i", data[pos + 4:pos + 8])[0])
        pos += 4
    return 0.0


def write_spectral_envelope(path, spectrogram, fs, frame_period, fft_size, nod=0):
    _write_matrix(path, b"SPEC", spectrogram, fs, frame_period, fft_size, nod)


def read_spectral_envelope(path):
    return _read_matrix(path, b"SPEC")


def write_aperiodicity(path, aperiodicity, fs, frame_period, fft_size, nod=0):
    _write_matrix(path, b"AP  ", aperiodicity, fs, frame_period, fft_size, nod)


def read_aperiodicity(path):
    return _read_matrix(path, b"AP  ")


def save_npz(path, *, f0=None, spectrogram=None, aperiodicity=None,
             fs=None, frame_period=None, fft_size=None, compress=False):
    """Native checkpoint: all analysis parameters in one .npz (SURVEY §5
    checkpoint/resume row; the byte-compatible tagged-binary writers above
    remain the reference-interchange path).

    Any subset of f0/spectrogram/aperiodicity may be given; metadata
    scalars are stored alongside.  Arrays may be [F, ...] single utterances
    or [B, F, ...] batches."""
    data = {}
    if f0 is not None:
        data["f0"] = np.asarray(f0)
    if spectrogram is not None:
        data["spectrogram"] = np.asarray(spectrogram)
    if aperiodicity is not None:
        data["aperiodicity"] = np.asarray(aperiodicity)
    if fs is not None:
        data["fs"] = np.asarray(int(fs))
    if frame_period is not None:
        data["frame_period"] = np.asarray(float(frame_period))
    if fft_size is not None:
        data["fft_size"] = np.asarray(int(fft_size))
    save = np.savez_compressed if compress else np.savez
    save(path, **data)


def load_npz(path):
    """Load a save_npz checkpoint.  Returns a dict with whichever of
    f0/spectrogram/aperiodicity/fs/frame_period/fft_size were stored
    (metadata scalars as python int/float)."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            v = z[k]
            if k == "fs" or k == "fft_size":
                out[k] = int(v)
            elif k == "frame_period":
                out[k] = float(v)
            else:
                out[k] = v
    return out
