"""Mono WAV read/write matching the reference's decode/encode semantics.

The port's own copy of ``worldtpu/io/wav.py`` (numpy only, unchanged in
behaviour; ``tests/test_torch_io.py`` holds the two byte for byte).
Reference tools/audioio.cpp: 16-bit decode is ``int16 / 2**15``
(:236-251) and encode is ``clip(int(x * 32767))`` (:163-167).  8/24-bit
reads use the same sign-bias scheme.
"""

from __future__ import annotations

import struct

import numpy as np


def wavread(path):
    """Read a mono PCM wav. Returns (x float64 in [-1, 1), fs, nbit)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fs = nbit = None
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if tag == b"fmt ":
            fmt, nch, fs, _, _, nbit = struct.unpack("<HHIIHH", body[:16])
            if fmt != 1:
                raise ValueError(f"{path}: only PCM supported")
            if nch != 1:
                raise ValueError(f"{path}: only mono supported")
        elif tag == b"data":
            if fs is None:
                raise ValueError(f"{path}: data before fmt")
            nbytes = nbit // 8
            n = size // nbytes
            raw = body[:n * nbytes]
            if nbit == 16:
                x = np.frombuffer(raw, "<i2").astype(np.float64) / 32768.0
            elif nbit == 8:
                # reference decodes 8-bit with the same sign-bias scheme
                # (two's complement byte / 128), not the usual 0x80 offset
                x = np.frombuffer(raw, "i1").astype(np.float64) / 128.0
            elif nbit == 24:
                b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int64)
                v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
                v = np.where(v >= 1 << 23, v - (1 << 24), v)
                x = v.astype(np.float64) / float(1 << 23)
            else:
                raise ValueError(f"{path}: unsupported bit depth {nbit}")
            return x, int(fs), int(nbit)
        pos += 8 + size + (size & 1)
    raise ValueError(f"{path}: no data chunk")


def get_audio_length(path):
    """Sample count of a wav file without reading the data
    (reference GetAudioLength, tools/audioio.cpp:173-216)."""
    with open(path, "rb") as f:
        data = f.read(65536)
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return -1
    pos = 12
    nbit = None
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if tag == b"fmt ":
            nbit = struct.unpack("<H", data[pos + 22:pos + 24])[0]
        elif tag == b"data":
            return size // (nbit // 8)
        pos += 8 + size + (size & 1)
    return -1


def wav_info(path):
    """(n_samples, fs, nbit) from the header only — the corpus loader's
    cheap metadata scan (same header walk as get_audio_length)."""
    with open(path, "rb") as f:
        data = f.read(65536)
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fs = nbit = None
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if tag == b"fmt ":
            fs = struct.unpack("<I", data[pos + 12:pos + 16])[0]
            nbit = struct.unpack("<H", data[pos + 22:pos + 24])[0]
        elif tag == b"data":
            if nbit is None:
                raise ValueError(f"{path}: data chunk before fmt chunk")
            return size // (nbit // 8), fs, nbit
        pos += 8 + size + (size & 1)
    raise ValueError(f"{path}: no data chunk found")


def wavwrite(path, x, fs, nbit=16):
    """Write a mono 16-bit PCM wav (reference wavwrite semantics)."""
    if nbit != 16:
        raise ValueError("only 16-bit write supported (like the reference)")
    x = np.asarray(x, dtype=np.float64)
    q = np.clip((x * 32767).astype(np.int64), -32768, 32767).astype("<i2")
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + 2 * len(q)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, fs, fs * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", 2 * len(q)))
        f.write(q.tobytes())
