"""The port's host C helpers, compiled on demand with the system C compiler.

The port's copies of the helpers of ``worldtpu/native``: the F0 smoother
(its ``worldtpu_filter_f0``, ``csrc/filter_f0.c``) and, for the float64
parity path, the reference's xorshift ``randn()`` stream and Harvest's
int-truncating sum (its ``XorshiftRandn`` and ``int_trunc_sum``,
``csrc/parity.c``), and the threaded batch WAV reader of the corpus
loader (its ``load_wavs_batch``, ``csrc/corpusio.cpp``).  The C sources
are built at first use with ``cc`` into one library, the C++ reader with
``c++`` into a second, each under ``build/worldtpu_torch/host/<hash>/``
at the repository root, keyed by a hash of its sources and flags, and
loaded with ctypes.  Without a compiler (or a writable build directory)
every C entry runs a Python loop that gives the same bits, only slower
(``filter_f0`` returns None and its caller runs the loop), and
``load_wavs_batch`` returns None (``io.corpus`` then reads each file in
Python, to the same samples).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SRCS = (_CSRC / "filter_f0.c", _CSRC / "parity.c")
_BUILD = _CSRC.parent.parent / "build" / "worldtpu_torch" / "host"
_CFLAGS = ("-O2", "-ffp-contract=off", "-fPIC", "-shared")
_CPP_SRC = _CSRC / "corpusio.cpp"
_CPP_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")
_LIB = None
_TRIED = False
_CPP_LIB = None
_CPP_TRIED = False

#: batches that load_wavs_batch decoded with the C++ reader (a plain count,
#: so a run can show which reader the corpus loader took)
corpus_reads = 0


def _compile(compiler, flags, srcs, name):
    """Path of the shared library built from srcs with compiler and flags
    under _BUILD/<hash of flags and sources>/name (built once)."""
    h = hashlib.sha256(" ".join((compiler, *flags)).encode()
                       + b"".join(src.read_bytes() for src in srcs))
    out_dir = _BUILD / h.hexdigest()[:16]
    so = out_dir / name
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            subprocess.run([compiler, *flags, *map(str, srcs), "-o",
                            f"{tmp}/lib.so"], check=True,
                           capture_output=True, timeout=120)
            os.replace(f"{tmp}/lib.so", so)
    return so


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(_compile("cc", _CFLAGS, _SRCS,
                                       "libworldtpu_host.so")))
        lib.wt_filter_f0.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double]
        lib.wt_filter_f0.restype = None
        lib.wt_randn_init.argtypes = [ctypes.c_void_p]
        lib.wt_randn_init.restype = None
        lib.wt_randn_fill.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64]
        lib.wt_randn_fill.restype = None
        lib.wt_int_trunc_sum.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.wt_int_trunc_sum.restype = ctypes.c_double
        _LIB = lib
    except (OSError, subprocess.SubprocessError):
        _LIB = None
    return _LIB


def filter_f0(x, b, a):
    """Two time-reversing biquad passes (zero-lag smoothing), exactly the
    arithmetic of contour._biquad_pass applied twice.  Returns None if the
    helper cannot be built (the caller falls back to the Python loop)."""
    lib = _build_and_load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    tmp = np.empty_like(x)
    out = np.empty_like(x)
    lib.wt_filter_f0(x.ctypes.data_as(ctypes.c_void_p), x.shape[0],
                     tmp.ctypes.data_as(ctypes.c_void_p),
                     out.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_double(b[0]), ctypes.c_double(b[1]),
                     ctypes.c_double(a[0]), ctypes.c_double(a[1]))
    return out


class _State(ctypes.Structure):
    _fields_ = [("x", ctypes.c_uint32), ("y", ctypes.c_uint32),
                ("z", ctypes.c_uint32), ("w", ctypes.c_uint32)]


class XorshiftRandn:
    """The reference vocoder's stateful ``randn()`` stream (xorshift128, the
    sum of 12 uniforms less 6), starting from the hard-coded seed of a
    fresh process.  The port's copy of ``worldtpu.native.XorshiftRandn``;
    ``state`` is the generator's four words."""

    def __init__(self):
        self._lib = _build_and_load()
        self._st = _State(123456789, 362436069, 521288629, 88675123)

    @property
    def state(self):
        return (self._st.x, self._st.y, self._st.z, self._st.w)

    def draw(self, n):
        """The next n values of the stream, [n] float64."""
        out = np.empty(n, dtype=np.float64)
        if self._lib is not None:
            self._lib.wt_randn_fill(ctypes.byref(self._st),
                                    out.ctypes.data_as(ctypes.c_void_p), n)
            return out
        m = 0xFFFFFFFF
        x, y, z, w = self.state
        for i in range(n):
            x, y, z = y, z, w
            tmp = 0
            for _ in range(12):
                t = (x ^ (x << 11)) & m
                x, y, z = y, z, w
                w = ((w ^ (w >> 19)) ^ (t ^ (t >> 8))) & m
                tmp = (tmp + (w >> 4)) & m
            out[i] = tmp / 268435456.0 - 6.0
        self._st = _State(x, y, z, w)
        return out


def int_trunc_sum(x):
    """The reference Harvest's int-initialized accumulate: the running sum
    truncated toward zero at every step, as a float.  The port's copy of
    ``worldtpu.native.int_trunc_sum``."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    lib = _build_and_load()
    if lib is not None:
        return lib.wt_int_trunc_sum(x.ctypes.data_as(ctypes.c_void_p),
                                    x.shape[0])
    acc = 0
    for v in x:
        acc = int(acc + v)
    return float(acc)


def _build_and_load_cpp():
    """The C++ corpus reader's library, or None if it cannot be built."""
    global _CPP_LIB, _CPP_TRIED
    if _CPP_TRIED:
        return _CPP_LIB
    _CPP_TRIED = True
    try:
        lib = ctypes.CDLL(str(_compile("c++", _CPP_FLAGS, (_CPP_SRC,),
                                       "libworldtpu_corpusio.so")))
        lib.worldtpu_load_wavs.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32]
        lib.worldtpu_load_wavs.restype = ctypes.c_int64
        _CPP_LIB = lib
    except (OSError, subprocess.SubprocessError):
        _CPP_LIB = None
    return _CPP_LIB


def corpus_reader_built():
    """Whether the C++ corpus reader is available (built at first call)."""
    return _build_and_load_cpp() is not None


def load_wavs_batch(paths, T, n_threads=8):
    """Read mono PCM wavs into a zero-padded [len(paths), T] float32 batch
    with the threaded C++ reader.  Returns (x, lengths, rates, bits), or
    None if the reader cannot be built (the caller reads in Python).  A
    file it cannot decode leaves lengths[i] == -1 and a zero row.  The
    port's copy of ``worldtpu.native.load_wavs_batch``."""
    global corpus_reads
    lib = _build_and_load_cpp()
    if lib is None:
        return None
    n = len(paths)
    x = np.zeros((n, T), np.float32)
    lengths = np.empty(n, np.int64)
    rates = np.empty(n, np.int32)
    bits = np.empty(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.worldtpu_load_wavs(
        arr, n, T, x.ctypes.data_as(ctypes.c_void_p),
        lengths.ctypes.data_as(ctypes.c_void_p),
        rates.ctypes.data_as(ctypes.c_void_p),
        bits.ctypes.data_as(ctypes.c_void_p), n_threads)
    corpus_reads += 1
    return x, lengths, rates, bits
