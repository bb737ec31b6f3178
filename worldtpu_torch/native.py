"""The port's host C helpers, compiled on demand with the system C compiler.

The port's copies of the helpers of ``worldtpu/native``: the F0 smoother
(its ``worldtpu_filter_f0``, ``csrc/filter_f0.c``) and, for the float64
parity path, the reference's xorshift ``randn()`` stream and Harvest's
int-truncating sum (its ``XorshiftRandn`` and ``int_trunc_sum``,
``csrc/parity.c``).  The sources are built at first use into one library
under ``build/worldtpu_torch/host/<hash>/`` at the repository root, keyed
by a hash of the sources and flags, and loaded with ctypes.  Without a C
compiler (or a writable build directory) every entry runs a Python loop
that gives the same bits, only slower (``filter_f0`` returns None and its
caller runs the loop).
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
_LIB = None
_TRIED = False


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    h = hashlib.sha256(" ".join(_CFLAGS).encode()
                       + b"".join(src.read_bytes() for src in _SRCS))
    out_dir = _BUILD / h.hexdigest()[:16]
    so = out_dir / "libworldtpu_host.so"
    try:
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                subprocess.run(["cc", *_CFLAGS, *map(str, _SRCS), "-o",
                                f"{tmp}/lib.so"], check=True,
                               capture_output=True, timeout=120)
                os.replace(f"{tmp}/lib.so", so)
        lib = ctypes.CDLL(str(so))
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
