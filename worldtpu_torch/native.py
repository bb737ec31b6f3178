"""The port's host C helper, compiled on demand with the system C compiler.

The port's copy of the F0 smoother of ``worldtpu/native`` (its
``worldtpu_filter_f0``): ``csrc/filter_f0.c`` is built at first use into
``build/worldtpu_torch/host/<hash>/`` at the repository root, keyed by a
hash of the source and flags, and loaded with ctypes.  Without a C compiler
(or a writable build directory) ``filter_f0`` returns None and the caller
runs its Python loop, which gives the same bits, only slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "filter_f0.c"
_BUILD = _SRC.parent.parent.parent / "build" / "worldtpu_torch" / "host"
_CFLAGS = ("-O2", "-ffp-contract=off", "-fPIC", "-shared")
_LIB = None
_TRIED = False


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    h = hashlib.sha256(" ".join(_CFLAGS).encode() + _SRC.read_bytes())
    out_dir = _BUILD / h.hexdigest()[:16]
    so = out_dir / "libworldtpu_host.so"
    try:
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                subprocess.run(["cc", *_CFLAGS, str(_SRC), "-o",
                                f"{tmp}/lib.so"], check=True,
                               capture_output=True, timeout=120)
                os.replace(f"{tmp}/lib.so", so)
        lib = ctypes.CDLL(str(so))
        lib.wt_filter_f0.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double]
        lib.wt_filter_f0.restype = None
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
