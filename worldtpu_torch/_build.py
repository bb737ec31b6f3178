"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` to an object file, all of them at
once in parallel, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The library lands in ``build/worldtpu_torch/<hash>/`` at
the repository root, keyed by a hash of the sources and flags, and is
built at first use — never at import, so the CPU-only tests import every
module without a CUDA toolkit.

Every kernel wrapper counts its launches in ``launches`` (a Counter keyed
by kernel name), so a caller can show that a run went through the kernels.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "worldtpu_torch"

#: fmad=false keeps every float product and sum separately rounded, as the
#: CPU reference computes them: the zc kernel's frame assignment and the
#: refine windows end in integer or threshold decisions where a fused
#: multiply-add could flip a knife edge against the plain version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

#: kernel name -> launches since the last clear()
launches: collections.Counter = collections.Counter()

_lib = None
build_seconds = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # filt, bounds, ev, out, n_rows, nb, L, F, e_max, fs_a, grid_hz,
    # tstep, f0_floor, f0_ceil, stream
    "wt_zc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P),
    # seg, delta, hw, gbin, n_active, twiddle, out, n_frames, cap, wseg,
    # hwmax, n_fft, stream
    "wt_refine_sums": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # resp, starts, out, B, P, fft, T, stream
    "wt_ola": (_P, _P, _P, _I, _I, _I, _I, _P),
    # cand, score, origin, shift, live, distance, tmp0, vals, scs, n_on, so,
    # B, W, F, S, E, miss_lim, allowed_range, stream
    "wt_extend": (_P,) * 11 + (_I,) * 6 + (_F, _P),
    # filt, ev, ccol, n_rows, nb, lo, nb_g, L, e_cap, c_row, n_cols,
    # n_store, stream
    "wt_zc_events": (_P, _P, _P) + (_I,) * 9 + (_P,),
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")


def _source_hash(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library():
    """The loaded kernel library, building it on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / _source_hash(sources)
    so = out_dir / "libworldtpu_kernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs = [f"{tmp}/{src.stem}.o" for src in sources]
            with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
                list(ex.map(_run, ([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                    str(src)]
                                   for src, obj in zip(sources, objs))))
            _run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", f"{tmp}/lib.so",
                  *objs])
            os.replace(f"{tmp}/lib.so", so)
        build_seconds = time.perf_counter() - t0
    else:
        build_seconds = 0.0
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check_tensor(t, name, dtype, shape=None, device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of dtype (and shape,
    and on ``device``)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(name, device, *args):
    """Call the C entry ``name`` on ``device``'s current stream (with that
    device current, so the kernel runs where its pointers live); count the
    launch and raise if the launch was refused."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1
