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
The compiler's ``-Xptxas -v`` report of each source (registers, shared
memory, spills per kernel) is saved beside the library and loaded into
``ptxas_report``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "worldtpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: multiply-add contraction by source (stem -> --fmad value; the rest
#: false).  fmad=false keeps every float product and sum separately
#: rounded, as the plain versions compute them: zc's frame assignment
#: (a ceil) and band gates, zc events' positions and extend's error
#: comparisons are held to their plain versions exactly, and a fused
#: multiply-add there could flip a knife edge; the contour merge's running
#: mean and the smoothing recursion keep the reference's operation order.
#: refine is held to a
#: tolerance (1e-5 of the largest sum), and contraction halves the
#: instructions of its 24 accumulations.  ola's sums are plain adds.
#: pulse is held to a tolerance (its FFTs' rounding is not cuFFT's); its
#: products and sums that must round as the plain version's (the spectral
#: rows' interpolation and the voicing gate) are written with __fmul_rn /
#: __fadd_rn, which are never contracted.  noise is held to its plain
#: version bit for bit: its erfinv polynomial's steps round one at a time.
#: d4c is held to a tolerance (its FFTs and sums are not the chain's);
#: the products and sums that decide an integer or its voicing gate are
#: written with __fmul_rn / __fadd_rn.
FMAD = {"refine": "true", "pulse": "true", "d4c": "true"}

#: kernel name -> launches since the last clear()
launches: collections.Counter = collections.Counter()

_lib = None
build_seconds = None
#: source stem -> nvcc's -Xptxas -v report of the loaded library's build
ptxas_report: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # filt, bounds, ev, out, n_rows, nb, L, F, e_max, fs_a, grid_hz,
    # tstep, f0_floor, f0_ceil, shared_events, stream
    "wt_zc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I,
              _P),
    # seg, delta, hw, gbin, n_active, offs, twiddle, out, n_frames, cap,
    # wseg, hwmax, n_fft, stream
    "wt_refine_sums": (_P,) * 8 + (_I,) * 5 + (_P,),
    # resp, starts, n_pulses (or NULL), out, B, P, fft, T, stream
    "wt_ola": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "wt_ola_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, out, n_rows, n, stream
    "wt_seq_cumsum_f64": (_P, _P, _I, _I, _P),
    # n_rows, n, sms (0: the device's), out (host int[5]: regime, rows,
    # chunk, blocks, shared bytes)
    "wt_seq_cumsum_plan": (_I, _I, _I, _P),
    # in (double[2] on the card: start, step), out, cycles (int64), n, stream
    "wt_dadd_latency": (_P, _P, _P, _I, _P),
    # cand, score, origin, shift, live, distance, tmp0, vals, scs, n_on, so,
    # B, W, F, S, E, miss_lim, allowed_range, stream
    "wt_extend": (_P,) * 11 + (_I,) * 6 + (_F, _P),
    # filt, ev, ccol, table (host: lo, nb_g, e_cap, c_row, ev_off, ccol_off
    # per group), n_groups, B, nb, L, n_cols, n_store, stream
    "wt_zc_events": (_P, _P, _P, _P) + (_I,) * 6 + (_P,),
    # f0, ss_run, ss_zero, st, ed, n_sec, vals, scs, n_on, so, out, ssum,
    # keep, order, src (or NULL), s1, s2, ordered (or NULL), B, F, S, E,
    # c_len, stream
    "wt_contour_merge": (_P,) * 18 + (_I,) * 4 + (_F, _P),
    # f0, st, ed, n_sec, out, ybuf, trace (or NULL), B, F, n, NS, lag,
    # chunk, cap, stream
    "wt_contour_smooth": (_P,) * 7 + (_I,) * 7 + (_P,),
    # pt, shift, ns, vuv, valid, spec, aper, noise, frame_offset (or NULL),
    # tw, dcr, out, B, P, F, fft, off0, coeff_scale, stream
    "wt_pulse_resp": (_P,) * 12 + (_I,) * 4 + (ctypes.c_longlong, _F, _P),
    # key, start, out, n_starts, count, fft, stream
    "wt_noise_rows": (_P, _P, _P, ctypes.c_longlong, _I, _I, _P),
    # x, f0, pos, sample_offset (or NULL), nuttall, tw, out, int table and
    # float table (host), B, F, T, pos_rows, stream
    "wt_d4c": (_P,) * 9 + (_I,) * 4 + (_P,),
    # mark (2 * stage + 0 at entry, + 1 at exit), stream; launched by
    # tracing.stage, never through launch(), so never counted
    "wt_mark": (_I, _P),
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
    return proc.stdout + proc.stderr


def compile_flags(src):
    """nvcc's flags for one source: the common ones and its --fmad."""
    return (*NVCC_FLAGS, f"--fmad={FMAD.get(src.stem, 'false')}")


def _source_hash(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(FMAD.items())).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(sources):
    """Compile ``sources`` (``*.cu`` paths) into one shared library under
    ``BUILD_ROOT/<hash>/`` unless it is there already; return (its path,
    the build's wall seconds: 0.0 when it was there)."""
    out_dir = BUILD_ROOT / _source_hash(sources)
    so = out_dir / "libworldtpu_kernels.so"
    if so.exists():
        return so, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [f"{tmp}/{src.stem}.o" for src in sources]
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
            logs = list(ex.map(_run, ([nvcc, *compile_flags(src), "-Xptxas",
                                       "-v", "-c", "-o", obj, str(src)]
                                      for src, obj in zip(sources, objs))))
        (out_dir / "ptxas.json").write_text(json.dumps(
            {src.stem: log for src, log in zip(sources, logs)}))
        _run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", f"{tmp}/lib.so", *objs])
        os.replace(f"{tmp}/lib.so", so)
    return so, time.perf_counter() - t0


def library():
    """The loaded kernel library, building it on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, build_seconds = build(sorted(CSRC.glob("*.cu")))
    report = so.parent / "ptxas.json"
    if report.exists():
        ptxas_report.update(json.loads(report.read_text()))
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


def c_args(args):
    """A launch's arguments for its C entry: each tensor as its data
    pointer, None as NULL, numbers as they are."""
    return [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]


def launch(name, device, *args):
    """Call the C entry ``name`` on ``device``'s current stream (with that
    device current, so the kernel runs where its pointers live); count the
    launch and raise if the launch was refused.  Tensors among ``args`` are
    passed as their data pointers."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        err = fn(*c_args(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1
