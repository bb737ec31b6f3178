"""D4C's float32 band aperiodicity (``ops/d4c_kernel.py``,
``csrc/d4c.cu``).

On the CPU: the plain version equals the frozen copy of the chain in
``wtbench/reference`` bit for bit, the routes and refusals (the rates the
kernel has no instance for raise), the stored JAX aperiodicity of t16
(tests/fixtures/t16.d4c_jax.npz) is the JAX package's, and a numpy model
of the CUDA kernel's arithmetic (the gate first, two real sequences packed
into one complex FFT and split, the centred centroid ramp, the kernel's
own DC correction and tap-by-tap smoothing, the radix selection of the
band's top powers and the direct sum of the rest, the interpolation)
against the plain chain in float64, at 22.05 kHz (fft 2,048), 25 kHz (fft
4,096, LoveTrain's 2,048) and 48 kHz (fft 4,096), with and without
``sample_offset`` and [B, F] frame times.

Marked ``cuda``: the kernel against the plain version on the card at the
cells' shapes, at a chunk step's and at the other rates, against the
stored JAX aperiodicity of t16, frame by frame against the chain in
float64 on pure harmonics, a captured and replayed call against its eager
call, one launch a call.  Run them on a GPU machine with
``python -m pytest tests/test_torch_d4c_kernel.py -m cuda --noconftest``.
"""

import math
import pathlib

import numpy as np
import pytest
import torch

from worldtpu_torch import _build
from worldtpu_torch import constants as C
from worldtpu_torch.analysis import d4c as TD
from worldtpu_torch.ops import d4c_kernel as DK
from worldtpu_torch.ops import filters
from worldtpu_torch.ops.numeric import frame_segments, matlab_round
from wtbench.reference.analysis import d4c as RD

torch.set_num_threads(1)

FRAME_S = 0.005


def _signal(fs, T, seed):
    """A harmonic voice (1/k^2 partials under 3 kHz: LoveTrain's ratio near
    1), white noise (ratio ~0.5: voiced but gated off), silence, and a
    voice with noise (ratio near the gate), one after another; returns
    (x [T], f0 on the frame grid of the whole signal)."""
    rng = np.random.RandomState(seed)
    t = np.arange(T) / fs
    f0t = (130.0 + 40 * rng.rand()) * 2 ** (0.15 * np.sin(2 * np.pi * 3 * t))
    ph = 2 * np.pi * np.cumsum(f0t) / fs
    voice = sum(np.sin(k * ph) / k ** 2 for k in range(1, 20)
                if k * f0t.max() < 3000.0)
    q = T // 4
    x = np.zeros(T)
    x[:q] = 0.5 * voice[:q] + 1e-3 * rng.randn(q)
    x[q:2 * q] = 0.2 * rng.randn(q)
    x[2 * q:3 * q] = 1e-4 * rng.randn(q)
    x[3 * q:] = 0.4 * voice[3 * q:] + 0.05 * rng.randn(T - 3 * q)
    frames = np.arange(int(T / fs / FRAME_S) + 1) * FRAME_S
    f0 = np.interp(frames, t, f0t)
    f0[(frames * fs >= 2 * q) & (frames * fs < 3 * q)] = 0.0
    return x, f0


def _inputs(fs, *, B=2, F=24, seed=0, rows=False, offset=False,
            dtype=torch.float32):
    """x [B, T], f0 [B, F], frame times [F] (or [B, F] with ``rows``) and
    ``sample_offset`` [B] (with ``offset``: row b is a slice of a longer
    recording starting at that sample, the frame times the recording's)."""
    T = int(F * FRAME_S * fs)
    xs, f0s, pos, off = [], [], [], []
    for b in range(B):
        x, f0 = _signal(fs, 3 * T, seed + b)
        a0 = (T // 2 + 37 * b) if offset else 0
        f_first = int(math.ceil(a0 / fs / FRAME_S)) if offset else 0
        tp = (f_first + np.arange(F)) * FRAME_S
        xs.append(x[a0:a0 + T])
        f0s.append(f0[f_first:f_first + F])
        pos.append(tp)
        off.append(a0)
    x = torch.tensor(np.stack(xs), dtype=dtype)
    f0 = torch.tensor(np.stack(f0s), dtype=dtype)
    tp = torch.tensor(np.stack(pos) if rows or offset else pos[0],
                      dtype=dtype)
    so = torch.tensor(off, dtype=torch.int64) if offset else None
    return x, f0, tp, so


def _kw(fs, fft_out):
    return dict(fs=fs, fft_size_out=fft_out, threshold=0.85,
                f0_ceil_bound=C.CEIL_F0)


CASES = [(22050, 1024, False, False), (22050, 1024, True, False),
         (22050, 1024, False, True), (48000, 2048, False, False),
         (48000, 2048, True, True), (25000, 2048, False, True)]


# ---- the plain version ----

@pytest.mark.parametrize("fs,fft_out,rows,offset", CASES)
def test_plain_equals_frozen_chain(fs, fft_out, rows, offset):
    """The plain version, and d4c_frames' CPU route, are the chain as it
    was (the benchmark's frozen copy), bit for bit."""
    x, f0, tp, so = _inputs(fs, rows=rows, offset=offset, seed=fs)
    want = RD.d4c_frames(x, f0, tp, fs=fs, fft_size_out=fft_out,
                         sample_offset=so)
    got = DK.d4c_frames_plain(x, f0, tp, sample_offset=so,
                              **_kw(fs, fft_out))
    assert torch.equal(got, want)
    assert torch.equal(TD.d4c_frames(x, f0, tp, fs=fs, fft_size_out=fft_out,
                                     sample_offset=so), want)
    active = want[..., 0] < 0.5
    assert bool(active.any()) and bool((~active).any())


def test_routes_by_device_and_dtype(monkeypatch):
    """float64 takes the parity branch and the CPU the plain chain, never
    the kernel; a float32 tensor on the card (faked) takes the kernel, and
    a kernel that cannot launch raises: there is no fallback."""
    calls = []
    monkeypatch.setattr(DK, "d4c_frames_cuda",
                        lambda *a, **k: calls.append("cuda"))
    x, f0, tp, _ = _inputs(22050, F=8)
    n0 = _build.launches["wt_d4c"]
    TD.d4c_frames(x, f0, tp, fs=22050, fft_size_out=1024)
    monkeypatch.setattr(TD, "device_kind", lambda t: "cuda")
    TD.d4c_frames(x.double(), f0.double(), tp.double(), fs=22050,
                  fft_size_out=1024)
    assert calls == [] and _build.launches["wt_d4c"] == n0
    TD.d4c_frames(x, f0, tp, fs=22050, fft_size_out=1024)
    assert calls == ["cuda"]

    def refuse(*a, **k):
        raise RuntimeError("wt_d4c: CUDA launch failed with error 1")
    monkeypatch.setattr(DK, "d4c_frames_cuda", refuse)
    with pytest.raises(RuntimeError, match="wt_d4c"):
        TD.d4c_frames(x, f0, tp, fs=22050, fft_size_out=1024)


def test_cuda_entry_checks_inputs():
    """The launcher refuses CPU tensors, FFT sizes it has no instance of and
    bad shapes before any launch (checked here without a card)."""
    x, f0, tp, _ = _inputs(22050, F=8)
    kw = _kw(22050, 1024)
    n0 = _build.launches["wt_d4c"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        DK.d4c_frames_cuda(x, f0, tp, **kw)
    with pytest.raises(ValueError, match="fs 6000"):
        DK.d4c_frames_cuda(x, f0, tp, **_kw(6000, 256))
    with pytest.raises(ValueError, match="CUDA tensor"):
        DK.d4c_frames_cuda(x.double(), f0, tp, **kw)
    assert _build.launches["wt_d4c"] == n0


@pytest.mark.parametrize("fs", [15800, 16000, 22050, 25000, 44100, 48000,
                                50000, 96000, 96244])
def test_kernel_params_follow_the_chain(fs):
    """The host tables: the chain's geometry (LoveTrain's bins on its own
    fft, half D4C's at 25 and 50 kHz), and each float the float32 that the
    chain's tensor operation makes of its Python number."""
    ip, fp = DK.kernel_params(fs, 1024, 0.85, C.CEIL_F0)
    ip = ip.tolist()
    n, n_lt = DK.d4c_fft_size(fs), DK.love_train_fft_size(fs)
    assert ip[0] == n and ip[13] == n_lt
    assert n_lt == (n // 2 if fs in (25000, 50000) else n)
    assert ip[5:8] == [int(math.ceil(hz * n_lt / fs))
                       for hz in (100.0, 4000.0, 7900.0)]
    assert ip[7] <= n_lt // 2
    assert ip[8] == DK.number_of_aperiodicities(fs)
    wl = int(C.FREQUENCY_INTERVAL * n / fs) * 2 + 1
    assert ip[9:12] == [wl, wl // 2, int(n * 8.0 / wl + 0.5)]
    assert ip[14:14 + ip[8]] == [int(C.FREQUENCY_INTERVAL * (b + 1) * n / fs)
                                 for b in range(ip[8])]
    ones = torch.ones(3)
    assert float(fp[1]) == float((ones / fs)[0])     # tensor / scalar
    assert float(fp[4]) == float(torch.tensor(C.PI * 2.0 / 3.0 / fs,
                                              dtype=torch.float32))


@pytest.mark.parametrize("fs", [8000, 11025, 12000, 15799, 96245, 176400,
                                192000])
def test_kernel_refuses_rates_without_an_instance(fs):
    """Below 15,800 Hz LoveTrain's 7,900 Hz bin lies past fs / 2 (the
    chain's index fails there too); from 96,245 Hz D4C's fft is 16,384,
    which the kernel has no instance for.  A CUDA float32 call there raises
    ValueError before any launch; the CPU's chain keeps its own
    behaviour."""
    x, f0, tp, _ = _inputs(22050, F=8)
    n0 = _build.launches["wt_d4c"]
    with pytest.raises(ValueError, match=f"fs {fs}"):
        DK.kernel_params(fs, 1024, 0.85, C.CEIL_F0)
    with pytest.raises(ValueError, match=f"fs {fs}"):
        DK.d4c_frames_cuda(x, f0, tp, **_kw(fs, 1024))
    assert _build.launches["wt_d4c"] == n0
    if fs < 15800:
        with pytest.raises(IndexError):
            DK.d4c_frames_plain(x, f0, tp, **_kw(fs, 1024))


# ---- JAX's aperiodicity of t16, the card's yardstick ----

#: JAX's float32 d4c_frames and LoveTrain ratio on t16, written on the CPU
#: by np.savez_compressed(T16_JAX, **jax_t16()) with x64 on
T16_JAX = pathlib.Path(__file__).parent / "fixtures" / "t16.d4c_jax.npz"


def _t16():
    """t16's waveform, F0 and frame times in float32 (the port's readers;
    the card's machine has no JAX) and its fs."""
    from worldtpu_torch.io import params, wav
    fx = pathlib.Path(__file__).parent / "fixtures"
    x, fs, _ = wav.wavread(str(fx / "t16.wav"))
    f0, tp, _ = params.read_f0(str(fx / "t16.f0.gz"))
    return (np.asarray(x, np.float32), np.asarray(f0, np.float32),
            np.asarray(tp, np.float32), fs)


def jax_t16():
    """{"ap": worldtpu's d4c_frames [F, fft / 2 + 1], "ap0": its
    love_train_ap0 [F]}, float32, on ``_t16``'s inputs."""
    import jax.numpy as jnp
    from worldtpu.analysis import d4c as JD
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    x, f0, tp, fs = _t16()
    args = (jnp.asarray(x), jnp.asarray(f0), jnp.asarray(tp))
    return {"ap": np.asarray(JD.d4c_frames(
                *args, fs=fs, fft_size_out=CheapTrickKernel(fs).fft_size)),
            "ap0": np.asarray(JD.love_train_ap0(*args, fs=fs))}


def test_jax_t16_fixture_is_jaxs():
    """The stored aperiodicity is the JAX package's on t16 (to 1e-5: the
    card is held to it at AP_TOL), with both gates' frames, and the CPU's
    chain lies within AP_TOL of it."""
    stored = np.load(T16_JAX)
    want = jax_t16()
    for k in ("ap", "ap0"):
        assert stored[k].dtype == np.float32
        np.testing.assert_allclose(stored[k], want[k], rtol=0, atol=1e-5)
    active = stored["ap"][:, 0] < 0.5
    assert active.sum() >= 50 and (~active).sum() >= 50
    x, f0, tp, fs = _t16()
    plain = TD.d4c_frames(torch.tensor(x)[None], torch.tensor(f0)[None],
                          torch.tensor(tp), fs=fs,
                          fft_size_out=stored["ap"].shape[1] * 2 - 2)
    np.testing.assert_allclose(plain[0].numpy(), stored["ap"], atol=AP_TOL)


# ---- a numpy model of the kernel's arithmetic ----

def _mround(v):
    return int(math.floor(v + 0.5)) if v > 0 else int(math.ceil(v - 0.5))


def _window(xb, base, c0, h, alpha, blackman):
    """The windowed, weight-removed samples m in [-h, h] (the cosine's
    column c0 + m, its phase alpha (c0 + m) - alpha c0)."""
    m = np.arange(-h, h + 1)
    c1 = np.cos(alpha * m)
    win = 0.42 + 0.5 * c1 + 0.08 * (2 * c1 * c1 - 1) if blackman \
        else 0.5 * c1 + 0.5
    wave = xb[np.clip(base + m, 0, len(xb) - 1)] * win
    return wave - win * (wave.sum() / win.sum())


def _packed_power(xr):
    """|X[k]|^2, k <= N/2, of a real N-point sequence from its N/2-point
    complex transform z[i] = x[2i] + i x[2i+1]."""
    N = len(xr)
    H = N // 2
    Zh = np.fft.fft(xr[0::2] + 1j * xr[1::2])
    k = np.arange(1, H)
    a, c = Zh[k], Zh[H - k]
    e = (a + np.conj(c)) / 2
    o = (a - np.conj(c)) / 2j
    s = e + np.exp(-2j * np.pi * k / N) * o
    out = np.empty(H + 1)
    out[0] = (Zh[0].real + Zh[0].imag) ** 2
    out[H] = (Zh[0].real - Zh[0].imag) ** 2
    out[1:H] = np.abs(s) ** 2
    return out


def _split(Z):
    """The spectra (k <= N/2) of a and b from Z = FFT(a + i b)."""
    N = len(Z)
    k = np.arange(N // 2 + 1)
    zm = np.conj(Z[(N - k) % N])
    return (Z[k] + zm) / 2, (Z[k] - zm) / 2j


def _dc_correct(row, f0d, fs, N, L):
    """The kernel's DC correction: bins i < L."""
    v = f0d * N / fs
    lim = 2 + int(v) - 1
    out = row.copy()
    for i in range(L):
        pos = v - i
        base = int(pos)
        frac = pos - base
        bc = min(max(base, 0), L - 2)
        if i < lim:
            out[i] = row[i] + row[bc] + (row[bc + 1] - row[bc]) * frac
    return out


def _smooth(row, width, fs, N):
    """The kernel's smoothing: taps (1 - f_lo, 1 ... 1, f_hi) over the row
    reflected at 0 and N/2, times fs / N, over width."""
    half = N // 2
    u = width * N / fs
    b = int(u) + 1
    lo_v, hi_v = b - 0.5 - u / 2, b - 0.5 + u / 2
    blo, bhi = int(lo_v), int(hi_v)
    wts = np.ones(bhi - blo + 1)
    wts[0], wts[-1] = 1.0 - (lo_v - blo), hi_v - bhi
    s = np.arange(half + 1)[:, None] + np.arange(blo + 1 - b,
                                                 bhi + 2 - b)[None, :]
    s = np.abs(s)
    s = np.where(s > half, 2 * half - s, s)
    return (row[s] * wts).sum(1) * (fs / N) / width


def _top_threshold(bits, count, nbits):
    """The radix select of the count-th largest of non-negative values by
    their bits, 8 at a time from the top: (its bits, how many values have
    them, how many of those the top count holds)."""
    prefix, rem, eq = 0, count, 0
    for shift in range(nbits - 8, -1, -8):
        cand = bits[(bits >> (shift + 8)) == (prefix >> (shift + 8))]
        hist = np.bincount((cand >> shift) & 255, minlength=256)
        above = 0
        for d in range(255, -1, -1):
            if above + hist[d] >= rem:
                prefix |= d << shift
                rem -= above
                eq = int(hist[d])
                break
            above += hist[d]
    return prefix, eq, rem


def _lo_hi(p, count):
    """hi, the sum of all powers; lo, the sum of those below the count-th
    largest plus the ties the top set leaves out."""
    if p.dtype == np.float64:   # non-negative: the sign bit is 0
        bits, nbits = p.view(np.int64), 64
    else:
        bits, nbits = p.view(np.uint32).astype(np.int64), 32
    t, eq, rem = _top_threshold(bits, count, nbits)
    tv = float(p[bits == t][0])
    lo = p[bits < t].sum(dtype=np.float64) + (eq - rem) * tv
    return lo, p.sum(dtype=np.float64)


def _kernel_model(x, f0, tp, so, fs, fft_out, threshold=0.85):
    """The kernel, block by block, in float64: rows [B, F, Ko] and the
    frames that ran past the gate."""
    x = x.double().numpy()
    f0 = f0.double().numpy()
    tp = tp.double().numpy()
    B, F = f0.shape
    ip, _ = DK.kernel_params(fs, fft_out, threshold, C.CEIL_F0)
    (N, Ko, mh_lt, mhc, seg_pad, b0, b1, b2, n_ap, wl, hw, boundary,
     dc_len, n_lt) = ip.tolist()[:14]
    centers = ip.tolist()[14:14 + n_ap]
    H = N // 2
    nut = filters.nuttall_window(wl, torch.float64).numpy()
    out = np.full((B, F, Ko), 1.0 - C.MY_SAFE_GUARD_MINIMUM)
    ran = np.zeros((B, F), bool)
    for b in range(B):
        xb = x[b]
        for f in range(F):
            f0v = f0[b, f]
            if f0v == 0.0:
                continue
            pv = tp[b, f] if tp.ndim == 2 else tp[f]
            o = _mround(pv * fs + 0.001)
            ro = min(max(o - (int(so[b]) if so is not None else 0), 0),
                     len(xb) - 1)
            # LoveTrain, first
            f0lt = max(f0v, 40.0)
            h = min(_mround(3.0 * fs / f0lt / 2.0), mh_lt)
            xr = np.zeros(n_lt)
            xr[:2 * h + 1] = _window(xb, ro, mh_lt, h,
                                     C.PI * 2.0 / 3.0 / fs * f0lt, True)
            p = _packed_power(xr)
            if not p[b0 + 1:b1 + 1].sum() / p[b0 + 1:b2 + 1].sum() \
                    > threshold:
                continue
            ran[b, f] = True
            f0d = max(f0v, C.FLOOR_F0_D4C)
            hc = min(_mround(4.0 * fs / f0d / 2.0), mhc)
            alpha = C.PI * 2.0 / 4.0 / fs * f0d
            S = 2.0 ** int(hc).bit_length()
            A = np.zeros(H + 1)
            for side in (-1.0, 1.0):
                d = _mround((pv + side * (0.25 / f0d)) * fs + 0.001) - o
                w = _window(xb, ro + d, mhc + seg_pad + d, hc, alpha, True)
                wn = w / np.sqrt((w * w).sum())
                z = np.zeros(N, complex)
                z[:2 * hc + 1] = wn + 1j * wn * np.arange(-hc, hc + 1) / S
                a, m = _split(np.fft.fft(z))
                A += S * (a.real * m.real + a.imag * m.imag) \
                    + (hc + 1) * np.abs(a) ** 2
            A = _dc_correct(A, f0d, fs, N, dc_len)
            xr = np.zeros(N)
            xr[:2 * hc + 1] = _window(xb, ro, mhc, hc, alpha, False)
            sps = _smooth(_dc_correct(_packed_power(xr), f0d, fs, N, dc_len),
                          f0d, fs, N)
            sgd = np.clip(A / np.maximum(sps, np.finfo(np.float32).tiny),
                          -1e12, 1e12)
            sgd = _smooth(sgd, f0d / 2.0, fs, N)
            sgd = sgd - _smooth(sgd, f0d, fs, N)
            ca = []
            for j in range(0, n_ap, 2):
                segs = [sgd[c - hw:c - hw + wl] * nut
                        for c in centers[j:j + 2]]
                scales = [2.0 ** -int(np.frexp((s * s).sum())[1] / 2)
                          for s in segs]
                z = np.zeros(N, complex)
                z[:wl] = segs[0] * scales[0]
                if len(segs) > 1:
                    z[:wl] += 1j * segs[1] * scales[1]
                for spec in _split(np.fft.fft(z))[:len(segs)]:
                    lo, hi = _lo_hi(np.abs(spec) ** 2, boundary + 1)
                    ca.append(min(10 * np.log10(lo / hi)
                                  + (f0d - 100.0) / 50.0, 0.0))
            knots = np.r_[C.FREQUENCY_INTERVAL * np.arange(n_ap + 1), fs / 2]
            vals = np.r_[-60.0, ca, -C.MY_SAFE_GUARD_MINIMUM]
            fr = np.arange(Ko) * fs / fft_out
            k = np.clip(np.searchsorted(knots, fr, side="right"), 1,
                        len(knots) - 1)
            s = (fr - knots[k - 1]) / (knots[k] - knots[k - 1])
            out[b, f] = 10.0 ** ((vals[k - 1] + s * (vals[k] - vals[k - 1]))
                                 / 20.0)
    return out, ran


@pytest.mark.parametrize("fs,fft_out,rows,offset", CASES)
def test_kernel_model_matches_plain(fs, fft_out, rows, offset):
    """The kernel's arithmetic (numpy, float64) against the plain chain in
    float64: the same gate on every frame (the unvoiced and gated-off
    frames never reach the body) and the same rows to rounding."""
    x, f0, tp, so = _inputs(fs, rows=rows, offset=offset, seed=fs + 7,
                            dtype=torch.float64)
    want = DK.d4c_frames_plain(x, f0, tp, sample_offset=so,
                               **_kw(fs, fft_out)).numpy()
    got, ran = _kernel_model(x, f0, tp, so, fs, fft_out)
    active = want[..., 0] < 0.5
    np.testing.assert_array_equal(ran, active)
    assert active.sum() >= 4 and (~active & (f0.numpy() > 0)).sum() >= 4
    # the chain's own float64 rounding (its centroid's uncentred ramp,
    # hi less the top) reaches ~7e-9
    assert np.abs(got - want).max() < 1e-7


def test_smoothing_and_dc_correction_follow_filters():
    """The kernel's own tap-by-tap smoothing and DC correction against
    ops/filters.py's float64 literal forms and its float32 production
    forms, on rows of high dynamic range and on signed rows."""
    rng = np.random.RandomState(4)
    for fs, N in ((22050, 2048), (48000, 4096)):
        K = N // 2 + 1
        rows = np.exp(rng.randn(6, K) * 4.0)
        rows[3:] = rng.randn(3, K) * 1e3
        f0 = np.array([47.0, 95.3, 180.7, 333.3, 512.9, 800.0])
        mb = int(1.2 * C.CEIL_F0 * N / fs) + 2
        L = min(K, int(1.2 * C.CEIL_F0 * N / fs) + 4)
        for width in (f0, f0 / 2.0):
            got = np.stack([_smooth(r, w, fs, N)
                            for r, w in zip(rows, width)])
            lit = filters.linear_smoothing(torch.tensor(rows),
                                           torch.tensor(width), fs, N, mb)
            f32 = filters.linear_smoothing_frames(
                torch.tensor(rows, dtype=torch.float32),
                torch.tensor(width, dtype=torch.float32), fs, N, mb)
            scale = np.abs(rows).max(1, keepdims=True)
            assert (np.abs(got - lit.numpy()) / scale).max() < 1e-12
            assert (np.abs(got - f32.double().numpy()) / scale).max() < 1e-5
        got = np.stack([_dc_correct(r, v, fs, N, L) for r, v in zip(rows, f0)])
        lit = filters.dc_correction(torch.tensor(rows), torch.tensor(f0), fs,
                                    N)
        f32 = filters.dc_correction_frames(
            torch.tensor(rows, dtype=torch.float32),
            torch.tensor(f0, dtype=torch.float32), fs, N, 1.2 * C.CEIL_F0)
        scale = np.abs(rows).max(1, keepdims=True)
        assert (np.abs(got - lit.numpy()) / scale).max() < 1e-12
        assert (np.abs(got - f32.double().numpy()) / scale).max() < 1e-5


@pytest.mark.parametrize("count", [1, 30, 65])
def test_selection_sums_the_rest(count):
    """The radix selection and the direct sum of what lies below the top
    count, ties at the threshold counted, against a sort: float32 bits
    (the kernel's) and float64 (the model's)."""
    rng = np.random.RandomState(count)
    for dtype in (np.float32, np.float64):
        for case in range(4):
            p = (rng.rand(2049) ** 6).astype(dtype)
            if case == 1:   # ties across the threshold
                top = np.sort(p)[::-1]
                p[rng.choice(2049, 40, replace=False)] = top[count - 1]
            if case == 2:   # mostly exact zeros
                p[rng.rand(2049) < 0.9] = 0.0
            if case == 3:   # all equal
                p[:] = dtype(0.25)
            lo, hi = _lo_hi(p, count)
            srt = np.sort(p.astype(np.float64))
            assert lo == pytest.approx(srt[:-count].sum(), rel=1e-12,
                                       abs=0.0)
            assert hi == pytest.approx(srt.sum(), rel=1e-12)


def test_packed_transforms_are_the_real_ones():
    """Two real sequences in one complex FFT, split by conjugate symmetry,
    and one real sequence as a half-length complex FFT: numpy's rfft."""
    rng = np.random.RandomState(1)
    for N in (1024, 2048, 4096):
        a, b = rng.randn(N), rng.randn(N) * 1e-3
        sa, sb = _split(np.fft.fft(a + 1j * b))
        np.testing.assert_allclose(sa, np.fft.rfft(a), atol=1e-9)
        np.testing.assert_allclose(sb, np.fft.rfft(b), atol=1e-9)
        np.testing.assert_allclose(_packed_power(a),
                                   np.abs(np.fft.rfft(a)) ** 2, rtol=1e-9,
                                   atol=1e-9)


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


#: the tolerance tests/test_torch_analysis.py's test_d4c_frames holds the
#: float32 D4C to against the JAX package
AP_TOL = 1e-4


def _chain_ap0(x, f0, tp, fs, so=None):
    """The chain's LoveTrain ratio in float32, as d4c_frames_plain computes
    it, for the frames' gate margins."""
    fft = DK.love_train_fft_size(fs)
    mh = DK.d4c_max_half_lt(fs)
    origin = matlab_round(tp * fs + 0.001)
    if so is not None:
        origin = origin - so.to(torch.int32)[:, None]
    seg = frame_segments(x, origin, mh)
    w = DK._centered_window(seg, torch.clamp(f0, min=40.0), fs, C.BLACKMAN,
                            3.0, mh)
    s = torch.fft.rfft(w, n=fft)
    ps = s.real ** 2 + s.imag ** 2
    b0 = int(math.ceil(100.0 * fft / fs))
    ps[..., :b0 + 1] = 0.0
    cum = torch.cumsum(ps, -1)
    return cum[..., int(math.ceil(4000.0 * fft / fs))] \
        / cum[..., int(math.ceil(7900.0 * fft / fs))]


def _compare(x, f0, tp, fs, fft_out, so=None):
    """Kernel against plain on the same CUDA inputs: one launch; rows of
    frames active on both sides within AP_TOL; inactive rows exactly the
    default; each gate flip at ap0 within 1e-6 of 0.85.  Returns the
    largest difference and the flips."""
    kw = _kw(fs, fft_out)
    n0 = _build.launches["wt_d4c"]
    got = TD.d4c_frames(x, f0, tp, sample_offset=so, **kw)
    assert _build.launches["wt_d4c"] == n0 + 1
    want = DK.d4c_frames_plain(x, f0, tp, sample_offset=so, **kw)
    ag, aw = got[..., 0] < 0.5, want[..., 0] < 0.5
    both = ag & aw
    assert bool(both.any())
    diff = float((got - want)[both].abs().max())
    assert diff <= AP_TOL, diff
    default = torch.tensor(1.0 - C.MY_SAFE_GUARD_MINIMUM, dtype=torch.float32)
    assert bool((got[~ag] == default.to(got.device)).all())
    flips = (ag != aw).nonzero().tolist()
    if flips:
        ap0 = _chain_ap0(x, f0, tp, fs, so)
        for b, f in flips:
            assert abs(float(ap0[b, f]) - 0.85) < 1e-6, (b, f,
                                                          float(ap0[b, f]))
    return diff, flips


def _batch(dev, fs, B, F, seed=0):
    """B utterances of F frames on the cells' layout: padded to a multiple
    of 4,096 samples, the last frames of all but the longest unvoiced fill
    (f0 0), frame times [F] shared by the rows."""
    T = -(-(int((F - 1) * FRAME_S * fs) + 1) // 4096) * 4096
    xs, f0s = [], []
    for b in range(B):
        x, f0 = _signal(fs, T, seed + b)
        n = F - 37 * b
        f0 = f0[:F].copy()
        f0[n:] = 0.0
        x[int((n - 1) * FRAME_S * fs) + 1:] = 0.0
        xs.append(x)
        f0s.append(f0)
    x = torch.tensor(np.stack(xs), dtype=torch.float32, device=dev)
    f0 = torch.tensor(np.stack(f0s), dtype=torch.float32, device=dev)
    tp = torch.arange(F, dtype=torch.float32, device=dev) * FRAME_S
    return x, f0, tp


def _speech(dev, fs, lengths_s, seed):
    """The cells' inputs: the benchmark's speech-shaped utterances
    (``wtbench.speech``) as 16-bit samples, padded to a multiple of 4,096,
    and their F0 from the port's Harvest on the card (``batch_analyze``),
    fill frames 0; frame times [F]."""
    from wtbench import speech
    from worldtpu_torch.analysis import harvest as TH
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.parallel import batch as TB
    rows = speech.utterances(fs, [int(v * fs) for v in lengths_s], seed, dev)
    T = -(-max(len(r) for r in rows) // 4096) * 4096
    x = np.zeros((len(rows), T), np.float32)
    for i, r in enumerate(rows):
        x[i, :len(r)] = r / 32768.0
    x = torch.tensor(x, device=dev)
    geo = TH.HarvestGeometry(fs, T, f0_floor=40.0)
    ck = CheapTrickKernel(fs)
    f0 = TB.batch_analyze(x, geo=geo, fs=fs, fft_size=ck.fft_size,
                          max_half_window=ck.max_half_window)[0]
    tp = torch.arange(f0.shape[1], dtype=torch.float32, device=dev) * FRAME_S
    return x, f0.contiguous(), tp


@pytest.mark.cuda
@pytest.mark.parametrize("fs,fft_out,lo_s,hi_s", [
    (22050, 1024, 6.40, 6.75), (48000, 2048, 3.12, 3.23),
    (22050, 1024, 4.458, 4.458)])
def test_kernel_matches_plain_at_cell_shapes(dev, fs, fft_out, lo_s, hi_s):
    """B = 8 utterances as the corpus cells' batches (22.05 kHz ~1,350
    frames, 48 kHz ~650) and the crops cell's (~892 frames)."""
    x, f0, tp = _speech(dev, fs, np.linspace(lo_s, hi_s, 8), seed=fs)
    diff, flips = _compare(x, f0, tp, fs, fft_out)
    print(f"fs {fs} F {f0.shape[1]}: max |d ap| {diff:.3e}, gate flips "
          f"{flips}")


@pytest.mark.cuda
@pytest.mark.parametrize("fs", [16000, 25000, 44100, 50000, 96000])
def test_kernel_matches_plain_at_other_rates(dev, fs):
    """The other rates: fft 2,048 at 16 kHz, 4,096 at 44.1 and 8,192 at
    96 kHz, and LoveTrain at half D4C's fft (2,048 of 4,096 at 25 kHz,
    4,096 of 8,192 at 50 kHz); CheapTrick's fft for the output bins."""
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    x, f0, tp = _speech(dev, fs, [2.0, 1.7], seed=fs)
    diff, flips = _compare(x, f0, tp, fs, CheapTrickKernel(fs).fft_size)
    print(f"fs {fs}: max |d ap| {diff:.3e}, gate flips {flips}")


@pytest.mark.cuda
@pytest.mark.parametrize("fs,fft_out", [(22050, 1024), (48000, 2048)])
def test_kernel_matches_plain_at_chunk_shapes(dev, fs, fft_out):
    """A chunk step's blocks (longaudio._analysis): rows sliced from one
    recording at sample offsets, [B, F] frame times on the recording."""
    x, f0, _ = _speech(dev, fs, [6.0], seed=fs + 1)
    G, Fb = 8, 160
    A = int((Fb + 8) * FRAME_S * fs)
    first = torch.arange(G, device=dev) * (Fb - 24) + 3
    a0 = (first.double() * FRAME_S * fs).long() - 97
    xs = x[0, a0[:, None] + torch.arange(A, device=dev)]
    f0s = f0[0, first[:, None] + torch.arange(Fb, device=dev)].contiguous()
    tps = (first[:, None] + torch.arange(Fb, device=dev)).float() * FRAME_S
    diff, flips = _compare(xs, f0s, tps, fs, fft_out, a0)
    print(f"fs {fs} chunk: max |d ap| {diff:.3e}, gate flips {flips}")


@pytest.mark.cuda
@pytest.mark.parametrize("fs,fft_out", [(22050, 1024), (48000, 2048)])
def test_kernel_is_as_close_to_float64_as_the_chain(dev, fs, fft_out):
    """Pure harmonics over noise 60 dB down: the group delay divides the
    centroid by the power in deep spectral valleys, where float32 rounding
    of either version moves the aperiodicity by ~1e-4, and float32 and
    float64 round some frames' integer decisions (half widths, smoothing
    bins) apart.  Frame by frame, on the frames all three call active:
    the kernel's largest distance from the chain in float64 within the
    chain's own plus the tolerance the kernel is held to against the
    chain.  The frames where kernel and chain lie more than that
    tolerance apart are printed with both distances."""
    x, f0, tp = _batch(dev, fs, 8, 400, seed=11)
    kw = _kw(fs, fft_out)
    got = TD.d4c_frames(x, f0, tp, **kw).double()
    want = DK.d4c_frames_plain(x, f0, tp, **kw).double()
    exact = DK.d4c_frames_plain(x.double(), f0.double(), tp.double(), **kw)
    act = (got[..., 0] < 0.5) & (want[..., 0] < 0.5) & (exact[..., 0] < 0.5)
    assert int(act.sum()) > 100
    d_k = (got - exact).abs().amax(-1)[act]
    d_c = (want - exact).abs().amax(-1)[act]
    d_kc = (got - want).abs().amax(-1)[act]
    far = (d_kc > AP_TOL).nonzero().flatten().tolist()
    where = act.nonzero().tolist()
    print(f"fs {fs}: {int(act.sum())} frames; kernel {float(d_k.max()):.3e},"
          f" chain {float(d_c.max()):.3e} from float64, {float(d_kc.max()):.3e}"
          f" apart; {len(far)} frames over {AP_TOL} apart (b, f, apart, "
          f"kernel, chain): "
          + "; ".join(f"({where[i][0]}, {where[i][1]}, {float(d_kc[i]):.2e}, "
                      f"{float(d_k[i]):.2e}, {float(d_c[i]):.2e})"
                      for i in far[:12]))
    worst = int((d_k - d_c).argmax())
    assert bool((d_k <= d_c + AP_TOL).all()), (where[worst],
                                                float(d_k[worst]),
                                                float(d_c[worst]))


@pytest.mark.cuda
def test_kernel_against_jax_t16(dev):
    """The card's float32 D4C on t16 against the JAX package's d4c_frames
    on the same x, F0 and frame times (stored, ``jax_t16``): within
    AP_TOL on every frame both call active or both not, as
    tests/test_torch_analysis.py holds the CPU's chain; each gate flip at
    JAX's ap0 within 1e-6 of 0.85."""
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    stored = np.load(T16_JAX)
    x, f0, tp, fs = _t16()
    n0 = _build.launches["wt_d4c"]
    got = TD.d4c_frames(torch.tensor(x, device=dev)[None],
                        torch.tensor(f0, device=dev)[None],
                        torch.tensor(tp, device=dev), fs=fs,
                        fft_size_out=CheapTrickKernel(fs).fft_size)
    assert _build.launches["wt_d4c"] == n0 + 1
    got, want = got[0].cpu().numpy(), stored["ap"]
    assert got.shape == want.shape
    flip = (got[:, 0] < 0.5) != (want[:, 0] < 0.5)
    diff = float(np.abs(got - want)[~flip].max())
    print(f"t16 against JAX: {len(f0)} frames, "
          f"{int((want[:, 0] < 0.5).sum())} active; max |d ap| {diff:.3e}; "
          f"gate flips (f, JAX's ap0) "
          f"{[(int(f), float(stored['ap0'][f])) for f in flip.nonzero()[0]]}")
    assert diff <= AP_TOL
    assert all(abs(float(stored["ap0"][f]) - 0.85) < 1e-6
               for f in flip.nonzero()[0])


@pytest.mark.cuda
def test_replay_equals_eager(dev):
    """A captured and replayed call gives the eager call's bits."""
    x, f0, tp = _batch(dev, 22050, 4, 400, seed=5)
    eager = TD.d4c_frames(x, f0, tp, fs=22050, fft_size_out=1024)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        TD.d4c_frames(x, f0, tp, fs=22050, fft_size_out=1024)
        with torch.cuda.graph(graph, stream=stream):
            out = TD.d4c_frames(x, f0, tp, fs=22050, fft_size_out=1024)
    torch.cuda.current_stream().wait_stream(stream)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_one_launch_a_batch(dev):
    """batch_analyze's D4C stage is one launch a batch."""
    from worldtpu_torch.analysis import harvest as TH
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.parallel import batch as TB
    fs = 22050
    x, _, _ = _batch(dev, fs, 2, 200, seed=9)
    geo = TH.HarvestGeometry(fs, x.shape[1], f0_floor=40.0)
    ck = CheapTrickKernel(fs)
    n0 = _build.launches["wt_d4c"]
    TB.batch_analyze(x, geo=geo, fs=fs, fft_size=ck.fft_size,
                     max_half_window=ck.max_half_window)
    assert _build.launches["wt_d4c"] == n0 + 1
