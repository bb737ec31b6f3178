"""The pulse responses (``ops/pulse_kernel.py``, ``csrc/pulse.cu``).

On the CPU: the plain version equals the frozen copy of the chain in
``wtbench/reference`` bit for bit (float32 and float64), rows past
``valid`` are zero, the wrapper's routes and refusals, and a numpy model
of the CUDA kernel's schedule (its Stockham passes, the packing of two
real sequences into one complex FFT and their split, the noise's
half-length FFT, the fftshift and DC removal) against the plain version.

Marked ``cuda``: the kernel against the plain version on the card at the
cells' shapes, at fft 1,024, 2,048 and 4,096 and at LongPipeline's chunk
shapes; a captured and replayed launch against its eager launch; one
launch a ``batch_wav_to_wav`` batch.  Run them on a GPU machine with
``python -m pytest tests/test_torch_pulse.py -m cuda --noconftest``."""

import numpy as np
import pytest
import torch

from worldtpu_torch import _build
from worldtpu_torch import constants as C
from worldtpu_torch.ops import dft
from worldtpu_torch.ops import pulse_kernel as PK
from worldtpu_torch.synthesis import synthesis as TS
from wtbench.reference.synthesis import synthesis as RS

torch.set_num_threads(1)


def _inputs(fft, *, B=2, P=48, F=30, fs=22050, seed=0, dtype=np.float32,
            prefix=False):
    """Pulse inputs with every case the chain branches on: integer
    positions (fl == ce) and positions past the last frame, unvoiced and
    voiced pulses, aperiodicity below 0.001 and above 1 (the clamp) and a
    bin 0 at the voicing gate's edge, noise sizes 0, ordinary and past
    fft, and a non-prefix ``valid`` (unless ``prefix``)."""
    rng = np.random.RandomState(seed)
    K = fft // 2 + 1
    k = np.arange(K) / K
    tilt = rng.uniform(6.0, 14.0, (B, F, 1))
    formants = sum(np.exp(-((k - c) / 0.02) ** 2) for c in (0.05, 0.12, 0.3))
    spec = (np.exp(-tilt * k) * (0.05 + formants)
            * np.exp(0.3 * rng.randn(B, F, K))) * 1e-2
    spec[:, :, 7] *= -1.0                    # |spectrogram| is taken
    ap = rng.uniform(-0.02, 1.02, (B, F, K))
    ap[:, ::3, 0] = np.sqrt(0.999) + rng.uniform(-2e-7, 2e-7,
                                                 ap[:, ::3, 0].shape)
    pt = np.sort(rng.uniform(0.0, F + 2.0, (B, P)), axis=1)
    pt[:, 1:4] = np.array([3.0, 11.0, F - 1.0])
    pt[:, -1] = F + 4.5
    shift = rng.uniform(0.0, 1.0 / fs, (B, P))
    ns = rng.randint(20, fft // 3, (B, P))
    ns[:, 5], ns[:, 6], ns[:, -1] = 0, fft + 37, 1
    vuv = (rng.rand(B, P) > 0.3).astype(np.float64)
    if prefix:
        valid = np.arange(P)[None, :] < np.array([[P - 9], [P - 20]])[:B]
    else:
        valid = rng.rand(B, P) > 0.25
        valid[:, :8] = True
    noise = rng.randn(B, P, fft)
    t = {n: torch.tensor(v.astype(dtype)) for n, v in
         dict(pt=pt, shift=shift, vuv_at=vuv, spectrogram=spec,
              aperiodicity=ap, noise=noise).items()}
    t["ns"] = torch.tensor(ns, dtype=torch.int64)
    t["valid"] = torch.tensor(valid)
    return t


def _call(fn, t, fft, fs=22050, frame_offset=0):
    return fn(t["pt"], t["shift"], t["ns"], t["vuv_at"], t["valid"],
              t["spectrogram"], t["aperiodicity"], t["noise"], fs=fs,
              fft_size=fft, frame_offset=frame_offset)


# ---- the plain version ----

@pytest.mark.parametrize("fft,dtype,offset", [
    (1024, np.float32, "int"), (1024, np.float32, "tensor"),
    (2048, np.float32, "int"), (2048, np.float32, "tensor"),
    (1024, np.float64, "tensor")])
def test_plain_equals_frozen_chain(fft, dtype, offset):
    """The plain version, and the CPU route of synthesis.pulse_responses,
    are the chain as it was (the benchmark's frozen copy), bit for bit."""
    t = _inputs(fft, dtype=dtype, seed=fft)
    off = 3 if offset == "int" else torch.tensor([2, 0])
    want = _call(RS.pulse_responses, t, fft, frame_offset=off)
    assert torch.equal(_call(PK.pulse_responses_plain, t, fft,
                             frame_offset=off), want)
    assert torch.equal(_call(TS.pulse_responses, t, fft, frame_offset=off),
                       want)
    assert float(want.abs().max()) > 0


def test_rows_past_valid_are_zero():
    t = _inputs(1024, prefix=True)
    got = _call(TS.pulse_responses, t, 1024)
    valid = t["valid"]
    assert bool((got[~valid] == 0).all())
    assert bool((got[valid].abs().amax(-1) > 0).any())


def test_wrapper_routes_by_device_and_dtype(monkeypatch):
    """A CPU tensor, and float64 on any device, take the plain chain; a
    float32 tensor on the card takes the kernel (the card faked by the
    device test); other dtypes and tensors on two devices raise."""
    calls = []
    monkeypatch.setattr(PK, "pulse_responses_cuda",
                        lambda *a, **k: calls.append("cuda"))
    t32 = _inputs(512, P=12, F=10)
    n0 = _build.launches["wt_pulse_resp"]
    _call(PK.pulse_responses, t32, 512)
    assert calls == [] and _build.launches["wt_pulse_resp"] == n0
    monkeypatch.setattr(PK, "device_kind", lambda t: "cuda")
    t64 = _inputs(512, P=12, F=10, dtype=np.float64)
    assert torch.equal(_call(PK.pulse_responses, t64, 512),
                       _call(RS.pulse_responses, t64, 512))
    assert calls == []
    _call(PK.pulse_responses, t32, 512)
    assert calls == ["cuda"]
    monkeypatch.undo()
    t16 = dict(t32, spectrogram=t32["spectrogram"].half(),
               aperiodicity=t32["aperiodicity"].half())
    with pytest.raises(ValueError, match="float32 or float64"):
        _call(PK.pulse_responses, t16, 512)
    mixed = dict(t32, pt=t32["pt"].to("meta"))
    with pytest.raises(ValueError, match="pt: on meta"):
        _call(PK.pulse_responses, mixed, 512)
    with pytest.raises(ValueError, match="frame_offset: on meta"):
        _call(PK.pulse_responses, t32, 512,
              frame_offset=torch.zeros(2, dtype=torch.int64, device="meta"))


def test_cuda_entry_checks_inputs():
    """The kernel's launcher validates the FFT size, device, dtype and
    shape before any launch (checked here without a card)."""
    t = _inputs(512, P=12, F=10)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _call(PK.pulse_responses_cuda, t, 512)
    t128 = _inputs(128, P=12, F=10)
    with pytest.raises(ValueError, match="fft_size 128"):
        _call(PK.pulse_responses_cuda, t128, 128)


def test_irfft_leaves_out_imaginary_dc_and_nyquist():
    """irfft's definition, which the kernel follows and the plain version
    meets on the CPU: a real signal's transform takes only the real parts
    of bins 0 and n/2 (the periodic spectrum's bin n/2 has an imaginary
    part: the phase's |sin| there is not 0)."""
    g = torch.Generator().manual_seed(5)
    for n in (256, 1024, 4096):
        X = torch.randn(96, n // 2 + 1, generator=g, dtype=torch.complex64)
        assert torch.equal(dft.irfft(X, n=n), _irfft_defined(X, n=n))


def _irfft_defined(X, n=None):
    """irfft with the imaginary parts of bins 0 and n/2 left out."""
    X = X.clone()
    X[..., 0] = X[..., 0].real.to(X.dtype)
    X[..., -1] = X[..., -1].real.to(X.dtype)
    return torch.fft.irfft(X, n=n, dim=-1)


# ---- a numpy model of the kernel's schedule ----

def _fft_model(x, inverse, tw, shift):
    """csrc/pulse.cu's fft_shared on one sequence: Stockham passes (radix 2
    first where log2 n is odd, then radix 4) in natural order."""
    n = len(x)
    x = x.copy()
    p = 1
    if int(np.log2(n)) & 1:
        q = n // 2
        a, c = x[:q].copy(), x[q:].copy()
        x[0::2], x[1::2] = a + c, a - c
        p = 2
    q = n // 4
    i = np.arange(q)
    while p < n:
        k = i & (p - 1)
        v = [x[i + j * q].copy() for j in range(4)]
        step = (n // (4 * p)) << shift
        for j in (1, 2, 3):
            w = tw[j * k * step]
            v[j] = v[j] * (np.conj(w) if inverse else w)
        a0, a1 = v[0] + v[2], v[0] - v[2]
        a2, d = v[1] + v[3], v[1] - v[3]
        a3 = d * (1j if inverse else -1j)
        o = ((i - k) << 2) + k
        for j, val in enumerate((a0 + a2, a1 + a3, a0 - a2, a1 - a3)):
            x[o + j * p] = val
        p <<= 2
    return x


def _kernel_model(t, fft, fs, frame_offset=0):
    """One pulse at a time, step for step as the kernel computes it, in
    float64 (numpy)."""
    N, H = fft, fft // 2
    K = H + 1
    tw = np.exp(-2j * np.pi * np.arange(N) / N)
    dcr = PK.dc_remover(fft, torch.float64).numpy()
    spec, aper = t["spectrogram"].numpy(), t["aperiodicity"].numpy()
    B, F, _ = spec.shape
    P = t["pt"].shape[1]
    out = np.zeros((B, P, N))
    for b in range(B):
        off = (int(frame_offset[b]) if isinstance(frame_offset, torch.Tensor)
               else frame_offset)
        for p in range(P):
            if not bool(t["valid"][b, p]):
                continue
            m = int(t["ns"][b, p])
            cnt = min(max(m, 0), N)
            x = np.zeros(N)
            x[:cnt] = t["noise"][b, p, :cnt].numpy()
            x[:cnt] -= x[:cnt].sum() / max(m, 1)
            z = _fft_model(x[0::2] + 1j * x[1::2], False, tw, 1)
            ns = np.zeros(K, complex)
            ns[0], ns[H] = z[0].real + z[0].imag, z[0].real - z[0].imag
            for k in range(1, H // 2 + 1):
                a, c = z[k], z[H - k]
                e = (a + np.conj(c)) / 2
                o = (a - np.conj(c)) / 2j
                ns[k] = e + tw[k] * o
                ns[H - k] = np.conj(e - tw[k] * o)
            ptv = float(t["pt"][b, p])
            fl = int(np.clip(int(np.floor(ptv)) - off, 0, F - 1))
            ce = int(np.clip(int(np.ceil(ptv)) - off, 0, F - 1))
            w = ptv - np.floor(ptv)
            sk = np.abs(spec[b, fl])
            ak = np.clip(aper[b, fl], 0.001, 0.999999999999)
            if fl != ce:
                sk = (1 - w) * sk + w * np.abs(spec[b, ce])
                ak = (1 - w) * ak + w * np.clip(aper[b, ce], 0.001,
                                                0.999999999999)
            ak = ak * ak
            v = float(t["vuv_at"][b, p])
            gate = v > 0.5 and ak[0] <= 0.999
            lp = np.log(sk * (1 - ak) + C.MY_SAFE_GUARD_MINIMUM) / 2
            la = np.log(sk * ak if v != 0 else sk) / 2
            X = np.zeros(N, complex)
            X[:K] = lp + 1j * la
            X[N - np.arange(1, H)] = X[1:H]
            X = _fft_model(X, True, tw, 0)
            X *= np.where((np.arange(N) == 0) | (np.arange(N) == H), 1.0,
                          np.where(np.arange(N) < H, 2.0, 0.0)) / N
            X = _fft_model(X, False, tw, 0)
            coeff = 2 * np.pi * fs / N * float(t["shift"][b, p])
            kk = np.arange(K)
            re2 = np.clip(np.cos(coeff * (kk // 128 * 128))
                          * np.cos(coeff * (kk % 128))
                          - np.sin(coeff * (kk // 128 * 128))
                          * np.sin(coeff * (kk % 128)), -1, 1)
            ph = re2 - 1j * np.sqrt(1 - re2 * re2)
            per_in = 1.0 if gate and m > 0 else 0.0
            W = np.zeros(N, complex)
            W[0] = (np.exp(X[0].real) * ph[0]).real * per_in \
                + 1j * np.exp(X[0].imag) * ns[0].real
            W[H] = (np.exp(X[H].real) * ph[H]).real * per_in \
                + 1j * np.exp(X[H].imag) * ns[H].real
            for k in range(1, H):
                c, d = X[k], X[N - k]
                per = np.exp((c + np.conj(d)) / 2) * ph[k] * per_in
                ap = np.exp((c - np.conj(d)) / 2j) * ns[k]
                W[k] = per + 1j * ap
                W[N - k] = np.conj(per) + 1j * np.conj(ap)
            X = _fft_model(W, True, tw, 0)
            dc = X[:H].real.sum()
            n = np.arange(N)
            per = np.where(n < H, -dc * dcr[n % H],
                           X[(n - H) % N].real - dc * dcr[(n - H) % H])
            if not gate:
                per = 0.0 * per
            ap = X[(n + H) % N].imag
            out[b, p] = (per * np.sqrt(m) + ap) / N
    return out


@pytest.mark.parametrize("fft,offset", [(256, 0), (512, 2), (1024, "tensor"),
                                        (2048, 0)])
def test_kernel_model_matches_plain(fft, offset):
    """The kernel's schedule (numpy, float64) against the plain version in
    float64: the same responses to rounding."""
    P = 10 if fft == 2048 else 16
    t = _inputs(fft, P=P, F=12, seed=fft + 1, dtype=np.float64)
    fo = torch.tensor([1, 0]) if offset == "tensor" else offset
    want = _call(PK.pulse_responses_plain, t, fft, frame_offset=fo).numpy()
    got = _kernel_model(t, fft, 22050, frame_offset=fo)
    scale = np.abs(want).max(-1, keepdims=True) + 1e-300
    assert np.abs(got - want).max() / scale.max() < 1e-9
    assert (np.abs(got - want) / scale).max() < 1e-8
    assert bool((want[~t["valid"].numpy()] == 0).all())


def test_fft_model_is_the_dft():
    """Each pass structure (odd and even log2 n, the half-length table
    stride) against numpy's FFT."""
    rng = np.random.RandomState(3)
    for n, shift in ((256, 0), (512, 0), (1024, 1), (2048, 0), (128, 1)):
        tw = np.exp(-2j * np.pi * np.arange(n << shift) / (n << shift))
        x = rng.randn(n) + 1j * rng.randn(n)
        np.testing.assert_allclose(_fft_model(x, False, tw, shift),
                                   np.fft.fft(x), atol=1e-9)
        np.testing.assert_allclose(_fft_model(x, True, tw, shift),
                                   np.fft.ifft(x) * n, atol=1e-9)


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


#: the kernel's rounding against the chain's (its FFTs against cuFFT's):
#: each row's relative RMS difference
ROW_REL = 1e-5


def _plain_on_card(t, fft, fs, frame_offset, monkeypatch):
    """The plain version on the card, its irfft as defined.  For some
    plans (fft 4,096 over the chain's [B, 2P] rows) cuFFT's complex-to-real
    transform also reads the imaginary part of bin n/2, which a real
    signal's spectrum cannot have and numpy's, pocketfft's and FFTW's
    leave out: the plain version's bits with torch.fft.irfft are the
    plan's, not irfft's (test_irfft_leaves_out_imaginary_dc_and_nyquist:
    on the CPU the two are equal)."""
    with monkeypatch.context() as m:
        m.setattr(dft, "irfft", _irfft_defined)
        return _call(PK.pulse_responses_plain, t, fft, fs, frame_offset)


def _compare(t, fft, fs, frame_offset=0, *, monkeypatch):
    """Kernel against plain on the same CUDA inputs: padded rows exactly
    zero, the voicing gate the same (read from a second call with zero
    noise, where a row is zero exactly where per_on is off or ns is 0),
    each row within ROW_REL; returns the largest row difference."""
    got = _call(PK.pulse_responses_cuda, t, fft, fs, frame_offset)
    want = _plain_on_card(t, fft, fs, frame_offset, monkeypatch)
    valid = t["valid"]
    assert bool((got[~valid] == 0).all())
    norm = want.norm(dim=-1)
    live = valid & (norm > 0)
    rel = (got - want).norm(dim=-1)[live] / norm[live]
    assert float(rel.max()) <= ROW_REL, float(rel.max())
    assert bool((got[valid & (norm == 0)] == 0).all())
    quiet = dict(t, noise=torch.zeros_like(t["noise"]))
    g0 = _call(PK.pulse_responses_cuda, quiet, fft, fs, frame_offset)
    w0 = _plain_on_card(quiet, fft, fs, frame_offset, monkeypatch)
    assert torch.equal(g0.abs().amax(-1) > 0, w0.abs().amax(-1) > 0)
    assert bool((w0.abs().amax(-1) > 0).any())
    return float(rel.max())


@pytest.mark.cuda
@pytest.mark.parametrize("fft,offset", [(1024, 0), (2048, "tensor"),
                                        (4096, 3), (256, 0)])
def test_kernel_matches_plain(dev, fft, offset, monkeypatch):
    t = {k: v.to(dev) for k, v in _inputs(fft, P=64, F=40, seed=fft).items()}
    fo = torch.tensor([2, 5], device=dev) if offset == "tensor" else offset
    _compare(t, fft, 22050, fo, monkeypatch=monkeypatch)


def _cell_inputs(dev, fs, B, seconds, fft, seed):
    """The pulse train's inputs at a cell's shapes: speech-like contours
    through the time base, spectra from CheapTrick and D4C of vowels."""
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.analysis.cheaptrick import cheaptrick_frames
    from worldtpu_torch.analysis.d4c import d4c_frames
    rng = np.random.RandomState(seed)
    T = int(fs * seconds)
    F = int(seconds / 0.005) + 1
    tt = np.arange(F) * 0.005
    f0 = np.stack([(110 + 60 * i) * 2 ** (0.2 * np.sin(2 * np.pi * 2 * tt))
                   for i in range(B)])
    f0[:, F // 4:F // 3] = 0.0
    f0[1::2, F // 2:F // 2 + F // 10] = 0.0
    ts = np.arange(T) / fs
    f0s = np.stack([np.interp(ts, tt, r) for r in f0])
    ph = 2 * np.pi * np.cumsum(f0s, 1) / fs
    x = (0.4 * np.sin(ph) + 0.2 * np.sin(2 * ph) + 0.1 * np.sin(3 * ph)) \
        * (f0s > 0) + 0.01 * rng.randn(B, T)
    ck = CheapTrickKernel(fs)
    assert ck.fft_size == fft
    x = torch.tensor(x, dtype=torch.float32, device=dev)
    f0t = torch.tensor(f0, dtype=torch.float32, device=dev)
    tpos = torch.tensor(tt, dtype=torch.float32, device=dev)
    spec = cheaptrick_frames(x, f0t, tpos, fs=fs, fft_size=fft,
                             max_half_window=ck.max_half_window)
    ap = d4c_frames(x, f0t, tpos, fs=fs, fft_size_out=fft)
    out_len = int((F - 1) * 0.00625 * fs) + 1
    mp = TS.default_max_pulses(out_len, fs, f0_ceil=960.0)
    idx, shift, n_p, vuv, valid, _ = TS._time_base(
        f0t, fs, 0.00625, out_len, fs / fft + 1.0, mp)
    nxt = torch.minimum(torch.arange(mp, device=dev) + 1,
                        (n_p - 1)[:, None]).clamp(min=0)
    ns = torch.where(valid, idx.gather(1, nxt) - idx, 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    return dict(pt=idx.to(torch.float32) / fs / 0.00625, shift=shift, ns=ns,
                vuv_at=vuv, valid=valid, spectrogram=spec, aperiodicity=ap,
                noise=torch.randn((B, mp, fft), generator=g, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("fs,fft", [(22050, 1024), (48000, 2048),
                                    (96000, 4096)])
def test_kernel_matches_plain_at_cell_shapes(dev, fs, fft, monkeypatch):
    """B = 8 utterances of 3.2 s, the capacity at the cells' 960 Hz
    ceiling: about a third of the pulses real."""
    t = _cell_inputs(dev, fs, 8, 3.2, fft, seed=fs)
    real = float(t["valid"].float().mean())
    assert 0.2 < real < 0.6
    _compare(t, fft, fs, monkeypatch=monkeypatch)


@pytest.mark.cuda
def test_kernel_matches_plain_at_chunk_shapes(dev, monkeypatch):
    """LongPipeline's chunk step: the global pt, the block offsets as a
    [G] tensor, ``own`` as ``valid``; the arguments of its first call."""
    from test_torch_cuda import _long_utterance
    from worldtpu_torch import longaudio as TLA
    seen = []
    real = PK.pulse_responses_cuda

    def spy(*a, **k):
        if not seen:
            seen.append(([v.clone() if isinstance(v, torch.Tensor) else v
                          for v in a], dict(k)))
        return real(*a, **k)

    monkeypatch.setattr(PK, "pulse_responses_cuda", spy)
    fs = 16000
    lp = TLA.LongPipeline(fs, f0_floor=40.0, chunk_frames=400,
                          harvest_chunk_ms=3000, device=dev)
    lp.copy_synthesis(_long_utterance(fs, 4.0, seed=2), seed=7,
                      pitch_scale=1.2, duration_scale=1.25)
    (args, kw), = seen
    assert isinstance(kw["frame_offset"], torch.Tensor)
    names = ("pt", "shift", "ns", "vuv_at", "valid", "spectrogram",
             "aperiodicity", "noise")
    monkeypatch.undo()
    _compare(dict(zip(names, args)), kw["fft_size"], kw["fs"],
             kw["frame_offset"], monkeypatch=monkeypatch)


@pytest.mark.cuda
def test_replay_equals_eager(dev):
    """A launch captured in a CUDA graph and replayed gives the eager
    launch's bits."""
    t = {k: v.to(dev) for k, v in _inputs(2048, P=64, F=40).items()}
    eager = _call(PK.pulse_responses_cuda, t, 2048)
    _call(PK.pulse_responses_cuda, t, 2048)    # the constants made
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _call(PK.pulse_responses_cuda, t, 2048)
    out.fill_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_one_launch_a_batch(dev):
    """batch_wav_to_wav launches the kernel once a batch: once in the first
    (eager) call, and the program's capture records one launch."""
    from test_torch_cuda import _vowels
    from worldtpu_torch.analysis import harvest as TH
    from worldtpu_torch.analysis.cheaptrick import CheapTrickKernel
    from worldtpu_torch.parallel import batch as TB
    from worldtpu_torch.parallel import graphs as TG
    fs = 22050
    x = torch.tensor(_vowels(fs, 2), device=dev)
    geo = TH.HarvestGeometry(fs, x.shape[1], f0_floor=40.0)
    ck = CheapTrickKernel(fs)
    out_len = int((geo.n_grid() - 1) * 0.005 * fs) + 1
    mp = TS.capacity_max_pulses(out_len, fs)
    noise = TS.make_noise(torch.Generator(device=dev).manual_seed(0), 2, mp,
                          ck.fft_size, device=dev)
    kw = dict(geo=geo, fs=fs, fft_size=ck.fft_size,
              max_half_window=ck.max_half_window, frame_period_s=0.005,
              out_length=out_len, max_pulses=mp)
    TG.clear()
    n0 = _build.launches["wt_pulse_resp"]
    TB.batch_wav_to_wav(x, noise, **kw)
    assert _build.launches["wt_pulse_resp"] == n0 + 1
    TG.clear()
