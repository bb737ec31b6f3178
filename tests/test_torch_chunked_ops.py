"""The functions the long-audio path extended, in the port: the per-row
frame offset of synthesis.pulse_responses and the per-row temporal
positions ([B, F]) of cheaptrick_frames and d4c_frames.

Without the extensions (offset 0, positions [F]) they give the bits they
gave before (digests recorded on the commit before the extensions, keyed by
the machine's float32 fingerprint as in tests/test_torch_f64_synthesis.py);
[B, F] positions give each row what that row alone gives; a block of
frames with its offset gives what the whole spectrogram gives.  And
convert.key_from_worldtpu carries a JAX PRNGKey across."""

import jax
import numpy as np
import pytest
import torch

from test_torch_f64_synthesis import _digest, _platform_fingerprint
from worldtpu_torch import convert
from worldtpu_torch.analysis.cheaptrick import (CheapTrickKernel,
                                                cheaptrick_frames)
from worldtpu_torch.analysis.d4c import d4c_frames
from worldtpu_torch.synthesis import noise as TN
from worldtpu_torch.synthesis import synthesis as TS

torch.set_num_threads(1)

FS = 16000


def _inputs(dtype):
    """Two seeded 0.4 s waveforms with their F0 rows ([2, F], voiced and
    unvoiced frames) and shared frame times [F]."""
    rng = np.random.RandomState(21)
    n = 6400
    t = np.arange(n) / FS
    x, f0 = [], []
    F = 1 + int(1000 * n / FS / 5.0)
    for i in range(2):
        ft = (130 + 70 * i) * 2 ** (0.2 * np.sin(2 * np.pi * 3 * t))
        ph = 2 * np.pi * np.cumsum(ft) / FS
        w = 0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph)
        w[int(0.35 * n):int(0.5 * n)] = 0.0
        x.append(w + 0.003 * rng.randn(n))
        fr = (130 + 70 * i) * 2 ** (0.2 * np.sin(
            2 * np.pi * 3 * np.arange(F) * 0.005))
        fr[int(0.35 * F):int(0.5 * F)] = 0.0
        f0.append(fr)
    tpos = np.arange(F) * 0.005
    return (torch.tensor(np.stack(x), dtype=dtype),
            torch.tensor(np.stack(f0), dtype=dtype),
            torch.tensor(tpos, dtype=dtype))


def _analysis(dtype, tpos=None):
    x, f0, tp = _inputs(dtype)
    ck = CheapTrickKernel(FS)
    tp = tp if tpos is None else tpos
    spec = cheaptrick_frames(x, f0, tp, fs=FS, fft_size=ck.fft_size,
                             max_half_window=ck.max_half_window)
    ap = d4c_frames(x, f0, tp, fs=FS, fft_size_out=ck.fft_size)
    return spec, ap


def _digests():
    """Digests of CheapTrick and D4C (float32 and float64) with [F] frame
    times and of the float32 pulse responses with no frame offset."""
    out = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        spec, ap = _analysis(dt)
        out[f"analysis_{name}"] = _digest(spec.numpy(), ap.numpy())
    spec, ap = _analysis(torch.float32)
    _, f0, _ = _inputs(torch.float32)
    fft = CheapTrickKernel(FS).fft_size
    out_len = int((f0.shape[1] - 1) * 0.005 * FS) + 1
    mp = TS.capacity_max_pulses(out_len, FS)
    noise = torch.tensor(np.random.RandomState(22).randn(
        2, mp, fft).astype(np.float32))
    resp, starts, n_p, _ = TS.pulse_train(
        f0, spec, ap, noise, fs=FS, fft_size=fft, frame_period_s=0.005,
        out_length=out_len, max_pulses=mp)
    out["responses"] = _digest(resp.numpy(), starts.numpy(), n_p.numpy())
    return out


#: platform fingerprint -> _digests() on the commit before the extensions
_BEFORE = {
    "f577952c543fae48": {"analysis_f32": "a7a1cd152ed84b12",
                         "analysis_f64": "244e6b62b8ab66fb",
                         "responses": "c31850d9997f6b20"},
}


def test_extended_functions_bit_identical_to_before():
    fp = _platform_fingerprint()
    if fp not in _BEFORE:
        pytest.skip(f"no digests recorded for this machine's arithmetic "
                    f"(fingerprint {fp})")
    assert _digests() == _BEFORE[fp]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_per_row_positions_equal_rows_one_by_one(dtype):
    """[B, F] frame times (each row its own origin, as the chunks of one
    recording have) give each row what that row gives alone with its [F]
    times; a row of shared times gives the [F] result."""
    x, f0, tp = _inputs(dtype)
    ck = CheapTrickKernel(FS)
    # chunk-like local times: the same frames seen from slices that start
    # a fraction of a frame apart
    rows = torch.stack([tp, tp - 37.25 / FS])
    spec, ap = _analysis(dtype, rows)
    for i in range(2):
        s_i = cheaptrick_frames(x[i:i + 1], f0[i:i + 1], rows[i], fs=FS,
                                fft_size=ck.fft_size,
                                max_half_window=ck.max_half_window)
        a_i = d4c_frames(x[i:i + 1], f0[i:i + 1], rows[i], fs=FS,
                         fft_size_out=ck.fft_size)
        assert torch.equal(spec[i], s_i[0])
        assert torch.equal(ap[i], a_i[0])
    spec_f, ap_f = _analysis(dtype)
    spec_s, ap_s = _analysis(dtype, tp.expand(2, -1))
    assert torch.equal(spec_s, spec_f) and torch.equal(ap_s, ap_f)
    # the shifted row does read other samples
    assert not torch.equal(spec[1], spec_f[1])


def test_sample_offset_slices_equal_the_whole_recording():
    """Rows that are slices of one recording, with the recording's frame
    times and each slice's first sample (sample_offset), give the frames
    the whole recording gives, in float32 and in float64 (the long-audio
    blocks of either dtype)."""
    x, f0, tp = _inputs(torch.float32)
    ck = CheapTrickKernel(FS)
    kw = dict(fs=FS, fft_size=ck.fft_size, max_half_window=ck.max_half_window)
    whole_s = cheaptrick_frames(x[:1], f0[:1], tp, **kw)[0]
    whole_a = d4c_frames(x[:1], f0[:1], tp, fs=FS,
                         fft_size_out=ck.fft_size)[0]
    halo = 1200                      # past every window's reach at 16 kHz
    blocks = [(20, 35), (28, 45), (35, 64)]
    a0 = torch.tensor([int(tp[lo] * FS) - halo for lo, _ in blocks])
    width = max(int(tp[hi - 1] * FS) - int(a) + halo
                for (_, hi), a in zip(blocks, a0.tolist()))
    xs = torch.stack([x[0, a:a + width] for a in a0.tolist()])
    Fb = max(hi - lo for lo, hi in blocks)
    rows = torch.stack([tp[lo:lo + Fb] for lo, _ in blocks])
    f0s = torch.stack([f0[0, lo:lo + Fb] for lo, _ in blocks])
    spec = cheaptrick_frames(xs, f0s, rows, sample_offset=a0, **kw)
    ap = d4c_frames(xs, f0s, rows, fs=FS, fft_size_out=ck.fft_size,
                    sample_offset=a0)
    for g, (lo, hi) in enumerate(blocks):
        assert torch.equal(spec[g, :hi - lo], whole_s[lo:hi])
        assert torch.equal(ap[g, :hi - lo], whole_a[lo:hi])
    x, f0, tp = (t.double() for t in (x, f0, tp))
    rows = torch.stack([tp[lo:lo + Fb] for lo, _ in blocks])
    whole_s = cheaptrick_frames(x[:1], f0[:1], tp, **kw)[0]
    whole_a = d4c_frames(x[:1], f0[:1], tp, fs=FS,
                         fft_size_out=ck.fft_size)[0]
    spec = cheaptrick_frames(xs.double(), f0s.double(), rows,
                             sample_offset=a0, **kw)
    ap = d4c_frames(xs.double(), f0s.double(), rows, fs=FS,
                    fft_size_out=ck.fft_size, sample_offset=a0)
    assert spec.dtype == ap.dtype == torch.float64
    for g, (lo, hi) in enumerate(blocks):
        assert torch.equal(spec[g, :hi - lo], whole_s[lo:hi])
        assert torch.equal(ap[g, :hi - lo], whole_a[lo:hi])


def test_frame_offset_block_equals_whole_spectrogram():
    """pulse_responses of a block of frames with its offset, the pulses'
    global positions pt, equal those of the whole spectrogram (the
    chunked synthesis' frame selection), row by row with its own offset."""
    spec, ap = _analysis(torch.float32)
    _, f0, _ = _inputs(torch.float32)
    fft = CheapTrickKernel(FS).fft_size
    F = f0.shape[1]
    P = 40
    rng = np.random.RandomState(23)
    pt = torch.tensor(np.sort(rng.uniform(20.0, 50.0, (2, P)), axis=1)
                      .astype(np.float32))
    pt[:, :3] = torch.tensor([21.0, 30.0, 44.0])    # integer positions
    shift = torch.tensor(rng.uniform(0, 1 / FS, (2, P)).astype(np.float32))
    ns = torch.tensor(rng.randint(40, 200, (2, P)))
    vuv = torch.tensor((rng.rand(2, P) > 0.2).astype(np.float32))
    valid = torch.ones(2, P, dtype=torch.bool)
    noise = torch.tensor(rng.randn(2, P, fft).astype(np.float32))
    kw = dict(fs=FS, fft_size=fft)
    whole = TS.pulse_responses(pt, shift, ns, vuv, valid, spec, ap, noise,
                               **kw)
    assert torch.equal(whole, TS.pulse_responses(
        pt, shift, ns, vuv, valid, spec, ap, noise, frame_offset=0, **kw))
    off = torch.tensor([18, 15])
    Fb = 40
    blk_s = torch.stack([spec[i, o:o + Fb] for i, o in enumerate([18, 15])])
    blk_a = torch.stack([ap[i, o:o + Fb] for i, o in enumerate([18, 15])])
    assert F > 15 + Fb
    got = TS.pulse_responses(pt, shift, ns, vuv, valid, blk_s, blk_a, noise,
                             frame_offset=off, **kw)
    assert torch.equal(got, whole)


def test_key_from_worldtpu_round_trips():
    words = np.asarray(jax.random.PRNGKey(7))
    key = convert.key_from_worldtpu(words)
    assert key == TN.prng_key(7) == (0, 7)
    np.testing.assert_array_equal(np.asarray(key, np.uint32), words)
    big = np.asarray(jax.random.PRNGKey(2 ** 40 + 5))
    assert convert.key_from_worldtpu(big) == TN.prng_key(2 ** 40 + 5)
    with pytest.raises(ValueError):
        convert.key_from_worldtpu(np.asarray([1, 2, 3], np.uint32))
    with pytest.raises(ValueError):
        convert.key_from_worldtpu(np.asarray([1, 2], np.int64))
