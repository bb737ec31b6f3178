"""The port's corpus streaming against the JAX package's: ``io.corpus``
(iter_corpus, CorpusBatch.slice_outputs) field by field on the same seeded
wav directories, the C++ batch reader (``native.load_wavs_batch``) against
the Python reader and against ``worldtpu.native``'s, and
``HarvestKernel.compute_corpus`` / ``compute_batch(transfer_dtype=...)``
against the port's own ``compute_batch`` and JAX's, on the CPU."""

import struct
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from worldtpu import native as jnative
from worldtpu.analysis import harvest as H
from worldtpu.io import corpus as jcorpus
from worldtpu_torch import native as tnative
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.io import corpus as tcorpus
from worldtpu_torch.io import wav as twav

torch.set_num_threads(1)

FS = 16000
# (length, bit depth) of the seeded corpus: three depths, lengths that
# sort differently from their names, one batch short of full at size 3
CORPUS = [(5000, 16), (12000, 8), (8000, 24), (20001, 16), (3000, 24),
          (9100, 8), (700, 16)]


def _write_pcm(path, x, fs, nbit):
    """x in [-1, 1) as mono PCM of nbit bits with the stdlib wave module
    (two's-complement bytes for 8 bits too, as the readers decode them)."""
    scale = float(1 << (nbit - 1))
    q = np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int64)
    if nbit == 8:
        raw = q.astype(np.int8).tobytes()
    elif nbit == 16:
        raw = q.astype("<i2").tobytes()
    else:
        u = (q & 0xFFFFFF).astype("<u4").view(np.uint8).reshape(-1, 4)
        raw = u[:, :3].tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(nbit // 8)
        w.setframerate(fs)
        w.writeframes(raw)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(11)
    for i, (n, nbit) in enumerate(CORPUS):
        sub = root / ("a" if i % 2 else "b")     # the scan is recursive
        sub.mkdir(exist_ok=True)
        x = np.clip(0.3 * rng.randn(n), -0.99, 0.99)
        _write_pcm(sub / f"utt{i}.wav", x, FS, nbit)
    return root


def _assert_batches_equal(mine, ref):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.x.dtype == b.x.dtype and a.x.shape == b.x.shape
        np.testing.assert_array_equal(a.x, b.x)
        for k in ("lengths", "n_frames", "valid"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=k)
        for k in ("names", "fs", "frame_period_ms", "F", "out_length"):
            assert getattr(a, k) == getattr(b, k), k


@pytest.mark.parametrize("pad_to,frames_to,sort_by_length,fill_batch", [
    (4096, 16, True, True), (1024, 8, False, True), (1, 1, True, False),
    (512, 16, False, False)])
def test_iter_corpus_matches_jax(corpus_dir, pad_to, frames_to,
                                 sort_by_length, fill_batch):
    """Every field of every batch equal to worldtpu's iter_corpus on the
    same directory of 8-, 16- and 24-bit files (x bit for bit)."""
    kw = dict(pad_to=pad_to, frames_to=frames_to,
              sort_by_length=sort_by_length, fill_batch=fill_batch)
    mine = list(tcorpus.iter_corpus(corpus_dir, 3, **kw))
    ref = list(jcorpus.iter_corpus(corpus_dir, 3, **kw))
    _assert_batches_equal(mine, ref)
    assert len(mine) == 3 and mine[0].x.dtype == np.float32
    assert sum(int(b.valid.sum()) for b in mine) == len(CORPUS)


def test_load_corpus_float64_matches_jax(corpus_dir):
    """A float64 corpus takes the Python reader in both packages: equal,
    and equal in value to the float32 batches."""
    mine = tcorpus.load_corpus(corpus_dir, 4, dtype=np.float64)
    _assert_batches_equal(mine,
                          jcorpus.load_corpus(corpus_dir, 4,
                                              dtype=np.float64))
    for a, b in zip(mine, tcorpus.load_corpus(corpus_dir, 4)):
        np.testing.assert_array_equal(a.x.astype(np.float32), b.x)


def test_corpus_rate_mismatch_and_empty_raise(tmp_path):
    twav.wavwrite(tmp_path / "a.wav", np.zeros(100), 16000)
    twav.wavwrite(tmp_path / "b.wav", np.zeros(100), 22050)
    with pytest.raises(ValueError, match="sample rate"):
        tcorpus.load_corpus(tmp_path, 2)
    with pytest.raises(FileNotFoundError):
        tcorpus.load_corpus(tmp_path / "none", 2)


def test_slice_outputs_numpy_and_tensor(corpus_dir):
    """slice_outputs gives the same pieces for numpy and for a tensor (and
    JAX's CorpusBatch for numpy); fill rows are dropped."""
    (b,) = list(tcorpus.iter_corpus(corpus_dir, 8))
    (jb,) = list(jcorpus.iter_corpus(corpus_dir, 8))
    assert int(b.valid.sum()) == len(CORPUS)
    y = np.random.RandomState(2).randn(8, b.out_length).astype(np.float32)
    outs = b.slice_outputs(y)
    for got in (b.slice_outputs(torch.tensor(y)), jb.slice_outputs(y)):
        assert len(got) == len(outs) == len(CORPUS)
        for o, g in zip(outs, got):
            np.testing.assert_array_equal(o, np.asarray(g))
    for o, n in zip(outs, b.n_frames[b.valid]):
        assert len(o) == int((n - 1) * 5.0 / 1000.0 * FS) + 1


def test_c_reader_matches_python_and_worldtpu(corpus_dir, tmp_path):
    """The port's threaded C++ reader against its Python reader (io.wav)
    and against worldtpu.native.load_wavs_batch, bit for bit, at 8, 16 and
    24 bits; a file it cannot decode gets length -1 and a zero row, as in
    the original.  Skips only where no C++ compiler exists."""
    if not tnative.corpus_reader_built():
        pytest.skip("no C++ compiler")
    paths = sorted(corpus_dir.rglob("*.wav"))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF" + struct.pack("<I", 4) + b"WAVX" + bytes(64))
    T = 20480
    reads = tnative.corpus_reads
    x, lengths, rates, bits = tnative.load_wavs_batch(paths + [bad], T,
                                                      n_threads=3)
    assert tnative.corpus_reads == reads + 1
    jx, jl, jr, jbits = jnative.load_wavs_batch(paths + [bad], T)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(lengths, jl)
    np.testing.assert_array_equal(rates[:-1], jr[:-1])
    np.testing.assert_array_equal(bits[:-1], jbits[:-1])
    assert lengths[-1] == -1 and not x[-1].any()
    assert sorted(set(bits[:-1].tolist())) == [8, 16, 24]
    for i, p in enumerate(paths):
        xi, fs, nbit = twav.wavread(p)
        assert (lengths[i], rates[i], bits[i]) == (len(xi), fs, nbit)
        np.testing.assert_array_equal(x[i, :len(xi)], xi.astype(np.float32))
        assert not x[i, len(xi):].any()


# ---- HarvestKernel.compute_corpus and transfer_dtype ----

N = 6000


def _batches():
    """Three [2, N] float32 batches cut from the t22 fixture."""
    f = load_fixture("t22")
    x = np.asarray(f.x[:N], np.float32)
    y = np.asarray(f.x[-N:], np.float32)
    return f.fs, [np.stack([x, 0.6 * x]), np.stack([y, 0.8 * x[::-1]]),
                  np.stack([0.5 * y, x])]


@pytest.fixture(scope="module")
def harvest_runs():
    """The port's compute_batch on each batch (float32, CPU)."""
    fs, batches = _batches()
    hk = TH.HarvestKernel(fs, N, f0_floor=40.0, device="cpu")
    return fs, batches, hk, [hk.compute_batch(b) for b in batches]


def test_compute_corpus_is_lazy_and_equals_compute_batch(harvest_runs):
    """compute_corpus reads its iterable one batch ahead and no further
    (batch k+1 is enqueued before batch k is handed out), and hands out
    compute_batch's (f0, tpos) for every utterance, in order, bit for
    bit."""
    fs, batches, hk, want = harvest_runs
    read = []

    def source():
        for b in batches:
            read.append(len(read))
            yield b

    gen = hk.compute_corpus(source())
    assert read == []                  # a generator: nothing runs yet
    got, seen = [], []
    for item in gen:
        got.append(item)
        seen.append(len(read))
    # utterances 0-1 are batch 0's (2 batches read), 2-3 batch 1's (3), 4-5
    # batch 2's (3: the iterable is exhausted)
    assert seen == [2, 2, 3, 3, 3, 3]
    flat = [r for rows in want for r in rows]
    assert len(got) == len(flat) == 6
    for (f0, tpos), (wf0, wtpos) in zip(got, flat):
        assert f0.dtype == np.float64
        np.testing.assert_array_equal(f0, wf0)
        np.testing.assert_array_equal(tpos, wtpos)


def test_compute_corpus_matches_jax(harvest_runs, monkeypatch):
    """Two small batches through JAX's compute_corpus (the device contour,
    the production refine Pallas kernel in interpret mode): identical
    voicing and F0 within 0.01 Hz, as test_torch_entry.py holds
    compute_batch."""
    fs, batches, hk, want = harvest_runs
    monkeypatch.setattr(H, "_use_refine_kernel_default",
                        lambda: "interpret")
    jk = H.HarvestKernel(fs, N, f0_floor=40.0)
    ref = list(jk.compute_corpus(batches[:2]))
    got = [r for rows in want[:2] for r in rows]   # = compute_corpus's
    assert len(ref) == len(got) == 4
    for (f0, tpos), (jf0, jtpos) in zip(got, ref):
        assert (f0 > 0).sum() > 0.2 * f0.size
        np.testing.assert_array_equal(tpos, jtpos)
        np.testing.assert_array_equal(f0 > 0, jf0 > 0)
        np.testing.assert_allclose(f0, jf0, atol=0.01)


def test_transfer_dtype_matches_jax(harvest_runs, monkeypatch):
    """transfer_dtype=torch.float16 on the host contour branch (CPU input
    past HOST_CONTOUR_FRAMES, lowered below this signal's frame count)
    against JAX's compute_batch(contour_on="host",
    transfer_dtype=jnp.float16): equal bit for bit on these inputs (the
    float16 rounding absorbs the two sides' float32 differences), and
    within the documented ~5e-4 relative of the float32 download; the
    port's side runs through compute_corpus, which narrows as
    compute_batch does."""
    fs, batches, hk, _ = harvest_runs
    monkeypatch.setattr(TH, "HOST_CONTOUR_FRAMES", 0)
    monkeypatch.setattr(H, "_use_refine_kernel_default",
                        lambda: "interpret")
    b = batches[0]
    got = list(hk.compute_corpus([b], transfer_dtype=torch.float16))
    full = hk.compute_batch(b)
    jk = H.HarvestKernel(fs, N, f0_floor=40.0)
    ref = jk.compute_batch(b, contour_on="host", transfer_dtype=jnp.float16)
    for (f0, _), (jf0, _), (f32, _) in zip(got, ref, full):
        np.testing.assert_array_equal(f0, jf0)
        np.testing.assert_array_equal(f0 > 0, f32 > 0)
        assert not np.array_equal(f0, f32)          # the narrowing ran
        np.testing.assert_allclose(f0, f32, rtol=5e-4, atol=0)


def test_compute_corpus_needs_a_device_for_numpy(harvest_runs):
    """Numpy batches need a device named: with device=None the generator
    raises at its first batch (nothing falls back to the CPU); tensors
    compute where they lie."""
    fs, batches, _, want = harvest_runs
    hk = TH.HarvestKernel(fs, N, f0_floor=40.0)
    with pytest.raises(ValueError, match="name a device"):
        next(hk.compute_corpus(batches))
    got = list(hk.compute_corpus([torch.tensor(batches[1])]))
    for (f0, _), (wf0, _) in zip(got, want[1]):
        np.testing.assert_array_equal(f0, wf0)


def test_compute_corpus_float64_one_batch_at_a_time():
    """float64 batches take harvest_parity, one batch at a time: equal to
    compute_batch(dtype=torch.float64) per batch."""
    f = load_fixture("t16")
    n = 4800
    b0 = np.stack([f.x[:n], 0.5 * f.x[:n]])
    b1 = f.x[n:2 * n][None]
    hk = TH.HarvestKernel(f.fs, n, device="cpu")
    want = hk.compute_batch(b0, dtype=torch.float64) \
        + hk.compute_batch(b1, dtype=torch.float64)
    got = list(hk.compute_corpus(iter([b0, b1]), dtype=torch.float64))
    assert len(got) == 3
    for (f0, _), (wf0, _) in zip(got, want):
        np.testing.assert_array_equal(f0, wf0)
    assert (want[0][0] > 0).any()


def test_corpus_stream_through_compute_corpus(tmp_path):
    """A corpus streamed end to end on the CPU: iter_corpus (the C++
    reader where it builds) feeds compute_corpus with CorpusBatch.x, one
    F0 per row, fill rows included (a fill row repeats its utterance's
    F0), each of its batch's geometry."""
    f = load_fixture("t16")
    for i, n in enumerate((3000, 4000, 2500, 3500, 3900)):
        twav.wavwrite(tmp_path / f"u{i}.wav", f.x[i * 500:i * 500 + n],
                      f.fs)
    batches = list(tcorpus.iter_corpus(tmp_path, 3))
    assert [b.x.shape for b in batches] == [(3, 4096)] * 2
    hk = TH.HarvestKernel(f.fs, 4096, device="cpu")
    out = list(hk.compute_corpus(b.x for b in batches))
    assert len(out) == 6
    for f0, tpos in out:
        assert f0.shape == tpos.shape == (hk.get_samples(),)
        assert np.isfinite(f0).all()
    assert np.concatenate([b.valid for b in batches]).tolist() == \
        [True] * 5 + [False]
    np.testing.assert_array_equal(out[5][0], out[4][0])
    assert (out[0][0] > 0).any()
