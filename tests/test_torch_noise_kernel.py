"""The long-audio noise rows' kernel (``ops/noise_kernel.py``,
``csrc/noise.cu``).

On the CPU: a uint32 numpy model of the kernel's arithmetic (the per-block
fold_in, four columns a thread, the 20 rounds with funnel-shift rotations
and adds wrapping at 2**32) equals ``noise.row_bits``; the normal's steps
as the kernel rounds them, with the constants read from its source, equal
``noise.bits_to_normal``; ``indexed_noise`` routes float32 on the card to
the kernel and the CPU and float64 to the plain version; the stored JAX
rows (tests/fixtures/noise_jax_rows.npy) are JAX's normals, and the
model draws JAX's bits.

Marked ``cuda``: the kernel against the plain version on the card (fft
512, 1,024 and 2,048; an int start, a [1] and a [G] tensor; ordinals past
2**32; a real chunk plan's Pmax), the kernel against the stored JAX rows
within 1e-6, a captured and replayed chunk step against its eager run, one
launch an eager chunk step.  Run them on a GPU
machine with
``python -m pytest tests/test_torch_noise_kernel.py -m cuda --noconftest``."""

import pathlib
import re

import numpy as np
import pytest
import torch

from worldtpu_torch import _build
from worldtpu_torch.ops import noise_kernel as NK
from worldtpu_torch.synthesis import noise as TN

torch.set_num_threads(1)

SOURCE = (pathlib.Path(NK.__file__).resolve().parent.parent / "csrc"
          / "noise.cu").read_text()
_U32 = np.uint32
_M32 = 0xFFFFFFFF
_NEAR_WRAP = 2 ** 32 - 3


# ---- the kernel's arithmetic in numpy ----

def _funnelshift_l(lo, hi, r):
    """__funnelshift_l: the high word of (hi:lo) << r."""
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((both << np.uint64(r)) >> np.uint64(32)).astype(_U32)


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 arrays (adds wrap at 2**32)."""
    k2 = k0 ^ k1 ^ _U32(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = x0 + x1
            x1 = _funnelshift_l(x1, x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + (ks[(i + 2) % 3] + _U32(i + 1))
    return x0, x1


def kernel_bits(key, starts, count, fft):
    """The bits the kernel draws: [*starts.shape, count, fft] uint32, block
    by block as ``wt_noise_rows`` launches them.  Each block's first
    threads compute its rows' keys (fold_in of the ordinal's low word);
    thread t then takes items t, t + 256, ..., four columns each.  A
    block holds about 4,096 columns: at least one row, at most 256 (its
    threads).  Every column is checked to be written exactly once."""
    k0, k1 = (np.array([w], _U32) for w in TN.as_key(key))
    starts = np.asarray(starts, np.int64)
    flat = starts.reshape(-1)
    rows = flat.size * count
    per = max(1, min(256, 4096 // fft))
    quads = -(-fft // 4)
    out = np.zeros((rows, fft), _U32)
    writes = np.zeros((rows, fft), np.int64)
    for r0 in range(0, rows, per):
        nr = min(per, rows - r0)
        r = r0 + np.arange(nr)
        ords = flat[r // count] + r % count
        f0, f1 = _threefry(k0, k1, np.zeros(nr, _U32),
                           (ords & _M32).astype(_U32))
        for t in range(256):
            it = np.arange(t, nr * quads, 256)
            lr = it // quads
            j0 = 4 * (it - lr * quads)
            for c in range(4):
                j = j0 + c
                y0, y1 = _threefry(f0[lr], f1[lr], np.zeros(j.size, _U32),
                                   j.astype(_U32))
                keep = j < fft
                out[r0 + lr[keep], j[keep]] = (y0 ^ y1)[keep]
                writes[r0 + lr[keep], j[keep]] += 1
    assert (writes == 1).all()
    return out.reshape(*starts.shape, count, fft)


def _plain_bits(key, starts, count, fft):
    ords = torch.as_tensor(starts, dtype=torch.int64)[..., None] \
        + torch.arange(count)
    return TN.row_bits(key, ords, fft).numpy().astype(_U32)


@pytest.mark.parametrize("seed", [7, 2 ** 32 + 11])
@pytest.mark.parametrize("fft,starts,count", [
    (1024, 0, 9),
    (512, [_NEAR_WRAP], 11),
    (4096, [5, _NEAR_WRAP - 1, 2 ** 33 - 2], 3),
    (16, [[_NEAR_WRAP, 40], [2 ** 32 + 1, 3]], 5),
    (10, [2 ** 32 - 1], 7),
])
def test_kernel_model_bits_equal_row_bits(seed, fft, starts, count):
    """Bits equal to row_bits for every row and column, with ordinals that
    cross 2**32 (the fold_in takes the low word), several blocks of rows,
    a block ending inside a start's rows, and an fft that is not a
    multiple of 4."""
    got = kernel_bits(seed, starts, count, fft)
    want = _plain_bits(seed, starts, count, fft)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _hex_floats(name):
    body = re.search(name + r"(?:\[\d+\])? = \{?([^;}]*)\}?;", SOURCE).group(1)
    return [np.float32(float.fromhex(h.rstrip("f")))
            for h in re.findall(r"-?0x[0-9a-f.]+p[-+]?\d+f", body)]


def test_kernel_constants_are_the_plain_versions():
    """Giles' coefficients, the uniform's lower end and sqrt(2) in the
    source are the plain version's values rounded to float32."""
    assert _hex_floats("kLt5") == [np.float32(c) for c in TN._ERFINV_LT5]
    assert _hex_floats("kGe5") == [np.float32(c) for c in TN._ERFINV_GE5]
    assert _hex_floats("kLo") == [np.float32(TN._LO)]
    assert _hex_floats("kSqrt2") == [np.float32(np.sqrt(2.0))]


def kernel_normal(bits):
    """``normal_of`` in csrc/noise.cu, step by step in float32: each
    product and sum rounded on its own; log1p and the square root as the
    CPU's torch computes them (the card's kernel calls log1pf and an IEEE
    square root, as PyTorch's CUDA kernels do)."""
    f32 = np.float32
    lt5, ge5 = _hex_floats("kLt5"), _hex_floats("kGe5")
    lo, sqrt2 = _hex_floats("kLo")[0], _hex_floats("kSqrt2")[0]
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - f32(1.0)
    u = np.maximum(f * f32(2.0) + lo, lo)
    w = -torch.log1p(torch.from_numpy(-(u * u))).numpy()
    lt = w < f32(5.0)
    v = np.where(lt, w - f32(2.5),
                 torch.sqrt(torch.from_numpy(w)).numpy() - f32(3.0))
    p = np.where(lt, lt5[0], ge5[0]).astype(np.float32)
    for a, b in zip(lt5[1:], ge5[1:]):
        p = p * v + np.where(lt, a, b)
    return (p * u) * sqrt2


def test_kernel_normal_steps_equal_bits_to_normal():
    """The kernel's float32 steps equal the plain version's bit for bit,
    on every bit pattern's top 23 bits at both ends of the interval (the
    w >= 5 branch) and on random rows."""
    edge = np.arange(4096, dtype=np.uint64) << np.uint64(9)
    bits = np.concatenate([
        edge.astype(_U32), (edge + (np.uint64(1) << np.uint64(32))
                            - (np.uint64(4096) << np.uint64(9))
                            ).astype(_U32),
        kernel_bits(7, [_NEAR_WRAP], 40, 1024).reshape(-1)])
    want = TN.bits_to_normal(torch.from_numpy(bits.astype(np.int64))).numpy()
    got = kernel_normal(bits)
    assert (np.abs(got) > 3.0).any()
    np.testing.assert_array_equal(got.view(_U32), want.view(_U32))


# JAX's float32 rows at seed 2**32 + 11 (key words (1, 11) under x64), 4
# rows of fft 1,024 from each start (the first start's last ordinal is
# 2**32, folded in as 0), drawn on the CPU into tests/fixtures/ by
# np.save(JAX_ROWS, jax_rows()) with x64 on: the card's yardstick
JAX_SEED, JAX_STARTS, JAX_COUNT, JAX_FFT = \
    2 ** 32 + 11, (2 ** 32 - 3, 123_456), 4, 1024
JAX_ROWS = pathlib.Path(__file__).parent / "fixtures" / "noise_jax_rows.npy"


def _jax_draw(draw):
    import jax
    key = jax.random.PRNGKey(JAX_SEED)
    return np.stack([np.stack([np.asarray(draw(jax.random.fold_in(
        key, (s + i) & _M32))) for i in range(JAX_COUNT)])
        for s in JAX_STARTS])


def jax_rows():
    """jax.random.normal of fold_in(PRNGKey(JAX_SEED), ordinal mod 2**32)
    a row: [len(JAX_STARTS), JAX_COUNT, JAX_FFT] float32."""
    import jax
    import jax.numpy as jnp
    return _jax_draw(lambda k: jax.random.normal(k, (JAX_FFT,), jnp.float32))


def test_jax_rows_fixture_is_jaxs():
    """The stored rows are JAX's normals bit for bit, and worldtpu's
    indexed_noise's; the kernel's model draws JAX's bits; the plain
    version on the CPU is within 1e-6 of the rows."""
    import jax
    import jax.numpy as jnp
    from worldtpu.synthesis import synthesis as JS
    key = jax.random.PRNGKey(JAX_SEED)
    assert TN.as_key(np.asarray(key)) == (1, 11)
    stored = np.load(JAX_ROWS)
    assert stored.shape == (2, JAX_COUNT, JAX_FFT)
    assert stored.dtype == np.float32
    np.testing.assert_array_equal(stored, jax_rows())
    np.testing.assert_array_equal(stored, np.stack([np.asarray(
        JS.indexed_noise(key, s, JAX_COUNT, JAX_FFT, jnp.float32))
        for s in JAX_STARTS]))
    np.testing.assert_array_equal(
        kernel_bits(JAX_SEED, list(JAX_STARTS), JAX_COUNT, JAX_FFT),
        _jax_draw(lambda k: jax.random.bits(k, (JAX_FFT,), jnp.uint32)))
    plain = TN.indexed_noise(JAX_SEED, torch.tensor(JAX_STARTS), JAX_COUNT,
                             JAX_FFT)
    np.testing.assert_allclose(plain.numpy(), stored, rtol=0, atol=1e-6)


def test_routes_by_device_and_dtype(monkeypatch):
    """The CPU, and float64 on any device, take the plain version;
    float32 with its start on the card launches the kernel (the card faked
    by the device test) with the key as a device tensor [2] and the start
    as an int64 tensor; a key_tensor is passed as it is."""
    calls = []

    def kernel(key, start, count, fft_size):
        calls.append((key, start, count, fft_size))
        return "kernel"

    monkeypatch.setattr(NK, "noise_rows_cuda", kernel)
    n0 = _build.launches["wt_noise_rows"]
    assert torch.equal(TN.indexed_noise(7, 5, 4, 16),
                       TN.indexed_noise_plain(7, torch.tensor(5), 4, 16))
    assert calls == [] and _build.launches["wt_noise_rows"] == n0
    monkeypatch.setattr(TN, "device_kind", lambda t: "cuda")
    rows64 = TN.indexed_noise(7, torch.tensor([5, 9]), 4, 16,
                              dtype=torch.float64)
    assert rows64.dtype == torch.float64 and calls == []
    assert torch.equal(rows64, TN.indexed_noise_plain(
        7, torch.tensor([5, 9]), 4, 16, dtype=torch.float64))
    assert TN.indexed_noise(2 ** 32 + 11, torch.tensor([5, 9]), 4, 16) \
        == "kernel"
    (key, start, count, fft), = calls
    assert key.dtype == torch.int64 and key.tolist() == [1, 11]
    assert start.dtype == torch.int64 and start.tolist() == [5, 9]
    assert (count, fft) == (4, 16)
    kt = TN.key_tensor(7, "cpu")
    TN.indexed_noise(kt, torch.tensor(3, dtype=torch.int32), 4, 16)
    assert calls[-1][0] is kt and calls[-1][1].dtype == torch.int64
    assert calls[-1][1].shape == ()
    with pytest.raises(ValueError, match="float32 or float64"):
        TN.indexed_noise(7, 0, 4, 16, dtype=torch.float16)


def test_cuda_entry_checks_inputs():
    """The launcher checks the key's and the start's device and dtype
    before any launch (checked here without a card)."""
    key = TN.key_tensor(7, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        NK.noise_rows_cuda(key, torch.zeros(1, dtype=torch.int64), 4, 16)


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _starts(form, dev):
    if form == "int":
        return _NEAR_WRAP - 100
    if form == "one":
        return torch.tensor([_NEAR_WRAP - 40], device=dev)
    return torch.tensor([0, _NEAR_WRAP - 60, 2 ** 33 - 7, 123_456],
                        device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("fft", [512, 1024, 2048])
@pytest.mark.parametrize("form", ["int", "one", "group"])
def test_kernel_equals_plain_on_card(dev, fft, form):
    """Normals bit-equal to the plain version on the card; bits equal to
    row_bits through the uniforms they give."""
    start = _starts(form, dev)
    key = TN.key_tensor(2 ** 32 + 11, dev)
    n0 = _build.launches["wt_noise_rows"]
    got = TN.indexed_noise(key, start, 300, fft, device=dev)
    assert _build.launches["wt_noise_rows"] == n0 + 1
    if not isinstance(start, torch.Tensor):
        start = torch.tensor(start, device=dev)
    want = TN.indexed_noise_plain(key, start, 300, fft)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
def test_kernel_equals_plain_at_a_plans_pmax(dev):
    """At the rows of a real chunk plan at the long cell's settings
    (22.05 kHz, chunks of 1,000 frames, pitch x1.2, duration x1.25): Pmax
    rows of fft 1,024 from an ordinal near 2**32."""
    from worldtpu_torch import longaudio as TLA
    fs = 22050
    lp = TLA.LongPipeline(fs, f0_floor=40.0, chunk_frames=1000, device=dev)
    x = np.zeros(int(fs * 12.0), np.float32)
    t = np.arange(1 + int(1000 * len(x) / fs / 5.0)) * 0.005
    f0 = 220 * 2 ** (np.sin(2 * np.pi * 0.2 * t))
    p = lp.plan(x, f0 * 1.2, 1.25, torch.float32)
    assert p.fft == 1024 and p.Pmax >= 2048
    key = TN.key_tensor(5, dev)
    start = torch.tensor([_NEAR_WRAP - p.Pmax // 2], device=dev)
    got = TN.indexed_noise(key, start, p.Pmax, p.fft)
    want = TN.indexed_noise_plain(key, start, p.Pmax, p.fft)
    assert torch.equal(got, want), int((got != want).sum())


def _chunk_plan(dev):
    from worldtpu_torch import longaudio as TLA
    fs = 16000
    lp = TLA.LongPipeline(fs, f0_floor=40.0, chunk_frames=200, device=dev)
    x = np.random.RandomState(3).randn(int(fs * 3.0)).astype(np.float32)
    t = np.arange(1 + int(1000 * len(x) / fs / 5.0)) * 0.005
    f0 = 170 * 2 ** ((40 / 1200) * np.sin(2 * np.pi * 0.35 * t))
    f0[(t > 1.5) & (t < 1.8)] = 0.0
    return TLA, lp, lp.plan(x, f0 * 1.2, 1.25, torch.float32)


@pytest.mark.cuda
def test_captured_chunk_step_equals_eager(dev):
    """A chunk step captured and replayed gives its eager run's buffer,
    carry, ordinal and flags bit for bit, from an ordinal near 2**32."""
    from worldtpu_torch.parallel import graphs as TG
    TLA, _, p = _chunk_plan(dev)
    k = torch.tensor([1], device=dev)
    carry = torch.zeros(1, dtype=torch.int64, device=dev)
    ord0 = torch.tensor([_NEAR_WRAP - 5], device=dev)
    key = TN.key_tensor(11, dev)
    args = (k, carry, ord0, key)
    eager = TG.eager(TLA._step_program, args, dtypes=TLA._DTYPES, plan=p)
    progs = TG.Programs(shared_pool=True)
    try:
        for _ in range(3):                  # replayed by the third call
            out = progs.call(TLA._step_program, args, dtypes=TLA._DTYPES,
                             plan=p)
        assert all(torch.equal(a, b) for a, b in zip(out, eager))
    finally:
        progs.clear()


@pytest.mark.cuda
def test_eager_loop_launches_once_a_step(dev):
    """An eager sequential synthesis loop launches the kernel once a chunk
    step."""
    from worldtpu_torch.parallel import graphs as TG
    _, lp, p = _chunk_plan(dev)
    n0 = _build.launches["wt_noise_rows"]
    lp._sequential(p, TN.as_key(5), call=TG.eager)
    assert _build.launches["wt_noise_rows"] - n0 == p.n_chunks > 1


@pytest.mark.cuda
def test_kernel_against_jax_rows(dev):
    """The card's float32 route against JAX's normals (``JAX_ROWS``, drawn
    on the CPU): within 1e-6 absolute, noise.py's contract with JAX; the
    columns that are not bit-equal are counted and printed."""
    want = torch.from_numpy(np.load(JAX_ROWS))
    n0 = _build.launches["wt_noise_rows"]
    got = TN.indexed_noise(TN.key_tensor(JAX_SEED, dev),
                           torch.tensor(JAX_STARTS, device=dev), JAX_COUNT,
                           JAX_FFT).cpu()
    assert _build.launches["wt_noise_rows"] == n0 + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    print(f"kernel against JAX: {int((got != want).sum())} of "
          f"{want.numel()} columns not bit-equal, max |d| "
          f"{float((got - want).abs().max()):.3e}")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
