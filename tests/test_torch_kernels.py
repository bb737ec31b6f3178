"""The port's kernel modules zc (with zc events), refine and OLA on the
CPU, where each wrapper runs its plain PyTorch version, against the JAX
package.

zc is compared with the jnp twin the TPU kernel is tested against
(``vmap(harvest._band_candidates)``; the Pallas zc in interpret mode takes
~40 s a case).  zc events, refine and OLA are compared with their Pallas
kernels in interpret mode, which is what the TPU computes; the zc capacity
model with JAX's dense one; the pulse count pulse_train hands the OLA
kernel with JAX's time base.  (The extend walk: test_torch_extend.py.)"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import ola_padded_tail
from worldtpu.analysis import harvest as H
from worldtpu.ops import zc_kernel as Z
from worldtpu.ops.ola_kernel import overlap_add as j_overlap_add
from worldtpu.ops.refine_kernel import refine_stage_pallas
from worldtpu.synthesis import synthesis as JS
from worldtpu_torch import convert
from worldtpu_torch.analysis import harvest as TH
from worldtpu_torch.ops import ola_kernel as TO
from worldtpu_torch.ops import refine_kernel as TR
from worldtpu_torch.ops import zc_kernel as TZ
from worldtpu_torch.synthesis import synthesis as TS

torch.set_num_threads(1)


def _vowel(fs, dur, f0_base, seed):
    rng = np.random.RandomState(seed)
    T = int(fs * dur)
    t = np.arange(T) / fs
    f0t = f0_base * 2 ** (0.2 * np.sin(2 * np.pi * 3 * t))
    x = np.sin(2 * np.pi * np.cumsum(f0t) / fs)
    x += 0.4 * np.sin(4 * np.pi * np.cumsum(f0t) / fs)
    x[int(0.2 * T):int(0.3 * T)] = 0.0
    return (x * 0.5 + 0.003 * rng.randn(T)).astype(np.float32)


def _filtered(fs, f0b, floor, seed):
    x = _vowel(fs, 0.5, f0b, seed)
    geo = H.HarvestGeometry(fs, len(x), f0_floor=floor)
    y = H.decimate_stage(jnp.asarray(x), ratio=geo.ratio,
                         y_length=geo.y_length)
    filt = jnp.concatenate([H._band_filter_matmul(y, geo, jnp.float32, lo,
                                                  hi, Lg)
                            for lo, hi, Lg in H._conv_groups(geo)], axis=0)
    return x, geo, y, filt


@pytest.mark.parametrize("fs,f0b,floor", [(16000, 180.0, 71.0),
                                          (22050, 120.0, 40.0)])
def test_zc_plain_matches_jnp_twin(fs, f0b, floor):
    _, geo, _, filt = _filtered(fs, f0b, floor, 0)
    tpos = jnp.arange(geo.f0_length, dtype=jnp.float32) / 1000.0
    ref = np.asarray(jax.vmap(
        lambda fi, b: H._band_candidates(fi, b, geo, tpos))(
            filt, jnp.asarray(geo.boundary_f0, jnp.float32)))
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    out = TZ.band_candidates(torch.tensor(np.asarray(filt))[None], tgeo)[0]
    out = out.numpy()
    assert out.shape == ref.shape
    # same tolerance as the TPU kernel's test against this twin
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-3)
    assert rel.max() < 1e-4
    assert (out > 0).sum() == (ref > 0).sum()


def test_zc_plain_silence():
    """All-zero band signals: no events, every candidate gated to 0."""
    geo = TH.HarvestGeometry(16000, 4000)
    filt = torch.zeros((2, geo.n_channels, geo.y_length))
    raw = TZ.band_candidates(filt, geo)
    assert raw.shape == (2, geo.n_channels, geo.f0_length)
    assert torch.all(raw == 0.0)


def test_zc_plain_band_filter_matches_jax():
    """The port's filter bank (same blocked-Toeplitz f32 product)."""
    _, geo, y, filt = _filtered(16000, 180.0, 71.0, 2)
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    out = TH.band_filter(torch.tensor(np.asarray(y))[None], tgeo)[0]
    # ~800-tap f32 dot products of O(1) samples: 1e-4 absolute
    np.testing.assert_allclose(out.numpy(), np.asarray(filt), atol=1e-4)


@pytest.mark.parametrize("fs,f0b,floor", [(16000, 180.0, 71.0),
                                          (22050, 120.0, 40.0)])
def test_refine_plain_matches_pallas_interpret(fs, f0b, floor):
    """Plain refine vs the Pallas refine in interpret mode (the TPU's
    semantics: sorted, deduplicated, compacted): identical active sets,
    F0 to f32 rounding, scores (1/deviation, ill-conditioned) loosely."""
    x = _vowel(fs, 0.5, f0b, 1)
    geo = H.HarvestGeometry(fs, len(x), f0_floor=floor)
    y = H.decimate_stage(jnp.asarray(x), ratio=geo.ratio,
                         y_length=geo.y_length)
    tpos = jnp.arange(geo.f0_length, dtype=jnp.float32) / 1000.0
    cand, _, _ = H.candidates_stage(y, jnp.float32(0), tpos, geo=geo,
                                    use_zc=False)
    r1, s1 = refine_stage_pallas(y, cand, tpos, geo=geo, interpret=True,
                                 dedup_tol=H.REFINE_DEDUP_TOL)
    r1, s1 = np.asarray(r1), np.asarray(s1)
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    r2, s2 = TR.refine_stage(torch.tensor(np.asarray(y))[None],
                             torch.tensor(np.asarray(cand))[None],
                             torch.tensor(np.asarray(tpos)), geo=tgeo,
                             dedup_tol=TH.REFINE_DEDUP_TOL)
    r2, s2 = r2[0].numpy(), s2[0].numpy()
    # knife-edge score/floor gates may flip a handful of pairs
    assert ((r1 > 0) != (r2 > 0)).sum() <= max(2, (r1 > 0).sum() // 500)
    both = (r1 > 0) & (r2 > 0)
    # the TPU kernel's polynomial sincos vs exact cos: 2e-4 relative F0
    np.testing.assert_allclose(r2[both], r1[both], rtol=2e-4)
    np.testing.assert_allclose(s2[both], s1[both], rtol=0.1)


def test_refine_spectral_sums_inactive_slots_zero():
    rng = np.random.RandomState(3)
    hwmax, n_fft, N, cap = 40, 128, 3, 8
    seg = torch.tensor(rng.randn(N, 2 * hwmax + 1).astype(np.float32))
    delta = torch.tensor(rng.uniform(-1, 0, N).astype(np.float32))
    hw = torch.tensor(rng.randint(10, hwmax + 1, (N, cap)).astype(np.int32))
    gbin = torch.tensor(rng.randint(0, n_fft // 2, (N, cap, 6))
                        .astype(np.int32))
    n_active = torch.tensor([0, 3, 8], dtype=torch.int32)
    out = TR.spectral_sums(seg, delta, hw, gbin, n_active, hwmax=hwmax,
                           n_fft=n_fft)
    assert out.shape == (N, cap, 24)
    assert torch.all(out[0] == 0) and torch.all(out[1, 3:] == 0)
    assert torch.all(out[2].abs().sum(-1) > 0)
    # one pair against a direct f64 evaluation of the documented sums
    n, p = 1, 2
    m = np.arange(2 * hwmax + 1)
    h = int(hw[n, p])
    wl = 2 * h + 1

    def win(mm):
        c = np.cos(2 * np.pi * (mm + float(delta[n])) / wl)
        w = 0.42 + 0.5 * c + 0.08 * (2 * c * c - 1)
        return np.where(np.abs(mm - hwmax) <= h, w, 0.0)
    inw = np.abs(m - hwmax) <= h
    dw = np.where(inw, -(win(m + 1) - win(m - 1)) / 2, 0.0)
    s = seg[n].double().numpy()
    for k in range(6):
        ph = 2 * np.pi / n_fft * ((int(gbin[n, p, k]) * m) % n_fft)
        ref = [np.sum(s * win(m) * np.cos(ph)), -np.sum(s * win(m) * np.sin(ph)),
               np.sum(s * dw * np.cos(ph)), -np.sum(s * dw * np.sin(ph))]
        got = out[n, p, [k, 6 + k, 12 + k, 18 + k]].double().numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)


def _ola_case(seed, P, fft, T):
    rng = np.random.RandomState(seed)
    resp = rng.randn(2, P, fft).astype(np.float32)
    starts = np.sort(rng.randint(-(fft - 1), T - 1, size=(2, P)),
                     axis=1).astype(np.int32)
    return resp, starts


def test_ola_plain_matches_pallas_interpret_and_scatter():
    resp, starts, T = *_ola_case(1, 61, 1024, 12007), 12007
    out = TO.overlap_add(torch.tensor(resp), torch.tensor(starts), T).numpy()
    for b in range(2):
        ref = np.asarray(j_overlap_add(jnp.asarray(resp[b]),
                                       jnp.asarray(starts[b]), T,
                                       interpret=True))
        # f32 sums of <= ~8 overlapping unit-variance terms
        np.testing.assert_allclose(out[b], ref, rtol=1e-5, atol=1e-5)
        j = np.arange(resp.shape[2])
        tgt = starts[b][:, None] + j
        ok = (tgt >= 0) & (tgt < T)
        sc = np.zeros(T + 1, np.float64)
        np.add.at(sc, np.where(ok, tgt, T), np.where(ok, resp[b], 0.0))
        np.testing.assert_allclose(out[b], sc[:T], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_count", [False, True])
def test_ola_padded_tail_matches_pallas_interpret_and_scatter(with_count):
    """The time base's layout: real pulses, then zero-response padding
    pulses at one start near the end (an utterance of padding only too),
    with and without the pulse count: equal to the Pallas OLA in
    interpret mode, which adds every pulse, and to a numpy scatter."""
    T, fft = 9000, 512
    resp, starts, n = ola_padded_tail(4, P=120, fft=fft, T=T,
                                      n_real=(80, 10, 0))
    out = TO.overlap_add(torch.tensor(resp), torch.tensor(starts), T,
                         torch.tensor(n) if with_count else None).numpy()
    assert (out[2] == 0).all()
    for b in range(3):
        ref = np.asarray(j_overlap_add(jnp.asarray(resp[b]),
                                       jnp.asarray(starts[b]), T,
                                       interpret=True))
        np.testing.assert_allclose(out[b], ref, rtol=1e-5, atol=1e-5)
        tgt = starts[b, :n[b], None] + np.arange(fft)
        ok = (tgt >= 0) & (tgt < T)
        sc = np.zeros(T + 1, np.float64)
        np.add.at(sc, np.where(ok, tgt, T), np.where(ok, resp[b, :n[b]], 0))
        np.testing.assert_allclose(out[b], sc[:T], rtol=1e-5, atol=1e-5)


def test_pulse_train_count_matches_jax_time_base():
    """pulse_train's pulse count (what the OLA kernel scans) equals the
    count of JAX's _time_base for the same F0, an overflowing utterance
    clamped at max_pulses included; the pulses past it have zero
    responses and the starts do not decrease."""
    fs, fft, fp, F = 16000, 1024, 0.005, 120
    r = np.random.RandomState(6)
    t = np.arange(F)
    f0 = np.stack([150 + 30 * np.sin(t / 9.0), np.full(F, 700.0)])
    f0[0, 30:55] = 0.0
    f0 = f0.astype(np.float32)
    K = fft // 2 + 1
    spec = r.uniform(1e-4, 1e-2, (2, F, K)).astype(np.float32)
    ap = r.uniform(0.01, 0.99, (2, F, K)).astype(np.float32)
    out_len = int((F - 1) * fp * fs) + 1
    mp = 300
    noise = r.randn(2, mp, fft).astype(np.float32)
    resp, starts, n, ovf = TS.pulse_train(
        torch.tensor(f0), torch.tensor(spec), torch.tensor(ap),
        torch.tensor(noise), fs=fs, fft_size=fft, frame_period_s=fp,
        out_length=out_len, max_pulses=mp)
    lowest = fs / fft + 1.0
    for b in range(2):
        ref = JS._time_base(jnp.asarray(f0[b]), fs, fp, out_len, lowest, mp)
        assert int(n[b]) == int(ref[2])
        assert bool(ovf[b]) == bool(ref[5])
        assert bool((resp[b, int(n[b]):] == 0).all())
    assert ovf.tolist() == [False, True] and int(n[1]) == mp
    assert bool((starts[:, 1:] >= starts[:, :-1]).all())


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device has no
    route: the wrappers raise instead of falling back."""
    resp = torch.zeros((1, 2, 128), device="meta")
    starts = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TO.overlap_add(resp, starts, 100)
    geo = TH.HarvestGeometry(16000, 4000)
    with pytest.raises(ValueError, match="unsupported device"):
        TZ.band_candidates(torch.zeros((1, geo.n_channels, geo.y_length),
                                       device="meta"), geo)


def test_cuda_entry_checks_inputs():
    """The CUDA wrappers validate device, dtype, shape and contiguity
    before any launch (checked here without a card)."""
    resp = torch.zeros((1, 2, 128))
    starts = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TO.overlap_add_cuda(resp, starts, 100)


@functools.lru_cache(maxsize=2)
def _events_case(kind):
    """Band signals [nb, L] of a short 16 kHz vowel, or of a bare 3 kHz
    tone, whose stopband leak crosses far above every low band's column
    capacity c_row and event capacity e_cap (the clamp)."""
    fs = 16000
    if kind == "vowel":
        x = _vowel(fs, 0.25, 170.0, 7)
    else:
        t = np.arange(int(fs * 0.3)) / fs
        x = np.sin(2 * np.pi * 3000.0 * t).astype(np.float32)
    geo = H.HarvestGeometry(fs, len(x))
    y = H.decimate_stage(jnp.asarray(x), ratio=geo.ratio,
                         y_length=geo.y_length)
    filt = np.asarray(jnp.concatenate(
        [H._band_filter_matmul(y, geo, jnp.float32, lo, hi, Lg)
         for lo, hi, Lg in H._conv_groups(geo)], axis=0))
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    outs = TZ.zc_events(torch.tensor(filt)[None], tgeo)
    return geo, filt, outs


@pytest.mark.parametrize("fs,floor,dur", [(16000, 71.0, 0.25),
                                          (22050, 40.0, 4.46),
                                          (48000, 71.0, 9.0)])
def test_zc_groups_match_jax(fs, floor, dur):
    """The group capacities field for field, down to the long-input frame
    tile (ft 1 past 8000 frames)."""
    geo = H.HarvestGeometry(fs, int(fs * dur), f0_floor=floor)
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    jg = Z.make_groups(geo, n_groups=Z._NGROUPS)
    assert [vars(a) for a in jg] == [vars(b) for b in TZ.make_groups(tgeo)]


def _jax_events(geo, filt, g):
    y_len = geo.y_length
    stot = -(-y_len // 128)
    fp = np.pad(filt, ((0, 0), (0, stot * 128 - y_len)))
    filt_t = jnp.asarray(fp.reshape(-1, stot, 128).transpose(0, 2, 1))
    ev, ccol = Z._zc_events_call(filt_t[g.lo:g.hi], y_length=y_len,
                                 stot=stot, e_cap=g.e_cap, c_row=g.c_row,
                                 interpret=True, rb=2)
    return (np.asarray(ev)[:, :, :4].transpose(0, 2, 1),
            np.asarray(ccol)[:, :4, :stot])


@pytest.mark.parametrize("kind,gi", [("vowel", g) for g in range(10)]
                         + [("tone", 0), ("tone", 9)])
def test_zc_events_plain_matches_pallas_interpret(kind, gi):
    """Every band group of the vowel, and the tone's lowest group (columns
    past c_row, the buffer clamped at e_cap - c_row, the pad columns'
    +inf writes) and highest: counts equal, +inf in the same places,
    finite values equal."""
    geo, filt, outs = _events_case(kind)
    g = Z.make_groups(geo, n_groups=Z._NGROUPS)[gi]
    ev, ccol = outs[gi]
    jev, jccol = _jax_events(geo, filt, g)
    assert ev.shape == (1, g.hi - g.lo, 4, g.e_cap)
    np.testing.assert_array_equal(ccol[0].numpy(), jccol)
    np.testing.assert_array_equal(ev[0].numpy(), jev)
    if kind == "tone" and gi == 0:
        assert jccol.max() == g.c_row
        assert (jccol.sum(-1) > g.e_cap - g.c_row).any()


@pytest.mark.parametrize("kind", ["vowel", "tone"])
def test_zc_capacity_violations_match_jax(kind):
    geo, filt, _ = _events_case(kind)
    ref = np.asarray(Z.capacity_violations(jnp.asarray(filt), geo))
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    out = TZ.capacity_violations(torch.tensor(filt)[None], tgeo)[0].numpy()
    np.testing.assert_array_equal(out, ref)
    assert (ref == 0).all() if kind == "vowel" else (ref > 0).all()


@pytest.mark.parametrize("kind", ["vowel", "tone"])
def test_zc_event_overflows_count_the_kernel_capacity(kind):
    """event_overflows counts the (band, crossing type) pairs with more
    than e_max events (a numpy count); only bands among them change their
    zc candidates when the event buffer grows."""
    geo, filt, _ = _events_case(kind)
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    g = filt[:, 1:] - filt[:, :-1]
    counts = np.stack([((s[:, :-1] > 0) & (s[:, 1:] <= 0)).sum(-1)
                       for s in (filt, -filt, g, -g)], axis=1)
    over = counts > tgeo.e_max
    out = TZ.event_overflows(torch.tensor(filt)[None], tgeo)
    assert out.shape == (1,) and int(out[0]) == int(over.sum())
    assert over.any() if kind == "tone" else not over.any()
    filt_t = torch.tensor(filt)[None]
    bounds = torch.tensor(tgeo.boundary_f0, dtype=torch.float32)
    args = TZ.geometry_args(tgeo)
    small = TZ.band_candidates_plain(filt_t, bounds, **args)[0]
    args["e_max"] = int(counts.max()) + 2
    large = TZ.band_candidates_plain(filt_t, bounds, **args)[0]
    changed = (small != large).any(-1).numpy()
    assert not (changed & ~over.any(1)).any()


def test_zc_events_cuda_checks_inputs():
    with pytest.raises(ValueError, match="CUDA tensor"):
        TZ.zc_events_cuda(torch.zeros((1, 4, 300)), 0, 2, e_cap=128,
                          c_row=8)


def test_zc_events_groups_one_entry_for_all_groups():
    """The one-call entry (on the card one launch for every group) returns
    per group what a single-group call returns, for the geometry's groups
    in any order and for a subset; ``zc_events`` is that entry on
    ``make_groups``.  (Every group is held to the Pallas kernel in
    interpret mode above, through ``zc_events``.)"""
    geo, filt, outs = _events_case("vowel")
    tgeo = convert.geometry_from_worldtpu(vars(geo))
    ft = torch.tensor(filt)[None]
    groups = TZ.make_groups(tgeo)
    specs = [(g.lo, g.hi, g.e_cap, g.c_row) for g in groups]
    assert len(outs) == len(specs) == TZ.N_GROUPS <= TZ.MAX_EVENT_GROUPS
    some = TZ.zc_events_groups(ft, specs[6:] + specs[:2])
    for (ev, ccol), (lo, hi, e_cap, c_row), want in zip(
            some, specs[6:] + specs[:2], outs[6:] + outs[:2]):
        assert ev.shape == (1, hi - lo, 4, e_cap)
        assert torch.equal(ev, want[0]) and torch.equal(ccol, want[1])
        pev, pcc = TZ.zc_events_plain(ft, lo, hi, e_cap=e_cap, c_row=c_row)
        assert torch.equal(ev, pev) and torch.equal(ccol, pcc)
    assert TZ.zc_events_groups(ft, []) == []


def test_zc_layout_by_e_max():
    """wt_zc keeps a row's events in shared memory up to the byte limit,
    past it in a device scratch; chip_smoke.py's B=8 geometry (e_max
    7,125) takes the shared layout, its 24.33 s utterance the global."""
    lim = TZ.ZC_SHARED_EVENT_BYTES // 16
    assert TZ.zc_layout(lim) == "shared"
    assert TZ.zc_layout(lim + 1) == "global"
    assert TZ.zc_layout(TH.HarvestGeometry(22050, 98304, 40.0).e_max) \
        == "shared"
    assert TZ.zc_layout(TH.HarvestGeometry(22050, 536400, 40.0).e_max) \
        == "global"


@pytest.mark.parametrize("n_fft, W, match", [
    (2000, 553, "power of two"),
    (2 ** 22, 1025, "2\\*\\*31"),
    (2 ** 15, 553, "shared memory"),
])
def test_refine_geometry_checks(n_fft, W, match):
    """The refine kernel's int32 phase reduction and its shared twiddle
    table hold only for power-of-two n_fft with (n_fft/2)*W < 2**31 and a
    table that fits: the wrapper raises before it touches the tensors."""
    TR.check_refine_geometry(2048, 553)
    with pytest.raises(ValueError, match=match):
        TR.check_refine_geometry(n_fft, W)
    seg = torch.zeros((2, W))
    with pytest.raises(ValueError, match=match):
        TR.spectral_sums_cuda(seg, torch.zeros(2), torch.zeros(
            (2, TR.CAP), dtype=torch.int32), torch.zeros(
            (2, TR.CAP, 6), dtype=torch.int32), torch.zeros(
            2, dtype=torch.int32), hwmax=(W - 1) // 2, n_fft=n_fft)
