"""Full long-audio pipeline: wav -> wav in bounded device memory for
arbitrarily long single utterances.

Port of worldtpu/longaudio.py, float32 and float64, on one device (its
chunks optionally split over a mesh of ranks, ``mesh=``).  The
batched programs materialize [F, K] slabs and a [max_pulses, fft_size]
response slab per utterance: fine for utterances, fatal for a 10-minute
recording.  This module composes chunked pieces instead:

  - F0: analysis.longform.LongHarvest (overlap-save chunked Harvest, one
    contour chain over the whole recording: on the card in float32, on
    the host otherwise).
  - Envelope and aperiodicity: frame-blocked CheapTrick + D4C.  Each block
    reads an audio slice with a halo covering the widest analysis window,
    so interior frames see the samples the unchunked analysis sees, and
    takes the recording's own frame times with the slice's first sample:
    window origins are rounded on the unchunked path's frame times (in
    the dtype), then read from the slice, and the recording is padded with its edge values
    as the unchunked analysis pads it, so every frame is the unchunked
    analysis' frame.  (worldtpu passes block-local times and pads with
    zeros: the local times can round a window origin to another sample
    than the unchunked path does at frames that fall on half samples, a
    quarter of the frames at 22.05 kHz in float32, and the first and last
    frames read zeros.)
  - Synthesis: output chunked on the sample axis.  The Q32 phase
    accumulator is carried across chunks (the unchunked cumulative sum's
    bits), each chunk detects one extra period of lookahead pulses so the
    noise size of its last owned pulse follows the unchunked rule, the
    responses are overlap-added (the OLA kernel on the card) into a local
    buffer of chunk + fft_size samples, and the host accumulates the
    buffers.  Noise is counter-based per GLOBAL pulse ordinal
    (synthesis.noise.indexed_noise), so in float32 the waveform does not
    depend on the chunk size (in float64 the block-local times can move a
    knife-edge pulse with it, as in worldtpu).

The chunked time base evaluates the unchunked one's formula
(synthesis._time_base, float32) on global sample indices: the same global
times, the same global knot lookup, the same extrapolated last knot (and
its voicing twin), so its pulses are the unchunked pulses, sample for
sample.  float64 (``dtype=torch.float64``) follows ``worldtpu``'s float64
chunk step: block-local times and interp1 over the block's knots, then the
same Q32 step and carried phase as float32 (not the unchunked float64
synthesis' sequential double sum, so a knife-edge pulse can fall apart
from the unchunked float64 path's, in ``worldtpu`` as here); the analysis
is the parity path's CheapTrick and D4C on each block, the noise JAX's
float64 rows, the overlap-add the OLA kernel's ``double`` instantiation.

The chunk step is one program, as JAX jits its ``_chunk_step``: the chunk
index is an int64 tensor on the device (JAX's traced ``k``), the noise key
too, so the step reads nothing from the host and one program serves every
chunk of a recording.  On the card each loop replays the step's captured
CUDA graph from its second call on (``parallel.graphs``; the prescan's
step likewise).  The programs are keyed on the recording's plan, read its
tables in place, share one memory pool and live as long as the loop: a
``graphs.Programs`` cache of the loop's own, dropped at its end.  (JAX
keys ``_chunks_map`` on the padded length, which a recording's plan fixes
too.)  The sequential mode keeps the carried phase and pulse ordinal on the
device and never waits for the host inside its loop: chunk k+1 is
enqueued before chunk k's buffer, copied to pinned memory behind an event,
is landed; the overflow flags are read once, at the end.  The mesh path
runs eagerly.

Trace points (``tracing``): the chunk step marks its parts as the stages
``long_analysis``, ``long_timebase``, ``long_noise``, ``long_pulses`` and
``long_ola``, the prescan step its time base as ``long_prescan``, so every
replay runs their marks; the host work is under ``wt.long.harvest``,
``wt.long.contour`` (LongHarvest; in float32 on the card its contour is
the device chain under the ``contour`` stage's marks), ``wt.long.plan``
and ``wt.long.land``.
``LongPipeline.counts`` holds the last call's chunk steps and
synthesized pulses, read with the overflow flags.

Memory: O(chunk) on the device (O(group) with ``parallel=True``), O(output)
on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import numpy as np
import torch

from worldtpu_torch import constants as C
from worldtpu_torch.analysis.cheaptrick import (CheapTrickKernel,
                                                cheaptrick_frames)
from worldtpu_torch.analysis.d4c import (d4c_frames, d4c_max_half_c,
                                         d4c_max_half_lt)
from worldtpu_torch.analysis.harvest import as_tensor, check_dtype
from worldtpu_torch.analysis.longform import LongHarvest
from worldtpu_torch.ops.interp import interp1
from worldtpu_torch.ops.numeric import download
from worldtpu_torch.ops.ola_kernel import overlap_add
from worldtpu_torch.parallel import graphs as _graphs
from worldtpu_torch.synthesis import noise as N
from worldtpu_torch.synthesis import synthesis as S
from worldtpu_torch.tracing import long_span, stage

#: chunks per batched call in the parallel mode (one OLA launch each)
PARALLEL_GROUP = 8

_Q32 = 4294967296.0
_M32 = 0xFFFFFFFF


def analysis_halo_samples(fs, f0_floor):
    """Widest temporal reach of any CheapTrick/D4C window around a frame:
    CheapTrick +-1.5 periods at its effective floor, D4C main loop +-2
    periods at kFloorF0D4C, LoveTrain +-1.5 periods at 40 Hz."""
    ct = int(1.5 * fs / min(f0_floor, C.FLOOR_F0) + 0.5)
    return max(ct, d4c_max_half_c(fs), d4c_max_half_lt(fs)) + 8


#: the dtypes a chunk program is captured in (graphs.Programs.call)
_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(eq=False)
class _Plan:
    """One recording's chunk geometry and its tables on the device.  A
    captured chunk program is keyed on the plan itself (by identity) and
    reads its tables in place."""
    fs: int
    fft: int
    max_half_window: int
    fp_a: float          # analysis frame period (s)
    fp_s: float          # synthesis frame period (s)
    L: int               # output samples owned per chunk
    slack: int           # lookahead samples
    Fb: int              # frames per analysis block
    A: int               # audio samples per block slice
    halo: int            # analysis halo (samples)
    Pmax: int            # pulse slots per chunk
    F_total: int         # frames of the recording
    out_length: int
    n_chunks: int
    flo: list            # first frame of each chunk's block (host)
    a0: list             # first audio sample of each block slice (host)
    x_dev: torch.Tensor      # [halo + ...] the input, edge-padded
    f0_dev: torch.Tensor     # [F_total + Fb] F0, edge-padded (analysis)
    cf0_dev: torch.Tensor    # [F_total + Fb + 1] time-base knots (+
    #                          extrapolated, then edge-padded)
    cvuv_dev: torch.Tensor   # [F_total + Fb + 1] their voicing (likewise)
    flo_dev: torch.Tensor    # [n_chunks] int64 flo on the device
    a0_dev: torch.Tensor     # [n_chunks] int64 a0 on the device
    tpos_dev: torch.Tensor   # [n_chunks, Fb] each block's frame times


def _plan(x, f0_np, *, fs, fft, max_half_window, halo, fp_a, fp_s,
          chunk_frames, dtype, device):
    """The chunk geometry of LongPipeline.copy_synthesis (worldtpu's, op
    for op) and its device tables, uploaded once."""
    F_total = len(f0_np)
    out_length = int((F_total - 1) * fp_s * fs) + 1
    L = max(1, int(round(chunk_frames * fp_s * fs)))
    # lookahead: one period at the synthesis lowest_f0 (= fs/fft + 1, so
    # < fft samples) + the boundary comparison sample
    slack = fft + 2
    n_chunks = max(1, -(-out_length // L))
    # frame block: covers chunk + slack pulses (+2 guard each side)
    Fb = int((L + slack) / (fs * fp_s)) + 6
    Fb = min(Fb, F_total + 4)
    F_pad = F_total + Fb        # edge-padded so every block slice exists
    # block audio slice: frames span (Fb-1)*fp_a s + halo each side
    A = int(np.ceil((Fb - 1) * fp_a * fs)) + 2 * halo + 2
    T = int(x.shape[0])
    need = A + int(np.ceil((F_pad - Fb) * fp_a * fs)) + 1
    # pulse bound per chunk: cycles at the fastest rate over L + slack
    max_rate = max(float(np.max(f0_np)), C.DEFAULT_F0)
    Pmax = int((L + slack) / fs * max_rate * 1.2) + 16
    Pmax = -(-Pmax // 128) * 128

    # block of chunk k: frames [flo, flo + Fb) cover the time base of its
    # pulses in [o0, o0 + L + slack) and the analysis frames of those
    # times; its audio slice starts halo samples before the first frame.
    # Its frame times are the recording's, in the dtype, as the unchunked
    # analysis computes them (arange * frame period)
    flo, a0, tpos = [], [], []
    ft = np.float64 if dtype == torch.float64 else np.float32
    for k in range(n_chunks):
        fl = min(max(int(k * L / (fs * fp_s)) - 2, 0), F_pad - Fb)
        t0_blk = ft(fl) * ft(fp_a)
        flo.append(fl)
        a0.append(int(np.floor(t0_blk * ft(fs))) - halo)
        tpos.append(np.arange(fl, fl + Fb).astype(ft) * ft(fp_a))

    # the input with `halo` samples before it and the rest after it, edge
    # values (the unchunked analysis replicates the edge samples)
    xd = as_tensor(x, device, dtype)
    x_dev = torch.cat([xd[:1].expand(halo), xd,
                       xd[-1:].expand(max(need, T + halo) - T)])
    f0 = torch.as_tensor(f0_np.astype(ft), device=device)
    f0_dev = torch.cat([f0, f0[-1:].expand(F_pad - F_total)])
    # the time base's knots, as synthesis._time_base builds them: the
    # unvoiced floor, then the extrapolated knot and its voicing twin,
    # edge-padded so every block's Fb + 1 knots exist (float64 reads a
    # block's; float32 reads no knot past the extrapolated one)
    lowest_f0 = fs / fft + 1.0
    cf0 = torch.where(f0 < lowest_f0, torch.zeros((), dtype=dtype,
                                                  device=device), f0)
    cvuv = (cf0 != 0.0).to(dtype)
    cf0 = torch.cat([cf0, cf0[-1:] * 2 - cf0[-2:-1]])
    cvuv = torch.cat([cvuv, cvuv[-1:] * 2 - cvuv[-2:-1]])
    cf0 = torch.cat([cf0, cf0[-1:].expand(Fb)])
    cvuv = torch.cat([cvuv, cvuv[-1:].expand(Fb)])
    flo_dev, a0_dev = (torch.as_tensor(np.asarray(v, np.int64),
                                       device=device) for v in (flo, a0))
    tpos_dev = torch.as_tensor(np.stack(tpos), device=device)
    return _Plan(fs=fs, fft=fft, max_half_window=max_half_window, fp_a=fp_a,
                 fp_s=fp_s, L=L, slack=slack, Fb=Fb, A=A, halo=halo,
                 Pmax=Pmax, F_total=F_total, out_length=out_length,
                 n_chunks=n_chunks, flo=flo, a0=a0, x_dev=x_dev,
                 f0_dev=f0_dev, cf0_dev=cf0, cvuv_dev=cvuv, flo_dev=flo_dev,
                 a0_dev=a0_dev, tpos_dev=tpos_dev)


def _timebase_core(p, k, carry):
    """Q32 pulse detection for chunks k [G] (int64, on the device) as rows
    (reference :180-288 with carried phase), carry [G] int64: the phase
    bits at the sample before each chunk.  float32: the unchunked
    _time_base's formula on GLOBAL sample indices (global times, the
    global knot lookup and the appended knot), so the pulses are the
    unchunked ones.  float64: ``worldtpu``'s float64 chunk step,
    block-local times and interp1 over the block's Fb + 1 knots."""
    dt = p.cf0_dev.dtype
    dev = carry.device
    n = p.L + p.slack
    G = k.shape[0]
    o0 = k * p.L
    s = torch.arange(n, device=dev)
    if dt == torch.float64:
        flo = p.flo_dev[k][:, None]
        knots = flo + torch.arange(p.Fb + 1, device=dev)       # [G, Fb+1]
        coarse_t = (torch.arange(p.Fb + 1, dtype=dt, device=dev)
                    * p.fp_s).expand(G, -1)
        t_loc = (o0[:, None] + s).to(dt) / p.fs - flo.to(dt) * p.fp_s
        f0i = interp1(coarse_t, p.cf0_dev[knots], t_loc)
        vuvi = interp1(coarse_t, p.cvuv_dev[knots], t_loc)
    else:
        t = (o0[:, None] + s).to(dt) / p.fs
        kn = torch.clamp((t / p.fp_s).to(torch.int32) + 1, 1,
                         p.F_total).long()
        x0 = kn.to(dt) * p.fp_s - p.fp_s
        sf = (t - x0) / p.fp_s
        f0_lo, f0_hi = p.cf0_dev[kn - 1], p.cf0_dev[kn]
        v_lo, v_hi = p.cvuv_dev[kn - 1], p.cvuv_dev[kn]
        f0i = f0_lo + sf * (f0_hi - f0_lo)
        vuvi = v_lo + sf * (v_hi - v_lo)
    vuvi = (vuvi > 0.5).to(dt)
    f0i = torch.where(vuvi == 0.0, torch.full((), C.DEFAULT_F0, dtype=dt,
                                              device=dev), f0i)

    step = (f0i / p.fs * _Q32 + 0.5).to(torch.int64)
    fbits = (carry[:, None] + torch.cumsum(step, dim=1)) & _M32
    carry_out = fbits[:, p.L - 1]
    wrap = fbits[:, 1:] < fbits[:, :-1]
    # comparisons beyond the true output end do not exist (unchunked
    # semantics: the global last pulse's noise size is 0 by the min rule)
    wrap = wrap & (o0[:, None] + s[:-1] + 1 <= p.out_length - 1)

    # static-size nonzero by rank scatter (no host sync); the extra slot
    # takes wraps past Pmax and the fill is the last local sample
    Pmax = p.Pmax
    rank = torch.cumsum(wrap, dim=1) - 1
    dest = torch.where(wrap & (rank < Pmax), rank, Pmax)
    idx = torch.full((G, Pmax + 1), n - 1, dtype=torch.int64, device=dev)
    idx.scatter_(1, dest, s[:-1].expand(G, n - 1))
    idx = idx[:, :Pmax]
    n_wrap = wrap.sum(1)
    n_det = torch.clamp(n_wrap, max=Pmax)
    slot = torch.arange(Pmax, device=dev)
    own = (slot < n_det[:, None]) & (
        idx < torch.clamp(p.out_length - o0, max=p.L)[:, None])
    n_own = own.sum(1)
    # the lookahead pulse must fit too
    overflowed = (n_wrap > Pmax) | (n_own == Pmax)
    return dict(vuvi=vuvi, fbits=fbits, carry_out=carry_out, idx=idx,
                n_det=n_det, own=own, n_own=n_own, overflowed=overflowed)


def _prescan_program(k, carry, ordn, *, plan):
    """One prescan step, the program that _phase_prescan replays: chunks
    k's time base alone -> (carry', ordinal', overflowed)."""
    with stage("long_prescan", k.device):
        tb = _timebase_core(plan, k, carry)
        out = tb["carry_out"], ordn + tb["n_own"], tb["overflowed"]
    return out


def _phase_prescan(p, dev, call=_graphs.eager):
    """Each chunk's entry state (Q32 carry, global pulse ordinal) and
    overflow flag, chunk by chunk on the device (the time base only): the
    cheap sequential pass that makes the expensive chunks independent.
    Each step goes through ``call`` (a ``graphs.Programs`` cache's: on the
    card a captured program from the second step on; graphs.eager:
    eagerly)."""
    carry = torch.zeros(1, dtype=torch.int64, device=dev)
    ordn = torch.zeros(1, dtype=torch.int64, device=dev)
    ks = torch.arange(p.n_chunks, device=dev)
    carries, ords, ovf = [], [], []
    for k in range(p.n_chunks):
        carries.append(carry)
        ords.append(ordn)
        carry, ordn, o = call(_prescan_program, (ks[k:k + 1], carry, ordn),
                              dtypes=_DTYPES, plan=p)
        ovf.append(o)
    return torch.cat(carries), torch.cat(ords), torch.cat(ovf)


def _pulse_table(p, k, carry):
    """The pulses of chunks k [G] as rows [G, Pmax]: _timebase_core's
    (idx local, own, n_own, carry_out, overflowed) and each pulse's
    sub-sample shift, noise size, voicing and GLOBAL fractional frame
    position pt (the unchunked path's float ops, so floor/ceil/frac of
    the response's frames match bit for bit)."""
    tb = _timebase_core(p, k, carry)
    idx, own, n_det = tb["idx"], tb["own"], tb["n_det"]
    dt = tb["vuvi"].dtype
    n = p.L + p.slack
    frac = tb["fbits"].to(dt) / _Q32
    f_lo = frac.gather(1, idx)
    f_hi = frac.gather(1, (idx + 1).clamp(max=n - 1))
    shift = (1.0 - f_lo) / (f_hi + 1.0 - f_lo) / p.fs
    vuv_at = tb["vuvi"].gather(1, idx)
    # noise size: samples to the next detected pulse, the lookahead one
    # for the chunk's last owned pulse (reference :106)
    nxt = torch.minimum(torch.arange(p.Pmax, device=idx.device) + 1,
                        (n_det - 1)[:, None]).clamp(min=0)
    ns = torch.where(own, idx.gather(1, nxt) - idx, 0)
    pt = ((k * p.L)[:, None] + idx).to(dt) / p.fs / p.fp_s
    return dict(idx=idx, own=own, n_own=tb["n_own"],
                carry_out=tb["carry_out"], overflowed=tb["overflowed"],
                shift=shift, ns=ns, vuv_at=vuv_at, pt=pt)


def _analysis(p, k):
    """Frame-blocked CheapTrick and D4C of chunks k [G] as rows:
    (spectrogram, aperiodicity) [G, Fb, fft//2 + 1] of each block's frames
    (on the ANALYSIS period), from its audio slice."""
    dev = k.device
    a0, flo = p.a0_dev[k], p.flo_dev[k]
    x_blk = p.x_dev[(a0 + p.halo)[:, None] + torch.arange(p.A, device=dev)]
    f0_blk = p.f0_dev[flo[:, None] + torch.arange(p.Fb, device=dev)]
    tpos_blk = p.tpos_dev[k]
    spec = cheaptrick_frames(x_blk, f0_blk, tpos_blk, fs=p.fs,
                             fft_size=p.fft,
                             max_half_window=p.max_half_window,
                             sample_offset=a0)
    ap = d4c_frames(x_blk, f0_blk, tpos_blk, fs=p.fs, fft_size_out=p.fft,
                    sample_offset=a0)
    return spec, ap


def _chunk_step(p, k, carry, ord0, key):
    """Chunks k [G] (int64, on the device: JAX's traced chunk index) as
    rows: frame-blocked CheapTrick + D4C and the carried synthesis.  key:
    the noise key (a ``noise.key_tensor`` on the device, or host words).
    Returns (buf [G, L + fft], carry', ord0', overflowed [G]); buf[g, j]
    belongs at global output sample k*L - fft//2 + 1 + j of its chunk
    k."""
    fs, fft, dev = p.fs, p.fft, k.device

    with stage("long_analysis", dev):
        spec, ap = _analysis(p, k)

    with stage("long_timebase", dev):
        pul = _pulse_table(p, k, carry)
    with stage("long_noise", dev):
        noise = N.indexed_noise(key, ord0, p.Pmax, fft, dtype=spec.dtype)
    with stage("long_pulses", dev):
        resp = S.pulse_responses(pul["pt"], pul["shift"], pul["ns"],
                                 pul["vuv_at"], pul["own"], spec, ap, noise,
                                 fs=fs, fft_size=fft,
                                 frame_offset=p.flo_dev[k])

    # ---- OLA into the local buffers (reference :118-139): a pulse at
    # local sample i writes [i - half + 1, i + half], and buffer position
    # j is local sample j - half + 1; the owned pulses come first, in
    # time order, and the kernel scans no pulse past n_own ----
    with stage("long_ola", dev):
        buf = overlap_add(resp.contiguous(), pul["idx"].to(torch.int32),
                          p.L + fft, pul["n_own"])
    return buf, pul["carry_out"], ord0 + pul["n_own"], pul["overflowed"]


def _step_program(k, carry, ord0, key, *, plan):
    """_chunk_step over the plan's tables: the program that the synthesis
    loops replay."""
    return _chunk_step(plan, k, carry, ord0, key)


class LongPipeline:
    """Streaming copy-synthesis for arbitrarily long utterances on
    ``device``.  One chunk geometry serves any input length; device memory
    is O(chunk_frames), host memory O(output).

    Args:
        fs: sample rate.
        frame_period: analysis frame period (ms).
        chunk_frames: synthesis-output chunk length in frames (~5 s at the
            default 1000).
        f0_floor / f0_ceil: Harvest range (the floor also sizes the
            analysis halo).
        harvest_chunk_ms / harvest_halo_ms: LongHarvest chunking.
        device: where everything runs ("cuda", "cpu" or a torch.device).

    Against worldtpu's class: the noise key is ``seed`` (an int, the key
    of JAX's PRNGKey(seed), or two uint32 words).

    ``counts``: the last ``copy_synthesis``'s ``chunk_steps`` (calls of
    the chunk step's program on this process) and ``pulses`` (the pulses
    they synthesized), None before the first.
    """

    def __init__(self, fs, *, frame_period=5.0, chunk_frames=1000,
                 f0_floor=C.FLOOR_F0, f0_ceil=C.CEIL_F0,
                 harvest_chunk_ms=8000, harvest_halo_ms=1000, device):
        self.fs = fs
        self.frame_period = frame_period
        self.chunk_frames = int(chunk_frames)
        self.f0_floor = f0_floor
        self.device = torch.device(device)
        self.harvest = LongHarvest(
            fs, chunk_ms=harvest_chunk_ms, halo_ms=harvest_halo_ms,
            frame_period=frame_period, f0_floor=f0_floor, f0_ceil=f0_ceil,
            device=device)
        ck = CheapTrickKernel(fs)
        self.fft_size = ck.fft_size
        self.max_half_window = ck.max_half_window
        self.halo = analysis_halo_samples(fs, f0_floor)
        self.counts = None

    def plan(self, x, f0_np, duration_scale=1.0, dtype=torch.float32):
        """The chunk geometry and device tables for input x and the
        (pitch-scaled) F0 contour f0_np [F] (float64 numpy)."""
        fp_a = self.frame_period / 1000.0
        return _plan(x, f0_np, fs=self.fs, fft=self.fft_size,
                     max_half_window=self.max_half_window, halo=self.halo,
                     fp_a=fp_a, fp_s=fp_a * float(duration_scale),
                     chunk_frames=self.chunk_frames, dtype=dtype,
                     device=self.device)

    def copy_synthesis(self, x, *, seed=0, pitch_scale=1.0,
                       duration_scale=1.0, dtype=torch.float32,
                       on_overflow="raise", parallel=False, mesh=None):
        """wav -> wav in ``dtype`` (float32, or float64: the parity path's
        stages and analysis, JAX's float64 noise rows).  Returns
        (y [out_length], f0 [n_frames]) as numpy, y in x's dtype.

        ``duration_scale`` stretches the synthesis frame period.
        ``on_overflow``: 'raise' or 'warn' when a chunk's pulse bound is
        exceeded (it cannot be for F0 below 1.2 * DEFAULT_F0 with the
        default margin).

        ``parallel``: the Q32 phase and pulse ordinal each chunk starts
        from are the only sequential state.  A cheap prescan (the time base
        alone, chunk by chunk, on the device) computes them for every
        chunk; the expensive chunks are then independent and run as rows
        of batched calls, PARALLEL_GROUP chunks at a time (one OLA launch
        per group; the last group filled up with repeats of the last
        chunk, dropped).  The pulses are those of the sequential mode by
        construction (the prescan reuses _timebase_core).

        ``mesh`` (a ('data', 'time') mesh, ``parallel.batch.make_mesh``;
        every rank of it calls with the same input): every rank runs
        LongHarvest and the prescan, then the chunk axis, padded to a
        multiple of the mesh's size, is split into contiguous runs over
        its ranks in (data, time) order; each rank runs its chunks in
        groups of PARALLEL_GROUP (padded chunks are silence), the chunk
        buffers are all-gathered, and every rank lands them in chunk order
        and returns the same y."""
        check_dtype(dtype)
        key = N.as_key(seed)
        out_dtype = (torch.empty((), dtype=x.dtype).numpy().dtype
                     if isinstance(x, torch.Tensor) else np.asarray(x).dtype)
        f0_np, _ = self.harvest.compute(x, dtype=dtype)
        f0_np = np.asarray(f0_np, np.float64) * pitch_scale
        with torch.no_grad():
            with long_span("plan"):
                p = self.plan(x, f0_np, duration_scale, dtype)
            if mesh is not None:
                y, ovf = self._sharded(p, key, mesh)
            else:
                y, ovf = (self._parallel if parallel else
                          self._sequential)(p, key)
        if bool(ovf.any()):
            msg = ("pulse bound exceeded in a synthesis chunk; rerun with "
                   "a larger chunk margin")
            if on_overflow == "raise":
                raise RuntimeError(msg)
            warnings.warn(msg)
        return y[:p.out_length].astype(out_dtype), f0_np

    def _sequential(self, p, key, call=None):
        """The chunks one by one, each step through ``call`` (a
        ``graphs.Programs`` cache's, None: a cache of this loop's own,
        dropped at its end; on the card the step's captured program from
        the second chunk on, the carry and ordinal passed from one
        replay's outputs to the next's inputs on the device;
        graphs.eager: eagerly)."""
        with _programs(call) as call:
            dev = self.device
            key = N.key_tensor(key, dev)
            ks = torch.arange(p.n_chunks, device=dev)
            y = np.zeros(p.out_length + p.fft, np.float64)
            carry = torch.zeros(1, dtype=torch.int64, device=dev)
            ord0 = torch.zeros(1, dtype=torch.int64, device=dev)
            pending, flags = None, []
            for k in range(p.n_chunks):
                buf, carry, ord0, ovf = call(
                    _step_program, (ks[k:k + 1], carry, ord0, key),
                    dtypes=_DTYPES, plan=p)
                flags.append(ovf)
                queued = (k, _download(buf))
                if pending is not None:
                    _land(y, p, *pending)
                pending = queued
            _land(y, p, *pending)
            return y, self._read_flags(flags, ord0, p.n_chunks)

    def _parallel(self, p, key, call=None):
        """The prescan, then the chunks PARALLEL_GROUP at a time through
        ``call`` (as ``_sequential``; the prescan's and the chunk step's
        programs in one cache); the last group is filled up with repeats
        of the last chunk, whose buffers and flags are dropped, so every
        group is one program's rows."""
        with _programs(call) as call:
            dev = self.device
            carries, ords, ovf_scan = _phase_prescan(p, dev, call)
            key = N.key_tensor(key, dev)
            G = PARALLEL_GROUP
            ks = torch.arange(-(-p.n_chunks // G) * G,
                              device=dev).clamp(max=p.n_chunks - 1)
            carries, ords = carries[ks], ords[ks]
            y = np.zeros(p.out_length + p.fft, np.float64)
            pending, flags = None, [ovf_scan]
            for k0 in range(0, p.n_chunks, G):
                n = min(G, p.n_chunks - k0)
                rows = slice(k0, k0 + G)
                buf, _, ord1, ovf = call(
                    _step_program, (ks[rows], carries[rows], ords[rows],
                                    key), dtypes=_DTYPES, plan=p)
                flags.append(ovf[:n])
                queued = (k0, _download(buf[:n]))
                if pending is not None:
                    _land(y, p, *pending)
                pending = queued
            _land(y, p, *pending)
            return y, self._read_flags(flags, ord1[n - 1:n], len(flags) - 1)

    def _sharded(self, p, key, mesh):
        from worldtpu_torch.parallel.distributed import all_gather
        carries, ords, ovf_scan = _phase_prescan(p, self.device)
        d, t = mesh.get_coordinate()
        n_time = mesh.size(1)
        per = -(-p.n_chunks // (mesh.size(0) * n_time))
        k_lo = min((d * n_time + t) * per, p.n_chunks)
        k_hi = min(k_lo + per, p.n_chunks)
        buf = torch.zeros((per, p.L + p.fft), dtype=p.x_dev.dtype,
                          device=self.device)
        ovf = torch.zeros(per, dtype=torch.uint8, device=self.device)
        # the pulses this rank synthesizes: its chunks' last ordinal out
        # less its first ordinal in
        done = torch.zeros(1, dtype=torch.int64, device=self.device)
        steps = 0
        for k0 in range(k_lo, k_hi, PARALLEL_GROUP):
            k1 = min(k0 + PARALLEL_GROUP, k_hi)
            ks = torch.arange(k0, k1, device=self.device)
            buf[k0 - k_lo:k1 - k_lo], _, ord1, ovf[k0 - k_lo:k1 - k_lo] = \
                _chunk_step(p, ks, carries[k0:k1], ords[k0:k1], key)
            done = ord1[-1:] - ords[k_lo:k_lo + 1]
            steps += 1
        # every rank's run, in the (data, time) rank order of the split
        bufs = all_gather(all_gather(buf, mesh, "time"), mesh, "data")
        ovfs = all_gather(all_gather(ovf, mesh, "time"), mesh, "data")
        bufs = bufs.reshape(-1, bufs.shape[-1])[:p.n_chunks].cpu().numpy()
        y = np.zeros(p.out_length + p.fft, np.float64)
        _land(y, p, 0, lambda: bufs)
        return y, self._read_flags(
            [ovf_scan, ovfs.reshape(-1)[:p.n_chunks].bool()], done, steps)

    def _read_flags(self, flags, pulses, steps):
        """The overflow flags (a list of bool tensors on the device) on the
        host, read with the synthesized pulses ([1] int64 on the device) in
        one copy; sets ``counts``."""
        got = torch.cat([*(f.to(torch.int64) for f in flags),
                         pulses.reshape(1).to(torch.int64)]).cpu()
        self.counts = {"chunk_steps": int(steps), "pulses": int(got[-1])}
        return got[:-1].bool()


@contextlib.contextmanager
def _programs(call):
    """``call``, or when it is None the ``call`` of a ``graphs.Programs``
    cache whose programs share one pool, dropped on exit."""
    if call is not None:
        yield call
        return
    programs = _graphs.Programs(shared_pool=True)
    try:
        yield programs.call
    finally:
        programs.clear()


def _download(buf):
    """A function that waits for buf [G, n] and gives it as numpy
    (``numeric.download``)."""
    wait = download(buf)
    return lambda: wait().numpy()


def _land(y, p, k0, finish):
    """Add chunk buffers k0, k0+1, ... into the host output y."""
    half = p.fft // 2
    with long_span("land"):
        for g, b in enumerate(finish()):
            lo = (k0 + g) * p.L - half + 1
            b = b.astype(np.float64)
            if lo < 0:
                b = b[-lo:]
                lo = 0
            hi = min(lo + len(b), len(y))
            y[lo:hi] += b[:hi - lo]
