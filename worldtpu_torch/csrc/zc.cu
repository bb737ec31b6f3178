// Harvest zero-crossing candidates: per band signal, the negative-going
// crossings of (f, -f, diff f, -diff f), their interval contour
// interpolated onto the candidate frame grid, and the band gates.
//
// Replaces the Pallas TPU kernel worldtpu/ops/zc_kernel.py::_zc_group_kernel
// (band_candidates_pallas).  The semantics follow its jnp twin
// worldtpu/analysis/harvest.py::_zero_crossings/_band_candidates, f32
// production path, operation for operation:
//   - event i: s[i] > 0 && s[i+1] <= 0 && i < n_eff-1, at the sub-sample
//     position (i+1) - s[i]/(s[i+1]-s[i]);
//   - events are ranked in order, the rank clamped at e_max-1 (the last
//     event wins the clamped slot); past the events, +inf;
//   - locations are midpoints of consecutive events, intervals fs_a over
//     their spacing; frame f takes the segment counted by
//     #{k < n_int : clip(ceil(loc_k * grid_hz), 0, F) <= f}, clipped to
//     [1, max(n_int-1, 1)], and the interpolation formula of the twin;
//   - the candidate is the mean of the four types (summed in order t=0..3),
//     kept when every type has more than 3 events and it lies inside
//     [0.9b, 1.1b] and [f0_floor, f0_ceil].
//
// What bounds it on the H100: the bytes, each band signal read once (B*nb*L
// floats, 194 MB at chip_smoke.py's shapes) and the candidates written once
// (26 MB): about 0.07 ms at 3.35 TB/s.  The work per sample is a handful of
// compares; what cost time in the first design were four passes over each
// row (one per type) with two barriers per 512 samples, events in a 169 MB
// global scratch, and a binary search of global memory per frame and type.
// This design is ~9x slower than that bound (PERF.md): its events and
// lists leave room for one block per SM,
// so nothing overlaps a block's barriers and dependent chains, and the
// frame merge's lanes branch apart.
// This design, one 1024-thread block per (utterance, band):
//   - one pass over the row classifies all four types at each sample from
//     f[i], f[i+1], f[i+2]; a thread takes 8 samples of an 8192-sample chunk
//     (8 independent loads in flight, the next chunk's loaded while this
//     one is ranked; f[i+1], f[i+2] come from the next lanes), and the ranks
//     of all four types come from one block-wide scan of the per-warp ballot
//     counts: 4 barriers per chunk, 20 per row here (the first design: ~512);
//     while counting, a warp lists its events (sub, type, lane, rank in the
//     ballot) in shared memory, and after the scan its lanes take the list
//     in turn, so the division of an event's position runs on full warps
//     (one branch per (sub, type) left most lanes idle in high bands);
//   - the events stay in shared memory (4 * e_max floats, 114 KB here) when
//     they fit ("shared" layout); a longer geometry (HarvestKernel's 24 s
//     utterance: e_max ~38,600) keeps them in a global scratch [rows, 4,
//     e_max] instead ("global" layout); the wrapper picks by e_max, the
//     code is the same template;
//   - each thread owns a run of consecutive frames: one binary search per
//     type for its first frame, then a forward merge (a frame's segment
//     count never decreases with the frame), O(F + events) per row in place
//     of a search per frame; a segment's two locations and intervals (four
//     divisions) are computed when the segment changes, not per frame, and
//     a location's first frame is decided by a product, with the division
//     only where the product lies within 1e-5 of the frame (phase 2 is a
//     chain of dependent steps per thread, and a division is the longest).
// Built with --fmad=false (_build.py): the plain version rounds every
// product and sum separately, and the ceil and the gates are knife edges.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;                      // samples per thread and chunk
constexpr int kChunk = kThreads * kSub;      // samples per chunk
constexpr int kTypeEntries = kSub * kWarps;  // (sub, warp) counts per type
static_assert(4 * kTypeEntries == kThreads, "one scan entry per thread");
// a warp's events in a chunk: at most one per two samples of each type
constexpr int kListCap = 4 * (32 * kSub / 2);
constexpr unsigned kFull = 0xffffffffu;

struct TypeView {
  const float* ev;  // sorted events, count clamped to e_max
  int count;        // true event count
  int e_max;
  float fs_a;

  // dense[k] of the twin: events below min(count, e_max), +inf elsewhere
  __device__ float event(int k) const {
    int have = count < e_max ? count : e_max;
    return k < have ? ev[k] : INFINITY;
  }
  // out-of-range takes read NaN, as the twin's jnp.take (fill mode)
  __device__ float location(int k) const {
    if (k < 0 || k >= e_max) return NAN;
    if (k >= count - 1) return INFINITY;
    return (event(k) + event(k + 1)) / 2.0f / fs_a;
  }
  __device__ float interval(int k) const {
    if (k < 0 || k >= e_max) return NAN;
    return fs_a / (event(k + 1) - event(k));
  }
  // ceil(location(k) * grid_hz) <= ff for 0 <= k < min(count-1, e_max) and
  // an integer ff >= 0, i.e. location(k) * grid_hz <= ff.  The product
  // s * (grid_hz / fs_a) is within a few ulps of the twin's rounded
  // s / fs_a * grid_hz, so only a value within 1e-5 of ff takes the
  // division
  __device__ bool starts_by(int k, float ff, float grid_hz,
                            float grid_per_fs) const {
    // event(k + 1) is +inf past e_max (a clamped type), and so is est
    const float s = (event(k) + event(k + 1)) / 2.0f;
    const float est = s * grid_per_fs;
    const float margin = 1e-5f * ff + 1e-5f;
    if (est < ff - margin) return true;
    if (est > ff + margin) return false;
    return ceilf(s / fs_a * grid_hz) <= ff;
  }
};

// The four event bits (bit t: an event of type t) of sample i from
// a = f[i], b = f[i+1], c = f[i+2] (read where they exist).
__device__ __forceinline__ unsigned classify(float a, float b, float c, int i,
                                             int L) {
  unsigned bits = 0u;
  if (i < L - 1) {
    if (a > 0.0f && b <= 0.0f) bits |= 1u;               // f
    if (-a > 0.0f && -b <= 0.0f) bits |= 2u;             // -f
  }
  if (i < L - 2) {
    const float d0 = b - a, d1 = c - b;
    if (d0 > 0.0f && d1 <= 0.0f) bits |= 4u;             // diff f
    if (-d0 > 0.0f && -d1 <= 0.0f) bits |= 8u;           // -diff f
  }
  return bits;
}

// The sub-sample position of the type-t event at sample i.
__device__ __forceinline__ float fine_of(const float* f, int t, int i) {
  const float sgn = (t & 1) ? -1.0f : 1.0f;
  float s0, s1;
  if (t < 2) {
    s0 = sgn * f[i];
    s1 = sgn * f[i + 1];
  } else {
    s0 = sgn * (f[i + 1] - f[i]);
    s1 = sgn * (f[i + 2] - f[i + 1]);
  }
  return (float)(i + 1) - s0 / (s1 - s0);
}

// #{k < hi : ceil(location(k) * grid_hz) <= ff}, locations non-decreasing
__device__ int frames_search(const TypeView& v, int hi, float ff,
                             float grid_hz, float grid_per_fs) {
  int lo = 0;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v.starts_by(mid, ff, grid_hz, grid_per_fs)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <bool kSharedEvents>
__global__ void __launch_bounds__(kThreads, 1)
    zc_kernel(const float* __restrict__ filt,
              const float* __restrict__ bounds, float* __restrict__ ev_all,
              float* __restrict__ out, int nb, int L, int F, int e_max,
              float fs_a, float grid_hz, float tstep, float f0_floor,
              float f0_ceil) {
  // dynamic: the events (shared layout), then each warp's event list
  extern __shared__ float dyn[];
  __shared__ int cnt[2][4 * kTypeEntries];  // per (type, sub, warp); by parity
  __shared__ int wsum[kWarps];
  __shared__ int wpre[kWarps];
  __shared__ int ttot[4];

  const int row = blockIdx.x;
  const int band = row % nb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const float* f = filt + (size_t)row * L;
  float* ev = kSharedEvents ? dyn : ev_all + (size_t)row * 4 * e_max;
  int* wl = reinterpret_cast<int*>(dyn + (kSharedEvents ? 4 * e_max : 0)) +
            warp * kListCap;

  int base[4] = {0, 0, 0, 0};  // events of each type before the chunk
  int parity = 0;
  // a chunk's samples: a[j] = f[i] at i = c0 + j*kThreads + tid, and in
  // lane 2j+q < 16 the sample 32 + q past the warp's span of sub j (what
  // lanes 30 and 31 need as f[i+1], f[i+2]); the next chunk's are loaded
  // while this one is ranked
  float a[kSub], an[kSub], ex, exn = 0.0f;
  auto load = [&](int c0, float* dst, float& e) {
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int i = c0 + j * kThreads + tid;
      dst[j] = i < L ? f[i] : 0.0f;
    }
    const int ie = c0 + (lane >> 1) * kThreads + warp * 32 + 32 + (lane & 1);
    e = (lane < 2 * kSub && ie < L) ? f[ie] : 0.0f;
  };
  load(0, an, exn);
  for (int c0 = 0; c0 < L - 1; c0 += kChunk, parity ^= 1) {
#pragma unroll
    for (int j = 0; j < kSub; ++j) a[j] = an[j];
    ex = exn;
    if (c0 + kChunk < L - 1) load(c0 + kChunk, an, exn);
    unsigned bits = 0u;  // 4 bits per sub-sample
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const float e0 = __shfl_sync(kFull, ex, 2 * j);
      const float e1 = __shfl_sync(kFull, ex, 2 * j + 1);
      float b = __shfl_down_sync(kFull, a[j], 1);
      float c = __shfl_down_sync(kFull, a[j], 2);
      if (lane == 31) b = e0;
      if (lane >= 30) c = lane == 30 ? e0 : e1;
      bits |= classify(a[j], b, c, c0 + j * kThreads + tid, L) << (4 * j);
    }
    // count each (sub, type) of the warp, and list the warp's events as
    // (sub, type, lane, rank among the ballot's lanes)
    int* cn = cnt[parity];
    int nl = 0;
#pragma unroll
    for (int j = 0; j < kSub; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool m = (bits >> (4 * j + t)) & 1u;
        const unsigned ball = __ballot_sync(kFull, m);
        if (lane == 0) cn[t * kTypeEntries + j * kWarps + warp] = __popc(ball);
        const int pre = __popc(ball & lt);
        if (m) wl[nl + pre] = (j << 12) | (t << 10) | (lane << 5) | pre;
        nl += __popc(ball);
      }
    __syncthreads();
    // exclusive scan of each type's counts in sample order (sub-major,
    // then warp): a warp scan, then the warp totals within each type
    const int x = cn[tid];
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // warps 8t..8t+7 hold type t
      const int w = wsum[lane];
      int s = w;
#pragma unroll
      for (int d = 1; d < 8; d <<= 1) {
        const int u = __shfl_up_sync(kFull, s, d);
        if ((lane & 7) >= d) s += u;
      }
      wpre[lane] = s - w;
      if ((lane & 7) == 7) ttot[lane >> 3] = s;
    }
    __syncthreads();
    cn[tid] = incl - x + wpre[warp];
    __syncthreads();
    // the warp's events, all lanes busy: rank, position, store
    for (int q = lane; q < nl; q += 32) {
      const int e = wl[q];
      const int j = e >> 12, t = (e >> 10) & 3, src = (e >> 5) & 31;
      const int i = c0 + j * kThreads + warp * 32 + src;
      const int bt = t == 0 ? base[0] : t == 1 ? base[1]
                   : t == 2 ? base[2] : base[3];
      const int rank = bt + cn[t * kTypeEntries + j * kWarps + warp] +
                       (e & 31);
      float* evt = ev + (size_t)t * e_max;
      if (rank < e_max - 1) {
        evt[rank] = fine_of(f, t, i);
      } else if (rank == bt + ttot[t] - 1) {
        evt[e_max - 1] = fine_of(f, t, i);  // clamped: the last wins
      }
    }
    __syncwarp();  // the list is rewritten by the next chunk
#pragma unroll
    for (int t = 0; t < 4; ++t) base[t] += ttot[t];
    // cnt alternates by parity and ttot/wsum/wpre are rewritten only after
    // the next chunk's first barrier, so no barrier is needed here
  }
  __syncthreads();  // event stores visible to the whole block

  bool usable = true;
#pragma unroll
  for (int t = 0; t < 4; ++t) usable = usable && (base[t] - 1 > 2);
  const float bnd = bounds[band];
  const float upper = bnd * 1.1f;
  const float lower = bnd * 0.9f;

  // a run of consecutive frames per thread: per type one search for its
  // first frame, then a merge; the four types' walks run side by side so
  // the candidate sums in order t = 0..3, as the twin adds
  const int per = (F + kThreads - 1) / kThreads;
  const int f_begin = tid * per;
  const int f_end = min(F, f_begin + per);
  if (f_begin >= f_end) return;
  const float grid_per_fs = grid_hz / fs_a;
  int lo[4], hi[4], top[4], seg_c[4];
  float x0[4], x1[4], y0[4], y1[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const TypeView v{ev + (size_t)t * e_max, base[t], e_max, fs_a};
    const int n_int = v.count - 1;
    hi[t] = n_int < e_max ? n_int : e_max;
    if (hi[t] < 0) hi[t] = 0;
    top[t] = n_int - 1 > 1 ? n_int - 1 : 1;
    // lo = #{k < hi : ceil(location(k) * grid_hz) <= frame}
    lo[t] = frames_search(v, hi[t], (float)f_begin, grid_hz, grid_per_fs);
    seg_c[t] = -2;
    x0[t] = x1[t] = y0[t] = y1[t] = 0.0f;
  }
  float* orow = out + (size_t)row * F;
  for (int fr = f_begin; fr < f_end; ++fr) {
    const float ff = (float)fr;
    const float tp = ff * tstep;
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const TypeView v{ev + (size_t)t * e_max, base[t], e_max, fs_a};
      // merge: the next locations that start by fr
      while (lo[t] < hi[t] && v.starts_by(lo[t], ff, grid_hz, grid_per_fs))
        ++lo[t];
      const int seg = lo[t] < 1 ? 1 : (lo[t] > top[t] ? top[t] : lo[t]);
      if (seg != seg_c[t]) {
        if (seg == seg_c[t] + 1) {
          x0[t] = x1[t];
          y0[t] = y1[t];
        } else {
          x0[t] = v.location(seg - 1);
          y0[t] = v.interval(seg - 1);
        }
        x1[t] = v.location(seg);
        y1[t] = v.interval(seg);
        seg_c[t] = seg;
      }
      sum += y0[t] + (tp - x0[t]) / (x1[t] - x0[t]) * (y1[t] - y0[t]);
    }
    const float cand = sum / 4.0f;
    const bool ok = (cand <= upper) && (cand >= lower) && (cand <= f0_ceil) &&
                    (cand >= f0_floor);
    orow[fr] = (usable && ok) ? cand : 0.0f;
  }
}

// The dynamic shared memory each layout's kernel is allowed, per device
// (0: not set yet): raised on the first call and again only when a
// geometry needs more, so a call does no other host query than
// cudaGetDevice.
constexpr int kMaxDevices = 64;
int g_smem_allowed[2][kMaxDevices];

}  // namespace

// shared_events != 0: the events of a row in shared memory (4 * e_max
// floats, which the wrapper has checked fit); else in ev [rows, 4, e_max].
extern "C" int wt_zc(const float* filt, const float* bounds, float* ev,
                     float* out, int n_rows, int nb, int L, int F, int e_max,
                     float fs_a, float grid_hz, float tstep, float f0_floor,
                     float f0_ceil, int shared_events, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lists = kWarps * kListCap * (int)sizeof(int);
  const int smem = lists + (shared_events ? 4 * e_max * (int)sizeof(float)
                                          : 0);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int once = 0;
  int& allowed =
      dev < kMaxDevices ? g_smem_allowed[shared_events ? 1 : 0][dev] : once;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(
        shared_events ? zc_kernel<true> : zc_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  if (shared_events)
    zc_kernel<true><<<n_rows, kThreads, smem, st>>>(
        filt, bounds, ev, out, nb, L, F, e_max, fs_a, grid_hz, tstep,
        f0_floor, f0_ceil);
  else
    zc_kernel<false><<<n_rows, kThreads, smem, st>>>(
        filt, bounds, ev, out, nb, L, F, e_max, fs_a, grid_hz, tstep,
        f0_floor, f0_ceil);
  return static_cast<int>(cudaGetLastError());
}
