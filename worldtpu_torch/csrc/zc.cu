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
//     event wins the clamped slot);
//   - locations are midpoints of consecutive events, intervals fs_a over
//     their spacing; frame f takes the segment counted by
//     #{k < n_int : clip(ceil(loc_k * grid_hz), 0, F) <= f}, clipped to
//     [1, max(n_int-1, 1)], and the interpolation formula of the twin;
//   - the candidate is the mean of the four types, kept when every type
//     has more than 3 events and it lies inside [0.9b, 1.1b] and
//     [f0_floor, f0_ceil].
//
// One block per (utterance, band) loops over the four types.  Events are
// ranked with a block-wide prefix sum (warp ballot + popc, then a scan of
// the warp totals) over 512-sample chunks, so they land sorted in a global
// scratch [rows, 4, e_max].  Then threads over frames binary-search each
// type's sorted locations.  On the H100 the kernel is bound by reading the
// band signals (4 passes over B*nb*L floats, mostly from L2) and by the
// dependent loads of the binary searches; the scratch (175 MB at config-5
// shapes) is written once and read from L2/L1.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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
};

__global__ void zc_kernel(const float* __restrict__ filt,
                          const float* __restrict__ bounds,
                          float* __restrict__ ev_all, float* __restrict__ out,
                          int nb, int L, int F, int e_max, float fs_a,
                          float grid_hz, float tstep, float f0_floor,
                          float f0_ceil) {
  const int row = blockIdx.x;
  const int band = row % nb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* f = filt + (size_t)row * L;
  float* ev = ev_all + (size_t)row * 4 * e_max;

  __shared__ int warp_tot[kWarps];
  __shared__ int warp_off[kWarps];
  __shared__ int chunk_total;
  __shared__ int counts[4];

  for (int t = 0; t < 4; ++t) {
    const int n_eff = t < 2 ? L : L - 1;
    const float sgn = (t & 1) ? -1.0f : 1.0f;
    float* evt = ev + (size_t)t * e_max;
    int base = 0;
    for (int i0 = 0; i0 < L - 1; i0 += kThreads) {
      const int i = i0 + tid;
      bool m = false;
      float fine = 0.0f;
      if (i < L - 1 && i < n_eff - 1) {
        float s0, s1;
        if (t < 2) {
          s0 = sgn * f[i];
          s1 = sgn * f[i + 1];
        } else {  // i + 2 <= L - 1 here (i < n_eff - 1 = L - 2)
          s0 = sgn * (f[i + 1] - f[i]);
          s1 = sgn * (f[i + 2] - f[i + 1]);
        }
        m = (s0 > 0.0f) && (s1 <= 0.0f);
        fine = (float)(i + 1) - s0 / (s1 - s0);
      }
      const unsigned ball = __ballot_sync(0xffffffffu, m);
      const int pre = __popc(ball & ((1u << lane) - 1u));
      if (lane == 0) warp_tot[warp] = __popc(ball);
      __syncthreads();
      if (warp == 0) {
        int v = lane < kWarps ? warp_tot[lane] : 0;
        int incl = v;
        for (int d = 1; d < 32; d <<= 1) {
          int u = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += u;
        }
        if (lane < kWarps) warp_off[lane] = incl - v;
        if (lane == 31) chunk_total = incl;
      }
      __syncthreads();
      const int total = chunk_total;
      if (m) {
        const int rank = base + warp_off[warp] + pre;
        if (rank < e_max - 1) {
          evt[rank] = fine;
        } else if (rank == base + total - 1) {
          evt[e_max - 1] = fine;  // clamped slot: the last event wins
        }
      }
      base += total;
    }
    if (tid == 0) counts[t] = base;
  }
  __syncthreads();  // event stores and counts visible to the whole block

  TypeView tv[4];
  for (int t = 0; t < 4; ++t)
    tv[t] = TypeView{ev + (size_t)t * e_max, counts[t], e_max, fs_a};
  bool usable = true;
  for (int t = 0; t < 4; ++t) usable = usable && (counts[t] - 1 > 2);
  const float b = bounds[band];
  const float upper = b * 1.1f;
  const float lower = b * 0.9f;

  for (int fr = tid; fr < F; fr += kThreads) {
    const float tp = (float)fr * tstep;
    const float ff = (float)fr;
    float sum = 0.0f;
    for (int t = 0; t < 4; ++t) {
      const TypeView& v = tv[t];
      const int n_int = v.count - 1;
      int hi = n_int < e_max ? n_int : e_max;
      int lo = 0;
      if (hi < 0) hi = 0;
      while (lo < hi) {  // #locations whose first frame is <= fr
        int mid = (lo + hi) >> 1;
        if (ceilf(v.location(mid) * grid_hz) <= ff) lo = mid + 1;
        else hi = mid;
      }
      int top = n_int - 1 > 1 ? n_int - 1 : 1;
      int seg = lo < 1 ? 1 : (lo > top ? top : lo);
      float x0 = v.location(seg - 1), x1 = v.location(seg);
      float y0 = v.interval(seg - 1), y1 = v.interval(seg);
      sum += y0 + (tp - x0) / (x1 - x0) * (y1 - y0);
    }
    const float cand = sum / 4.0f;
    const bool ok = (cand <= upper) && (cand >= lower) && (cand <= f0_ceil) &&
                    (cand >= f0_floor);
    out[(size_t)row * F + fr] = (usable && ok) ? cand : 0.0f;
  }
}

}  // namespace

extern "C" int wt_zc(const float* filt, const float* bounds, float* ev,
                     float* out, int n_rows, int nb, int L, int F, int e_max,
                     float fs_a, float grid_hz, float tstep, float f0_floor,
                     float f0_ceil, void* stream) {
  zc_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      filt, bounds, ev, out, nb, L, F, e_max, fs_a, grid_hz, tstep, f0_floor,
      f0_ceil);
  return static_cast<int>(cudaGetLastError());
}
