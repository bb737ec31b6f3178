// The extendF0 walk of the Harvest contour chain (reference extendF0 /
// selectBestF0, src/harvest.cpp:347-403).
//
// Replaces the Pallas TPU kernel worldtpu/ops/extend_kernel.py::_walk_kernel
// and follows the port's plain version (ops/extend_kernel.py::
// extend_walk_plain) over the S real candidate slots:
//   - step i of a walk visits frame j = origin + shift * (i + 1) and runs
//     while live, i <= distance and not stopped;
//   - ref = tmp > 0 ? tmp : 1; err_s = |ref - cand_s| / ref (a true
//     division); the pick is the LAST slot reaching the minimum error, kept
//     if that minimum is <= allowed_range, else the step is a miss (0); a
//     NaN error anywhere makes the minimum NaN, so the step is a miss;
//   - the step's score is the max score over the slots whose candidate
//     equals the value (for a miss, the zero-candidate slots), 0 if none;
//   - a miss adds to the miss count, an accept resets it and becomes the
//     new reference and the last accepted frame; the walk stops once the
//     count reaches miss_lim (checked after the update).
//
// One warp per (utterance, walk), lanes across the slots, so each step
// reads one candidate row and one score row coalesced; the argmin with its
// tie-break and the score max are warp-shuffle reductions.  A walk is a
// chain of dependent steps (the reference F0 carries), so the kernel is
// bound by the latency of one row read plus the reductions per step, not by
// bandwidth; each warp exits as soon as its walk stops, where the plain
// version runs every walk for all ext_lim + 1 steps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// max that propagates NaN, as torch.amax does
__device__ float nan_max(float a, float b) {
  if (a != a || b != b) return NAN;
  return fmaxf(a, b);
}

__global__ void extend_kernel(const float* __restrict__ cand,
                              const float* __restrict__ score,
                              const long long* __restrict__ origin,
                              const long long* __restrict__ shift,
                              const bool* __restrict__ live,
                              const long long* __restrict__ distance,
                              const float* __restrict__ tmp0,
                              float* __restrict__ vals,
                              float* __restrict__ scs,
                              long long* __restrict__ n_on,
                              long long* __restrict__ so, int B, int W, int F,
                              int S, int E, int miss_lim,
                              float allowed_range) {
  const int walk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (walk >= B * W) return;  // whole warps only
  const int b = walk / W;
  const float* cb = cand + (size_t)b * F * S;
  const float* sb = score + (size_t)b * F * S;
  float* vrow = vals + (size_t)walk * E;
  float* srow = scs + (size_t)walk * E;

  const long long org = origin[walk];
  const long long sh = shift[walk];
  const long long dist = distance[walk];
  const bool lv = live[walk];
  float tmp = tmp0[walk];
  long long last = org;
  int cnt = 0;
  int n = 0;
  while (n < E && lv && n <= dist) {
    const long long j = org + sh * (n + 1);
    const long long jc = j < 0 ? 0 : (j > F - 1 ? F - 1 : j);
    const float* cr = cb + jc * S;
    const float* sr = sb + jc * S;
    const float ref = tmp > 0.0f ? tmp : 1.0f;

    // per lane: smallest error, latest slot on ties
    float best_err = INFINITY;
    int best_idx = -1;
    float best_val = 0.0f;
    bool nan_seen = false;
    for (int s = lane; s < S; s += 32) {
      const float c = cr[s];
      const float e = fabsf(ref - c) / ref;
      if (e != e) {
        nan_seen = true;
      } else if (e <= best_err) {
        best_err = e;
        best_idx = s;
        best_val = c;
      }
    }
    for (int d = 16; d > 0; d >>= 1) {
      const float oe = __shfl_xor_sync(kFull, best_err, d);
      const int oi = __shfl_xor_sync(kFull, best_idx, d);
      const float ov = __shfl_xor_sync(kFull, best_val, d);
      if (oe < best_err || (oe == best_err && oi > best_idx)) {
        best_err = oe;
        best_idx = oi;
        best_val = ov;
      }
    }
    const bool any_nan = __any_sync(kFull, nan_seen);
    const float val =
        (!any_nan && best_idx >= 0 && best_err <= allowed_range) ? best_val
                                                                 : 0.0f;

    float smax = -INFINITY;
    bool has = false;
    for (int s = lane; s < S; s += 32) {
      if (cr[s] == val) {
        has = true;
        smax = nan_max(smax, sr[s]);
      }
    }
    for (int d = 16; d > 0; d >>= 1)
      smax = nan_max(smax, __shfl_xor_sync(kFull, smax, d));
    const float sc = __any_sync(kFull, has) ? smax : 0.0f;

    if (lane == 0) {
      vrow[n] = val;
      srow[n] = sc;
    }
    ++n;
    if (val == 0.0f) {
      ++cnt;
    } else {
      cnt = 0;
      tmp = val;
      last = j;
    }
    if (cnt == miss_lim) break;
  }
  for (int t = n + lane; t < E; t += 32) {
    vrow[t] = 0.0f;
    srow[t] = 0.0f;
  }
  if (lane == 0) {
    n_on[walk] = n;
    so[walk] = last;
  }
}

}  // namespace

extern "C" int wt_extend(const float* cand, const float* score,
                         const long long* origin, const long long* shift,
                         const bool* live, const long long* distance,
                         const float* tmp0, float* vals, float* scs,
                         long long* n_on, long long* so, int B, int W, int F,
                         int S, int E, int miss_lim, float allowed_range,
                         void* stream) {
  const int walks = B * W;
  const int blocks = (walks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  extend_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      cand, score, origin, shift, live, distance, tmp0, vals, scs, n_on, so,
      B, W, F, S, E, miss_lim, allowed_range);
  return static_cast<int>(cudaGetLastError());
}
