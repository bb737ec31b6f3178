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
//     equals the value (for a miss, the zero-candidate slots), 0 if none,
//     NaN if one of them is NaN;
//   - a miss adds to the miss count, an accept resets it and becomes the
//     new reference and the last accepted frame; the walk stops once the
//     count reaches miss_lim (checked after the update).
//
// What bounds it on the H100: not bytes (a walk reads two rows of S floats
// a step) but the chain of dependent steps of the longest walk, since each
// step's reference F0 is the last step's pick.  The kernel's time is that
// walk's steps times the latency of one step, so the design shortens the
// step:
//   - the rows a walk visits do not depend on the data, so each warp keeps
//     a ring of kRing rows (candidates and scores) in shared memory, filled
//     by cp.async kRing - 1 steps ahead: a step waits for no global load,
//     and the copies are issued while its first reduction is in flight;
//   - one division a step, not one per slot: the error RN(d / ref) of
//     d = |ref - cand| does not decrease with d (ref > 0), so the least
//     error is m = RN(dmin / ref), dmin the least d; dmin is one redux.sync
//     min over the d's bit patterns (non-negative floats order as unsigned
//     ints, and a NaN d, which makes the step a miss through one vote, as
//     the largest).  A slot ties with the least error if its d equals
//     dmin, or if d - dmin <= ref * ulp(m) (a superset of the ties: they
//     lie in one rounding interval of m) and its own RN(d / ref) equals m.
//     That second kind needs m of about 1 or more; only a lane with a slot
//     that near takes those divisions.  The LAST tied slot comes from one
//     ballot per 32-slot chunk and a clz;
//   - the score max is one redux.sync max over an order-preserving int key
//     of the scores (a NaN score maps to INT_MAX, no match to INT_MIN);
//   - a step is one warp's chain of dependent instructions, so it has as
//     few as the work allows: each lane works out where its slots are
//     copied from and to once, the ring's rows are padded to whole 32-slot
//     chunks, and a lane's fixed mask of its real slots replaces the
//     guards around each slot's work (no branch per slot).
// One warp per block, so the B x W walks spread over all SMs.  What is left
// of a step is the issue of one warp's instructions in order: the 2 x NC
// copies and their addresses, the division, the ballots and the two
// reductions (chip_smoke.py prints the device time per step of the
// longest walk).

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRing = 4;          // ring slots: the current row, 3 ahead
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf; NaN bits lie above

// copy 4 bytes from global src to the shared-window address dst
__device__ __forceinline__ void copy4_async(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// an int that orders like the float (for non-NaN values)
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float from_order_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

template <int NC>
__global__ void __launch_bounds__(32)
extend_kernel(const float* __restrict__ cand, const float* __restrict__ score,
              const long long* __restrict__ origin,
              const long long* __restrict__ shift,
              const bool* __restrict__ live,
              const long long* __restrict__ distance,
              const float* __restrict__ tmp0, float* __restrict__ vals,
              float* __restrict__ scs, long long* __restrict__ n_on,
              long long* __restrict__ so, int W, int F, int S, int E,
              int miss_lim, float allowed_range) {
  constexpr int SP = 32 * NC;       // a ring row's slots, padded
  extern __shared__ float ring[];   // kRing x (SP candidates, SP scores)
  const int walk = blockIdx.x;
  const int lane = threadIdx.x;
  const int b = walk / W;
  const float* cb = cand + (size_t)b * F * S;
  const float* sb = score + (size_t)b * F * S;
  float* vrow = vals + (size_t)walk * E;
  float* srow = scs + (size_t)walk * E;

  const long long org = origin[walk];
  const long long sh = shift[walk];
  const long long dist = distance[walk];
  const int n_max = !live[walk] || dist < 0
                        ? 0
                        : static_cast<int>(dist + 1 < E ? dist + 1 : E);

  // each lane's slots, where it copies them from and to: a pad (a slot
  // at or past S) copies slot S - 1 and is masked out of every use
  bool real[NC];
  const float* c_src[NC];
  const float* s_src[NC];
  unsigned dst[NC];
  const unsigned ring_base =
      static_cast<unsigned>(__cvta_generic_to_shared(ring));
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int s = lane + 32 * k;
    real[k] = s < S;
    c_src[k] = cb + min(s, S - 1);
    s_src[k] = sb + min(s, S - 1);
    dst[k] = ring_base + 4 * s;
  }
  // copy the row of step i into ring slot i % kRing; one group per step
  auto fetch = [&](int i) {
    if (i < n_max) {
      const long long j = org + sh * (i + 1);
      const size_t row = (size_t)(j < 0 ? 0 : (j > F - 1 ? F - 1 : j)) * S;
      const unsigned slot = (i % kRing) * 2 * SP * 4;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        copy4_async(dst[k] + slot, c_src[k] + row);
        copy4_async(dst[k] + slot + SP * 4, s_src[k] + row);
      }
    }
    commit_async();
  };
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) fetch(i);

  float tmp = tmp0[walk];
  long long last = org;
  int cnt = 0;
  int n = 0;
  while (n < n_max) {
    wait_async<kRing - 2>();     // the row of step n has landed
    __syncwarp();                // ... and every lane's part is visible
    const float* cr = ring + (n % kRing) * 2 * SP;
    const float* sr = cr + SP;
    const float ref = tmp > 0.0f ? tmp : 1.0f;

    float c[NC], d[NC], sco[NC];
    unsigned key[NC];
    unsigned lane_min = 0xffffffffu;
    bool nan_seen = false;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      c[k] = cr[lane + 32 * k];
      sco[k] = sr[lane + 32 * k];
      d[k] = fabsf(ref - c[k]);
      key[k] = __float_as_uint(d[k]);
      nan_seen |= real[k] && key[k] > kInfBits;
      lane_min = min(lane_min, real[k] ? key[k] : 0xffffffffu);
    }
    const unsigned kmin = __reduce_min_sync(kFull, lane_min);
    const bool any_nan = __any_sync(kFull, nan_seen);
    // refill the last step's slot, which every lane is done with, while
    // the reductions are in flight
    fetch(n + kRing - 1);
    const float dmin = __uint_as_float(kmin);
    const float m = dmin / ref;            // the least error
    float val = 0.0f;
    if (!any_nan && m <= allowed_range) {
      const float slack =
          m < INFINITY ? ref * (__int_as_float(__float_as_int(m) + 1) - m)
                       : INFINITY;
      bool tie[NC], near = false;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        tie[k] = real[k] && key[k] == kmin;
        near |= real[k] && key[k] != kmin && d[k] - dmin <= slack;
      }
      if (near) {                          // rare: see the note above
#pragma unroll
        for (int k = 0; k < NC; ++k)
          tie[k] |= real[k] && d[k] - dmin <= slack && d[k] / ref == m;
      }
      unsigned hit[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) hit[k] = __ballot_sync(kFull, tie[k]);
      int best = 0;
#pragma unroll
      for (int k = 0; k < NC; ++k)
        if (hit[k]) best = 32 * k + 31 - __clz(hit[k]);
      val = cr[best];
    }

    int skey = INT_MIN;           // no slot equal to val
#pragma unroll
    for (int k = 0; k < NC; ++k)
      skey = max(skey, !real[k] || c[k] != val ? INT_MIN
                       : sco[k] != sco[k]      ? INT_MAX
                                               : order_key(sco[k]));
    skey = __reduce_max_sync(kFull, skey);
    const float sc = skey == INT_MIN ? 0.0f
                     : skey == INT_MAX ? NAN
                                       : from_order_key(skey);

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
      last = org + sh * n;
    }
    if (cnt == miss_lim) break;
  }
  wait_async<0>();               // no copy may land after the block exits
  for (int t = n + lane; t < E; t += 32) {
    vrow[t] = 0.0f;
    srow[t] = 0.0f;
  }
  if (lane == 0) {
    n_on[walk] = n;
    so[walk] = last;
  }
}

template <int NC>
int launch(const float* cand, const float* score, const long long* origin,
           const long long* shift, const bool* live,
           const long long* distance, const float* tmp0, float* vals,
           float* scs, long long* n_on, long long* so, int walks, int W,
           int F, int S, int E, int miss_lim, float allowed_range,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRing * 2 * 32 * NC;
  extend_kernel<NC><<<walks, 32, smem, stream>>>(
      cand, score, origin, shift, live, distance, tmp0, vals, scs, n_on, so,
      W, F, S, E, miss_lim, allowed_range);
  return static_cast<int>(cudaGetLastError());
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WT_EXTEND_CASE(NC)                                                  \
  case NC:                                                                  \
    return launch<NC>(cand, score, origin, shift, live, distance, tmp0,     \
                      vals, scs, n_on, so, walks, W, F, S, E, miss_lim,     \
                      allowed_range, st);
  switch ((S + 31) / 32) {       // 32-slot chunks; S <= 256
    WT_EXTEND_CASE(1)
    WT_EXTEND_CASE(2)
    WT_EXTEND_CASE(3)
    WT_EXTEND_CASE(4)
    WT_EXTEND_CASE(5)
    WT_EXTEND_CASE(6)
    WT_EXTEND_CASE(7)
    WT_EXTEND_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WT_EXTEND_CASE
}
