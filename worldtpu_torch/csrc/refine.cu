// Harvest F0 refinement: the six-harmonic DFT sums of each candidate's
// Blackman-windowed frame segment and of its centered-difference window.
//
// Replaces the Pallas TPU kernel worldtpu/ops/refine_kernel.py::
// _refine_frame_kernel.  The math is the production branch of
// worldtpu/analysis/harvest.py::_refine_chunk: for segment sample m of a
// frame (m in [hwmax-hw, hwmax+hw] for a candidate of half window hw)
//   t2(m) = 2*pi*(m + delta) / (2*hw + 1)
//   mw(m) = 0.42 + 0.5*cos(t2) + 0.08*cos(2*t2)        (zero off-window)
//   dw(m) = -(mw(m+1) - mw(m-1)) / 2
//   S_main[h] = sum_m seg[m]*mw(m)*e^{-i a_h(m)},  a_h(m) = (2*pi/N)*((g_h*m) mod N)
//   S_diff[h] likewise with dw; g_h is the candidate's global bin of
//   harmonic h on the N-point grid.
// Compaction, dedup, the segment gather and the instantaneous-frequency
// finishing math stay in torch (worldtpu_torch/ops/refine_kernel.py).
// Output [frames, cap, 24]: index c*6 + h for c in (main re, main im,
// diff re, diff im); slots at or beyond n_active are zero.
//
// What bounds it on the H100: the bytes.  The [frames, 64, 24] output is
// written once (219 MB at chip_smoke.py's shapes, mostly zeros); of the
// inputs only what active (frame, slot) pairs touch is read: the window
// span of each frame with a pair and the pairs' half windows and bins
// (267 MB in all there): 0.080 ms at 3.35 TB/s.  The useful work, 48
// flops per window sample of each active candidate (3.2 GFLOP there), is
// 0.05 ms at 67 TFLOP/s.  This design is ~11-13x slower than that bound
// (PERF.md), far below the card's issue rate too: each warp is a chain of
// dependent steps that 24 warps per SM do not hide.  The design:
//   - the harmonic phase is reduced in int32, (g*m) & (N-1) (N a power of
//     two, g*m < 2^31, checked by the wrapper), not a 64-bit remainder;
//   - the file is built with multiply-add contraction (_build.py), so each
//     accumulation is one FFMA;
//   - the twiddle table cos/sin(2*pi*k/N) sits in shared memory as float2
//     pairs.  The bins g are multiples of N/fft_p, a power of two, so the
//     32 lanes' indices (g*m) & (N-1) at consecutive m fall on a few banks
//     (8- to 16-way conflicts: the first version of this design spent
//     ~1 ms there).  So a lane reads its twiddle exactly once every
//     kRefresh strides and in between rotates it by the step of 32
//     samples, e^{i*2*pi*((32*g) & (N-1))/N}, one broadcast read for the
//     warp; the window angle 2*pi*(m + delta)/(2*hw+1) advances the same
//     way (a division and a sincosf per kRefresh strides, not per sample);
//     the rotations' rounding stays within a few ulps;
//   - work is the flat list of active (frame, slot) pairs: each warp takes
//     a contiguous run of them, finds the frame of its first pair by one
//     binary search of the inclusive cumsum of n_active (made on the device
//     by the wrapper, no host sync), then steps forward (a search per pair,
//     16 dependent L2 loads, cost the first version ~0.5 ms); the grid is
//     the blocks the card holds at once; the inactive slots are one
//     coalesced float4 zero store, so unvoiced and padding frames cost no
//     window loop;
//   - the 24 sums are reduced across the warp by halving exchanges (lanes
//     trade half of their values each step: 16+8+4+2+1 = 31 shuffles, not
//     24*5 = 120), leaving sum l in lane l, so 24 lanes store the pair's
//     row at once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRefresh = 8;  // lane strides between exact twiddle reads
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float blackman(float c) {
  return 0.42f + 0.5f * c + 0.08f * (2.0f * c * c - 1.0f);
}

// One halving step of the warp reduction of v[0..2D): a lane keeps the half
// selected by bit D of its lane id and adds the partner's copy of it.
template <int D>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool up = (lane & D) != 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float send = up ? v[k] : v[k + D];
    const float keep = up ? v[k + D] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, D);
  }
}

__global__ void __launch_bounds__(kThreads)
    refine_kernel(const float* __restrict__ seg,
                  const float* __restrict__ delta,
                  const int* __restrict__ hw_all,
                  const int* __restrict__ gbin_all,
                  const int* __restrict__ n_active,
                  const int* __restrict__ offs,
                  const float* __restrict__ twiddle,
                  float* __restrict__ out, int n_frames, int cap, int wseg,
                  int hwmax, int n_fft) {
  extern __shared__ float2 tw[];  // (cos, sin)(2*pi*k/n_fft)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int k = tid; k < n_fft; k += kThreads)
    tw[k] = make_float2(twiddle[k], twiddle[n_fft + k]);

  // zeros for the inactive slots: a warp per frame, six float4 per slot
  for (int n = blockIdx.x * kWarps + warp; n < n_frames;
       n += gridDim.x * kWarps) {
    float4* row = reinterpret_cast<float4*>(out + (size_t)n * cap * 24);
    for (int u = max(n_active[n], 0) * 6 + lane; u < cap * 6; u += 32)
      row[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();  // the twiddle table is complete

  // this warp's contiguous run of pairs [p0, p1); the frame of p0 is the
  // first n with offs[n] > p0, later pairs step forward through the frames
  const int total = offs[n_frames - 1];
  const int n_warps = gridDim.x * kWarps;
  const int per = (total + n_warps - 1) / n_warps;
  const int p0 = (blockIdx.x * kWarps + warp) * per;
  const int p1 = min(total, p0 + per);
  if (p0 >= p1) return;
  int n = 0;
  for (int hi = n_frames - 1; n < hi;) {
    const int mid = (n + hi) >> 1;
    if (offs[mid] > p0) hi = mid; else n = mid + 1;
  }
  // n_active is at most cap (refine_kernel.prepare); the clamp only keeps
  // a malformed input inside the output row
  int slot = p0 - (offs[n] - n_active[n]);
  int na = min(n_active[n], cap);
  const int mask = n_fft - 1;
  // the pair's parameters are loaded one pair ahead, while the window loop
  // of the pair before runs
  int nxt_hw = 0, nxt_g[6];
  float nxt_dl = 0.0f;
  auto fetch = [&]() {
    while (slot >= na) {  // frames with no pair left
      ++n;
      slot = 0;
      na = min(n_active[n], cap);
    }
    const size_t ps = (size_t)n * cap + slot;
    nxt_dl = delta[n];
    nxt_hw = hw_all[ps];
#pragma unroll
    for (int h = 0; h < 6; ++h) nxt_g[h] = gbin_all[ps * 6 + h];
  };
  fetch();
  for (int p = p0; p < p1; ++p) {
    const size_t ps = (size_t)n * cap + slot;
    const float* s = seg + (size_t)n * wseg;
    const float dl = nxt_dl;
    // a candidate never exceeds the worst-case window; the clamp only
    // keeps a malformed input inside the segment row
    const int hw = min(nxt_hw, hwmax);
    int g[6];
#pragma unroll
    for (int h = 0; h < 6; ++h) g[h] = nxt_g[h];
    if (p + 1 < p1) {
      ++slot;
      fetch();
    }
    const float wlf = (float)(2 * hw + 1);
    const float d1 = kTwoPi / wlf;
    float sd1, cd1, s32, c32;  // window angle steps of 1 and 32 samples
    sincosf(d1, &sd1, &cd1);
    sincosf(kTwoPi * 32.0f / wlf, &s32, &c32);
    float sw = 0.0f, cw = 1.0f;  // window angle at m
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = 0.0f;
    float zc[6], zs[6];  // this lane's twiddle of each harmonic at m
    int stride = 0;
    for (int m = hwmax - hw + lane; m <= hwmax + hw; m += 32, ++stride) {
      if ((stride & (kRefresh - 1)) == 0) {  // exact
#pragma unroll
        for (int h = 0; h < 6; ++h) {
          const float2 z = tw[(g[h] * m) & mask];
          zc[h] = z.x;
          zs[h] = z.y;
        }
        sincosf(kTwoPi * ((float)m + dl) / wlf, &sw, &cw);
      } else {  // rotate by the warp-uniform steps of 32 samples
#pragma unroll
        for (int h = 0; h < 6; ++h) {
          const float2 w = tw[(g[h] * 32) & mask];
          const float c = zc[h] * w.x - zs[h] * w.y;
          zs[h] = zs[h] * w.x + zc[h] * w.y;
          zc[h] = c;
        }
        const float c = cw * c32 - sw * s32;
        sw = sw * c32 + cw * s32;
        cw = c;
      }
      const float cp = cw * cd1 - sw * sd1;  // window angle at m + 1
      const float cm = cw * cd1 + sw * sd1;  // window angle at m - 1
      const int dmm = m - hwmax;
      const float wp = abs(dmm + 1) <= hw ? blackman(cp) : 0.0f;
      const float wm = abs(dmm - 1) <= hw ? blackman(cm) : 0.0f;
      const float x = s[m];
      const float mainv = x * blackman(cw);
      const float diffv = x * (-(wp - wm) * 0.5f);
#pragma unroll
      for (int h = 0; h < 6; ++h) {
        v[4 * h + 0] += mainv * zc[h];
        v[4 * h + 1] += mainv * zs[h];
        v[4 * h + 2] += diffv * zc[h];
        v[4 * h + 3] += diffv * zs[h];
      }
    }
    halve<16>(v, lane);
    halve<8>(v, lane);
    halve<4>(v, lane);
    halve<2>(v, lane);
    halve<1>(v, lane);
    if (lane < 24) {  // v[0] is sum `lane` = 4*h + c
      const int c = lane & 3, h = lane >> 2;
      out[ps * 24 + c * 6 + h] = (c & 1) ? -v[0] : v[0];
    }
  }
}

// The grid per device: the blocks the card holds at once for a twiddle
// table of `smem` bytes (smem 0: not worked out yet).  Worked out on the
// first call and again only when n_fft changes, so a call does no host
// queries beyond cudaGetDevice.
struct LaunchShape {
  int smem;
  int blocks;
};
constexpr int kMaxDevices = 64;
LaunchShape g_shape[kMaxDevices];

}  // namespace

extern "C" int wt_refine_sums(const float* seg, const float* delta,
                              const int* hw, const int* gbin,
                              const int* n_active, const int* offs,
                              const float* twiddle, float* out, int n_frames,
                              int cap, int wseg, int hwmax, int n_fft,
                              void* stream) {
  if (n_frames <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = n_fft * (int)sizeof(float2);
  LaunchShape once = {0, 0};
  LaunchShape& shape = dev < kMaxDevices ? g_shape[dev] : once;
  if (shape.smem != smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(refine_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, refine_kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    shape.blocks = sms * (per_sm > 0 ? per_sm : 1);
    shape.smem = smem;
  }
  refine_kernel<<<shape.blocks, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      seg, delta, hw, gbin, n_active, offs, twiddle, out, n_frames, cap, wseg,
      hwmax, n_fft);
  return static_cast<int>(cudaGetLastError());
}
