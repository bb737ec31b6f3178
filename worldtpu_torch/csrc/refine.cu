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
// The phase is reduced exactly in integers and the twiddles are read from
// a table of cos/sin(2*pi*k/N) (exact for every reduced phase), instead of
// the TPU's rotation chains and polynomial sincos; the window angle uses
// sincosf once per sample and the +-1-sample neighbours by rotation.
//
// Compaction, dedup, the segment gather and the instantaneous-frequency
// finishing math stay in torch (worldtpu_torch/ops/refine_kernel.py).
// Layout: one block per frame, one warp per active candidate (strided);
// lanes stride over the window samples and keep 24 accumulators, reduced
// with shuffles.  On the H100 the kernel is bound by instruction issue
// (one sincosf and ~60 FMAs/loads per window sample and candidate); the
// segment and the 16 KB twiddle table stay in L1.
// Output [frames, cap, 24]: index c*6 + h for c in (main re, main im,
// diff re, diff im); slots at or beyond n_active are zero.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float blackman(float c) {
  return 0.42f + 0.5f * c + 0.08f * (2.0f * c * c - 1.0f);
}

__global__ void refine_kernel(const float* __restrict__ seg,
                              const float* __restrict__ delta,
                              const int* __restrict__ hw_all,
                              const int* __restrict__ gbin_all,
                              const int* __restrict__ n_active,
                              const float* __restrict__ twiddle,
                              float* __restrict__ out, int cap, int wseg,
                              int hwmax, int n_fft) {
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* s = seg + (size_t)n * wseg;
  const float dl = delta[n];
  const int na = n_active[n];
  const float* tw_cos = twiddle;
  const float* tw_sin = twiddle + n_fft;

  for (int p = warp; p < cap; p += kWarps) {
    float* o = out + ((size_t)n * cap + p) * 24;
    if (p >= na) {
      if (lane < 24) o[lane] = 0.0f;
      continue;
    }
    // a candidate never exceeds the worst-case window; the clamp only
    // keeps a malformed input inside the segment row
    const int hw = min(hw_all[(size_t)n * cap + p], hwmax);
    int g[6];
    for (int h = 0; h < 6; ++h) g[h] = gbin_all[((size_t)n * cap + p) * 6 + h];
    const float wlf = (float)(2 * hw + 1);
    const float d1 = kTwoPi / wlf;
    const float cd1 = cosf(d1), sd1 = sinf(d1);
    float acc[24];
    for (int k = 0; k < 24; ++k) acc[k] = 0.0f;
    for (int m = hwmax - hw + lane; m <= hwmax + hw; m += 32) {
      const float t2 = kTwoPi * ((float)m + dl) / wlf;
      float sw, cw;
      sincosf(t2, &sw, &cw);
      const float cp = cw * cd1 - sw * sd1;  // window angle at m + 1
      const float cm = cw * cd1 + sw * sd1;  // window angle at m - 1
      const int dmm = m - hwmax;
      const float wp = abs(dmm + 1) <= hw ? blackman(cp) : 0.0f;
      const float wm = abs(dmm - 1) <= hw ? blackman(cm) : 0.0f;
      const float x = s[m];
      const float mainv = x * blackman(cw);
      const float diffv = x * (-(wp - wm) * 0.5f);
      for (int h = 0; h < 6; ++h) {
        const int k = (int)(((long long)g[h] * m) % n_fft);
        const float c = __ldg(tw_cos + k), sn = __ldg(tw_sin + k);
        acc[4 * h + 0] += mainv * c;
        acc[4 * h + 1] += mainv * sn;
        acc[4 * h + 2] += diffv * c;
        acc[4 * h + 3] += diffv * sn;
      }
    }
    for (int k = 0; k < 24; ++k) {
      float v = acc[k];
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      acc[k] = v;
    }
    if (lane == 0) {
      for (int h = 0; h < 6; ++h) {
        o[0 * 6 + h] = acc[4 * h + 0];
        o[1 * 6 + h] = -acc[4 * h + 1];
        o[2 * 6 + h] = acc[4 * h + 2];
        o[3 * 6 + h] = -acc[4 * h + 3];
      }
    }
  }
}

}  // namespace

extern "C" int wt_refine_sums(const float* seg, const float* delta,
                              const int* hw, const int* gbin,
                              const int* n_active, const float* twiddle,
                              float* out, int n_frames, int cap, int wseg,
                              int hwmax, int n_fft, void* stream) {
  refine_kernel<<<n_frames, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seg, delta, hw, gbin, n_active, twiddle, out, cap, wseg, hwmax, n_fft);
  return static_cast<int>(cudaGetLastError());
}
