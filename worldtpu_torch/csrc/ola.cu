// Overlap-add of pulse impulse responses (synthesis).
//
// Replaces the Pallas TPU kernel worldtpu/ops/ola_kernel.py::_ola_kernel,
// which keeps one utterance's output resident in VMEM and adds each pulse's
// response at its start offset sequentially.
//
//   out[b, t] = sum_p resp[b, p, t - starts[b, p]]   over 0 <= t-start < fft
//
// On the H100 this is bound by reading the responses (B*P*fft floats,
// 134 MB at B=8, P=4096, fft=1024): each response sample is read by exactly
// one output sample, so the kernel is one streaming pass.  The design has
// no atomics and is deterministic: pulse starts are non-decreasing per
// utterance (pulses come in time order; padded pulses sit at the end with
// zero response), so a block owning an output tile finds the pulses that
// overlap it by binary search and each thread sums its sample's
// contributions in pulse order.  Consecutive threads read consecutive
// response samples, so loads coalesce.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // output samples per block (one per thread)

// first index p in [0, n) with a[p] >= v (a non-decreasing)
__device__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void ola_kernel(const float* __restrict__ resp,
                           const int* __restrict__ starts,
                           float* __restrict__ out, int P, int fft, int T) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int* st = starts + (size_t)b * P;
  __shared__ int range[2];
  if (threadIdx.x == 0) {
    // pulses with start in (t0 - fft, t0 + kTile) touch this tile
    range[0] = lower_bound(st, P, t0 - fft + 1);
    range[1] = lower_bound(st, P, t0 + kTile);
  }
  __syncthreads();
  const int t = t0 + threadIdx.x;
  if (t >= T) return;
  const float* rb = resp + (size_t)b * P * fft;
  float acc = 0.0f;
  for (int p = range[0]; p < range[1]; ++p) {
    int j = t - st[p];
    if (j >= 0 && j < fft) acc += rb[(size_t)p * fft + j];
  }
  out[(size_t)b * T + t] = acc;
}

}  // namespace

extern "C" int wt_ola(const float* resp, const int* starts, float* out,
                      int B, int P, int fft, int T, void* stream) {
  dim3 grid((T + kTile - 1) / kTile, B);
  ola_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      resp, starts, out, P, fft, T);
  return static_cast<int>(cudaGetLastError());
}
