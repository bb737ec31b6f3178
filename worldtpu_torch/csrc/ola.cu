// Overlap-add of pulse impulse responses (synthesis).
//
// Replaces the Pallas TPU kernel worldtpu/ops/ola_kernel.py::_ola_kernel,
// which keeps one utterance's output resident in VMEM and adds each pulse's
// response at its start offset sequentially.
//
//   out[b, t] = sum_{p < n_b} resp[b, p, t - starts[b, p]]
//               over 0 <= t - starts[b, p] < fft
//
// with n_b = n_pulses[b] (the real pulses; all P when n_pulses is null).
// Starts are non-decreasing along p (pulses in time order; the time base
// pads each utterance with zero-response pulses at one start near the end).
//
// What bounds it on the H100: reading the real pulses' responses (n_b * fft
// floats per utterance, 71.7 MB at chip_smoke's batch), each sample read by
// exactly one output sample: a streaming pass, 21 us at 3.35 TB/s.  The
// design, block by block (one block per utterance and 512-sample tile):
//   - the pulse count cuts the padded tail: without it the three tiles at
//     the padding's start each walked ~1,900 zero responses, and they set
//     the whole launch's time;
//   - the tile's pulse range [p0, p1) comes from two warp-parallel searches
//     (warp 0 and warp 1 at once; each round a lane tests one of 32 evenly
//     spaced pulses and a ballot keeps the bucket: 3 rounds for 4,096
//     pulses in place of one thread's 12-step binary search);
//   - the range's starts are staged in shared memory, 256 at a time;
//   - each thread owns two output samples (t and t + 256, coalesced across
//     the warp) and loads four pulses x two samples before it adds them, so
//     eight independent response loads are in flight per thread; loads are
//     4-byte (a response starts at any offset, so 16-byte alignment is not
//     given).
// No atomics: each output is summed in pulse order (an out-of-range pulse
// adds a predicated 0.0f, which leaves any sum unchanged), so the result is
// deterministic and equal to the former one-sample-per-thread design's.
//
// The kernel is a template on the sample type.  wt_ola is the float
// instantiation; wt_ola_f64 the double one, for the float64 parity path:
// its sums must come in pulse order, as the reference's sequential loop adds
// them, which an index_add_ with atomics does not give.  Its bytes double.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;                   // output samples per thread
constexpr int kTile = kThreads * kPer;    // output samples per block
constexpr int kChunk = kThreads;          // starts staged per pass
constexpr int kUnroll = 4;                // pulses loaded before adding
constexpr unsigned kFull = 0xffffffffu;

// First index p in [0, n) with a[p] >= v (a non-decreasing), by the whole
// warp: each round lane i tests a[lo + i * step] and the ballot's count
// keeps one bucket of length < step.  The invariant: a[p] < v for p < lo,
// a[p] >= v for hi <= p < n.
__device__ int warp_lower_bound(const int* a, int n, int v, int lane) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int q = lo + lane * step;
    const unsigned below = __ballot_sync(kFull, q < hi && a[q] < v);
    const int c = __popc(below);
    if (c == 0) break;
    const int nlo = lo + (c - 1) * step + 1;
    hi = min(lo + c * step, hi);
    lo = nlo;
  }
  return lo;
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
ola_kernel(const R* __restrict__ resp, const int* __restrict__ starts,
           const long long* __restrict__ n_pulses, R* __restrict__ out,
           int P, int fft, int T) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int* st = starts + (size_t)b * P;
  int n = P;
  if (n_pulses != nullptr) {
    const long long nb = n_pulses[b];
    n = nb < 0 ? 0 : (nb > P ? P : static_cast<int>(nb));
  }
  __shared__ int range[2];
  __shared__ int sst[kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {
    // pulses with start in (t0 - fft, t0 + kTile) touch this tile
    const int r = warp_lower_bound(st, n, warp == 0 ? t0 - fft + 1
                                                    : t0 + kTile, lane);
    if (lane == 0) range[warp] = r;
  }
  __syncthreads();
  const int p0 = range[0], p1 = range[1];

  int t[kPer];
  bool inside[kPer];
  R acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    t[k] = t0 + threadIdx.x + k * kThreads;
    inside[k] = t[k] < T;
    acc[k] = R(0);
  }
  const R* rb = resp + (size_t)b * P * fft;
  for (int base = p0; base < p1; base += kChunk) {
    const int cnt = min(kChunk, p1 - base);
    if (threadIdx.x < cnt) sst[threadIdx.x] = st[base + threadIdx.x];
    __syncthreads();
    const R* rp = rb + (size_t)base * fft;
    int i = 0;
    for (; i + kUnroll <= cnt; i += kUnroll) {
      R v[kUnroll][kPer];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = sst[i + u];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int j = t[k] - s;
          v[u][k] = (inside[k] && j >= 0 && j < fft)
                        ? __ldg(rp + (size_t)(i + u) * fft + j)
                        : R(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kPer; ++k) acc[k] += v[u][k];
    }
    for (; i < cnt; ++i) {
      const int s = sst[i];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = t[k] - s;
        if (inside[k] && j >= 0 && j < fft)
          acc[k] += __ldg(rp + (size_t)i * fft + j);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (inside[k]) out[(size_t)b * T + t[k]] = acc[k];
}

template <typename R>
int launch_ola(const R* resp, const int* starts, const long long* n_pulses,
               R* out, int B, int P, int fft, int T, void* stream) {
  dim3 grid((T + kTile - 1) / kTile, B);
  ola_kernel<R><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      resp, starts, n_pulses, out, P, fft, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wt_ola(const float* resp, const int* starts,
                      const long long* n_pulses, float* out, int B, int P,
                      int fft, int T, void* stream) {
  return launch_ola<float>(resp, starts, n_pulses, out, B, P, fft, T, stream);
}

extern "C" int wt_ola_f64(const double* resp, const int* starts,
                          const long long* n_pulses, double* out, int B,
                          int P, int fft, int T, void* stream) {
  return launch_ola<double>(resp, starts, n_pulses, out, B, P, fft, T,
                            stream);
}
