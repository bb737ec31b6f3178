// Strictly sequential cumulative sum of float64 rows (the float64 parity
// path).
//
// No TPU kernel stands behind it: the JAX package's float64 path, which ran
// on the CPU, sums left to right with a lax.scan (the spectral integration
// of worldtpu/ops/filters.py::linear_smoothing) or XLA's CPU cumsum (the
// phase sum of worldtpu/synthesis/synthesis.py::_time_base), because the
// reference vocoder's loops round once per step and a reassociated sum
// moves a pulse boundary or a near-zero spectral tail.  torch.cumsum on the
// card is a parallel scan that reassociates, so the parity path on the card
// takes this kernel:
//
//   out[r, i] = out[r, i-1] + x[r, i],  out[r, 0] = x[r, 0]
//
// one thread per row, in order.  What bounds it is the chain of dependent
// additions of the longest row (n steps of one double add each), not bytes:
// rows are independent, so frames (hundreds of rows) fill warps, while the
// synthesis time base is one long row per utterance.  A thread loads eight
// values ahead of the eight additions that consume them, so the chain
// waits for the adder and not for memory.  A parity path pays the chain;
// the float32 main path never calls it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kAhead = 8;  // values loaded before they are added

__global__ void __launch_bounds__(kThreads)
    seq_cumsum_kernel(const double* __restrict__ x, double* __restrict__ out,
                      int n_rows, int n) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  const double* xr = x + (size_t)r * n;
  double* o = out + (size_t)r * n;
  double acc = xr[0];
  o[0] = acc;
  int i = 1;
  for (; i + kAhead <= n; i += kAhead) {
    double v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) v[u] = xr[i + u];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      acc = __dadd_rn(acc, v[u]);  // never contracted, never reassociated
      o[i + u] = acc;
    }
  }
  for (; i < n; ++i) {
    acc = __dadd_rn(acc, xr[i]);
    o[i] = acc;
  }
}

}  // namespace

extern "C" int wt_seq_cumsum_f64(const double* x, double* out, int n_rows,
                                 int n, void* stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  seq_cumsum_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, out, n_rows, n);
  return static_cast<int>(cudaGetLastError());
}
