// Harvest zero-crossing phase 1 alone: each band signal's sorted event
// positions ("fines") of the four crossing types, compacted per
// 128-sample column, and the kept events per column.
//
// Replaces the Pallas TPU kernel worldtpu/ops/zc_kernel.py::
// _zc_events_kernel (the phase-1 measurement entry of the zc stage) and
// computes what it computes, for one band group:
//   - event i of type t: s[i] > 0 && s[i+1] <= 0 && i < n_eff-1 for s in
//     (f, -f, diff f, -diff f), at (i+1) - s[i]/(s[i+1]-s[i]);
//   - column c holds samples [128c, 128c+128); it keeps its first c_row
//     events, and ccol[c] counts the kept ones;
//   - column c writes c_row slots at o_c = min(off_c, e_cap - c_row), where
//     off_c sums ccol over the columns before it: its kept events, then +inf.
//     Columns write in order, later ones over earlier ones, and the TPU
//     kernel's store loop runs over round_up(n_cols, 8) columns (the pad
//     columns have no events).  Everything never written is +inf.
// The last write to slot p comes from the last column c with o_c <= p, so
// a kept event (c, rank r) survives iff o_c + r < o_{c+1} (the next
// column's offset; none after the last store column).  Each surviving event
// owns its slot, so every slot is written once after the +inf fill and the
// result does not depend on the order of the writes.
//
// Two passes, each a block per (band row, type, span of kSpan 512-sample
// chunks of four columns), so all spans of all bands run in parallel:
//   1. count: the +inf fill of the event buffers and ccol, the events per
//      column (warp ballot + popc) capped at c_row;
//   2. write: a block sums ccol over the columns before its span, then per
//      chunk ranks its events inside their columns as pass 1 did and
//      writes the surviving ones, the offset running across its chunks.
// No serial chain runs along the whole signal (the TPU kernel's column
// loop).  On the H100 the passes are bound by instructions and barriers per
// sample, not by the bytes they move, so a block takes a span of several
// chunks (fewer, fuller blocks), the division runs for events only, and
// pass 2 takes the column prefixes once per chunk: at chip_smoke.py's
// shapes one chunk per block took 3.3 ms of device time for both passes,
// this design 1.6 ms, the whole zc kernel 1.3 ms.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCol = 128;                  // samples per column
constexpr int kColWarps = kCol / 32;       // warps per column
constexpr int kChunkCols = kThreads / kCol;
constexpr int kSpan = 8;                   // chunks per block

struct Geometry {
  int nb, lo, nb_g, L, e_cap, c_row, n_cols, n_store, n_spans;
};

// The block's (band row, type, span) and its band signal.
struct Block {
  int rt, t, span;
  const float* f;
  __device__ Block(const float* filt, const Geometry& g) {
    span = blockIdx.x % g.n_spans;
    rt = blockIdx.x / g.n_spans;  // (utterance, band of the group, type)
    t = rt & 3;
    const int row = rt >> 2;
    const int b = row / g.nb_g;
    const int band = g.lo + row % g.nb_g;
    f = filt + ((size_t)b * g.nb + band) * g.L;
  }
};

// Is sample i an event of type t, and where (as csrc/zc.cu)?
__device__ bool crossing(const float* f, int t, int i, int L, float* fine) {
  const int n_eff = t < 2 ? L : L - 1;
  if (i >= L - 1 || i >= n_eff - 1) return false;
  const float sgn = (t & 1) ? -1.0f : 1.0f;
  float s0, s1;
  if (t < 2) {
    s0 = sgn * f[i];
    s1 = sgn * f[i + 1];
  } else {  // i + 2 <= L - 1 here (i < n_eff - 1 = L - 2)
    s0 = sgn * (f[i + 1] - f[i]);
    s1 = sgn * (f[i + 2] - f[i + 1]);
  }
  const bool m = (s0 > 0.0f) && (s1 <= 0.0f);
  if (m) *fine = (float)(i + 1) - s0 / (s1 - s0);  // divide for events only
  return m;
}

__global__ void __launch_bounds__(kThreads, 4)
    count_kernel(const float* __restrict__ filt, float* __restrict__ ev,
                 int* __restrict__ ccol, Geometry g) {
  const Block blk(filt, g);
  const int tid = threadIdx.x;
  float* evt = ev + (size_t)blk.rt * g.e_cap;
  for (int k = blk.span * kThreads + tid; k < g.e_cap;
       k += g.n_spans * kThreads)
    evt[k] = INFINITY;

  __shared__ int warp_tot[kWarps];
  for (int ch = blk.span * kSpan; ch < (blk.span + 1) * kSpan; ++ch) {
    float fine = 0.0f;
    const bool m = crossing(blk.f, blk.t, ch * kThreads + tid, g.L, &fine);
    const unsigned ball = __ballot_sync(0xffffffffu, m);
    if ((tid & 31) == 0) warp_tot[tid >> 5] = __popc(ball);
    __syncthreads();
    if ((tid & (kCol - 1)) == 0) {
      const int q = tid / kCol;
      const int c = ch * kChunkCols + q;
      if (c < g.n_cols) {
        int cnt = 0;
        for (int w = q * kColWarps; w < (q + 1) * kColWarps; ++w)
          cnt += warp_tot[w];
        ccol[(size_t)blk.rt * g.n_cols + c] = cnt < g.c_row ? cnt : g.c_row;
      }
    }
    __syncthreads();  // warp_tot is rewritten by the next chunk
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    write_kernel(const float* __restrict__ filt, float* __restrict__ ev,
                 const int* __restrict__ ccol, Geometry g) {
  const Block blk(filt, g);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col_in_chunk = warp / kColWarps;
  const int* cct = ccol + (size_t)blk.rt * g.n_cols;
  float* evt = ev + (size_t)blk.rt * g.e_cap;
  const int o_max = g.e_cap - g.c_row;

  // kept events in the columns before this span
  __shared__ int part[kWarps];
  __shared__ int warp_tot[kWarps];
  __shared__ int warp_pre[kWarps];     // events in the column's earlier warps
  __shared__ int col_kept[kChunkCols];
  const int first = blk.span * kSpan * kChunkCols;
  int s = 0;
  for (int j = tid; j < first && j < g.n_cols; j += kThreads) s += cct[j];
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < kWarps; ++w) base += part[w];

  for (int ch = blk.span * kSpan; ch < (blk.span + 1) * kSpan; ++ch) {
    float fine = 0.0f;
    const bool m = crossing(blk.f, blk.t, ch * kThreads + tid, g.L, &fine);
    const unsigned ball = __ballot_sync(0xffffffffu, m);
    if (lane == 0) warp_tot[warp] = __popc(ball);
    __syncthreads();
    if (tid < kChunkCols) {  // one thread per column of the chunk
      int cnt = 0;
      for (int w = tid * kColWarps; w < (tid + 1) * kColWarps; ++w) {
        warp_pre[w] = cnt;
        cnt += warp_tot[w];
      }
      col_kept[tid] = cnt < g.c_row ? cnt : g.c_row;
    }
    __syncthreads();

    const int rank = warp_pre[warp] + __popc(ball & ((1u << lane) - 1u));
    const int kept = col_kept[col_in_chunk];
    int off = base;
    for (int q = 0; q < col_in_chunk; ++q) off += col_kept[q];
    const int c = ch * kChunkCols + col_in_chunk;
    const int o = off < o_max ? off : o_max;
    int o_next = INT_MAX;
    if (c + 1 < g.n_store) {
      const int nx = off + kept;
      o_next = nx < o_max ? nx : o_max;
    }
    if (m && rank < kept && o + rank < o_next) evt[o + rank] = fine;
    for (int q = 0; q < kChunkCols; ++q) base += col_kept[q];
    __syncthreads();  // the shared counts are rewritten by the next chunk
  }
}

}  // namespace

extern "C" int wt_zc_events(const float* filt, float* ev, int* ccol,
                            int n_rows, int nb, int lo, int nb_g, int L,
                            int e_cap, int c_row, int n_cols, int n_store,
                            void* stream) {
  const int n_spans = (n_cols + kSpan * kChunkCols - 1) / (kSpan * kChunkCols);
  const Geometry g{nb, lo, nb_g, L, e_cap, c_row, n_cols, n_store, n_spans};
  const int blocks = n_rows * 4 * n_spans;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  count_kernel<<<blocks, kThreads, 0, st>>>(filt, ev, ccol, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  write_kernel<<<blocks, kThreads, 0, st>>>(filt, ev, ccol, g);
  return static_cast<int>(cudaGetLastError());
}
