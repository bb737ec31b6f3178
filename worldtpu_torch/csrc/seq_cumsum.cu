// Strictly sequential cumulative sum of float64 rows (the float64 parity
// path).
//
// No TPU kernel stands behind it: the JAX package's float64 path, which ran
// on the CPU, sums left to right with a lax.scan (the spectral integration
// of worldtpu/ops/filters.py::linear_smoothing, :367-374, and the phase sum
// of worldtpu/synthesis/synthesis.py::_time_base, :98-105), because the
// reference vocoder's loops round once per step and a reassociated sum
// moves a pulse boundary or a near-zero spectral tail.  torch.cumsum on the
// card is a parallel scan that reassociates, so the parity path on the card
// takes this kernel:
//
//   out[r, i] = __dadd_rn(out[r, i-1], x[r, i]),  out[r, 0] = x[r, 0]
//
// each row in order, one rounding a step (numpy.cumsum's bits, -0.0, NaN,
// +-inf and subnormals included; built with --fmad=false).  No parallel
// scan, no compensated sum, no split of a row: the bits rule them out.
//
// What bounds it.  A row is a chain of n - 1 dependent double adds, so its
// floor is n - 1 times the add's latency (chip_smoke.py measures it); the
// bytes (each value read and written once) bound the many-row launches
// (2,026 x 1,025 moves 33 MB).  The design before this one (60827b6), one
// thread a row reading its own row from global memory, ran at 22-23 ns a
// step on an H100: its lanes read addresses n * 8 bytes apart (32 sectors
// an instruction), eight loads in flight a thread, and 280 rows filled 5
// of the 132 SMs.  The chain waited on memory, not on the adder.
//
// This design takes memory off the chain.  A block of four warps owns
// `rows` rows (one to four).  Warps 1-3 (the producers) stream the rows'
// columns 1..n-1 in chunks of C through a ring of three shared-memory
// stages with 8-byte cp.async (a row's pitch is n * 8 bytes, n odd on the
// path, so neither TMA nor 16-byte vectors can address it), a warp reading
// 32 consecutive doubles of one row an instruction; lane r of warp 0 runs
// row r's chain out of its stage with 16-byte shared loads and stores, the
// next 32 values already in registers, and writes each sum back in place;
// the producers drain a finished stage with coalesced stores and refill
// it.  One block barrier a chunk, never one an element.  A stage row's
// pitch is C + 2 doubles: 16-byte aligned, and the lanes of warp 0 reading
// the same column of their rows hit distinct banks.
//
// The host picks one of two regimes from (n_rows, n) (wt_seq_cumsum_plan,
// mirrored by worldtpu_torch/ops/seqsum.py::plan):
//   rows  many rows (the D4C and LinearSmoothing frames, 140 to 2,026 rows
//         of 575 to 1,207): rows a block = n_rows / SMs, clamped to 1..4,
//         so the grid covers every SM wherever the rows allow, and a
//         launch of 2,026 rows puts ~4 blocks on an SM, whose producers
//         keep the bytes in flight; C = 128;
//   long  few long rows (the synthesis time base, one row an utterance:
//         n_rows < SMs and n > 4,096): one block a row, C = 1,024, one
//         chain thread streaming the row through the ring.
// On an H100 (chip_smoke.py) a dependent add takes 8.2 cycles (4.2 ns);
// a long row's step 4.7 ns.  Shared memory stays far under 48 KB (3 x 4 x
// 130 x 8 = 12,480 bytes at the most), so no attribute is set and a CUDA
// graph can capture the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // warp 0: the chains; warps 1-3: memory
constexpr int kProducers = kThreads - 32;
constexpr int kStages = 3;
constexpr int kPad = 2;           // a stage row's pitch is C + kPad doubles
constexpr int kUnroll = 32;       // values a chain thread holds ahead
constexpr int kRowsChunk = 128;
constexpr int kLongChunk = 1024;
constexpr int kRowsMax = 4;
constexpr int kLongN = 4096;
constexpr int kSmsDefault = 132;

struct Plan {
  int regime;   // 0 rows, 1 long
  int rows;     // rows a block
  int chunk;    // columns a chunk
  int blocks;
  int smem;     // dynamic shared bytes
};

Plan make_plan(int n_rows, int n, int sms) {
  Plan p;
  if (n_rows < sms && n > kLongN) {
    p.regime = 1;
    p.rows = 1;
    p.chunk = kLongChunk;
  } else {
    p.regime = 0;
    p.rows = n_rows / sms;
    p.rows = p.rows < 1 ? 1 : (p.rows > kRowsMax ? kRowsMax : p.rows);
    p.chunk = kRowsChunk;
  }
  p.blocks = (n_rows + p.rows - 1) / p.rows;
  p.smem = kStages * p.rows * (p.chunk + kPad) * 8;
  return p;
}

int sm_count() {
  // cached per device: the first call of a shape is eager (graphs.py runs
  // a program eagerly before it captures it), so no query runs in a capture
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return kSmsDefault;
  if (cache[dev] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || v <= 0)
      v = kSmsDefault;
    cache[dev] = v;
  }
  return cache[dev];
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the kStages - 2 newest groups landed (the thread's own copies)
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// The chain warp and the producers reach the block barrier from different
// instructions, so it is the non-aligned barrier.sync (__syncthreads is
// bar.sync, which is .aligned: every thread at the same instruction).
__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

// the producers alone (named barrier 1)
__device__ __forceinline__ void producers_sync() {
  asm volatile("barrier.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

// Two steps of a chain on a pair of values, their sums written as a pair.
__device__ __forceinline__ double2 add_pair(double& acc, double2 v) {
  const double s0 = __dadd_rn(acc, v.x);  // never contracted or reassociated
  acc = __dadd_rn(s0, v.y);
  return make_double2(s0, acc);
}

// A full chunk's C steps of one chain out of its 16-byte aligned stage
// row, 16-byte loads and stores: the next kUnroll values are loaded before
// the current kUnroll additions (two register groups in turn), so the
// chain waits on the adder.  (With 16 values a group, ptxas issued part of
// a group's loads just before their adds: 5.8 ns a step on an H100.)
template <int C>
__device__ __forceinline__ double chain_full(double* t, double acc) {
  constexpr int H = kUnroll / 2;    // pairs a group
  constexpr int N = C / 2;          // pairs a chunk
  static_assert(N % (2 * H) == 0, "a chunk is a whole number of group pairs");
  double2* t2 = reinterpret_cast<double2*>(t);
  double2 a[H], b[H];
#pragma unroll
  for (int h = 0; h < H; ++h) a[h] = t2[h];
#pragma unroll 1
  for (int c = 0; c < N; c += 2 * H) {
#pragma unroll
    for (int h = 0; h < H; ++h) b[h] = t2[c + H + h];
#pragma unroll
    for (int h = 0; h < H; ++h) t2[c + h] = add_pair(acc, a[h]);
    // the next group (on the last one, harmless reloads of its own sums)
    const int nx = c + 2 * H < N ? c + 2 * H : c;
#pragma unroll
    for (int h = 0; h < H; ++h) a[h] = t2[nx + h];
#pragma unroll
    for (int h = 0; h < H; ++h) t2[c + H + h] = add_pair(acc, b[h]);
  }
  return acc;
}

// The last, partial chunk: cnt < C steps (C a multiple of kUnroll, so the
// unguarded loads stay inside the stage row).
__device__ __forceinline__ double chain_part(double* t, int cnt, double acc) {
  int c = 0;
  for (; c + kUnroll <= cnt; c += kUnroll) {
    double v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = t[c + u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = __dadd_rn(acc, v[u]);
      t[c + u] = acc;
    }
  }
  const int rem = cnt - c;
  double v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) v[u] = t[c + u];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < rem) {
      acc = __dadd_rn(acc, v[u]);
      t[c + u] = acc;
    }
  }
  return acc;
}

// Columns 1..n-1 of the block's rows, chunk k, into or out of a stage:
// element e of the stage's rows x C tile is row e / C, column e % C, so a
// warp's 32 lanes take 32 consecutive columns of one row.
template <int C>
__device__ __forceinline__ void load_chunk(double* stage, const double* x,
                                           int r0, int nr, int n, int k,
                                           int p) {
  const int j0 = 1 + k * C;
  for (int e = p; e < nr * C; e += kProducers) {
    const int row = e / C, col = e - row * C;
    if (j0 + col < n)
      cp_async8(stage + row * (C + kPad) + col,
                x + static_cast<size_t>(r0 + row) * n + j0 + col);
  }
}

template <int C>
__device__ __forceinline__ void store_chunk(const double* stage, double* out,
                                            int r0, int nr, int n, int k,
                                            int p) {
  const int j0 = 1 + k * C;
  for (int e = p; e < nr * C; e += kProducers) {
    const int row = e / C, col = e - row * C;
    if (j0 + col < n)
      out[static_cast<size_t>(r0 + row) * n + j0 + col] =
          stage[row * (C + kPad) + col];
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    seq_cumsum_kernel(const double* __restrict__ x, double* __restrict__ out,
                      int n_rows, int n, int rows) {
  extern __shared__ __align__(16) double smem[];
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n_rows - r0);
  const int m = n - 1;                  // columns after the first
  const int n_chunks = (m + C - 1) / C;
  const int tile = rows * (C + kPad);   // doubles a stage
  if (threadIdx.x < 32) {
    // the chains: lane r owns row r0 + r
    const int lane = threadIdx.x;
    const bool mine = lane < nr;
    double acc = 0.0;
    if (mine) {
      const size_t base = static_cast<size_t>(r0 + lane) * n;
      acc = x[base];                    // out[r, 0] = x[r, 0], -0.0 kept
      out[base] = acc;
    }
    int s = 0;
    for (int k = 0; k < n_chunks; ++k) {
      block_sync();                  // chunk k has landed in stage s
      if (mine) {
        double* t = smem + s * tile + lane * (C + kPad);
        const int cnt = min(C, m - k * C);
        acc = cnt == C ? chain_full<C>(t, acc) : chain_part(t, cnt, acc);
      }
      s = s == kStages - 1 ? 0 : s + 1;
    }
    block_sync();                    // the last chunk's sums are written
  } else {
    const int p = threadIdx.x - 32;
    // chunks 0 .. kStages-2 in flight before the first chain
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n_chunks) load_chunk<C>(smem + k * tile, x, r0, nr, n, k, p);
      cp_async_commit();
    }
    cp_async_wait_ahead();
    block_sync();                    // chunk 0 in stage 0
    int s = kStages - 1;             // the stage chunk k-1 used
    for (int k = 0; k < n_chunks; ++k) {
      // during chunk k's chain: drain chunk k-1's sums, then refill its
      // stage with chunk k + kStages - 1; the chunks between are in flight
      double* free_stage = smem + s * tile;
      if (k > 0) {
        store_chunk<C>(free_stage, out, r0, nr, n, k - 1, p);
        producers_sync();            // every read of the stage is done
      }
      if (k + kStages - 1 < n_chunks)
        load_chunk<C>(free_stage, x, r0, nr, n, k + kStages - 1, p);
      cp_async_commit();
      cp_async_wait_ahead();         // chunk k+1 has landed
      block_sync();
      s = s == kStages - 1 ? 0 : s + 1;
    }
    if (n_chunks > 0)
      store_chunk<C>(smem + s * tile, out, r0, nr, n, n_chunks - 1, p);
  }
}

// One thread, `n` dependent __dadd_rn between two clock64() reads: the
// add's latency, the chain's floor (chip_smoke.py).
__global__ void dadd_latency_kernel(const double* in, double* out,
                                    long long* cycles, int n) {
  double acc = in[0];
  const double y = in[1];
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; i += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) acc = __dadd_rn(acc, y);
  }
  const long long t1 = clock64();
  out[0] = acc;
  cycles[0] = t1 - t0;
}

}  // namespace

// out[0..4] = regime (0 rows, 1 long), rows a block, chunk, blocks, shared
// bytes for (n_rows, n) on a card of `sms` SMs (0: the current device's).
extern "C" int wt_seq_cumsum_plan(int n_rows, int n, int sms, int* out) {
  const Plan p = make_plan(n_rows, n, sms > 0 ? sms : sm_count());
  out[0] = p.regime;
  out[1] = p.rows;
  out[2] = p.chunk;
  out[3] = p.blocks;
  out[4] = p.smem;
  return 0;
}

extern "C" int wt_seq_cumsum_f64(const double* x, double* out, int n_rows,
                                 int n, void* stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  const Plan p = make_plan(n_rows, n, sm_count());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.chunk == kLongChunk)
    seq_cumsum_kernel<kLongChunk>
        <<<p.blocks, kThreads, p.smem, st>>>(x, out, n_rows, n, p.rows);
  else
    seq_cumsum_kernel<kRowsChunk>
        <<<p.blocks, kThreads, p.smem, st>>>(x, out, n_rows, n, p.rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wt_dadd_latency(const double* in, double* out,
                               long long* cycles, int n, void* stream) {
  dadd_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, cycles, n);
  return static_cast<int>(cudaGetLastError());
}
