// The long-audio synthesis noise rows (synthesis/noise.py indexed_noise,
// float32): row i is the standard normal row of the global pulse ordinal
// start + i under a Threefry-2x32 key, as jax.random draws it.
//
// Replaces no Pallas kernel: the JAX package leaves indexed_noise
// (worldtpu/synthesis/synthesis.py) to XLA, which fuses it into one loop.
// In the port it was a chain of int64 tensor operations masked to 32 bits:
// two 20-round Threefry-2x32 a column (the row's fold_in over [rows], the
// column's over [rows, fft]), then the uniform and Giles' erfinv, ~220
// full-size passes and ~390 launches a LongPipeline chunk step, each pass
// reading and writing 8 bytes a column through device memory: 9.1 ms of a
// 12.4 ms chunk step on the H100.
//
// This kernel keeps the rounds in uint32 registers and writes each column
// once:
//   - one block takes rows_per_block consecutive rows (about kColumns
//     columns a block, at least one row, at most kThreads);
//     threads 0 .. rows - 1 compute their row's key, fold_in(key, (start +
//     i) mod 2^32) = threefry(key, (0, ordinal)), once a row, into shared
//     memory;
//   - then each thread takes 4 consecutive columns j of a row at a time:
//     threefry(row key, (0, j)) for the four as independent chains (the
//     rotations are funnel shifts of a word with itself, the adds wrap at
//     2^32), their bits x0 ^ x1, and a float4 store of the four normals
//     (scalar stores where fft is not a multiple of 4);
//   - the normal follows bits_to_normal and erfinv_f32 operation by
//     operation, each product and sum rounded on its own (__fmul_rn /
//     __fadd_rn, never contracted; the source also builds with
//     --fmad=false), log1pf and an IEEE square root as PyTorch's float
//     kernels call them, and the constants as the plain version's float32
//     values (hexadecimal literals): the normals equal the plain version's
//     on the card bit for bit.
//
// What bounds it on the H100: instruction issue.  A column costs one
// Threefry (20 rounds of add, funnel shift and xor, five key injections)
// and the normal, 155 SASS instructions on its common path (sm_90a,
// --fmad=false), 75 of them on the integer ALU pipe (nvcc issues half the
// adds as IMAD on the FMA pipe), against 4 bytes written; at
// LongPipeline's [Pmax, 1,024] rows (~3.9 M columns) that is ~0.61 G
// instructions, ~18 us at four warp instructions an SM a clock, against
// ~5 us to write the rows.  Nothing is read but the key and the starts.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;   // also the most rows a block holds keys for
constexpr int kColumns = 4096;  // the columns a block aims at
constexpr uint32_t kParity = 0x1BD11BDAu;

// XLA's float32 erfinv (Giles): the polynomials in w - 2.5 (w < 5) and in
// sqrt(w) - 3 (w >= 5); the plain version's _ERFINV_LT5 / _ERFINV_GE5 as
// float32
__constant__ float kLt5[9] = {
    0x1.e2cb1p-26f,  0x1.70966cp-22f, -0x1.d8e6aep-19f,
    -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
    -0x1.11c9dep-8f, 0x1.f91ec6p-3f,  0x1.805c5ep+0f};
__constant__ float kGe5[9] = {
    -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
    -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
    0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
// nextafter(-1, 0): the uniform's lower end; sqrt(2) rounded to float32
constexpr float kLo = -0x1.fffffep-1f;
constexpr float kSqrt2 = 0x1.6a09e6p+0f;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, on N independent counter pairs under one key
template <int N>
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t (&x0)[N],
                                         uint32_t (&x1)[N]) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  const uint32_t ks[3] = {k0, k1, k2};
#pragma unroll
  for (int n = 0; n < N; ++n) {
    x0[n] += k0;
    x1[n] += k1;
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int r = (i & 1) ? (s == 0 ? 17 : s == 1 ? 29 : s == 2 ? 16 : 24)
                            : (s == 0 ? 13 : s == 1 ? 15 : s == 2 ? 26 : 6);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        x0[n] += x1[n];
        x1[n] = rotl(x1[n], r) ^ x0[n];
      }
    }
    const uint32_t a = ks[(i + 1) % 3];
    const uint32_t b = ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      x0[n] += a;
      x1[n] += b;
    }
  }
}

template <int K>
__device__ __forceinline__ float horner(const float (&c)[K], float v) {
  float p = c[0];
#pragma unroll
  for (int k = 1; k < K; ++k) p = __fadd_rn(__fmul_rn(p, v), c[k]);
  return p;
}

// bits_to_normal: the uniform from the top 23 bits, sqrt(2) erfinv of it
__device__ __forceinline__ float normal_of(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(__fadd_rn(__fmul_rn(f, 2.0f), kLo), kLo);
  const float w = -log1pf(-__fmul_rn(u, u));
  const float p = w < 5.0f ? horner(kLt5, __fsub_rn(w, 2.5f))
                           : horner(kGe5, __fsub_rn(__fsqrt_rn(w), 3.0f));
  return __fmul_rn(__fmul_rn(p, u), kSqrt2);
}

__global__ void __launch_bounds__(kThreads)
    noise_kernel(const long long* __restrict__ key,
                 const long long* __restrict__ start,
                 float* __restrict__ out, long long rows, int count,
                 int fft, int rows_per_block) {
  __shared__ uint2 row_key[kThreads];
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int nr = static_cast<int>(
      rows - r0 < rows_per_block ? rows - r0 : rows_per_block);
  if (static_cast<int>(threadIdx.x) < nr) {
    // fold_in(key, (start + i) & 0xFFFFFFFF): the ordinal's low word
    const long long r = r0 + threadIdx.x;
    uint32_t x0[1] = {0u};
    uint32_t x1[1] = {static_cast<uint32_t>(start[r / count] + r % count)};
    threefry<1>(k0, k1, x0, x1);
    row_key[threadIdx.x] = make_uint2(x0[0], x1[0]);
  }
  __syncthreads();
  const int quads = (fft + 3) / 4;
  const int items = nr * quads;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int lr = it / quads;
    const int j0 = 4 * (it - lr * quads);
    const uint2 f = row_key[lr];
    uint32_t x0[4], x1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x0[c] = 0u;
      x1[c] = static_cast<uint32_t>(j0 + c);
    }
    threefry<4>(f.x, f.y, x0, x1);
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = normal_of(x0[c] ^ x1[c]);
    float* row = out + (r0 + lr) * static_cast<long long>(fft);
    if ((fft & 3) == 0) {
      *reinterpret_cast<float4*>(row + j0) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + c < fft) row[j0 + c] = v[c];
    }
  }
}

}  // namespace

// key [2] int64 (two uint32 words); start [n_starts] int64; out
// [n_starts, count, fft] float32.
extern "C" int wt_noise_rows(const long long* key, const long long* start,
                             float* out, long long n_starts, int count,
                             int fft, void* stream) {
  if (n_starts <= 0 || count <= 0 || fft <= 0) return 0;
  const int rows_per_block = std::max(1, std::min(kThreads, kColumns / fft));
  const long long rows = n_starts * count;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  noise_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      key, start, out, rows, count, fft, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
