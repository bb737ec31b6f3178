// D4C's band aperiodicity in float32, one block a frame
// (analysis/d4c.py d4c_frames; reference src/d4c.cpp D4C, D4CLoveTrain,
// D4CGeneralBody).
//
// Replaces no Pallas kernel: the JAX package leaves D4C
// (worldtpu/analysis/d4c.py d4c_frames) to XLA.  In the port it was a chain
// of PyTorch operations (ops/d4c_kernel.py d4c_frames_plain), each over
// every frame of the batch and each writing [B, F, ~fft] rows to device
// memory (~0.44 GB of band spectra alone a 48 kHz batch of eight 3.2 s
// utterances); every frame was computed in full, the ones the LoveTrain
// gate rejects then replaced by the default row.  It held 36-49% of a
// replayed batch's device time.  This kernel was added to keep a frame's
// rows in shared memory, to skip the frames the gate rejects, and to write
// each aperiodicity row once.
//
// For each frame g = b * F + f, one block:
//   - f0 == 0 (unvoiced and padded fill frames): the default row, end;
//   - the frame's origin round(pos * fs + 0.001) (less sample_offset[b]),
//     rounded as frame_segments rounds it; every window reads x directly,
//     with the chain's edge replication;
//   - LoveTrain: the Blackman 3-period window (its cosines by
//     ops/trig.cos_affine's seed-and-rotate form, its weight removed), one
//     real transform of LoveTrain's own size (fft, or fft / 2 where fs
//     lies just above a power of two's step: 24,053-27,293 and
//     48,117-54,599 Hz) packed into a complex FFT of half that, and the
//     power ratio ap0 of (100, 4000] Hz over (100, 7900] Hz; a frame with
//     ap0 <= threshold writes the default row and ends;
//   - the two shifted Blackman centroids: each window w (normalized) and
//     w m / S, m the sample's offset from the window's centre and S a power
//     of two above its half width, are the real and imaginary parts of one
//     fft-point complex FFT; split by conjugate symmetry, the centroid is
//     S Re(W conj M) + (half + 1) |W|^2, the chain's base + delta p1 with
//     the ramp centred (a circular shift of a window moves neither term);
//     the two summed, DC-corrected;
//   - the Hanning power spectrum (a packed real transform), DC-corrected,
//     smoothed over f0 and floored at FLT_MIN; the group delay, clamped,
//     smoothed over f0 / 2, less its own smoothing over f0;
//   - the coarse bands two at a time: each band's Nuttall-windowed slice,
//     scaled by a power of two to about unit energy (exact: lo / hi does
//     not move) so that neither band's rounding swamps the other's, as the
//     real and imaginary parts of one fft-point FFT; both power spectra
//     split into shared rows; the (boundary + 1)-th largest power of each
//     by a radix select on its bits (four 8-bit passes over shared
//     histograms counted with integer atomics, whose result has no order);
//     hi the sum of all powers, lo the sum of those below that threshold
//     plus the ties the top set leaves out: lo is a sum of positive terms,
//     not hi less the top; 10 log10(lo / hi) + (f0 - 100) / 50, clamped
//     at 0;
//   - the interpolation to the output bins and 10^(dB / 20), one write.
// The DC correction and the smoothing are this kernel's own copies of
// ops/filters.py's float32 forms (dc_correction_frames;
// linear_smoothing_frames, whose dense kernel (1 - f_lo, 1 ... 1, f_hi)
// over the mirrored row is summed here tap by tap over the reflected row).
// Every product and sum that decides an integer or a comparison (the
// origin, the half widths, the centroid shifts, the smoothing's and the DC
// correction's bins, the gate's ratio, the interpolation) is written with
// __fmul_rn / __fadd_rn / __fdiv_rn in the chain's order, which the build's
// --fmad=true does not contract; a tensor divided by a Python number is,
// on the card, a product with the number's float32 reciprocal, and so it
// is here (Params holds those reciprocals).  Block sums add the warps'
// shuffle-reduced parts in warp order, so a replay repeats an eager call's
// bits.
//
// FFTs: radix-4 Stockham passes (one radix-2 pass first where log2 n is
// odd) in shared memory, twiddles from a table of exp(-2 pi i m / fft)
// rounded once to float.  The kernel is a template on fft (2,048 ... 8,192)
// with fft / 8 threads; dynamic shared memory: the complex buffer (8 fft
// bytes) and three rows of fft / 2 + 1 floats (28 KB at 2,048, 56 KB at
// 4,096).
//
// What bounds it on the H100: operations.  An active frame runs the
// equivalent of 4 (fft 2,048: 22.05 kHz) or 5.5 (4,096: 48 kHz) complex
// fft-point FFTs and three smoothings of ~width * fft / fs taps a bin; the
// bytes are the frames' samples read and the rows written (~27 MB a
// 22 kHz corpus batch).  The FFT passes and the taps run at shared-memory
// bandwidth, with several blocks resident on each SM to hide the barriers.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 16;
constexpr int kQ = 128;       // ops/trig.cos_affine's block of columns
constexpr int kMaxBands = 8;  // ops/d4c_kernel.MAX_BANDS
constexpr unsigned kFull = 0xffffffffu;

// Params.i: ops/d4c_kernel.kernel_params' int table
enum {
  kN, kKo, kMhLt, kMhc, kSegPad, kB0, kB1, kB2, kNap, kWl, kHalfW,
  kBoundary, kDcLen, kNLt, kCenters, kInts = kCenters + kMaxBands
};
// Params.f: its float table
enum {
  kFs, kInvFs, kLtNum, kCNum, kLtAlpha, kCAlpha, kBinHz, kThreshold,
  kFloorD4c, kFftF, kInvFftOut, kHalfFs, kDefault, kTopGuard, kFloats
};

struct Params {
  int i[kInts];
  float f[kFloats];
};

__host__ __device__ constexpr int threads_for(int n) {
  return n / 8 < 128 ? 128 : (n / 8 > 1024 ? 1024 : n / 8);
}

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ops/numeric.matlab_round: half away from zero
__device__ __forceinline__ int mround(float v) {
  return static_cast<int>(v > 0.f ? floorf(__fadd_rn(v, 0.5f))
                                  : ceilf(__fsub_rn(v, 0.5f)));
}

// In-place forward DFT of x[0, n) in shared memory (exp(-2 pi i jk / n)).
// tw[m] = exp(-2 pi i m / (n << shift)).  Stockham passes: a pass of radix
// R over sub-sequences of length p takes inputs x[i + j n/R], j < R,
// twiddles them by exp(-2 pi i j k / (R p)), k = i mod p, and writes its
// R-point DFT to x[(i - k) R + k + j p]; the output comes in natural order.
template <int n, int T>
__device__ void fft_shared(float2* x, const float2* __restrict__ tw,
                           int shift) {
  const int tid = threadIdx.x;
  int p = 1;
  if (ilog2(n) & 1) {  // radix 2 with p = 1: no twiddles
    constexpr int Q = n / 2;
    constexpr int kPer = (Q + T - 1) / T;
    float2 a[kPer], c[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * T;
      if (i < Q) {
        a[u] = x[i];
        c[u] = x[i + Q];
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * T;
      if (i < Q) {
        x[2 * i] = cadd(a[u], c[u]);
        x[2 * i + 1] = csub(a[u], c[u]);
      }
    }
    __syncthreads();
    p = 2;
  }
  constexpr int Q = n / 4;
  constexpr int kPer = (Q + T - 1) / T;
  for (; p < n; p <<= 2) {
    float2 v[kPer][4];
    const int step = (n / (4 * p)) << shift;  // table units of 1 / (4p)
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * T;
      if (i < Q) {
        const int k = i & (p - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = x[i + j * Q];
        if (k != 0) {
          const int m = k * step;  // 3m < 3 (n << shift) / 4
#pragma unroll
          for (int j = 1; j < 4; ++j)
            v[u][j] = cmul(v[u][j], __ldg(tw + j * m));
        }
        const float2 a0 = cadd(v[u][0], v[u][2]);
        const float2 a1 = csub(v[u][0], v[u][2]);
        const float2 a2 = cadd(v[u][1], v[u][3]);
        const float2 d = csub(v[u][1], v[u][3]);
        const float2 a3 = make_float2(d.y, -d.x);  // d * -i
        v[u][0] = cadd(a0, a2);
        v[u][1] = cadd(a1, a3);
        v[u][2] = csub(a0, a2);
        v[u][3] = csub(a1, a3);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * T;
      if (i < Q) {
        const int k = i & (p - 1);
        const int o = ((i - k) << 2) + k;
#pragma unroll
        for (int j = 0; j < 4; ++j) x[o + j * p] = v[u][j];
      }
    }
    __syncthreads();
  }
}

// The sums over the block of each thread's v[0 .. M), the same values in
// every thread: the warps' shuffle-reduced parts added in warp order.
// red: 32 M floats.
template <int T, int M>
__device__ void block_sums(float (&v)[M], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[m] += __shfl_xor_sync(kFull, v[m], o);
    if (lane == 0) red[warp * M + m] = v[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) s += red[w * M + m];
    v[m] = s;
  }
  __syncthreads();  // red free again
}

// The chain's windowed, weight-removed samples (_centered_window, and the
// shifted centroid's window over its segment): sample m in [-h, h] is
// x[clamp(base + m)] times its window, whose cosine is
// cos(alpha (c0 + m) + beta), beta = -alpha c0, by ops/trig.cos_affine's
// seed-and-rotate form (cq: the 128-column blocks' angles, cr: the offsets'
// in a block).  Thread value u holds j = tid + u T, m = j - h; 0 past 2h.
template <int N, int T>
__device__ void window(float (&w)[N / T], bool blackman, float alpha,
                       int c0, int h, const float* __restrict__ xb,
                       int base, int len, float2* cq, float2* cr,
                       float* red) {
  constexpr int kPer = N / T;
  const float beta = __fmul_rn(-alpha, static_cast<float>(c0));
  const int q0 = (c0 - h) >> 7;
  const int nq = ((c0 + h) >> 7) - q0 + 1;
  for (int t = threadIdx.x; t < kQ + nq; t += T) {
    const float a =
        t < kQ ? __fmul_rn(alpha, static_cast<float>(t))
               : __fadd_rn(__fmul_rn(alpha,
                                     static_cast<float>((q0 + t - kQ) * kQ)),
                           beta);
    const float2 cs = make_float2(cosf(a), sinf(a));
    if (t < kQ) {
      cr[t] = cs;
    } else {
      cq[t - kQ] = cs;
    }
  }
  __syncthreads();
  float win[kPer];
  float acc[2] = {0.f, 0.f};
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = threadIdx.x + u * T;
    w[u] = 0.f;
    win[u] = 0.f;
    if (j <= 2 * h) {
      const int m = j - h;
      const int i = c0 + m;
      const float2 a = cq[(i >> 7) - q0], r = cr[i & (kQ - 1)];
      const float c1 = __fsub_rn(__fmul_rn(a.x, r.x), __fmul_rn(a.y, r.y));
      float v;
      if (blackman) {  // 0.42 + 0.5 c1 + 0.08 (2 c1 c1 - 1)
        const float c2 = __fsub_rn(__fmul_rn(2.f * c1, c1), 1.f);
        v = __fadd_rn(__fadd_rn(0.42f, __fmul_rn(0.5f, c1)),
                      __fmul_rn(0.08f, c2));
      } else {  // 0.5 c1 + 0.5
        v = __fadd_rn(__fmul_rn(0.5f, c1), 0.5f);
      }
      win[u] = v;
      w[u] = __fmul_rn(__ldg(xb + clampi(base + m, 0, len - 1)), v);
      acc[0] += w[u];
      acc[1] += v;
    }
  }
  block_sums<T, 2>(acc, red);
  const float weight = __fdiv_rn(acc[0], acc[1]);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (threadIdx.x + u * T <= 2 * h)
      w[u] = __fsub_rn(w[u], __fmul_rn(win[u], weight));
  }
}

// |X[k]|^2, 0 <= k <= H, of the real 2H-point sequence x packed as
// z[i] = x[2i] + i x[2i+1], whose H-point transform is Zh: with
// E = (Zh[k] + conj Zh[H-k]) / 2 and O = (Zh[k] - conj Zh[H-k]) / 2i,
// X[k] = E + exp(-2 pi i k / 2H) O.  tw: the table of a 2H stride-point
// transform.
template <int H>
__device__ __forceinline__ float packed_power(const float2* Zh,
                                              const float2* __restrict__ tw,
                                              int stride, int k) {
  if (k == 0 || k == H) {
    const float s = k == 0 ? Zh[0].x + Zh[0].y : Zh[0].x - Zh[0].y;
    return s * s;
  }
  const float2 a = Zh[k], c = Zh[H - k];
  const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
  const float2 o = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
  const float2 s = cadd(e, cmul(__ldg(tw + k * stride), o));
  return s.x * s.x + s.y * s.y;
}

// The spectra at bin k of a and b from Z = FFT(a + i b), N points:
// A = (Z[k] + conj Z[N-k]) / 2, B = (Z[k] - conj Z[N-k]) / 2i.
template <int N>
__device__ __forceinline__ void split_pair(const float2* Z, int k, float2& a,
                                           float2& b) {
  const float2 z = Z[k], m = Z[(N - k) & (N - 1)];
  a = make_float2(0.5f * (z.x + m.x), 0.5f * (z.y - m.y));
  b = make_float2(0.5f * (z.y + m.y), 0.5f * (m.x - z.x));
}

// ops/filters.dc_correction_frames' float32 form on one row: bin i < L
// gains the replica of the sub-f0 power, y0 + (y1 - y0) frac, where
// i < upper_limit - 1; tmp holds the new bins until every read is done.
// Starts and ends with the block in step.
template <int T>
__device__ void dc_correct(float* row, float* tmp, float f0d,
                           const Params& p) {
  const int L = p.i[kDcLen];
  const float v = __fmul_rn(__fmul_rn(f0d, p.f[kFftF]), p.f[kInvFs]);
  const float lim = static_cast<float>(2 + static_cast<int>(v) - 1);
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += T) {
    const float pos = __fsub_rn(v, static_cast<float>(i));
    const int base = static_cast<int>(pos);  // toward zero
    const float frac = __fsub_rn(pos, static_cast<float>(base));
    const int bc = clampi(base, 0, L - 2);
    const float y0 = row[bc], y1 = row[bc + 1];
    const float add = static_cast<float>(i) < lim
                          ? __fadd_rn(y0, __fmul_rn(__fsub_rn(y1, y0), frac))
                          : 0.f;
    tmp[i] = __fadd_rn(row[i], add);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += T) row[i] = tmp[i];
  __syncthreads();
}

// bin s of the row mirrored at 0 and at half (the chain's mirror pads)
template <int half>
__device__ __forceinline__ int refl(int s) {
  s = s < 0 ? -s : s;
  s = s > half ? 2 * half - s : s;
  return s < 0 ? 0 : s;
}

// ops/filters.linear_smoothing_frames' float32 form on one row: the dense
// kernel (1 - f_lo, 1 ... 1, f_hi) over the mirrored row, times fs / fft,
// over width; src and dst distinct.  Ends with the block in step.
template <int T, int K>
__device__ void smooth(const float* src, float* dst, float width,
                       const Params& p) {
  constexpr int half = K - 1;
  const float u = __fmul_rn(__fmul_rn(width, p.f[kFftF]), p.f[kInvFs]);
  const int b = static_cast<int>(u) + 1;
  const float bh = __fsub_rn(static_cast<float>(b), 0.5f);
  const float hu = __fmul_rn(u, 0.5f);
  const float lo_v = __fsub_rn(bh, hu), hi_v = __fadd_rn(bh, hu);
  const int blo = static_cast<int>(lo_v), bhi = static_cast<int>(hi_v);
  const float w_lo = __fsub_rn(1.f, __fsub_rn(lo_v, static_cast<float>(blo)));
  const float w_hi = __fsub_rn(hi_v, static_cast<float>(bhi));
  const int o_lo = blo + 1 - b, o_hi = bhi + 1 - b;
  const float scale = p.f[kBinHz];
  for (int k = threadIdx.x; k < K; k += T) {
    float acc = w_lo * src[refl<half>(k + o_lo)];
    for (int s = k + o_lo + 1; s < k + o_hi; ++s) acc += src[refl<half>(s)];
    acc += w_hi * src[refl<half>(k + o_hi)];
    dst[k] = __fdiv_rn(acc * scale, width);
  }
  __syncthreads();
}

// The count-th largest value of each of the nr (1 or 2) rows (K
// non-negative floats, whose bits order as their values): a radix select
// on the bits, 8 at a time from the top.  Leaves in prefix[r] its bits, in
// eq[r] how many values have them, in rem[r] how many of those the top
// count holds.  hist: 512 ints.
template <int T, int K>
__device__ void select_top(const float* r0, const float* r1, int nr,
                           int count, int* hist, unsigned* prefix, int* rem,
                           int* eq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 2) {
    prefix[threadIdx.x] = 0u;
    rem[threadIdx.x] = count;
  }
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const unsigned mask = pass == 0 ? 0u : kFull << (32 - 8 * pass);
    for (int i = threadIdx.x; i < 512; i += T) hist[i] = 0;
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const float* row = r == 0 ? r0 : r1;
      const unsigned pre = prefix[r];
      for (int k = threadIdx.x; k < K; k += T) {
        const unsigned u = __float_as_uint(row[k]);
        if (((u ^ pre) & mask) == 0u)
          atomicAdd(hist + r * 256 + ((u >> shift) & 255), 1);
      }
    }
    __syncthreads();
    if (warp < nr) {
      // the digit whose bucket holds the rem-th largest of the candidates:
      // lane l sums buckets 8l .. 8l+7, suf the lanes >= l
      const int* h = hist + warp * 256;
      const int need = rem[warp];
      int s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += h[8 * lane + j];
      int suf = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_down_sync(kFull, suf, o);
        if (lane + o < 32) suf += t;
      }
      const int above = suf - s;
      __syncwarp();
      if (above < need && suf >= need) {
        int acc = above;
        for (int j = 7; j >= 0; --j) {
          const int c = h[8 * lane + j];
          if (acc + c >= need) {
            prefix[warp] |= static_cast<unsigned>(8 * lane + j) << shift;
            rem[warp] = need - acc;
            eq[warp] = c;
            break;
          }
          acc += c;
        }
      }
    }
    __syncthreads();
  }
}

// LoveTrain's sums (b0, b1] and (b0, b2] of the power of the real L-point
// window in fz (zero past it; L = N or N / 2), into acc.  Ends with the
// block in step.
template <int L, int N, int T>
__device__ void love_train_sums(float2* Z, const float2* __restrict__ tw,
                                const Params& p, float (&acc)[2],
                                float* red) {
  constexpr int s = ilog2(N / L);  // tw is the N-point table
  fft_shared<L / 2, T>(Z, tw, s + 1);
  acc[0] = acc[1] = 0.f;
  for (int k = p.i[kB0] + 1 + threadIdx.x; k <= p.i[kB2]; k += T) {
    const float pk = packed_power<L / 2>(Z, tw, 1 << s, k);
    acc[1] += pk;
    if (k <= p.i[kB1]) acc[0] += pk;
  }
  block_sums<T, 2>(acc, red);
}

// ~1 / sqrt(e) as a power of two (1 where e is 0 or not finite)
__device__ __forceinline__ float unit_scale(float e) {
  if (!(e > 0.f) || isinf(e)) return 1.f;
  int ex;
  frexpf(e, &ex);
  return ldexpf(1.f, -(ex / 2));
}

template <int N>
__global__ void __launch_bounds__(threads_for(N), 1024 / threads_for(N))
d4c_kernel(const float* __restrict__ x, const float* __restrict__ f0,
           const float* __restrict__ pos, const long long* __restrict__ off,
           const float* __restrict__ nut, const float2* __restrict__ tw,
           float* __restrict__ out, const __grid_constant__ Params p,
           int F, int len,
           int pos_rows) {
  constexpr int T = threads_for(N);
  constexpr int H = N / 2;
  constexpr int K = H + 1;
  constexpr int KP = (K + 3) & ~3;
  constexpr int kPer = N / T;
  extern __shared__ float4 smem4[];
  float2* Z = reinterpret_cast<float2*>(smem4);  // [N]
  float* fz = reinterpret_cast<float*>(smem4);   // Z as 2N floats
  float* A = fz + 2 * N;                         // [K] the centroid, sgd
  float* R1 = A + KP;                            // [K] rows
  float* R2 = R1 + KP;                           // [K]
  __shared__ float2 cq[N / kQ + 2];
  __shared__ float2 cr[kQ];
  __shared__ float red[32 * 4];
  __shared__ int hist[512];
  __shared__ unsigned sel_prefix[2];
  __shared__ int sel_rem[2], sel_eq[2];
  __shared__ float ca[kMaxBands];

  const long long g = blockIdx.x;
  const int b = static_cast<int>(g / F), f = static_cast<int>(g % F);
  const int tid = threadIdx.x;
  const int Ko = p.i[kKo];
  float* orow = out + g * Ko;
  const float f0v = f0[g];
  bool active = f0v != 0.f && f0v == f0v;  // a NaN f0 is never active
  const float fs = p.f[kFs];
  const float pv = pos[pos_rows ? g : f];
  const int o = mround(__fadd_rn(__fmul_rn(pv, fs), 0.001f));
  const int ro =
      clampi(o - (off != nullptr ? static_cast<int>(off[b]) : 0), 0, len - 1);
  const float* xb = x + static_cast<long long>(b) * len;

  // ---- LoveTrain: the voicing gate, first ----
  if (active) {
    const float f0lt = fmaxf(f0v, 40.f);
    const int mh = p.i[kMhLt];
    const int h =
        min(mround(__fmul_rn(__fdiv_rn(p.f[kLtNum], f0lt), 0.5f)), mh);
    float w[kPer];
    window<N, T>(w, true, __fmul_rn(p.f[kLtAlpha], f0lt), mh, h, xb, ro, len,
                 cq, cr, red);
#pragma unroll
    for (int u = 0; u < kPer; ++u) fz[tid + u * T] = w[u];
    __syncthreads();
    float acc[2];  // (b0, b1], (b0, b2]
    if (p.i[kNLt] == N) {
      love_train_sums<N, N, T>(Z, tw, p, acc, red);
    } else {
      love_train_sums<N / 2, N, T>(Z, tw, p, acc, red);
    }
    active = __fdiv_rn(acc[0], acc[1]) > p.f[kThreshold];
  }
  if (!active) {
    const float v = p.f[kDefault];
    for (int k = tid; k < Ko; k += T) orow[k] = v;
    return;
  }

  const float f0d = fmaxf(f0v, p.f[kFloorD4c]);
  const int mhc = p.i[kMhc];
  const int hc = min(mround(__fmul_rn(__fdiv_rn(p.f[kCNum], f0d), 0.5f)), mhc);
  const float alpha_c = __fmul_rn(p.f[kCAlpha], f0d);

  // ---- the two shifted centroids, summed into A ----
  {
    const int e = 32 - __clz(hc);  // 2^e > hc
    const float S = ldexpf(1.f, e), inv_s = ldexpf(1.f, -e);
    const float delta = static_cast<float>(hc + 1);
    const float quarter = __fdiv_rn(0.25f, f0d);
    for (int side = 0; side < 2; ++side) {
      const float at = side == 0 ? __fsub_rn(pv, quarter)
                                 : __fadd_rn(pv, quarter);
      const int d = mround(__fadd_rn(__fmul_rn(at, fs), 0.001f)) - o;
      float w[kPer];
      window<N, T>(w, true, alpha_c, mhc + p.i[kSegPad] + d, hc, xb, ro + d,
                   len, cq, cr, red);
      float nrm[1] = {0.f};
#pragma unroll
      for (int u = 0; u < kPer; ++u) nrm[0] += __fmul_rn(w[u], w[u]);
      block_sums<T, 1>(nrm, red);
      const float sq = sqrtf(nrm[0]);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int j = tid + u * T;
        float2 z = make_float2(0.f, 0.f);
        if (j <= 2 * hc) {
          const float wn = __fdiv_rn(w[u], sq);
          z = make_float2(
              wn, __fmul_rn(__fmul_rn(wn, static_cast<float>(j - hc)), inv_s));
        }
        Z[j] = z;
      }
      __syncthreads();
      fft_shared<N, T>(Z, tw, 0);
      for (int k = tid; k <= H; k += T) {
        float2 a, m;
        split_pair<N>(Z, k, a, m);
        const float c = S * (a.x * m.x + a.y * m.y)
                        + delta * (a.x * a.x + a.y * a.y);
        A[k] = side == 0 ? c : A[k] + c;
      }
    }
  }
  dc_correct<T>(A, R1, f0d, p);

  // ---- the smoothed Hanning power spectrum into R2 ----
  {
    float w[kPer];
    window<N, T>(w, false, alpha_c, mhc, hc, xb, ro, len, cq, cr, red);
#pragma unroll
    for (int u = 0; u < kPer; ++u) fz[tid + u * T] = w[u];
    __syncthreads();
    fft_shared<H, T>(Z, tw, 1);
    for (int k = tid; k <= H; k += T) R1[k] = packed_power<H>(Z, tw, 1, k);
  }
  dc_correct<T>(R1, R2, f0d, p);
  smooth<T, K>(R1, R2, f0d, p);

  // ---- the static group delay into A ----
  for (int k = tid; k < K; k += T) {
    const float s = R2[k] < 1.17549435e-38f ? 1.17549435e-38f : R2[k];
    const float q = __fdiv_rn(A[k], s);
    A[k] = q < -1e12f ? -1e12f : (q > 1e12f ? 1e12f : q);
  }
  __syncthreads();
  smooth<T, K>(A, R1, __fmul_rn(f0d, 0.5f), p);
  smooth<T, K>(R1, R2, f0d, p);
  for (int k = tid; k < K; k += T) A[k] = __fsub_rn(R1[k], R2[k]);
  __syncthreads();

  // ---- the coarse bands, two at a time ----
  const int n_ap = p.i[kNap], wl = p.i[kWl], hw = p.i[kHalfW];
  for (int b0 = 0; b0 < n_ap; b0 += 2) {
    const int nr = n_ap - b0 < 2 ? 1 : 2;
    const int s0 = p.i[kCenters + b0] - hw;
    const int s1 = nr > 1 ? p.i[kCenters + b0 + 1] - hw : 0;
    float v0[kPer], v1[kPer];
    float en[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = tid + u * T;
      v0[u] = j < wl ? __fmul_rn(A[s0 + j], __ldg(nut + j)) : 0.f;
      v1[u] = nr > 1 && j < wl ? __fmul_rn(A[s1 + j], __ldg(nut + j)) : 0.f;
      en[0] += v0[u] * v0[u];
      en[1] += v1[u] * v1[u];
    }
    block_sums<T, 2>(en, red);
    const float sc0 = unit_scale(en[0]), sc1 = unit_scale(en[1]);
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      Z[tid + u * T] = make_float2(v0[u] * sc0, v1[u] * sc1);
    __syncthreads();
    fft_shared<N, T>(Z, tw, 0);
    for (int k = tid; k <= H; k += T) {
      float2 a, c;
      split_pair<N>(Z, k, a, c);
      R1[k] = a.x * a.x + a.y * a.y;
      R2[k] = c.x * c.x + c.y * c.y;
    }
    __syncthreads();
    select_top<T, K>(R1, R2, nr, p.i[kBoundary] + 1, hist, sel_prefix,
                     sel_rem, sel_eq);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};  // hi, lo of each row
    const unsigned t0 = sel_prefix[0], t1 = sel_prefix[1];
    for (int k = tid; k < K; k += T) {
      const float a = R1[k];
      acc[0] += a;
      if (__float_as_uint(a) < t0) acc[1] += a;
      if (nr > 1) {
        const float c = R2[k];
        acc[2] += c;
        if (__float_as_uint(c) < t1) acc[3] += c;
      }
    }
    block_sums<T, 4>(acc, red);
    if (tid < nr) {
      const float hi = tid == 0 ? acc[0] : acc[2];
      const float below = tid == 0 ? acc[1] : acc[3];
      const float lo =
          below + static_cast<float>(sel_eq[tid] - sel_rem[tid]) *
                      __uint_as_float(sel_prefix[tid]);
      const float db = 10.f * log10f(__fdiv_rn(lo, hi));
      const float v =
          __fadd_rn(db, __fmul_rn(__fsub_rn(f0d, 100.f), 0.02f));
      ca[b0 + tid] = v > 0.f ? 0.f : v;
    }
  }
  __syncthreads();

  // ---- the interpolation to the output bins ----
  const int n = n_ap + 2;  // knots 0, 3000 ... 3000 n_ap, fs / 2
  for (int k = tid; k < Ko; k += T) {
    const float fr = __fmul_rn(__fmul_rn(static_cast<float>(k), fs),
                               p.f[kInvFftOut]);
    int idx = 1;  // searchsorted(knots, fr, right), clamped to [1, n - 1]
    while (idx < n - 1 && 3000.f * static_cast<float>(idx) <= fr) ++idx;
    const float x0 = 3000.f * static_cast<float>(idx - 1);
    const float x1 =
        idx < n - 1 ? 3000.f * static_cast<float>(idx) : p.f[kHalfFs];
    const float y0 = idx == 1 ? -60.f : ca[idx - 2];
    const float y1 = idx < n - 1 ? ca[idx - 1] : p.f[kTopGuard];
    const float s = __fdiv_rn(__fsub_rn(fr, x0), __fsub_rn(x1, x0));
    const float v = __fadd_rn(y0, __fmul_rn(s, __fsub_rn(y1, y0)));
    orow[k] = powf(10.f, __fmul_rn(v, 0.05f));
  }
}

// dynamic shared memory beyond the default for fn, once per device
template <typename Fn>
int allow_smem(Fn fn, int* table, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int once = 0;
  int& allowed = dev < kMaxDevices ? table[dev] : once;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  return 0;
}

template <int N>
int launch_d4c(const float* x, const float* f0, const float* pos,
               const long long* off, const float* nut, const float2* tw,
               float* out, const Params& p, int B, int F, int len,
               int pos_rows, void* stream) {
  static int allowed[kMaxDevices] = {0};
  constexpr int KP = (N / 2 + 1 + 3) & ~3;
  const int smem = 8 * N + 12 * KP;  // Z [N] float2, three rows [KP]
  const int err = allow_smem(d4c_kernel<N>, allowed, smem);
  if (err != 0) return err;
  d4c_kernel<N><<<B * F, threads_for(N), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      x, f0, pos, off, nut, tw, out, p, F, len, pos_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, T]; f0 [B, F]; pos [F] (pos_rows 0) or [B, F] (1); off [B] (or
// NULL); nut [wl]; tw [fft] (cos, -sin) pairs; out [B, F, Ko]; ip and fp
// host tables (ops/d4c_kernel.kernel_params).
extern "C" int wt_d4c(const float* x, const float* f0, const float* pos,
                      const long long* off, const float* nut,
                      const float* tw, float* out, const int* ip,
                      const float* fp, int B, int F, int T, int pos_rows,
                      void* stream) {
  if (B <= 0 || F <= 0) return 0;
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int i = 0; i < kInts; ++i) p.i[i] = ip[i];
  for (int i = 0; i < kFloats; ++i) p.f[i] = fp[i];
  if (p.i[kNap] > kMaxBands || p.i[kDcLen] < 2 ||
      (p.i[kNLt] != p.i[kN] && 2 * p.i[kNLt] != p.i[kN]) ||
      p.i[kB2] > p.i[kNLt] / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* t2 = reinterpret_cast<const float2*>(tw);
#define WT_D4C_CASE(n)                                                      \
  case n:                                                                  \
    return launch_d4c<n>(x, f0, pos, off, nut, t2, out, p, B, F, T,        \
                         pos_rows, stream);
  switch (p.i[kN]) {
    WT_D4C_CASE(2048)
    WT_D4C_CASE(4096)
    WT_D4C_CASE(8192)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WT_D4C_CASE
}
