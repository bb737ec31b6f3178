// Per-pulse impulse responses of the synthesis (synthesis.pulse_responses,
// reference src/synthesis.cpp:308-393).
//
// Replaces no Pallas kernel: the JAX package leaves the pulse responses
// (worldtpu/synthesis/synthesis.py pulse_responses) to XLA.  In the port
// they were a chain of ~250 PyTorch operations, each over the whole static
// pulse capacity [B, P, fft] (doubled to [B, 2P, fft] for the minimum phase
// and the inverse FFT), each writing its result to device memory: ~35 GB of
// intermediates a batch of eight 3.2 s utterances at 48 kHz (fft 2,048,
// P = 3,842, ~36% of the pulses real), which kept the stage memory-bound
// at ~1% of its own bound.  This kernel was added to keep those
// intermediates in shared memory and to skip the padded pulses.
//
// For each pulse g = b * P + p, one block:
//   - a padded pulse (!valid[g]) writes its zero row and ends;
//   - the noise: the first ns samples of its row, less their mean, as a
//     real sequence packed into fft/2 complex values; one fft/2-point FFT
//     and the split into the real sequence's spectrum;
//   - the spectral rows fl and ce of |spectrogram| and of the clamped
//     aperiodicity, interpolated, the aperiodicity squared; the voicing
//     gate per_on from bin 0.  These products and sums are rounded one at a
//     time (__fmul_rn / __fadd_rn), as the plain version's tensor
//     operations round them: the gate is a knife edge and switches exactly
//     as there;
//   - the two half log spectra (periodic and aperiodic) are real and even:
//     one complex inverse FFT of (log_per + i log_ap) gives both cepstra as
//     its real and imaginary parts; the causal fold; one forward FFT gives
//     both folded spectra, split by the conjugate symmetry, and their
//     complex exp gives the two minimum-phase spectra;
//   - the phase: re2 = clamp(cos(coeff * k), -1, 1) by the plain version's
//     seed-and-rotate form (ops/trig.cos_affine: cos and sin of the 128-bin
//     block's angle and of the offset in it, combined with separately
//     rounded products), im2 = -sqrt(1 - re2^2) (the reference's |sin|);
//   - the periodic spectrum mp_per * phase and the aperiodic mp_ap * noise
//     spectrum are Hermitian spectra of real signals: one complex inverse
//     FFT of (periodic + i aperiodic) gives both; as irfft, the imaginary
//     parts of bins 0 and fft/2 are left out;
//   - the fftshift, the DC removal (dc_remover's table, the periodic
//     half's sum by a block reduction), the per_on mask and
//     (per * sqrt(ns) + aper) / fft, written with 16-byte stores.
// The FFTs are radix-4 Stockham passes (one radix-2 pass first where
// log2 n is odd) in shared memory: each thread loads its butterflies'
// inputs into registers, the block synchronizes, and the outputs go back to
// the same buffer.  Twiddles come from a table of exp(-2 pi i m / fft),
// m < fft, computed in double and rounded once to float.  The kernel is a
// template on fft (256 ... 16,384), with fft / 8 threads (128 to 1,024), so
// a thread holds two radix-4 butterflies of an fft-point transform (four at
// 16,384).  Shared memory: 12 fft bytes (16 KB ... 192 KB; opt-in above
// 48 KB).
//
// What bounds it on the H100: bytes.  Each real pulse reads two rows of
// each spectral array (4 x (fft/2 + 1) floats) and its ns noise samples
// and writes its row (fft floats); a padded pulse writes its zero row.  At
// the 48 kHz cell's batch (~11,000 real pulses of 30,736) that is
// ~0.45 GB, ~0.13 ms at 3.35 TB/s; the operations (three fft-point and one
// fft/2-point complex FFTs, ~fft logs and exps a pulse) are ~5 GFLOP,
// ~0.08 ms at 67 TFLOP/s.  Only those bytes reach device memory; the FFT
// passes run at shared-memory bandwidth, with several blocks resident on
// each SM to hide the barriers.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 16;
constexpr int kQ = 128;  // ops/trig.cos_affine's block of bins
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float2 cexp(float2 a) {
  const float e = expf(a.x);
  return make_float2(e * cosf(a.y), e * sinf(a.y));
}

// torch.clamp(x, lo, hi): a NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// In-place unnormalized DFT of x[0, n) in shared memory: forward
// (exp(-2 pi i jk / n)) or, with kInv, inverse (exp(+2 pi i jk / n)).  tw[m]
// = exp(-2 pi i m / (n << shift)).  Stockham passes: a pass of radix R over
// sub-sequences of length p takes inputs x[i + j n/R], j < R, twiddles them
// by exp(-+2 pi i j k / (R p)), k = i mod p, and writes its R-point DFT to
// x[(i - k) R + k + j p]; the output comes in natural order.
template <int n, int T, bool kInv>
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
          for (int j = 1; j < 4; ++j) {
            float2 w = __ldg(tw + j * m);
            if (kInv) w.y = -w.y;
            v[u][j] = cmul(v[u][j], w);
          }
        }
        const float2 a0 = cadd(v[u][0], v[u][2]);
        const float2 a1 = csub(v[u][0], v[u][2]);
        const float2 a2 = cadd(v[u][1], v[u][3]);
        const float2 d = csub(v[u][1], v[u][3]);
        // d * -i forward, d * +i inverse
        const float2 a3 = kInv ? make_float2(-d.y, d.x)
                               : make_float2(d.y, -d.x);
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

// Sum of every thread's v, the same value in every thread (the warps'
// partial sums added in warp order).  scratch: 32 floats.
template <int T>
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) s += scratch[w];
  __syncthreads();  // scratch free again
  return s;
}

template <int N>
__global__ void __launch_bounds__(threads_for(N))
pulse_kernel(const float* __restrict__ pt, const float* __restrict__ shift,
             const long long* __restrict__ ns,
             const float* __restrict__ vuv, const bool* __restrict__ valid,
             const float* __restrict__ spec, const float* __restrict__ aper,
             const float* __restrict__ noise,
             const long long* __restrict__ frame_offset,
             const float2* __restrict__ tw, const float* __restrict__ dcr,
             float* __restrict__ out, int P, int F, long long off0,
             float coeff_scale) {
  constexpr int T = threads_for(N);
  constexpr int H = N / 2;
  constexpr int K = H + 1;
  constexpr int kNq = (K + kQ - 1) / kQ;
  extern __shared__ float2 smem[];
  float2* X = smem;      // [N]: the cepstra, the spectra, the responses
  float2* Y = smem + N;  // [H]: the noise, then its spectrum
  __shared__ float2 cq[kNq];  // (cos, sin)(coeff * 128 q)
  __shared__ float2 cr[kQ];   // (cos, sin)(coeff * r)
  __shared__ float scratch[32];
  __shared__ int gate;

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  float4* o4 = reinterpret_cast<float4*>(out + g * N);
  if (!valid[g]) {
    for (int i = tid; i < N / 4; i += T)
      o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int b = static_cast<int>(g / P);

  // ---- the noise: its first ns samples less their mean ----
  const long long m = ns[g];
  const int cnt = static_cast<int>(m < 0 ? 0 : (m > N ? N : m));
  const float2* nrow = reinterpret_cast<const float2*>(noise + g * N);
  float part = 0.f;
  for (int i = tid; i < H; i += T) {
    float2 v = make_float2(0.f, 0.f);
    if (2 * i < cnt) {
      v = nrow[i];
      if (2 * i + 1 >= cnt) v.y = 0.f;
    }
    part += v.x + v.y;
    Y[i] = v;
  }
  const float mean = __fdiv_rn(block_sum<T>(part, scratch),
                               static_cast<float>(m < 1 ? 1 : m));
  for (int i = tid; i < H; i += T) {
    const float2 v = Y[i];
    Y[i] = make_float2(2 * i < cnt ? v.x - mean : 0.f,
                       2 * i + 1 < cnt ? v.y - mean : 0.f);
  }
  __syncthreads();
  fft_shared<H, T, false>(Y, tw, 1);
  // Z = FFT(z), z[i] = x[2i] + i x[2i+1]: with E = (Z[k] + conj Z[H-k]) / 2
  // and O = (Z[k] - conj Z[H-k]) / 2i the real x's spectrum is
  // S[k] = E + W^k O and S[H-k] = conj(E - W^k O), W = exp(-2 pi i / N);
  // Y[0] keeps (S[0], S[H]), both real
  for (int k = tid; k <= H / 2; k += T) {
    const float2 a = Y[k];
    if (k == 0) {
      Y[0] = make_float2(a.x + a.y, a.x - a.y);
    } else {
      const float2 c = Y[H - k];
      const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
      const float2 o = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
      const float2 wo = cmul(__ldg(tw + k), o);
      Y[k] = cadd(e, wo);
      if (k != H / 2) {
        const float2 r = csub(e, wo);
        Y[H - k] = make_float2(r.x, -r.y);
      }
    }
  }

  // ---- the seed-and-rotate cosine's two tables ----
  const float coeff = __fmul_rn(coeff_scale, shift[g]);
  for (int i = tid; i < kQ + kNq; i += T) {
    if (i < kQ) {
      const float a = __fmul_rn(coeff, static_cast<float>(i));
      cr[i] = make_float2(cosf(a), sinf(a));
    } else {
      const float a = __fmul_rn(coeff, static_cast<float>((i - kQ) * kQ));
      cq[i - kQ] = make_float2(cosf(a), sinf(a));
    }
  }

  // ---- the two half log spectra, mirrored: X[k] = log_per + i log_ap ----
  const float ptv = pt[g];
  const long long off = frame_offset != nullptr ? frame_offset[b] : off0;
  const float pfl = floorf(ptv), pce = ceilf(ptv);
  long long fl = static_cast<long long>(static_cast<int>(pfl)) - off;
  long long ce = static_cast<long long>(static_cast<int>(pce)) - off;
  fl = fl < 0 ? 0 : (fl > F - 1 ? F - 1 : fl);
  ce = ce < 0 ? 0 : (ce > F - 1 ? F - 1 : ce);
  const bool same = fl == ce;
  const float w = __fsub_rn(ptv, pfl);
  const float w1 = __fsub_rn(1.f, w);
  const float* s0 = spec + (static_cast<long long>(b) * F + fl) * K;
  const float* s1 = spec + (static_cast<long long>(b) * F + ce) * K;
  const float* a0 = aper + (static_cast<long long>(b) * F + fl) * K;
  const float* a1 = aper + (static_cast<long long>(b) * F + ce) * K;
  const float v_at = vuv[g];
  // the plain version's Python constants, each rounded to float once
  const float ap_lo = static_cast<float>(0.001);
  const float ap_hi = static_cast<float>(0.999999999999);
  const float guard = static_cast<float>(0.000000000001);
  const float gate_at = static_cast<float>(0.999);
  for (int k = tid; k < K; k += T) {
    float sk = fabsf(s0[k]);
    float ak = clampf(a0[k], ap_lo, ap_hi);
    if (!same) {
      sk = __fadd_rn(__fmul_rn(w1, sk), __fmul_rn(w, fabsf(s1[k])));
      ak = __fadd_rn(__fmul_rn(w1, ak),
                     __fmul_rn(w, clampf(a1[k], ap_lo, ap_hi)));
    }
    ak = __fmul_rn(ak, ak);
    if (k == 0) gate = v_at > 0.5f && ak <= gate_at;
    const float lp =
        logf(__fadd_rn(__fmul_rn(sk, __fsub_rn(1.f, ak)), guard)) * 0.5f;
    const float la = (v_at != 0.f ? logf(__fmul_rn(sk, ak)) : logf(sk)) * 0.5f;
    X[k] = make_float2(lp, la);
    if (k > 0 && k < H) X[N - k] = make_float2(lp, la);
  }
  __syncthreads();

  // ---- both cepstra, the causal fold (x1, x2 ..., x1, 0 ...), both
  // folded spectra ----
  fft_shared<N, T, true>(X, tw, 0);
  for (int i = tid; i < N; i += T) {
    const float sc = (i == 0 || i == H) ? 1.f / N : (i < H ? 2.f / N : 0.f);
    X[i] = make_float2(X[i].x * sc, X[i].y * sc);
  }
  __syncthreads();
  fft_shared<N, T, false>(X, tw, 0);

  // ---- the minimum-phase spectra, the phase and the noise spectrum:
  // X[k] = periodic + i aperiodic, X[N-k] its mirror.  A periodic
  // response that the mask or ns = 0 zeroes is left out here, so that its
  // rounding in the shared transform cannot reach the aperiodic one: a
  // response the plain version computes as exactly zero stays zero ----
  const bool per_on = gate != 0;
  const float per_in = per_on && m > 0 ? 1.f : 0.f;
  for (int k = tid; k <= H; k += T) {
    const float2 c = X[k];
    const float re_raw =
        __fsub_rn(__fmul_rn(cq[k / kQ].x, cr[k % kQ].x),
                  __fmul_rn(cq[k / kQ].y, cr[k % kQ].y));
    const float re2 = clampf(re_raw, -1.f, 1.f);
    const float2 ph =
        make_float2(re2, -sqrtf(__fsub_rn(1.f, __fmul_rn(re2, re2))));
    if (k == 0 || k == H) {
      // bins 0 and N/2: only the real parts reach the real signals
      const float per = cmul(make_float2(expf(c.x), 0.f), ph).x * per_in;
      const float ap = expf(c.y) * (k == 0 ? Y[0].x : Y[0].y);
      X[k] = make_float2(per, ap);
    } else {
      const float2 d = X[N - k];
      const float2 lper = make_float2(0.5f * (c.x + d.x), 0.5f * (c.y - d.y));
      const float2 lap = make_float2(0.5f * (c.y + d.y), -0.5f * (c.x - d.x));
      float2 per = cmul(cexp(lper), ph);
      per = make_float2(per.x * per_in, per.y * per_in);
      const float2 ap = cmul(cexp(lap), Y[k]);
      X[k] = make_float2(per.x - ap.y, per.y + ap.x);
      X[N - k] = make_float2(per.x + ap.y, ap.x - per.y);
    }
  }
  __syncthreads();

  // ---- both responses: real part periodic, imaginary part aperiodic ----
  fft_shared<N, T, true>(X, tw, 0);
  float dpart = 0.f;
  for (int i = tid; i < H; i += T) dpart += X[i].x;
  const float dc = block_sum<T>(dpart, scratch);
  const float sq = sqrtf(static_cast<float>(m));
  const float inv = 1.f / N;
  for (int i = tid; i < N / 4; i += T) {
    float r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = 4 * i + u;  // fftshift: sample n is X[(n + H) % N]
      float per, ap;
      if (n < H) {
        per = __fmul_rn(-dc, __ldg(dcr + n));
        ap = X[n + H].y;
      } else {
        per = __fsub_rn(X[n - H].x, __fmul_rn(dc, __ldg(dcr + n - H)));
        ap = X[n - H].y;
      }
      if (!per_on) per = 0.f;
      r[u] = __fmul_rn(__fadd_rn(__fmul_rn(per, sq), ap), inv);
    }
    o4[i] = make_float4(r[0], r[1], r[2], r[3]);
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
int launch_pulse(const float* pt, const float* shift, const long long* ns,
                 const float* vuv, const bool* valid, const float* spec,
                 const float* aper, const float* noise,
                 const long long* frame_offset, const float2* tw,
                 const float* dcr, float* out, int B, int P, int F,
                 long long off0, float coeff_scale, void* stream) {
  static int allowed[kMaxDevices] = {0};
  const int smem = 12 * N;  // X [N] and Y [N/2] float2
  const int err = allow_smem(pulse_kernel<N>, allowed, smem);
  if (err != 0) return err;
  pulse_kernel<N><<<B * P, threads_for(N), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      pt, shift, ns, vuv, valid, spec, aper, noise, frame_offset, tw, dcr,
      out, P, F, off0, coeff_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frame_offset [B] (or NULL: off0 for every row); tw [fft] (cos, -sin)
// pairs; dcr [fft / 2]; out [B, P, fft].
extern "C" int wt_pulse_resp(const float* pt, const float* shift,
                             const long long* ns, const float* vuv,
                             const bool* valid, const float* spec,
                             const float* aper, const float* noise,
                             const long long* frame_offset, const float* tw,
                             const float* dcr, float* out, int B, int P,
                             int F, int fft, long long off0,
                             float coeff_scale, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  const float2* t2 = reinterpret_cast<const float2*>(tw);
#define WT_PULSE_CASE(n)                                                    \
  case n:                                                                  \
    return launch_pulse<n>(pt, shift, ns, vuv, valid, spec, aper, noise,   \
                           frame_offset, t2, dcr, out, B, P, F, off0,      \
                           coeff_scale, stream);
  switch (fft) {
    WT_PULSE_CASE(256)
    WT_PULSE_CASE(512)
    WT_PULSE_CASE(1024)
    WT_PULSE_CASE(2048)
    WT_PULSE_CASE(4096)
    WT_PULSE_CASE(8192)
    WT_PULSE_CASE(16384)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WT_PULSE_CASE
}
