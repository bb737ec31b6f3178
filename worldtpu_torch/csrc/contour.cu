// The data-dependent loops of the Harvest contour chain on the device: the
// section filter and merge of fixF0Contour's step 3 (wt_contour_merge) and
// the per-section zero-lag smoothing of smoothF0Contour
// (wt_contour_smooth).  Reference: src/harvest.cpp:427-536 and :639-703.
//
// No TPU kernel stands behind either.  Each replaces a JAX loop of the
// JAX package's device chain (worldtpu/analysis/contour_device.py): kernel
// A the lax.scan of the section means and the lax.while_loop of the merge
// (:356-405), kernel B the lax.while_loop over 32-section chunks of the
// smoothing (:497-547).  The port ran each loop as a host read of the
// batch's section count and a Python loop of masked torch steps; as kernels
// the chain reads nothing back, so the main path can be captured as a CUDA
// graph.  They follow the plain versions in ops/contour_kernel.py.
//
// Kernel A, wt_contour_merge: one block per utterance.
//   - Section k's channel is never stored.  At frame j it is the extend
//     walk's accepted value if j lies on the ON prefix of one of its two
//     walks (forward from ed[k], walk k; backward from st[k], walk S + k),
//     else f0[j] inside its own run [st[k], ed[k]], else 0; its score
//     shadow is the walk's score, else ss_run[j] in the run, else
//     ss_zero[j].  The walks visit fresh frames on either side of the run,
//     so the three cases never overlap.
//   - Section sums: the channel is 0 before st2 = so[S + k], so the plain
//     version's cumulative-sum difference csum[ed2] - csum[st2] is the sum
//     of [st2, ed2) in frame order.  torch.cumsum of float32 on the CPU
//     accumulates in double and rounds each prefix once, so one thread per
//     section sums in double in frame order and rounds once: the CPU plain
//     version's bits.
//   - One thread then scans the live sections in order (the running mean
//     without reset, harvest.cpp:446-452, in float32 with true divisions),
//     keeps a section when c_len / mean < length, and inserts the kept
//     sections into a list ordered stably by st2 (argsort(stable=True)).
//   - The merge: the merged row and its score row start as the FIRST kept
//     section's channel (kept order, not start order: the reference's
//     quirk), then each later entry of the ordered list merges in.  Where
//     it neither starts a new section nor is covered, the block sums the
//     two score rows over [i1, b1] (double partial sums in a fixed tree
//     order, rounded to float32 and compared) and takes [b1, i2] or
//     [i1, i2].  Only the frames of the section's own extent are touched.
//   - The two rows sit in shared memory when 8 F bytes fit (F <= 28,000 or
//     so), else in a global scratch the wrapper allocates.
//   What bounds it: not bytes (it reads each walk output and the [F] rows a
//   few times) but the chain of the merge's steps, each a block reduction
//   and a barrier, and the one-thread scan of the section means.
//
// Kernel B, wt_contour_smooth: one block per (section slot, utterance); a
// slot past the utterance's section count exits at once.  A live section's
// first thread runs the reference's filteringF0 on its edge-held signal of
// length n = F + 600 in double, in the operation order of
// csrc/filter_f0.c (built without FMA contraction here too), and rounds
// once: a forward biquad pass, then a second pass over its time-reversed
// output.  The second pass needs the first pass's outputs from the end of
// the signal backwards, and n doubles a section do not fit beside many
// blocks, so the first pass keeps only its state every `chunk` samples
// (shared memory), and the second recomputes one chunk at a time from its
// checkpoint into a shared buffer, last chunk first, down to the section's
// start.  It writes only the frames of its own run: each frame belongs to
// one section, so no atomics.  What bounds it: the dependent chain of
// n + 2 (n - st) recursion steps of the longest section (a double multiply
// and two adds each), not bytes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreadsA = 256;
constexpr int kWarpsA = kThreadsA / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// dynamic shared memory allowed for kernel A, per device (0: not set yet)
int g_merge_smem[kMaxDevices];

// the smoothing biquad (reference smoothF0Contour's b and a)
constexpr double kB0 = 0.0078202080334971724;
constexpr double kB1 = 0.015640416066994345;
constexpr double kA0 = 1.7347257688092754;
constexpr double kA1 = -0.76600660094326412;

// one utterance's inputs of kernel A
struct Utt {
  const float* f0;
  const float* ss_run;
  const float* ss_zero;
  const long long* st;
  const long long* ed;
  const float* vals;
  const float* scs;
  const long long* n_on;
  const long long* so;
  int S, E;
};

// one section's run and walks
struct Sec {
  int st, ed, nf, nb;
  const float* vf;  // forward walk's values, scores
  const float* sf;
  const float* vb;  // backward walk's
  const float* sb;
};

__device__ __forceinline__ Sec load_sec(const Utt& u, int k) {
  Sec s;
  s.st = static_cast<int>(u.st[k]);
  s.ed = static_cast<int>(u.ed[k]);
  s.nf = static_cast<int>(u.n_on[k]);
  s.nb = static_cast<int>(u.n_on[u.S + k]);
  s.vf = u.vals + (size_t)k * u.E;
  s.sf = u.scs + (size_t)k * u.E;
  s.vb = u.vals + (size_t)(u.S + k) * u.E;
  s.sb = u.scs + (size_t)(u.S + k) * u.E;
  return s;
}

__device__ __forceinline__ float sec_value(const Sec& s, const Utt& u,
                                           int j) {
  if (j > s.ed) {
    const int t = j - s.ed - 1;
    return t < s.nf ? s.vf[t] : 0.0f;
  }
  if (j < s.st) {
    const int t = s.st - j - 1;
    return t < s.nb ? s.vb[t] : 0.0f;
  }
  return u.f0[j];
}

__device__ __forceinline__ float sec_score(const Sec& s, const Utt& u,
                                           int j) {
  if (j > s.ed) {
    const int t = j - s.ed - 1;
    return t < s.nf ? s.sf[t] : u.ss_zero[j];
  }
  if (j < s.st) {
    const int t = s.st - j - 1;
    return t < s.nb ? s.sb[t] : u.ss_zero[j];
  }
  return u.ss_run[j];
}

// sum of a and b over the block, in a fixed order; every thread gets it
__device__ __forceinline__ void block_sum2(double& a, double& b,
                                           double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(kFull, a, o);
    b += __shfl_down_sync(kFull, b, o);
  }
  const int w = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red[2 * w] = a;
    red[2 * w + 1] = b;
  }
  __syncthreads();
  a = 0.0;
  b = 0.0;
#pragma unroll
  for (int i = 0; i < kWarpsA; ++i) {
    a += red[2 * i];
    b += red[2 * i + 1];
  }
  __syncthreads();  // red is free for the next call
}

__global__ void __launch_bounds__(kThreadsA)
    merge_kernel(Utt u0, const long long* __restrict__ n_sec,
                 float* __restrict__ out, float* __restrict__ ssum,
                 unsigned char* __restrict__ keep, int* __restrict__ order,
                 float* __restrict__ rows_g, float* __restrict__ s1_out,
                 float* __restrict__ s2_out, int F, float c_len) {
  extern __shared__ float rows_s[];  // [2F] unless rows_g
  __shared__ double red[2 * kWarpsA];
  __shared__ int sh_nch, sh_first;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int S = u0.S, E = u0.E;
  Utt u = u0;
  u.f0 += (size_t)b * F;
  u.ss_run += (size_t)b * F;
  u.ss_zero += (size_t)b * F;
  u.st += (size_t)b * S;
  u.ed += (size_t)b * S;
  u.vals += (size_t)b * 2 * S * E;
  u.scs += (size_t)b * 2 * S * E;
  u.n_on += (size_t)b * 2 * S;
  u.so += (size_t)b * 2 * S;
  float* o = out + (size_t)b * F;
  float* sm = ssum + (size_t)b * S;
  unsigned char* kp = keep ? keep + (size_t)b * S : nullptr;
  int* ord = order + (size_t)b * S;
  float* s1b = s1_out ? s1_out + (size_t)b * S : nullptr;
  float* s2b = s2_out ? s2_out + (size_t)b * S : nullptr;

  const long long ns = n_sec[b];
  const int nl = ns < S ? static_cast<int>(ns) : S;
  for (int k = tid; k < S; k += kThreadsA) {
    sm[k] = 0.0f;
    if (kp) kp[k] = 0;
    if (s1b) {
      s1b[k] = NAN;
      s2b[k] = NAN;
    }
  }
  if (ns <= 0) {
    for (int j = tid; j < F; j += kThreadsA) o[j] = u.f0[j];
    return;
  }

  // section sums over [st2, ed2), in frame order, in double
  for (int k = tid; k < nl; k += kThreadsA) {
    const Sec s = load_sec(u, k);
    const int st2 = static_cast<int>(u.so[S + k]);
    const int ed2 = static_cast<int>(u.so[k]);
    double acc = 0.0;
    for (int j = st2; j < ed2; ++j) acc += (double)sec_value(s, u, j);
    sm[k] = (float)acc;
  }
  __syncthreads();

  // the running mean (no reset), the keep decision, the stable start order
  if (tid == 0) {
    float m = 0.0f;
    int n_ch = 0, first = 0;
    for (int k = 0; k < nl; ++k) {
      const int st2 = static_cast<int>(u.so[S + k]);
      const float len = (float)(static_cast<int>(u.so[k]) - st2);
      m = (m + sm[k]) / len;
      if (c_len / m < len) {
        if (kp) kp[k] = 1;
        if (n_ch == 0) first = k;
        int i = n_ch++;
        while (i > 0 && u.so[S + ord[i - 1]] > st2) {
          ord[i] = ord[i - 1];
          --i;
        }
        ord[i] = k;
      }
    }
    sh_nch = n_ch;
    sh_first = first;
  }
  __syncthreads();
  const int n_ch = sh_nch;
  if (n_ch == 0) {  // the first section's channel, extended
    const Sec s = load_sec(u, 0);
    for (int j = tid; j < F; j += kThreadsA) o[j] = sec_value(s, u, j);
    return;
  }

  float* mrg = rows_g ? rows_g + (size_t)b * 2 * F : rows_s;
  float* mss = mrg + F;
  const int first = sh_first;
  {
    const Sec s = load_sec(u, first);
    for (int j = tid; j < F; j += kThreadsA) {
      mrg[j] = sec_value(s, u, j);
      mss[j] = sec_score(s, u, j);
    }
  }
  int b0 = static_cast<int>(u.so[S + first]);
  int b1 = static_cast<int>(u.so[first]);
  __syncthreads();
  for (int i = 1; i < n_ch; ++i) {
    const int k = ord[i];
    const Sec s = load_sec(u, k);
    const int i1 = static_cast<int>(u.so[S + k]);
    const int i2 = static_cast<int>(u.so[k]);
    const bool fresh = i1 - b1 > 0;
    const bool covered = b0 <= i1 && b1 >= i2;
    int lo = i1;
    if (!fresh && !covered) {
      double p1 = 0.0, p2 = 0.0;
      for (int j = i1 + tid; j <= b1; j += kThreadsA) {
        p1 += (double)mss[j];
        p2 += (double)sec_score(s, u, j);
      }
      block_sum2(p1, p2, red);
      const float s1 = (float)p1, s2 = (float)p2;
      if (s1 > s2) lo = b1;
      if (tid == 0 && s1b) {
        s1b[i] = s1;
        s2b[i] = s2;
      }
    }
    if (fresh || !covered) {
      for (int j = lo + tid; j <= i2; j += kThreadsA) {
        mrg[j] = sec_value(s, u, j);
        mss[j] = sec_score(s, u, j);
      }
    }
    if (fresh) b0 = i1;
    if (fresh || !covered) b1 = i2;
    __syncthreads();
  }
  for (int j = tid; j < F; j += kThreadsA) o[j] = mrg[j];
}

__global__ void __launch_bounds__(32)
    smooth_kernel(const float* __restrict__ f0,
                  const long long* __restrict__ st,
                  const long long* __restrict__ ed,
                  const long long* __restrict__ n_sec,
                  float* __restrict__ out, int F, int n, int NS, int lag,
                  int chunk) {
  extern __shared__ double sh[];  // checkpoints (w0, w1), then a chunk
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  if (k >= n_sec[b] || threadIdx.x != 0) return;
  const int n_ck = (n + chunk - 1) / chunk;
  double* ck = sh;
  double* buf = sh + 2 * n_ck;
  const int s = static_cast<int>(st[(size_t)b * NS + k]);
  const int e = static_cast<int>(ed[(size_t)b * NS + k]);
  const float* x = f0 + (size_t)b * F - lag;  // x[j]: padded frame j
  float* o = out + (size_t)b * F - lag;
  const double xs = (double)x[s], xe = (double)x[e];

  // first pass: the state at every chunk start
  double w0 = 0.0, w1 = 0.0;
  for (int c = 0; c < n_ck; ++c) {
    ck[2 * c] = w0;
    ck[2 * c + 1] = w1;
    const int i1 = min(n, (c + 1) * chunk);
#pragma unroll 4
    for (int i = c * chunk; i < i1; ++i) {
      const double xi = i < s ? xs : (i > e ? xe : (double)x[i]);
      const double wt = xi + kA0 * w0 + kA1 * w1;
      w1 = w0;
      w0 = wt;
    }
  }
  // second pass over the first pass's outputs, last first, down to s
  double v0 = 0.0, v1 = 0.0;
  for (int c = n_ck - 1; c >= 0 && (c + 1) * chunk > s; --c) {
    const int i0 = c * chunk;
    const int i1 = min(n, i0 + chunk);
    w0 = ck[2 * c];
    w1 = ck[2 * c + 1];
    for (int i = i0; i < i1; ++i) {
      const double xi = i < s ? xs : (i > e ? xe : (double)x[i]);
      const double wt = xi + kA0 * w0 + kA1 * w1;
      buf[i - i0] = kB0 * wt + kB1 * w0 + kB0 * w1;
      w1 = w0;
      w0 = wt;
    }
    for (int i = i1 - 1; i >= i0 && i >= s; --i) {
      const double zt = buf[i - i0] + kA0 * v0 + kA1 * v1;
      const double z = kB0 * zt + kB1 * v0 + kB0 * v1;
      v1 = v0;
      v0 = zt;
      if (i <= e) o[i] = (float)z;
    }
  }
}

}  // namespace

// rows == NULL: the merged rows in shared memory (8 F bytes, which the
// wrapper has checked fit); else in rows [B, 2, F].  ssum [B, S] holds the
// section sums the running mean reads; keep, s1 and s2 (the trace) may
// be NULL.
extern "C" int wt_contour_merge(const float* f0, const float* ss_run,
                                const float* ss_zero, const long long* st,
                                const long long* ed, const long long* n_sec,
                                const float* vals, const float* scs,
                                const long long* n_on, const long long* so,
                                float* out, float* ssum, unsigned char* keep,
                                int* order, float* rows, float* s1, float* s2,
                                int B, int F, int S, int E, float c_len,
                                void* stream) {
  if (B <= 0 || F <= 0) return 0;
  const int smem = rows ? 0 : 2 * F * (int)sizeof(float);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    int once = 0;
    int& allowed = dev < kMaxDevices ? g_merge_smem[dev] : once;
    if (smem > allowed) {
      err = cudaFuncSetAttribute(
          merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
  }
  const Utt u = {f0, ss_run, ss_zero, st, ed, vals, scs, n_on, so, S, E};
  merge_kernel<<<B, kThreadsA, smem, static_cast<cudaStream_t>(stream)>>>(
      u, n_sec, out, ssum, keep, order, rows, s1, s2, F, c_len);
  return static_cast<int>(cudaGetLastError());
}

// chunk: samples between the first pass's checkpoints; the wrapper keeps
// (2 ceil(n / chunk) + chunk) doubles within 48 KB.
extern "C" int wt_contour_smooth(const float* f0, const long long* st,
                                 const long long* ed, const long long* n_sec,
                                 float* out, int B, int F, int n, int NS,
                                 int lag, int chunk, void* stream) {
  if (B <= 0 || NS <= 0) return 0;
  const int n_ck = (n + chunk - 1) / chunk;
  const size_t smem = sizeof(double) * (2 * (size_t)n_ck + chunk);
  smooth_kernel<<<dim3(NS, B), 32, smem,
                  static_cast<cudaStream_t>(stream)>>>(f0, st, ed, n_sec, out,
                                                       F, n, NS, lag, chunk);
  return static_cast<int>(cudaGetLastError());
}
