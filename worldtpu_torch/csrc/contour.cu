// The data-dependent loops of the Harvest contour chain on the device: the
// section filter and merge of fixF0Contour's step 3 (wt_contour_merge) and
// the per-section zero-lag smoothing of smoothF0Contour
// (wt_contour_smooth).  Reference: src/harvest.cpp:427-536 and :639-703.
//
// No TPU kernel stands behind either.  Each replaces a JAX loop of the
// JAX package's device chain (worldtpu/analysis/contour_device.py): kernel
// A the lax.scan of the section means and the lax.while_loop of the merge
// (:356-405), kernel B the lax.while_loop over 32-section chunks of the
// smoothing (:497-547).  As kernels the chain reads nothing back, so the
// main path can be captured as a CUDA graph.  They follow the plain
// versions in ops/contour_kernel.py, and keep the bits of their first
// design (one thread per section for the sums and the smoothing).
//
// Kernel A, wt_contour_merge: one block of 8 warps per utterance.
//   - Section k's channel is never stored.  At frame j it is the extend
//     walk's accepted value if j lies on the ON prefix of one of its two
//     walks (forward from ed[k], walk k; backward from st[k], walk S + k),
//     else f0[j] inside its own run [st[k], ed[k]], else 0; its score
//     shadow is the walk's score, else ss_run[j] in the run, else
//     ss_zero[j].  The walks visit fresh frames on either side of the run,
//     so the three cases never overlap.
//   - Section sums over [st2, ed2) = [so[S + k], so[k]), a warp a section
//     (the whole block for one past kLongSum frames), each lane over its
//     share of the three pieces (backward walk, run, forward walk), in
//     double.  The plain version on the CPU takes csum[ed2] - csum[st2]
//     with torch.cumsum, which accumulates float32 in double in frame
//     order and rounds once (the channel is 0 before st2).  The order is
//     free where every partial sum is exact in double: each nonzero value
//     is a multiple of 2^(emin - 150) (emin its smallest biased exponent,
//     1 for subnormals), each is below 2^(emax - 126), so N terms stay
//     within 2^53 such units when N <= 2^(29 - (emax - emin)).  F0
//     candidates in [40, 800] Hz span emax - emin <= 4, so that holds up
//     to 2^25 frames.  The sum checks it from its reduced exponents; where
//     it fails (a value a caller could pass, far below the others) one
//     thread sums that section in frame order, as the first design did for
//     every section.
//   - Warp 0 then scans the live sections in order, all lanes alike, 32
//     sections' sums and lengths staged in registers and read by shuffles
//     (the running mean without reset, harvest.cpp:446-452, in float32
//     with true divisions), and keeps a section when c_len / mean <
//     length.  The block ranks the kept sections by start, stably:
//     rank_k = #{kept j: st2_j < st2_k or (st2_j == st2_k and j < k)},
//     which is argsort(stable=True).
//   - The merge: the merged row starts as the FIRST kept section's channel
//     (kept order, not start order: the reference's quirk), then each
//     later entry of the ordered list merges in.  The row is held as its
//     sources: for each frame, where the value and score of the section
//     that last wrote it sit (an index into the walk outputs, or the run's
//     f0 and ss_run, or 0 and ss_zero), so a merge step stores one int a
//     frame and loads nothing, and a later read of the row is one shared
//     and one global load a frame.  The steps run on warp 0 alone, 32
//     steps' sections staged in registers at a time, with no block
//     barrier: a contested step sums the two score rows over [i1, b1]
//     (the merged row's and the section's), each lane in double over its
//     frames and a shuffle tree in a fixed order (not the first design's
//     block tree: a decision within rounding of its threshold may go the
//     other way), rounds to float32, compares, and takes [b1, i2] or
//     [i1, i2].  The block then writes the output from the sources; the
//     merge's loops issue 8 frames' loads a lane at once.
//   - The sources sit in shared memory when 4 F bytes fit (F <= 57,856),
//     else in a global scratch the wrapper allocates.  An utterance has a
//     block of its own: a batch of 8 leaves most of the 132 SMs idle
//     either way, and the chain of merge steps is a row's, not a block's.
//   What bounds it: not bytes (it reads each walk output and the [F] rows a
//   few times) but latency.  The first design spent it on the section sums
//   (one thread a section, a dependent global load a frame: 76 of 98 us on
//   the main path, 2.33 of 2.49 ms at F = 60,001), then on the merge
//   steps, each two round trips to L2 and three block barriers.
//
// Kernel B, wt_contour_smooth: a warp per live section.  A persistent grid
// of one-warp blocks (as many as the SMs hold at once, at most the static
// slot count) strides over the batch's live sections, found on the device
// from n_sec; a block with no section left exits.  The warp runs the
// reference's filteringF0 on the section's edge-held signal of length n =
// F + 600 in double, in the operation order of csrc/filter_f0.c (built
// without FMA contraction here too), all 32 lanes alike, and rounds once.
// The output must be those bits, so the recursion stays one dependent
// chain: a parallel-in-time scan, a blocked matmul or the FP64 tensor
// cores (DMMA) would reorder the sums.  What bounds it is that chain's
// length times a step's latency (a double multiply and two adds), not
// bytes.  The design shortens the chain and keeps each step's inputs off
// it:
//   1. Prefix [0, s): the input is the constant x[s].  From zero state the
//      biquad's state reaches an exact periodic orbit (bit for bit, within
//      ~280 steps, of period 1, 4, 6 or 8 for float32 constants in [40,
//      800]).  Every kBlk steps the state is saved and the next kBlk
//      states compared with it; on a match of period p the state at s is
//      the saved one advanced (s - t0) mod p steps.
//   2. Section [s, e]: x staged 32 frames ahead by the lanes and read by
//      shuffles; the forward outputs y[s..e] go to a global scratch row
//      [B, n] (sections are disjoint, so the row is the batch's), 32 at a
//      time, from the lane that holds each.
//   3. Tail (e, n): the input is the constant x[e]; its outputs go to a
//      shared buffer of `cap` doubles while the orbit is sought the same
//      way.  Past the orbit's start i0 the outputs repeat with its period.
//   4. Backward from n - 1: over [i0, n) the input is periodic and known;
//      the backward state (with the input's phase) is saved every kBlk
//      steps and matched the same way, a cycle whose length is a multiple
//      of the input's period; then the state after i0 is the saved one
//      advanced.  Then (e, i0) from the shared buffer and [s, e] from the
//      scratch row, staged 32 frames ahead, writing frames [s, e] only
//      (each frame belongs to one section: no atomics).
//   5. Where no orbit or cycle shows within `cap` steps (or before the
//      stretch ends), that stretch runs in full, in this kernel, with the
//      same bits: the prefix to s; the tail to n keeping its state every
//      `chunk` steps in shared memory, and the second pass recomputing a
//      chunk at a time from those checkpoints (the first design's scheme,
//      for that range only); the backward periodic stretch step by step.
//      An optional trace records, per section, the steps run and which
//      shortcuts hit.
// A section's chain falls from the first design's n + 2 (n - s) steps to
// about 2 (e - s) + 1,100.  Why a warp per section and not a lane: lanes
// of one warp on different sections would sit in different stretches of
// their chains and serialize each other's branches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreadsA = 256;
constexpr int kWarpsA = kThreadsA / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// dynamic shared memory allowed for kernels A and B, per device (0: not
// set yet)
int g_merge_smem[kMaxDevices];
int g_smooth_smem[kMaxDevices];

// the smoothing biquad (reference smoothF0Contour's b and a)
constexpr double kB0 = 0.0078202080334971724;
constexpr double kB1 = 0.015640416066994345;
constexpr double kA0 = 1.7347257688092754;
constexpr double kA1 = -0.76600660094326412;
// kernel A: a section sum over more frames than this takes the block
constexpr int kLongSum = 2048;
// kernel B: steps between the saved states that orbits and cycles are
// matched against (the longest period it finds)
constexpr int kBlk = 16;
// kernel B's trace flags, per section
constexpr int kPrefixOrbit = 1;  // the prefix jumped on its orbit
constexpr int kTailOrbit = 2;    // the tail's orbit was found
constexpr int kBackCycle = 4;    // the backward periodic stretch jumped
constexpr int kPrefixFull = 8;   // the prefix ran in full (s > 0)
constexpr int kTailFull = 16;    // the tail ran in full, checkpointed
constexpr int kBackFull = 32;    // the backward periodic stretch in full

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

// one section's run, walk lengths and walk values
struct Sec {
  int st, ed, nf, nb;
  const float* vf;  // the forward walk's values
  const float* vb;  // the backward walk's
};

__device__ __forceinline__ Sec make_sec(const Utt& u, int k, int st, int ed,
                                        int nf, int nb) {
  Sec s;
  s.st = st;
  s.ed = ed;
  s.nf = nf;
  s.nb = nb;
  s.vf = u.vals + (size_t)k * u.E;
  s.vb = u.vals + (size_t)(u.S + k) * u.E;
  return s;
}

__device__ __forceinline__ Sec load_sec(const Utt& u, int k) {
  return make_sec(u, k, static_cast<int>(u.st[k]), static_cast<int>(u.ed[k]),
                  static_cast<int>(u.n_on[k]),
                  static_cast<int>(u.n_on[u.S + k]));
}

// where section k's channel sits at frame j, as a code: the index of its
// walk output (>= 0, into vals and scs), kRun (f0[j] and ss_run[j]) or
// kZero (0 and ss_zero[j]); chosen without a branch
constexpr int kRun = -1;
constexpr int kZero = -2;

__device__ __forceinline__ int source(const Sec& s, const Utt& u, int k,
                                      int j) {
  const int tf = j - s.ed - 1, tb = s.st - j - 1;
  return j > s.ed ? (tf < s.nf ? k * u.E + tf : kZero)
                  : (j < s.st ? (tb < s.nb ? (u.S + k) * u.E + tb : kZero)
                              : kRun);
}

__device__ __forceinline__ const float* score_of(int c, const Utt& u,
                                                int j) {
  return c >= 0 ? u.scs + c : (c == kRun ? u.ss_run + j : u.ss_zero + j);
}

__device__ __forceinline__ float value_of(int c, const Utt& u, int j) {
  return c >= 0 ? u.vals[c] : (c == kRun ? u.f0[j] : 0.0f);
}

// frames a lane loads at once in the merge's batched loops
constexpr int kBatch = 8;

// a section sum's term: the double sum and the biased exponent range of
// the nonzero values (subnormals count as exponent 1)
__device__ __forceinline__ void add_term(float v, double& acc, int& emin,
                                         int& emax) {
  acc += (double)v;
  const int ex = (__float_as_int(v) >> 23) & 0xff;
  emin = min(emin, v != 0.0f ? max(ex, 1) : 256);
  emax = max(emax, v != 0.0f ? ex : -1);
}

// lane 0's sum of a over the warp, in a fixed order
__device__ __forceinline__ double warp_sum(double a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(kFull, a, o);
  return a;
}

// a section sum's terms over [st2, ed2) from index `from` in strides of
// `step`: its three pieces (backward walk, run, forward walk)
__device__ __forceinline__ void section_terms(const Sec& s, const Utt& u,
                                              int st2, int ed2, int from,
                                              int step, double& acc,
                                              int& emin, int& emax) {
  // the backward walk: frame st - 1 - t
  const int tb1 = min(s.nb - 1, s.st - 1 - st2);
#pragma unroll 8
  for (int t = max(0, s.st - ed2) + from; t <= tb1; t += step)
    add_term(s.vb[t], acc, emin, emax);
  // the run
  const int jr1 = min(s.ed, ed2 - 1);
#pragma unroll 8
  for (int j = max(s.st, st2) + from; j <= jr1; j += step)
    add_term(u.f0[j], acc, emin, emax);
  // the forward walk: frame ed + 1 + t
  const int tf1 = min(s.nf, ed2 - s.ed - 1);
#pragma unroll 8
  for (int t = max(0, st2 - s.ed - 1) + from; t < tf1; t += step)
    add_term(s.vf[t], acc, emin, emax);
}

// section k's sum once its terms are reduced: in any order where every
// partial sum is exact in double, else in frame order (lane 0's caller)
__device__ __forceinline__ bool sum_is_exact(int n, int emin, int emax) {
  const int d = emax - emin;
  return emax < 0 || n <= 0 ||
         (emax < 255 && d <= 29 && n <= (1 << (29 - d)));
}

__device__ __forceinline__ float frame_order_sum(const Sec& s, const Utt& u,
                                                 int k, int st2, int ed2) {
  double acc = 0.0;
  for (int j = st2; j < ed2; ++j)
    acc += (double)value_of(source(s, u, k, j), u, j);
  return (float)acc;
}

__global__ void __launch_bounds__(kThreadsA)
    merge_kernel(Utt u0, const long long* __restrict__ n_sec,
                 float* __restrict__ out, float* __restrict__ ssum,
                 unsigned char* __restrict__ keep, int* __restrict__ order,
                 int* __restrict__ src_g, float* __restrict__ s1_out,
                 float* __restrict__ s2_out,
                 unsigned char* __restrict__ ordered, int F, float c_len) {
  extern __shared__ int src_s[];  // [F] unless src_g
  __shared__ double red[kWarpsA];
  __shared__ int red_e[2 * kWarpsA];
  __shared__ int sh_nch, sh_first;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
  unsigned char* kp = keep + (size_t)b * S;
  int* ord = order + (size_t)b * S;
  float* s1b = s1_out ? s1_out + (size_t)b * S : nullptr;
  float* s2b = s2_out ? s2_out + (size_t)b * S : nullptr;
  unsigned char* sq = ordered ? ordered + (size_t)b * S : nullptr;

  const long long ns = n_sec[b];
  const int nl = ns < S ? static_cast<int>(ns) : S;
  for (int k = tid; k < S; k += kThreadsA) {
    if (k >= nl) {
      sm[k] = 0.0f;
      if (sq) sq[k] = 0;
    }
    kp[k] = 0;
    if (s1b) {
      s1b[k] = NAN;
      s2b[k] = NAN;
    }
  }
  if (ns <= 0) {
    for (int j = tid; j < F; j += kThreadsA) o[j] = u.f0[j];
    return;
  }

  // section sums over [st2, ed2): a warp a section, a long one the block
  for (int k = warp; k < nl; k += kWarpsA) {
    const int st2 = static_cast<int>(u.so[S + k]);
    const int ed2 = static_cast<int>(u.so[k]);
    if (ed2 - st2 > kLongSum) continue;
    const Sec s = load_sec(u, k);
    double acc = 0.0;
    int emin = 256, emax = -1;
    section_terms(s, u, st2, ed2, lane, 32, acc, emin, emax);
    acc = warp_sum(acc);
    emin = __reduce_min_sync(kFull, emin);
    emax = __reduce_max_sync(kFull, emax);
    if (lane == 0) {
      const bool exact = sum_is_exact(ed2 - st2, emin, emax);
      sm[k] = exact ? (float)acc : frame_order_sum(s, u, k, st2, ed2);
      if (sq) sq[k] = !exact;
    }
  }
  for (int k = 0; k < nl; ++k) {
    const int st2 = static_cast<int>(u.so[S + k]);
    const int ed2 = static_cast<int>(u.so[k]);
    if (ed2 - st2 <= kLongSum) continue;
    const Sec s = load_sec(u, k);
    double acc = 0.0;
    int emin = 256, emax = -1;
    section_terms(s, u, st2, ed2, tid, kThreadsA, acc, emin, emax);
    acc = warp_sum(acc);
    emin = __reduce_min_sync(kFull, emin);
    emax = __reduce_max_sync(kFull, emax);
    if (lane == 0) {
      red[warp] = acc;
      red_e[2 * warp] = emin;
      red_e[2 * warp + 1] = emax;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarpsA; ++w) {
        acc += red[w];
        emin = min(emin, red_e[2 * w]);
        emax = max(emax, red_e[2 * w + 1]);
      }
      const bool exact = sum_is_exact(ed2 - st2, emin, emax);
      sm[k] = exact ? (float)acc : frame_order_sum(s, u, k, st2, ed2);
      if (sq) sq[k] = !exact;
    }
    __syncthreads();  // red is free for the next section
  }
  __syncthreads();

  // the running mean (no reset) and the keep decision, on warp 0: 32
  // sections' sums and lengths in registers, every lane the same chain
  if (warp == 0) {
    float m = 0.0f;
    int first = -1, n_ch = 0;
    for (int k0 = 0; k0 < nl; k0 += 32) {
      const int kk = k0 + lane;
      float sv = 0.0f, ln = 1.0f;
      if (kk < nl) {
        sv = sm[kk];
        ln = (float)(static_cast<int>(u.so[kk]) -
                     static_cast<int>(u.so[S + kk]));
      }
      const int cnt = min(32, nl - k0);
      unsigned kb = 0;
      for (int j = 0; j < cnt; ++j) {
        const float len = __shfl_sync(kFull, ln, j);
        m = (m + __shfl_sync(kFull, sv, j)) / len;
        if (c_len / m < len) kb |= 1u << j;
      }
      if (kk < nl) kp[kk] = (kb >> lane) & 1u;
      if (first < 0 && kb) first = k0 + __ffs(kb) - 1;
      n_ch += __popc(kb);
    }
    if (lane == 0) {
      sh_nch = n_ch;
      sh_first = first;
    }
  }
  __syncthreads();
  const int n_ch = sh_nch;
  if (n_ch == 0) {  // the first section's channel, extended
    const Sec s = load_sec(u, 0);
    for (int j = tid; j < F; j += kThreadsA)
      o[j] = value_of(source(s, u, 0, j), u, j);
    return;
  }
  // the stable start order: each kept section's rank
  for (int k = tid; k < nl; k += kThreadsA) {
    if (!kp[k]) continue;
    const long long sk = u.so[S + k];
    int r = 0;
    for (int j = 0; j < nl; ++j) {
      const long long sj = u.so[S + j];
      r += kp[j] && (sj < sk || (sj == sk && j < k));
    }
    ord[r] = k;
  }
  // the merged row as the source of each frame's value and score: the
  // first kept section's channel everywhere to begin with
  int* src = src_g ? src_g + (size_t)b * F : src_s;
  const int first = sh_first;
  {
    const Sec s = load_sec(u, first);
#pragma unroll 4
    for (int j = tid; j < F; j += kThreadsA)
      src[j] = source(s, u, first, j);
  }
  __syncthreads();
  if (warp == 0) {
    int b0 = static_cast<int>(u.so[S + first]);
    int b1 = static_cast<int>(u.so[first]);
    for (int i0 = 1; i0 < n_ch; i0 += 32) {
      // the next 32 steps' sections, one a lane
      int kl = 0, i1l = 0, i2l = 0, stl = 0, edl = 0, nfl = 0, nbl = 0;
      if (i0 + lane < n_ch) {
        kl = ord[i0 + lane];
        i1l = static_cast<int>(u.so[S + kl]);
        i2l = static_cast<int>(u.so[kl]);
        stl = static_cast<int>(u.st[kl]);
        edl = static_cast<int>(u.ed[kl]);
        nfl = static_cast<int>(u.n_on[kl]);
        nbl = static_cast<int>(u.n_on[S + kl]);
      }
      const int cnt = min(32, n_ch - i0);
      for (int q = 0; q < cnt; ++q) {
        const int k = __shfl_sync(kFull, kl, q);
        const int i1 = __shfl_sync(kFull, i1l, q);
        const int i2 = __shfl_sync(kFull, i2l, q);
        const Sec s = make_sec(u, k, __shfl_sync(kFull, stl, q),
                               __shfl_sync(kFull, edl, q),
                               __shfl_sync(kFull, nfl, q),
                               __shfl_sync(kFull, nbl, q));
        const bool fresh = i1 - b1 > 0;
        const bool covered = b0 <= i1 && b1 >= i2;
        int lo = i1;
        if (!fresh && !covered) {
          // the merged row's scores and section k's, each lane in frame
          // order, kBatch frames' loads issued together
          double p1 = 0.0, p2 = 0.0;
          for (int j0 = i1 + lane; j0 <= b1; j0 += 32 * kBatch) {
            const float* q1[kBatch];
            const float* q2[kBatch];
#pragma unroll
            for (int r = 0; r < kBatch; ++r) {
              const int j = min(j0 + 32 * r, b1);
              q1[r] = score_of(src[j], u, j);
              q2[r] = score_of(source(s, u, k, j), u, j);
            }
            float v1[kBatch], v2[kBatch];
#pragma unroll
            for (int r = 0; r < kBatch; ++r) {
              v1[r] = *q1[r];
              v2[r] = *q2[r];
            }
#pragma unroll
            for (int r = 0; r < kBatch; ++r) {
              if (j0 + 32 * r <= b1) {
                p1 += (double)v1[r];
                p2 += (double)v2[r];
              }
            }
          }
          const float s1 = (float)__shfl_sync(kFull, warp_sum(p1), 0);
          const float s2 = (float)__shfl_sync(kFull, warp_sum(p2), 0);
          if (s1 > s2) lo = b1;
          if (lane == 0 && s1b) {
            s1b[i0 + q] = s1;
            s2b[i0 + q] = s2;
          }
        }
        if (fresh || !covered) {
#pragma unroll 4
          for (int j = lo + lane; j <= i2; j += 32)
            src[j] = source(s, u, k, j);
        }
        if (fresh) b0 = i1;
        if (fresh || !covered) b1 = i2;
        __syncwarp();
      }
    }
  }
  __syncthreads();
  // the output from the sources, kBatch frames' loads issued together
  for (int j0 = tid; j0 < F; j0 += kThreadsA * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int j = min(j0 + kThreadsA * r, F - 1);
      v[r] = value_of(src[j], u, j);
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r)
      if (j0 + kThreadsA * r < F) o[j0 + kThreadsA * r] = v[r];
  }
}

// ---- kernel B ----

// one step of the biquad (filter_f0.c's order): returns its output
__device__ __forceinline__ double bq_step(double x, double& w0, double& w1) {
  const double wt = x + kA0 * w0 + kA1 * w1;
  const double y = kB0 * wt + kB1 * w0 + kB0 * w1;
  w1 = w0;
  w0 = wt;
  return y;
}

// the chain alone: the next state on input x (bq_step without its output)
__device__ __forceinline__ double bq_state(double x, double& w0,
                                           double& w1) {
  const double wt = x + kA0 * w0 + kA1 * w1;
  w1 = w0;
  w0 = wt;
  return wt;
}

// the biquad's outputs of a warp's run of steps, one a lane: lane j held
// the new state wt of step j (wsel); the state before the run was (wa,
// wb).  Step j's output is bq_step's, b0 wt_j + b1 wt_{j-1} + b0 wt_{j-2}
// in its order, off the chain.
__device__ __forceinline__ double bq_outputs(double wsel, double wa,
                                             double wb) {
  const int lane = threadIdx.x & 31;
  double p1 = __shfl_up_sync(kFull, wsel, 1);
  double p2 = __shfl_up_sync(kFull, wsel, 2);
  if (lane == 0) p1 = wa;
  if (lane == 0) p2 = wb;
  if (lane == 1) p2 = wa;
  return kB0 * wsel + kB1 * p1 + kB0 * p2;
}

__device__ __forceinline__ bool same(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

// the live section of linear index idx over the batch (utterance 0's
// first): its utterance b and slot k; b = -1 past the last
__device__ void locate(const long long* n_sec, int B, int NS, int idx,
                       int& b, int& k) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int c0 = 0; c0 < B; c0 += 32) {
    const long long c = c0 + lane < B ? n_sec[c0 + lane] : 0;
    const int cnt = c < 0 ? 0 : (c > NS ? NS : static_cast<int>(c));
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (idx < base + total) {
      const int l = __popc(__ballot_sync(kFull, base + incl <= idx));
      b = c0 + l;
      k = idx - base - __shfl_sync(kFull, incl - cnt, l);
      return;
    }
    base += total;
  }
  b = -1;
  k = 0;
}

__global__ void __launch_bounds__(32)
    smooth_kernel(const float* __restrict__ f0,
                  const long long* __restrict__ st,
                  const long long* __restrict__ ed,
                  const long long* __restrict__ n_sec,
                  float* __restrict__ out, double* ybuf,
                  int* __restrict__ trace, int B, int F, int n, int NS,
                  int lag, int chunk, int cap) {
  extern __shared__ double sh[];  // tail [cap], checkpoints, a chunk
  double* tbuf = sh;
  double* ck = sh + cap;
  const int lane = threadIdx.x;
  for (int idx = blockIdx.x;; idx += gridDim.x) {
    int b, k;
    locate(n_sec, B, NS, idx, b, k);
    if (b < 0) return;
    const int s = static_cast<int>(st[(size_t)b * NS + k]);
    const int e = static_cast<int>(ed[(size_t)b * NS + k]);
    const float* x = f0 + (size_t)b * F - lag;  // x[j]: padded frame j
    float* o = out + (size_t)b * F - lag;
    double* yr = ybuf + (size_t)b * n;
    int flags = 0, steps = 0;

    // 1. prefix [0, s): the constant x[s]
    const double xs = (double)x[s];
    double w0 = 0.0, w1 = 0.0;
    int i = 0;
    while (i + kBlk <= s && i < cap) {
      const double s0 = w0, s1 = w1;
      int hit = 0;
#pragma unroll
      for (int j = 1; j <= kBlk; ++j) {
        bq_state(xs, w0, w1);
        hit = (hit == 0 && same(w0, s0) && same(w1, s1)) ? j : hit;
      }
      i += kBlk;
      steps += kBlk;
      if (hit) {
        const int r = (s - (i - kBlk)) % hit;
        w0 = s0;
        w1 = s1;
        for (int j = 0; j < r; ++j) bq_state(xs, w0, w1);
        steps += r;
        i = s;
        flags |= kPrefixOrbit;
      }
    }
    if (i < s) flags |= kPrefixFull;
    steps += s - i;
#pragma unroll 4
    for (; i < s; ++i) bq_state(xs, w0, w1);

    // 2. the section [s, e]: x staged 32 frames ahead, y to the scratch row
    float xn = s + lane <= e ? x[s + lane] : 0.0f;
    for (i = s; i <= e; i += 32) {
      const double xc = (double)xn;
      xn = i + 32 + lane <= e ? x[i + 32 + lane] : 0.0f;
      const int cnt = min(32, e - i + 1);
      const double wa = w0, wb = w1;
      double wsel = 0.0;
      if (cnt == 32) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const double wt = bq_state(__shfl_sync(kFull, xc, j), w0, w1);
          wsel = lane == j ? wt : wsel;
        }
      } else {
        for (int j = 0; j < cnt; ++j) {
          const double wt = bq_state(__shfl_sync(kFull, xc, j), w0, w1);
          wsel = lane == j ? wt : wsel;
        }
      }
      const double y = bq_outputs(wsel, wa, wb);
      if (lane < cnt) yr[i + lane] = y;
    }
    steps += e - s + 1;

    // 3. the tail (e, n): the constant x[e]; outputs to tbuf until the
    //    orbit shows (from i0, period lam), else to n with checkpoints
    const double xe = (double)x[e];
    int i0 = -1, lam = 0;
    for (i = e + 1; i + kBlk <= n && i - (e + 1) + kBlk <= cap;) {
      const double s0 = w0, s1 = w1;
      double wsel = 0.0;
      int hit = 0;
#pragma unroll
      for (int j = 1; j <= kBlk; ++j) {
        const double wt = bq_state(xe, w0, w1);
        wsel = lane == j - 1 ? wt : wsel;
        hit = (hit == 0 && same(w0, s0) && same(w1, s1)) ? j : hit;
      }
      const double y = bq_outputs(wsel, s0, s1);
      if (lane < kBlk) tbuf[i - (e + 1) + lane] = y;
      i += kBlk;
      steps += kBlk;
      if (hit) {
        i0 = i - kBlk;
        lam = hit;
        flags |= kTailOrbit;
        break;
      }
    }
    const int i_f = i;  // the tail's full run starts here (i0 < 0)
    if (i0 < 0 && i_f < n) {
      flags |= kTailFull;
      steps += n - i_f;
      for (int c0 = i_f; c0 < n; c0 += chunk) {
        if (lane == 0) {
          ck[2 * ((c0 - i_f) / chunk)] = w0;
          ck[2 * ((c0 - i_f) / chunk) + 1] = w1;
        }
        const int c1 = min(n, c0 + chunk);
#pragma unroll 4
        for (int j = c0; j < c1; ++j) bq_state(xe, w0, w1);
      }
    }
    __syncwarp();

    // 4. backward from n - 1
    double v0 = 0.0, v1 = 0.0;
    int top;
    if (i0 >= 0) {
      // [i0, n): the input repeats tbuf[pb .. pb + lam)
      const double* P = tbuf + (i0 - (e + 1));
      const int T = n - i0;
      int t = 0, ph = (n - 1 - i0) % lam;
      while (t < cap && t + kBlk <= T) {
        const double s0 = v0, s1 = v1;
        const int sph = ph;
        int hit = 0;
#pragma unroll
        for (int j = 1; j <= kBlk; ++j) {
          bq_state(P[ph], v0, v1);
          ph = ph ? ph - 1 : lam - 1;
          hit = (hit == 0 && ph == sph && same(v0, s0) && same(v1, s1))
                    ? j : hit;
        }
        t += kBlk;
        steps += kBlk;
        if (hit) {
          const int r = (T - (t - kBlk)) % hit;
          v0 = s0;
          v1 = s1;
          ph = sph;
          for (int j = 0; j < r; ++j) {
            bq_state(P[ph], v0, v1);
            ph = ph ? ph - 1 : lam - 1;
          }
          steps += r;
          t = T;
          flags |= kBackCycle;
        }
      }
      if (t < T) flags |= kBackFull;
      steps += T - t;
      for (; t < T; ++t) {
        bq_state(P[ph], v0, v1);
        ph = ph ? ph - 1 : lam - 1;
      }
      top = i0;
    } else {
      // [i_f, n): a chunk at a time from its checkpoint, last first
      double* cb = ck + 2 * ((n - i_f + chunk - 1) / chunk);
      for (int c0 = i_f + ((n - i_f - 1) / chunk) * chunk; c0 >= i_f;
           c0 -= chunk) {
        const int c1 = min(n, c0 + chunk);
        w0 = ck[2 * ((c0 - i_f) / chunk)];
        w1 = ck[2 * ((c0 - i_f) / chunk) + 1];
        for (int j = c0; j < c1; ++j) {
          const double y = bq_step(xe, w0, w1);
          if (lane == 0) cb[j - c0] = y;
        }
        __syncwarp();
#pragma unroll 4
        for (int j = c1 - 1; j >= c0; --j) bq_state(cb[j - c0], v0, v1);
        __syncwarp();
        steps += 2 * (c1 - c0);
      }
      top = i_f;
    }
    // (e, top) from tbuf
    steps += top - e - 1;
#pragma unroll 4
    for (int j = top - 1; j > e; --j) bq_state(tbuf[j - (e + 1)], v0, v1);
    // [s, e] from the scratch row, staged 32 frames ahead
    double yn = e - lane >= s ? yr[e - lane] : 0.0;
    for (int hi = e; hi >= s; hi -= 32) {
      const double yc = yn;
      yn = hi - 32 - lane >= s ? yr[hi - 32 - lane] : 0.0;
      const int cnt = min(32, hi - s + 1);
      const double va = v0, vb = v1;
      double vsel = 0.0;
      if (cnt == 32) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const double zt = bq_state(__shfl_sync(kFull, yc, j), v0, v1);
          vsel = lane == j ? zt : vsel;
        }
      } else {
        for (int j = 0; j < cnt; ++j) {
          const double zt = bq_state(__shfl_sync(kFull, yc, j), v0, v1);
          vsel = lane == j ? zt : vsel;
        }
      }
      const double z = bq_outputs(vsel, va, vb);
      if (lane < cnt) o[hi - lane] = (float)z;
    }
    steps += e - s + 1;
    if (trace && lane == 0) {
      int* tr = trace + 4 * ((size_t)b * NS + k);
      tr[0] = steps;
      tr[1] = flags;
      tr[2] = lam;
      tr[3] = i0 >= 0 ? i0 - e - 1 : -1;
    }
    __syncwarp();  // tbuf and the checkpoints are free for the next section
  }
}

// dynamic shared memory beyond 48 KB for fn, once per device and size
template <typename Fn>
int allow_smem(Fn fn, int* table, int smem) {
  if (smem <= 48 * 1024) return 0;
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

}  // namespace

// src == NULL: the merged row's sources in shared memory (4 F bytes,
// which the wrapper has checked fit); else in src [B, F].  ssum [B, S]
// holds the
// section sums the running mean reads, keep [B, S] the decisions, order
// [B, S] the kept slots by start; s1 and s2 (the trace) and ordered (1
// where a section was summed in frame order) may be NULL.
extern "C" int wt_contour_merge(const float* f0, const float* ss_run,
                                const float* ss_zero, const long long* st,
                                const long long* ed, const long long* n_sec,
                                const float* vals, const float* scs,
                                const long long* n_on, const long long* so,
                                float* out, float* ssum, unsigned char* keep,
                                int* order, int* src, float* s1, float* s2,
                                unsigned char* ordered, int B, int F, int S,
                                int E, float c_len, void* stream) {
  if (B <= 0 || F <= 0) return 0;
  const int smem = src ? 0 : F * (int)sizeof(int);
  const int err = allow_smem(merge_kernel, g_merge_smem, smem);
  if (err) return err;
  const Utt u = {f0, ss_run, ss_zero, st, ed, vals, scs, n_on, so, S, E};
  merge_kernel<<<B, kThreadsA, smem, static_cast<cudaStream_t>(stream)>>>(
      u, n_sec, out, ssum, keep, order, src, s1, s2, ordered, F, c_len);
  return static_cast<int>(cudaGetLastError());
}

// ybuf [B, n] double: the forward outputs of each section's own frames.
// chunk: the tail's checkpoint spacing in its full run; cap: steps the
// orbits and cycles are sought for (a multiple of 16), also the tail
// buffer's length; shared memory (cap + 2 ceil(n / chunk) + chunk)
// doubles.  trace [B, NS, 4] int (or NULL): steps run, flags, the tail's
// period and its orbit's start past e + 1 (-1: none).
extern "C" int wt_contour_smooth(const float* f0, const long long* st,
                                 const long long* ed, const long long* n_sec,
                                 float* out, double* ybuf, int* trace, int B,
                                 int F, int n, int NS, int lag, int chunk,
                                 int cap, void* stream) {
  if (B <= 0 || NS <= 0) return 0;
  const int smem = (int)sizeof(double) *
                   (cap + 2 * ((n + chunk - 1) / chunk) + chunk);
  int err = allow_smem(smooth_kernel, g_smooth_smem, smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, smooth_kernel,
                                                      32, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long slots = (long long)B * NS;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(slots < fit ? slots : fit);
  smooth_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      f0, st, ed, n_sec, out, ybuf, trace, B, F, n, NS, lag, chunk, cap);
  return static_cast<int>(cudaGetLastError());
}
