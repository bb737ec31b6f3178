// Harvest zero-crossing phase 1 alone: each band signal's sorted event
// positions ("fines") of the four crossing types, compacted per
// 128-sample column, and the kept events per column.
//
// Replaces the Pallas TPU kernel worldtpu/ops/zc_kernel.py::
// _zc_events_kernel (the phase-1 measurement entry of the zc stage) and
// computes what it computes, for every band group in one launch:
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
// owns its slot, so every slot is written once after the +inf fill.
//
// On the H100 the work is one read of the band signals and one write of
// the event buffers: bytes bound it.  The design reads each row once:
//   - one block per (utterance, band) row, whatever its group: the groups'
//     geometry (bands, e_cap, c_row, where their ev and ccol start) comes
//     by value in a small table, and a block finds its group from its band;
//   - the block fills its row's four event buffers with +inf, one barrier,
//     then walks the row in chunks of one 128-sample column per warp;
//   - a warp classifies its column's samples for all four types from
//     f[i], f[i+1], f[i+2] (four samples a lane, 16 ballots), so a column's
//     counts and the ranks inside it never leave the warp; a lane keeps its
//     ranks packed in four registers;
//   - per chunk one barrier: the warps' kept counts go to shared memory
//     (two types packed in an int, double buffered), every warp scans them
//     with shuffles for its column's offset, and the four running offsets
//     stay in registers from chunk to chunk.  o_{c+1} = off_c + kept_c, so
//     the survive rule is decided where the event is found and the event
//     goes straight to its final slot;
//   - the division runs for events only, and a lane walks its own events
//     (bit by bit of a 16-bit mask), so the lanes of a warp divide together.
// No pass counts first, and no prefix over earlier columns is re-summed.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;  // columns per chunk, one a warp
constexpr int kCol = 128;              // samples per column
constexpr int kSub = kCol / 32;        // samples per lane and column
constexpr int kMaxGroups = 16;

struct Group {
  int lo, nb_g, e_cap, c_row;
  int row0;                    // rows of an utterance in the groups before
  long long ev_off, ccol_off;  // the group's first element in ev and ccol
};

struct Params {
  int n_groups, rows_per_utt, nb, L, n_cols, n_store;
  Group g[kMaxGroups];
};

// The four crossing types' event flags of sample i, from f[i], f[i+1],
// f[i+2].  kEdge: the chunk reaches the row's end, so loads and events are
// bounded by L; else every index is inside the row.
template <bool kEdge>
__device__ __forceinline__ void classify(const float* f, int i, int L,
                                         bool e[4]) {
  const bool in01 = !kEdge || i < L - 1;  // n_eff = L
  const bool in23 = !kEdge || i < L - 2;  // n_eff = L - 1
  const float a = (!kEdge || i < L) ? __ldg(f + i) : 0.0f;
  const float b = in01 ? __ldg(f + i + 1) : 0.0f;
  const float c = in23 ? __ldg(f + i + 2) : 0.0f;
  const float d0 = b - a;
  const float d1 = c - b;
  e[0] = in01 && a > 0.0f && b <= 0.0f;
  e[1] = in01 && -a > 0.0f && -b <= 0.0f;
  e[2] = in23 && d0 > 0.0f && d1 <= 0.0f;
  e[3] = in23 && -d0 > 0.0f && -d1 <= 0.0f;
}

// A column's events by lane: the counts per type (cnt), this lane's
// rank at each of its four samples (rk[j]: a byte per type), and which of
// its (sample, type) pairs are events (bit 4j + t of mine).
template <bool kEdge>
__device__ __forceinline__ void scan_column(const float* f, int i0, int L,
                                            unsigned below, int cnt[4],
                                            unsigned rk[kSub],
                                            unsigned& mine) {
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    bool e[4];
    classify<kEdge>(f, i0 + 32 * j, L, e);
    rk[j] = 0u;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned bits = __ballot_sync(0xffffffffu, e[t]);
      // cnt + popc <= 127 for an event's rank: a byte holds it
      rk[j] |= (unsigned)(cnt[t] + __popc(bits & below)) << (8 * t);
      mine |= (e[t] ? 1u : 0u) << (4 * j + t);
      cnt[t] += __popc(bits);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    events_kernel(const float* __restrict__ filt, float* __restrict__ ev,
                  int* __restrict__ ccol, const Params p) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / p.rows_per_utt;
  const int k = blockIdx.x % p.rows_per_utt;
  int gi = 0;
  while (gi + 1 < p.n_groups && k >= p.g[gi + 1].row0) ++gi;
  const Group g = p.g[gi];
  const int band = k - g.row0;  // within the group
  const int L = p.L;
  const float* f = filt + ((size_t)b * p.nb + g.lo + band) * L;
  const size_t row = (size_t)b * g.nb_g + band;
  float* evr = ev + g.ev_off + row * 4 * g.e_cap;
  int* ccr = ccol + g.ccol_off + row * 4 * p.n_cols;

  for (int j = tid; j < 4 * g.e_cap; j += kThreads) evr[j] = INFINITY;
  __syncthreads();  // the events below land on filled slots

  // kept counts of the chunk's columns: [parity][types 0|1 and 2|3][column]
  __shared__ int sk[2][2][kWarps];
  const int o_max = g.e_cap - g.c_row;
  const unsigned below = (1u << lane) - 1u;
  int base[4] = {0, 0, 0, 0};  // kept events of each type before the chunk
  const int n_chunks = (p.n_cols + kWarps - 1) / kWarps;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c = ch * kWarps + warp;
    const int i0 = c * kCol + lane;
    int cnt[4] = {0, 0, 0, 0};
    unsigned rk[kSub];
    unsigned mine = 0u;
    if ((c + 1) * kCol + 2 <= L)  // the same for the whole warp
      scan_column<false>(f, i0, L, below, cnt, rk, mine);
    else
      scan_column<true>(f, i0, L, below, cnt, rk, mine);
    int kept[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) kept[t] = cnt[t] < g.c_row ? cnt[t] : g.c_row;
    const int par = ch & 1;
    if (lane == 0) {
      sk[par][0][warp] = kept[0] | (kept[1] << 16);
      sk[par][1][warp] = kept[2] | (kept[3] << 16);
    }
    if (lane < 4 && c < p.n_cols) {
      const int kl = lane == 0 ? kept[0] : lane == 1 ? kept[1]
                   : lane == 2 ? kept[2] : kept[3];
      ccr[(size_t)lane * p.n_cols + c] = kl;
    }
    __syncthreads();  // the only barrier of a chunk: sk is double buffered

    // every warp scans the chunk's kept counts (a column keeps <= 128
    // events and a chunk has 16 columns: a prefix fits 16 bits)
    const int v01 = lane < kWarps ? sk[par][0][lane] : 0;
    const int v23 = lane < kWarps ? sk[par][1][lane] : 0;
    int s01 = v01, s23 = v23;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int u01 = __shfl_up_sync(0xffffffffu, s01, d);
      const int u23 = __shfl_up_sync(0xffffffffu, s23, d);
      if (lane >= d) {
        s01 += u01;
        s23 += u23;
      }
    }
    const int e01 = __shfl_sync(0xffffffffu, s01 - v01, warp);
    const int e23 = __shfl_sync(0xffffffffu, s23 - v23, warp);
    const int t01 = __shfl_sync(0xffffffffu, s01, kWarps - 1);
    const int t23 = __shfl_sync(0xffffffffu, s23, kWarps - 1);
    const int off[4] = {base[0] + (e01 & 0xffff), base[1] + (e01 >> 16),
                        base[2] + (e23 & 0xffff), base[3] + (e23 >> 16)};
    base[0] += t01 & 0xffff;
    base[1] += t01 >> 16;
    base[2] += t23 & 0xffff;
    base[3] += t23 >> 16;

    // a lane walks its own events (a few at most), so the warp's lanes
    // divide together instead of taking 16 (sample, type) branches in turn
    const bool last_store = c + 1 >= p.n_store;
    for (unsigned todo = mine; todo != 0u; todo &= todo - 1u) {
      const int bit = __ffs(todo) - 1;
      const int t = bit & 3;
      const int j = bit >> 2;
      const unsigned rkj = j == 0 ? rk[0] : j == 1 ? rk[1]
                         : j == 2 ? rk[2] : rk[3];
      const int rank = (rkj >> (8 * t)) & 0xff;
      const int kt = t == 0 ? kept[0] : t == 1 ? kept[1]
                   : t == 2 ? kept[2] : kept[3];
      const int ot = t == 0 ? off[0] : t == 1 ? off[1]
                   : t == 2 ? off[2] : off[3];
      const int o = ot < o_max ? ot : o_max;
      const int nx = ot + kt;
      const int o_next = last_store ? INT_MAX : (nx < o_max ? nx : o_max);
      if (rank < kt && o + rank < o_next) {
        const int i = i0 + 32 * j;
        const float sgn = (t & 1) ? -1.0f : 1.0f;
        float s0, s1;
        if (t < 2) {
          s0 = sgn * f[i];
          s1 = sgn * f[i + 1];
        } else {  // i + 2 <= L - 1 for an event of these types
          s0 = sgn * (f[i + 1] - f[i]);
          s1 = sgn * (f[i + 2] - f[i + 1]);
        }
        evr[(size_t)t * g.e_cap + o + rank] =
            (float)(i + 1) - s0 / (s1 - s0);  // divide for events only
      }
    }
  }
}

}  // namespace

// table: host memory, n_groups rows of (lo, nb_g, e_cap, c_row, ev_off,
// ccol_off), the offsets in elements of ev and ccol.
extern "C" int wt_zc_events(const float* filt, float* ev, int* ccol,
                            const long long* table, int n_groups, int B,
                            int nb, int L, int n_cols, int n_store,
                            void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.n_groups = n_groups;
  p.nb = nb;
  p.L = L;
  p.n_cols = n_cols;
  p.n_store = n_store;
  int rows = 0;
  for (int i = 0; i < n_groups; ++i) {
    const long long* r = table + 6 * i;
    p.g[i] = Group{(int)r[0], (int)r[1], (int)r[2], (int)r[3], rows,
                   r[4], r[5]};
    rows += (int)r[1];
  }
  p.rows_per_utt = rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  events_kernel<<<B * rows, kThreads, 0, st>>>(filt, ev, ccol, p);
  return static_cast<int>(cudaGetLastError());
}
