// Device-side running top-k shared by the search kernels.
//
// The counterpart of repro/kernels/common.py::merge_topk.  The Pallas
// kernels merge each score tile into the running best with K masked mins
// over [best | tile]; here every warp keeps its own sorted list spread over
// its lanes' registers and inserts candidates into it one at a time.  Both
// follow one order: ascending on the (distance, id) pair, so equal
// distances break toward the smaller id whatever the tiling.
//
// A list holds 32 NR >= k entries, NR a compile-time constant so the
// arrays stay in registers (every loop below is fully unrolled).  The
// top-k of a subset of the candidates contains that subset's share of the
// global top-k, so merging per-warp lists gives the exact result.
//
// Any k: a list may carry a lower bound, the pair `after`; a pair ranks
// only if it comes strictly after it in the (distance, id) order.  The
// wrappers (kernels/common.py: topk_passes) run a scan ceil(k / KMAX)
// times, each pass bounded by the last pair of the pass before, and
// concatenate the passes' lists.  The bound is tested where a pair is
// offered (WarpTopK::beats), so every kernel keeps it.  It is
// a compile-time choice (BOUNDED): a first pass, which has no bound, runs
// lists without the test, since even a constant bound's test slowed the
// BM25 scan and the fp32 tile on the card (kernels/tile_ablation.py, PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rt {

// Longest list of one pass of the dense scans (l2, candidate, bm25); the PQ
// scan also instantiates lists of 64 (kernels/common.py: KMAX, KMAX_PQ).
// A larger k takes several passes.
constexpr int KMAX = 32;

// Id of an empty slot.  It sorts after every real id, and the writers turn
// it (and any slot whose distance is +inf) into the -1 of the (inf, -1)
// sentinel.
constexpr int ID_NONE = 0x7fffffff;

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// No bound, (-inf, INT_MIN): every pair above -inf comes after it.
#define RT_AFTER_NONE_D (-CUDART_INF_F)
constexpr int AFTER_NONE_I = -0x7fffffff - 1;

// The bound of query b: after_d / after_i are (B,) or null (no bound).
__device__ __forceinline__ void after_of(const float* after_d, const int* after_i, int b,
                                         float& ad, int& ai) {
  ad = after_d == nullptr ? RT_AFTER_NONE_D : after_d[b];
  ai = after_i == nullptr ? AFTER_NONE_I : after_i[b];
}

// A warp's running top-k spread over its lanes (pq_adc_topk.cu,
// bm25_topk.cu, candidate_topk.cu): entry r * 32 + j of the sorted list
// sits in register r of lane j, NR registers a lane (lists of up to 32 NR
// entries), and every lane holds the k-th pair as the threshold.
// Candidates are offered one a lane; a ballot keeps those that beat the
// threshold, and each of them is inserted with one ballot for its position
// and two shuffles a register to shift the tail.  With UNIQUE a pair the
// list holds already is not inserted again (the probe chain can meet a row
// twice); without it the ids offered to one list are distinct (each row is
// scanned once).  All lanes call in step.
template <int NR, bool UNIQUE = false, bool BOUNDED = false>
struct WarpTopK {
  float d[NR];
  int i[NR];
  float thr_d;
  int thr_i;
  float aft_d;   // the lower bound (none: RT_AFTER_NONE_D, AFTER_NONE_I)
  int aft_i;

  __device__ __forceinline__ void init() { init(RT_AFTER_NONE_D, AFTER_NONE_I); }

  __device__ __forceinline__ void init(float ad, int ai) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      d[r] = CUDART_INF_F;
      i[r] = ID_NONE;
    }
    thr_d = CUDART_INF_F;
    thr_i = ID_NONE;
    aft_d = ad;
    aft_i = ai;
  }

  // (dd, ii) beats the k-th pair (and comes after the bound).
  __device__ __forceinline__ bool beats(float dd, int ii) const {
    return lex_less(dd, ii, thr_d, thr_i) && (!BOUNDED || lex_less(aft_d, aft_i, dd, ii));
  }

  // A one-register list kept in shared memory between uses (sd / si: 32
  // entries, entry j at j); the threshold is entry k - 1.
  __device__ __forceinline__ void load(const float* sd, const int* si, float ad, int ai, int k,
                                       int lane) {
    static_assert(NR == 1, "lists of one register a lane");
    d[0] = sd[lane];
    i[0] = si[lane];
    thr_d = __shfl_sync(0xffffffffu, d[0], k - 1);
    thr_i = __shfl_sync(0xffffffffu, i[0], k - 1);
    aft_d = ad;
    aft_i = ai;
  }

  __device__ __forceinline__ void save(float* sd, int* si, int lane) const {
    sd[lane] = d[0];
    si[lane] = i[0];
  }

  // Insert the warp-uniform pair (dd, ii) if it beats the k-th pair (and,
  // with UNIQUE, is not held already).
  __device__ __forceinline__ void insert(float dd, int ii, int k, int lane) {
    if (!beats(dd, ii)) return;
    if (UNIQUE) {
      bool held = false;
#pragma unroll
      for (int r = 0; r < NR; ++r) held = held || (r * 32 + lane < k && d[r] == dd && i[r] == ii);
      if (__any_sync(0xffffffffu, held)) return;
    }
    int p = 0;   // entries ahead of the new one; it beats entry k - 1
#pragma unroll
    for (int r = 0; r < NR; ++r)
      p += __popc(__ballot_sync(0xffffffffu,
                                r * 32 + lane < k && lex_less(d[r], i[r], dd, ii)));
    float up_d[NR];
    int up_i[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      up_d[r] = __shfl_up_sync(0xffffffffu, d[r], 1);
      up_i[r] = __shfl_up_sync(0xffffffffu, i[r], 1);
      if (r > 0) {   // lane 0 of register r takes lane 31 of register r - 1
        const float wd = __shfl_sync(0xffffffffu, d[r - 1], 31);
        const int wi = __shfl_sync(0xffffffffu, i[r - 1], 31);
        if (lane == 0) {
          up_d[r] = wd;
          up_i[r] = wi;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int e = r * 32 + lane;
      if (e < k && e >= p) {
        d[r] = e == p ? dd : up_d[r];
        i[r] = e == p ? ii : up_i[r];
      }
    }
    const int last = k - 1;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (NR == 1 || last / 32 == r) {
        thr_d = __shfl_sync(0xffffffffu, d[r], last & 31);
        thr_i = __shfl_sync(0xffffffffu, i[r], last & 31);
      }
    }
  }

  // Offer one pair a lane (cand false: none); the pairs that beat the
  // threshold are inserted one at a time, lowest lane first, each checked
  // again against the tightened threshold.  +inf and NaN never rank.
  __device__ __forceinline__ void offer(bool cand, float dd, int ii, int k, int lane) {
    unsigned m = __ballot_sync(0xffffffffu, cand && dd < CUDART_INF_F && beats(dd, ii));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      insert(__shfl_sync(0xffffffffu, dd, src), __shfl_sync(0xffffffffu, ii, src), k, lane);
    }
  }

  // Write entries 0 .. n - 1 (n <= 32 NR) at out + e; with `sentinel`,
  // unfilled entries as (inf, -1), else as held ((inf, ID_NONE)).
  __device__ __forceinline__ void store(float* out_d, int* out_i, int n, int lane,
                                        bool sentinel) const {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int e = r * 32 + lane;
      if (e < n) {
        const bool filled = d[r] < CUDART_INF_F;
        out_d[e] = filled ? d[r] : CUDART_INF_F;
        out_i[e] = filled || !sentinel ? i[r] : -1;
      }
    }
  }
};

// Second pass of the warp-list scans: a block of WARPS warps per query
// folds its L partial entries, part_d / part_i (B, L), into the top-k (B,
// k): each warp offers every WARPS-th run of 32 entries to a WarpTopK, and
// warp 0 folds the others' lists.  (One warp a query left a batch of 64
// with 16 blocks for 132 SMs: 57 us of the fp32 scan's 0.74 ms.)  Launched
// with B blocks; the answer is the top-k of the union under the (distance,
// id) order whatever the split of the work.
template <int NR, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
warp_merge_partials(const float* __restrict__ part_d, const int* __restrict__ part_i, int L,
                    float* __restrict__ out_d, int* __restrict__ out_i, int B, int k) {
  __shared__ float sd[(WARPS - 1) * 32 * NR];
  __shared__ int si[(WARPS - 1) * 32 * NR];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  WarpTopK<NR> top;
  top.init();
  const float* pd = part_d + (size_t)b * L;
  const int* pi = part_i + (size_t)b * L;
  for (int e0 = 32 * warp; e0 < L; e0 += 32 * WARPS) {
    const int e = e0 + lane;
    const bool in = e < L;
    top.offer(in, in ? pd[e] : CUDART_INF_F, in ? pi[e] : ID_NONE, k, lane);
  }
  if (warp > 0)
    top.store(sd + (warp - 1) * 32 * NR, si + (warp - 1) * 32 * NR, 32 * NR, lane, false);
  __syncthreads();
  if (warp == 0) {
    for (int e0 = 0; e0 < (WARPS - 1) * 32 * NR; e0 += 32)
      top.offer(true, sd[e0 + lane], si[e0 + lane], k, lane);
    top.store(out_d + (size_t)b * k, out_i + (size_t)b * k, k, lane, true);
  }
}

}  // namespace rt
