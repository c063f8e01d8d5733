// Fused BM25 scan over fixed-shape postings slabs + top-k for Hopper
// (sm_90a).
//
// Replaces: repro/kernels/bm25.py::bm25_topk_pallas (the TPU kernel).
//   For each query b (T term ids qt_b, -1 padded, and their weights qw_b)
//   and document n (S slab slots: term ids, -1 padded, and saturated tf):
//   dist = -score(b, n), score as in lexical.cuh (query slot t outer, two
//   roundings per term, hit_t the in-order sum of the tf of the document's
//   slots holding qt_t); +inf for rows with valid == 0; the k smallest
//   under the (distance, id) order, (inf, -1) in slots no live row fills.
//   An unmatched document scores -0.0, and lexical scores tie massively:
//   the (distance, id) rule makes the ids agree exactly.
//
// Bound at the main path's shape (B = 64, N = 1M, S = 16, T = 8): 64 MB of
// terms + 64 MB of tf + 4 MB of valid = 39 us at 3.35 TB/s.  The work the
// inputs need is small: each (query, document) pair's score is a handful
// of lookups and roundings (the queries' real term slots, four of eight on
// the served path), and the matched (query slot, document slot) pairs are
// tens a document.  With the T x S compare loop gone (128 compare-selects
// and 128 dependent adds a pair, 8.2e9 of each at this shape), the bytes
// set the floor.  chip_smoke.py's bound counts the bytes and, as
// operations, a multiply and an add a (live query term slot, live
// document) and an add a matched slot of the run's data; it reports the
// old T x S count beside it.
//
// Design.  The grid is (query tiles of BQ) x (splits of N), as in
// l2_topk.cu; a block walks its split in tiles of BN documents.
// * The query dictionary, the per-slot lookup, the in-order hit
//   accumulation and the scoring are lexical.cuh's (shared with the hybrid
//   tile of l2_topk.cu): four threads a document, four slots and a quarter
//   of a query group each; the distances go to a BQ x BN tile.
// * Selection: each warp owns BQ / 8 queries, one rt::WarpTopK each; a
//   row of the tile is read 32 columns at a time, a ballot keeps the
//   columns that beat the query's k-th pair (and come after the pass's
//   bound, rt::WarpTopK::beats), and only those are inserted.  The
//   per-query partials of the splits are folded by
//   rt::warp_merge_partials.
// * Loads: a thread's quarter of the next tile's slab row (one 16-byte
//   load of terms, one of tf) is in flight while the current tile is
//   scored.
//
// Left on the table: four barriers a 64-document tile (three more a
// further group), with the in-order accumulation on one thread a document
// while the others wait; the dictionary probes' bank conflicts; a wider
// query tile to share each document's lookups among more queries.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lexical.cuh"
#include "topk_common.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BN = 64;        // documents per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QG = THREADS / BN;    // threads scoring one document
constexpr int QW = BQ / WARPS;      // queries each selecting warp owns
constexpr int UCAP = rt::lex::UCAP; // hit rows: distinct query terms + the zero row
constexpr int MERGE_WARPS = 8;      // warps merging one query's partials
constexpr int MAX_T = rt::lex::MAX_T;  // query term slots (bm25.MAX_T)
constexpr int GROUPS_MAX = BQ / QG;  // query groups: G >= QG, and QG MAX_T <= 256

static_assert(THREADS % BN == 0 && BQ % WARPS == 0, "whole groups");
static_assert((BQ / GROUPS_MAX) * MAX_T <= rt::lex::ZERO_ROW, "the smallest group always fits");

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// BOUNDED: the launch carries a pass's bound (after_d / after_i); without
// one (a first pass) the lists' bound is the constant none, which costs no
// registers.
template <int KT, bool BOUNDED>
__global__ void __launch_bounds__(THREADS)
bm25_topk_partial(const int* __restrict__ q_terms, const float* __restrict__ q_weights,
                  const int* __restrict__ terms, const float* __restrict__ tf_sat,
                  const int* __restrict__ valid, const float* __restrict__ after_d,
                  const int* __restrict__ after_i, float* __restrict__ part_d,
                  int* __restrict__ part_i, int B, int N, int T, int S, int k,
                  int rows_per_split, int dict_bits) {
  extern __shared__ float4 smem4[];
  const int dict_size = 1 << dict_bits;
  float* hits = reinterpret_cast<float*>(smem4);      // [UCAP][BN]
  float* ds = hits + UCAP * BN;                        // [BQ][BN]
  float* qws = ds + BQ * BN;                           // [BQ][T]
  int* qts = reinterpret_cast<int*>(qws + BQ * T);     // [BQ][T] dictionary slots
  rt::lex::Dict dc;
  dc.qinfo = reinterpret_cast<int2*>(qts + BQ * T);    // [BQ][T] (hit row, weight)
  dc.dkey = reinterpret_cast<int*>(dc.qinfo + BQ * T); // [dict_size] the dictionaries
  dc.dval = dc.dkey + dict_size;
  __shared__ unsigned char s_rows[rt::SLAB_MAX * BN];  // rows a document filled
  __shared__ short s_su[rt::SLAB_MAX * BN];            // each slot's hit row, or -1
  __shared__ float s_tf[rt::SLAB_MAX * BN];
  __shared__ int s_distinct[GROUPS_MAX];               // each group's distinct terms
  __shared__ int s_reach[GROUPS_MAX];                  // ... and longest probe
  __shared__ int s_nq[BQ];
  dc.distinct = s_distinct;
  dc.reach = s_reach;
  dc.nq = s_nq;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);

  for (int e = tid; e < UCAP * BN; e += THREADS) hits[e] = 0.f;
  for (int e = tid; e < BQ * T; e += THREADS)
    qws[e] = q0 + e / T < B ? q_weights[(size_t)q0 * T + e] : 0.f;
  rt::lex::build_dict<BQ, BN, THREADS, GROUPS_MAX>(dc, q_terms, qws, qts, q0, B, T, dict_bits,
                                                   tid);
  const int G = dc.G, gbits = dc.gbits;
  __syncthreads();

  const int row = tid % BN;   // the tile's document this thread looks up and scores
  const int qg = tid / BN;    // ... with slots 4 qg .. 4 qg + 3 and a quarter of a group
  const bool vec = S == rt::SLAB_MAX && ((reinterpret_cast<uintptr_t>(terms) |
                                          reinterpret_cast<uintptr_t>(tf_sat)) & 15) == 0;

  // the scan, compiled twice: for one group of all BQ queries (the common
  // case, its sizes known at compile time) and for several
  auto scan = [&](auto one_group) {
    constexpr bool ONE = decltype(one_group)::value;
    const int g_size = ONE ? BQ : G;
    const int g_bits = ONE ? dict_bits : gbits;
    const int per = g_size / QG;   // queries of a group this thread scores

    rt::WarpTopK<1, false, BOUNDED> top[QW];   // KT <= 32: one entry a lane
#pragma unroll
    for (int j = 0; j < QW; ++j) {
      if (BOUNDED) {
        float ad;
        int ai;
        rt::after_of(after_d, after_i, min(q0 + warp * QW + j, B - 1), ad, ai);
        top[j].init(ad, ai);
      } else {
        top[j].init();
      }
    }

    // each thread holds a quarter of its document's slab row, the next
    // tile's loaded once the current one is looked up
    int4 t4;
    float4 f4;
    bool live = rt::lex::load_quarter(t4, f4, terms, tf_sat, valid, r_begin + row, r_end, S,
                                      vec, qg);
    for (int r0 = r_begin; r0 < r_end; r0 += BN) {
      const int gr = r0 + row;
      const bool was_live = live;
      for (int g0 = 0; g0 < BQ; g0 += g_size) {
        const int base = ONE ? 0 : (g0 / g_size) << g_bits;
        rt::lex::lookup_quarter<BN>(dc, t4, f4, qg, row, base, s_reach[ONE ? 0 : g0 / g_size],
                                    g_bits, s_su, s_tf);
        if (g0 + g_size >= BQ)   // the last group's lookups are done
          live = rt::lex::load_quarter(t4, f4, terms, tf_sat, valid, gr + BN, r_end, S, vec, qg);
        __syncthreads();
        const int filled = qg == 0 && was_live
                               ? rt::lex::accumulate_hits<BN>(row, s_su, s_tf, hits, s_rows)
                               : 0;
        __syncthreads();
        rt::lex::score_queries<BN>(dc, T, hits, row, g0 + qg * per, per, was_live, -1.f, ds,
                                   BN);
        __syncthreads();
        rt::lex::zero_hits<BN>(filled, row, s_rows, hits);
      }

      // select: warp w offers the tile's documents to its QW queries (a
      // ballot keeps the columns that beat a query's k-th pair; only
      // those are inserted)
      const int lim = min(BN, r_end - r0);
#pragma unroll
      for (int j = 0; j < QW; ++j) {
        const float* dq = ds + (warp * QW + j) * BN;
        for (int c0 = 0; c0 < lim; c0 += 32) {
          const int c = c0 + lane;
          const bool ok = c < lim;
          top[j].offer(ok, ok ? dq[c] : CUDART_INF_F, r0 + c, k, lane);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < QW; ++j) {
      const int gq = q0 + warp * QW + j;
      if (gq < B) {
        const size_t o = ((size_t)gq * gridDim.y + split) * KT;
        top[j].store(part_d + o, part_i + o, KT, lane, false);
      }
    }
  };
  if (G == BQ)
    scan(Flag<true>{});
  else
    scan(Flag<false>{});
}

template <int KT, bool BOUNDED>
int launch(const int* q_terms, const float* q_weights, const int* terms, const float* tf_sat,
           const int* valid, const float* after_d, const int* after_i, float* part_d,
           int* part_i, float* out_d, int* out_i, int B, int N, int T, int S, int k, int splits,
           int rows_per_split, cudaStream_t stream) {
  int dict_bits = 1;   // the dictionary: at least twice the block's term slots
  while ((1 << dict_bits) < 2 * BQ * T) ++dict_bits;
  const size_t smem = sizeof(float) * ((size_t)UCAP * BN + (size_t)BQ * BN +
                                       4 * (size_t)BQ * T + 2 * ((size_t)1 << dict_bits));
  cudaError_t err = cudaFuncSetAttribute(
      bm25_topk_partial<KT, BOUNDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  bm25_topk_partial<KT, BOUNDED><<<grid, THREADS, smem, stream>>>(q_terms, q_weights, terms, tf_sat,
                                                        valid, after_d, after_i, part_d, part_i,
                                                        B, N, T, S, k, rows_per_split,
                                                        dict_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rt::warp_merge_partials<1, MERGE_WARPS><<<B, MERGE_WARPS * 32, 0, stream>>>(
          part_d, part_i, splits * KT, out_d, out_i, B, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  valid may be null (all
// rows live); after_d / after_i are (B,) or both null: the pass's bound
// (rt::WarpTopK).  S <= rt::SLAB_MAX; kt is 8, 16 or 32, with 1 <= k <= kt;
// part_d / part_i are (B, splits, kt) scratch, one list a query a split.
int bm25_topk_launch(const int* q_terms, const float* q_weights, const int* terms,
                     const float* tf_sat, const int* valid, const float* after_d,
                     const int* after_i, float* part_d, int* part_i, float* out_d, int* out_i,
                     int B, int N, int T, int S, int k, int kt, int splits, int rows_per_split,
                     cudaStream_t stream) {
  if (k < 1 || k > kt || T > MAX_T) return (int)cudaErrorInvalidValue;
  const bool bounded = after_d != nullptr;
#define RT_BM25_LAUNCH(KT)                                                                   \
  return bounded ? launch<KT, true>(q_terms, q_weights, terms, tf_sat, valid, after_d, after_i, \
                                    part_d, part_i, out_d, out_i, B, N, T, S, k, splits,      \
                                    rows_per_split, stream)                                   \
                 : launch<KT, false>(q_terms, q_weights, terms, tf_sat, valid, after_d, after_i, \
                                     part_d, part_i, out_d, out_i, B, N, T, S, k, splits,     \
                                     rows_per_split, stream)
  switch (kt) {
    case 8:
      RT_BM25_LAUNCH(8);
    case 16:
      RT_BM25_LAUNCH(16);
    case 32:
      RT_BM25_LAUNCH(32);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_BM25_LAUNCH
}

}  // extern "C"
