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
// * A dictionary of the block's query terms, built once: open addressing
//   in shared memory (atomicCAS), each distinct term numbered by a hit row
//   (256 rows plus a zero row).  64 queries of four distinct terms always
//   fit; a tile of more distinct terms is taken in groups of G queries
//   (halved until every group fits; G T <= 256 always does), each group
//   with its own dictionary in its share of the slots, and each tile is
//   looked up, accumulated and scored once a group.  The longest probe of
//   any term is kept, so a lookup is a fixed window of loads with no
//   data-dependent loop.
// * Per tile, each document's slots are looked up in the dictionary, four
//   slots a thread, and one thread a document then adds each matched
//   slot's tf to its term's row of `hits` ([row][document], so a warp's
//   lanes write 32 banks), in slot order from 0.0f: the row's value is the
//   S-inner loop's hit bit for bit (adding the loop's +0.0 terms never
//   changes a sum that starts at +0.0), repeated terms included.
// * Scoring: four threads a document, a quarter of the group each.  A
//   query's slots are a compact list of (hit row, weight) in slot order:
//   its terms, and its pads only where the weight is not finite (0 x
//   weight is NaN there); a pad of finite weight adds +-0.0 to a sum that
//   is never -0.0, which changes nothing.  A term the document lacks reads
//   its row's zero.  So a (query, document) pair costs one shared load,
//   one multiply and one add a real term, in lexical.cuh's order; the
//   distances go to a BQ x BN tile.  The rows a document filled are
//   zeroed after its group is scored.
// * Selection: each warp owns BQ / 8 queries, one rt::WarpTopK each; a
//   row of the tile is read 32 columns at a time, a ballot keeps the
//   columns that beat the query's k-th pair, and only those are inserted.
//   The per-query partials of the splits are folded by
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
constexpr int UCAP = 257;           // hit rows: distinct query terms + the zero row
constexpr int ZERO_ROW = UCAP - 1;  // never written: the hit of a pad slot
constexpr int EMPTY = -1;           // key of an empty dictionary slot
constexpr int MERGE_WARPS = 4;
constexpr int MAX_T = 64;            // query term slots (bm25.MAX_T)
constexpr int GROUPS_MAX = BQ / QG;  // query groups: G >= QG, and QG MAX_T <= 256

static_assert(THREADS % BN == 0 && BQ % WARPS == 0, "whole groups");
static_assert(ZERO_ROW <= 256, "a hit row's number fits a byte");
static_assert((BQ / GROUPS_MAX) * MAX_T <= ZERO_ROW, "the smallest group always fits");

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// A term's first dictionary slot: the top `bits` bits of a multiplicative
// hash, so ids equal in their low bits still spread.
__device__ __forceinline__ unsigned term_slot(int term, int bits) {
  return ((unsigned)term * 0x9E3779B1u) >> (32 - bits);
}

// Load slots 4 g .. 4 g + 3 of document `gr`'s slab row ((-1, 0.0) past S
// or when the row is out of range or dead); returns whether the row is in
// range and live.  `vec`: 64-byte rows, read as one 16-byte load of terms
// and one of tf.
__device__ __forceinline__ bool load_quarter(int4& t4, float4& f4, const int* __restrict__ terms,
                                             const float* __restrict__ tf_sat,
                                             const int* __restrict__ valid, int gr, int r_end,
                                             int S, bool vec, int g) {
  const bool live = gr < r_end && (valid == nullptr || valid[gr] != 0);
  t4 = make_int4(-1, -1, -1, -1);
  f4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live && vec) {
    t4 = __ldg(reinterpret_cast<const int4*>(terms + (size_t)gr * S) + g);
    f4 = __ldg(reinterpret_cast<const float4*>(tf_sat + (size_t)gr * S) + g);
  } else if (live) {
    int* t = &t4.x;
    float* f = &f4.x;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (4 * g + v < S) {
        t[v] = terms[(size_t)gr * S + 4 * g + v];
        f[v] = tf_sat[(size_t)gr * S + 4 * g + v];
      }
    }
  }
  return live;
}

template <int KT>
__global__ void __launch_bounds__(THREADS)
bm25_topk_partial(const int* __restrict__ q_terms, const float* __restrict__ q_weights,
                  const int* __restrict__ terms, const float* __restrict__ tf_sat,
                  const int* __restrict__ valid, float* __restrict__ part_d,
                  int* __restrict__ part_i, int B, int N, int T, int S, int k,
                  int rows_per_split, int dict_bits) {
  extern __shared__ float4 smem4[];
  const int dict_size = 1 << dict_bits;
  float* hits = reinterpret_cast<float*>(smem4);      // [UCAP][BN]
  float* ds = hits + UCAP * BN;                        // [BQ][BN]
  float* qws = ds + BQ * BN;                           // [BQ][T]
  int* qts = reinterpret_cast<int*>(qws + BQ * T);     // [BQ][T] dictionary slots
  int2* qinfo = reinterpret_cast<int2*>(qts + BQ * T);   // [BQ][T] (hit row, weight)
  int* dkey = reinterpret_cast<int*>(qinfo + BQ * T);    // [dict_size] the dictionaries
  int* dval = dkey + dict_size;
  __shared__ unsigned char s_rows[rt::SLAB_MAX][BN];   // rows a document filled
  __shared__ short s_su[rt::SLAB_MAX][BN];             // each slot's hit row, or -1
  __shared__ float s_tf[rt::SLAB_MAX][BN];
  __shared__ int s_distinct[GROUPS_MAX];               // each group's distinct terms
  __shared__ int s_reach[GROUPS_MAX];                  // ... and longest probe
  __shared__ int s_nq[BQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);

  for (int e = tid; e < UCAP * BN; e += THREADS) hits[e] = 0.f;
  for (int e = tid; e < BQ * T; e += THREADS)
    qws[e] = q0 + e / T < B ? q_weights[(size_t)q0 * T + e] : 0.f;

  // the block's query terms in dictionaries of the distinct ones (open
  // addressing), each term numbered by the hit row it owns.  One
  // dictionary for all BQ queries when their distinct terms fit the hit
  // rows (64 queries of four distinct terms always do); else the queries
  // are taken in groups of G, each with its own dictionary in its share
  // of the slots, G halved until every group fits (G T <= 256 always does)
  int G = BQ, gbits = dict_bits;
  for (;;) {
    for (int e = tid; e < dict_size; e += THREADS) dkey[e] = EMPTY;
    if (tid < GROUPS_MAX) {
      s_distinct[tid] = 0;
      s_reach[tid] = 0;
    }
    __syncthreads();
    const unsigned gmask = (1u << gbits) - 1u;
    for (int e = tid; e < BQ * T; e += THREADS) {
      const int g = e / T / G;
      const int term = q0 + e / T < B ? q_terms[(size_t)q0 * T + e] : -1;
      int h = -1;
      if (term >= 0) {
        const int base = g << gbits;
        unsigned s = term_slot(term, gbits);
        for (int d = 0;; ++d) {
          const int old = atomicCAS(dkey + base + s, EMPTY, term);
          if (old == EMPTY) {
            dval[base + s] = atomicAdd(&s_distinct[g], 1);
            atomicMax(&s_reach[g], d);
          }
          if (old == EMPTY || old == term) break;
          s = (s + 1) & gmask;
        }
        h = base + (int)s;
      }
      qts[e] = h;
    }
    __syncthreads();
    bool fits = true;
    for (int g = 0; g < BQ / G; ++g) fits = fits && s_distinct[g] <= ZERO_ROW;
    if (fits) break;   // every thread read the same counts
    G /= 2;
    --gbits;
    __syncthreads();   // the counts are read before they are reset
  }
  // each query's slots in order as (hit row offset, weight): its terms,
  // and its pad slots of non-finite weight (0 x weight is NaN there); a
  // pad of finite weight adds +-0.0 to a sum that is never -0.0, which
  // changes nothing, so it is left out
  if (tid < BQ) {
    int n = 0;
    for (int t = 0; t < T; ++t) {
      const int h = qts[tid * T + t];
      const float w = qws[tid * T + t];
      if (h >= 0 || !isfinite(w))
        qinfo[tid * T + n++] = make_int2((h >= 0 ? dval[h] : ZERO_ROW) * BN, __float_as_int(w));
    }
    s_nq[tid] = n;
  }
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
    const unsigned gmask = (1u << g_bits) - 1u;

    rt::WarpTopK<1> top[QW];   // KT <= 32: one entry a lane
#pragma unroll
    for (int j = 0; j < QW; ++j) top[j].init();

    // each thread holds a quarter of its document's slab row, the next
    // tile's loaded once the current one is looked up
    int4 t4;
    float4 f4;
    bool live = load_quarter(t4, f4, terms, tf_sat, valid, r_begin + row, r_end, S, vec, qg);
    for (int r0 = r_begin; r0 < r_end; r0 += BN) {
      const int gr = r0 + row;
      const bool was_live = live;
      for (int g0 = 0; g0 < BQ; g0 += g_size) {
        // the hit row of each slot's term in this group's dictionary (-1:
        // no query of the group holds it): a term sits within `reach`
        // slots of its hash, so a fixed window of loads finds it
        const int base = ONE ? 0 : (g0 / g_size) << g_bits;
        const int reach = s_reach[ONE ? 0 : g0 / g_size];
        {
          const int t[4] = {t4.x, t4.y, t4.z, t4.w};
          const float f[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            int u = -1;
            if (t[v] >= 0) {
              const unsigned h = term_slot(t[v], g_bits);
              for (int d = 0; d <= reach; ++d) {
                const int e = base + (int)((h + d) & gmask);
                if (dkey[e] == t[v]) u = dval[e];
              }
            }
            s_su[4 * qg + v][row] = (short)u;
            s_tf[4 * qg + v][row] = f[v];
          }
        }
        if (g0 + g_size >= BQ)   // the last group's lookups are done
          live = load_quarter(t4, f4, terms, tf_sat, valid, gr + BN, r_end, S, vec, qg);
        __syncthreads();

        // the document's hits, in slot order: each slot with a hit row
        // adds its tf to that row, from 0.0f
        int filled = 0;
        if (qg == 0 && was_live) {
          int us[rt::SLAB_MAX];   // all slots read first: one wait, not sixteen
#pragma unroll
          for (int s = 0; s < rt::SLAB_MAX; ++s) us[s] = s_su[s][row];
#pragma unroll
          for (int s = 0; s < rt::SLAB_MAX; ++s) {
            if (us[s] >= 0) {
              float* p = hits + us[s] * BN + row;
              *p = __fadd_rn(*p, s_tf[s][row]);
              s_rows[filled++][row] = (unsigned char)us[s];
            }
          }
        }
        __syncthreads();

        // score the group's queries: a hit-row read a real slot (a pad of
        // non-finite weight reads the zero row)
        const int qa = g0 + qg * per;
        if (!was_live) {
          for (int b = qa; b < qa + per; ++b) ds[b * BN + row] = CUDART_INF_F;
        } else {
          const float* col = hits + row;
#pragma unroll 2
          for (int b = qa; b < qa + per; ++b) {
            const int2* qi = qinfo + b * T;
            const int n = s_nq[b];
            float score = 0.f;
#pragma unroll 4
            for (int i = 0; i < n; ++i) {
              const int2 e = qi[i];
              score = __fadd_rn(score, __fmul_rn(col[e.x], __int_as_float(e.y)));
            }
            ds[b * BN + row] = -score;
          }
        }
        __syncthreads();
        // zero the rows this document filled (only this thread writes them)
        for (int j = 0; j < filled; ++j) hits[s_rows[j][row] * BN + row] = 0.f;
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

template <int KT>
int launch(const int* q_terms, const float* q_weights, const int* terms, const float* tf_sat,
           const int* valid, float* part_d, int* part_i, float* out_d, int* out_i, int B,
           int N, int T, int S, int k, int splits, int rows_per_split, cudaStream_t stream) {
  int dict_bits = 1;   // the dictionary: at least twice the block's term slots
  while ((1 << dict_bits) < 2 * BQ * T) ++dict_bits;
  const size_t smem = sizeof(float) * ((size_t)UCAP * BN + (size_t)BQ * BN +
                                       4 * (size_t)BQ * T + 2 * ((size_t)1 << dict_bits));
  cudaError_t err = cudaFuncSetAttribute(
      bm25_topk_partial<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  bm25_topk_partial<KT><<<grid, THREADS, smem, stream>>>(q_terms, q_weights, terms, tf_sat,
                                                        valid, part_d, part_i, B, N, T, S, k,
                                                        rows_per_split, dict_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rt::warp_merge_partials<1, MERGE_WARPS>
      <<<(B + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0, stream>>>(
          part_d, part_i, splits * KT, out_d, out_i, B, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  valid may be null (all
// rows live).  S <= rt::SLAB_MAX; kt is 8, 16 or 32, with 1 <= k <= kt;
// part_d / part_i are (B, splits, kt) scratch, one list a query a split.
int bm25_topk_launch(const int* q_terms, const float* q_weights, const int* terms,
                     const float* tf_sat, const int* valid, float* part_d, int* part_i,
                     float* out_d, int* out_i, int B, int N, int T, int S, int k, int kt,
                     int splits, int rows_per_split, cudaStream_t stream) {
  if (k < 1 || k > kt || T > MAX_T) return (int)cudaErrorInvalidValue;
  switch (kt) {
    case 8:
      return launch<8>(q_terms, q_weights, terms, tf_sat, valid, part_d, part_i, out_d, out_i,
                       B, N, T, S, k, splits, rows_per_split, stream);
    case 16:
      return launch<16>(q_terms, q_weights, terms, tf_sat, valid, part_d, part_i, out_d,
                        out_i, B, N, T, S, k, splits, rows_per_split, stream);
    case 32:
      return launch<32>(q_terms, q_weights, terms, tf_sat, valid, part_d, part_i, out_d,
                        out_i, B, N, T, S, k, splits, rows_per_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
