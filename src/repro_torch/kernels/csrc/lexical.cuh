// Device side of the BM25 score over fixed-shape postings slabs, shared by
// bm25_topk.cu (the lexical scan) and l2_topk.cu (the hybrid scan).
//
// The counterpart of repro/kernels/bm25.py::_lexical_tile and of
// ref.bm25_dists_ref: for one (query, document) pair,
//   score = sum over query term slots t, in order, of hit_t * qw_t,
//   hit_t = sum over document slots s, in order, of [term_s == qt_t] tf_s,
// with a query slot whose term is < 0 contributing hit_t = 0.  Every add
// and multiply is a round-to-nearest intrinsic, so nvcc contracts nothing
// into an FMA and the order is the plain version's: on slab rows that hold
// distinct terms (what build_lexical_slabs makes) hit_t has at most one
// non-zero term, and the score is bitwise the plain version's.
//
// How a block computes it without the T x S compare loop:
// * A dictionary of the block's query terms, built once (build_dict):
//   open addressing in shared memory (atomicCAS), each distinct term
//   numbered by a hit row (256 rows plus a zero row).  64 queries of four
//   distinct terms always fit; a tile of more distinct terms is taken in
//   groups of G queries (halved until every group fits; G T <= 256 always
//   does), each group with its own dictionary in its share of the slots.
//   The longest probe of any term is kept, so a lookup is a fixed window
//   of loads with no data-dependent loop.
// * Per tile of BN documents, each document's slots are looked up in the
//   dictionary, four slots a thread (lookup_quarter), and one thread a
//   document then adds each matched slot's tf to its term's row of `hits`
//   ([row][document], so a warp's lanes write 32 banks), in slot order from
//   0.0f (accumulate_hits): the row's value is the S-inner loop's hit bit
//   for bit (adding the loop's +0.0 terms never changes a sum that starts
//   at +0.0), repeated terms included.
// * Scoring (score_queries): a query's slots are a compact list of (hit
//   row, weight) in slot order: its terms, and its pads only where the
//   weight is not finite (0 x weight is NaN there); a pad of finite weight
//   adds +-0.0 to a sum that is never -0.0, which changes nothing.  A term
//   the document lacks reads its row's zero.  So a (query, document) pair
//   costs one shared load, one multiply and one add a real term, in the
//   order above.  The rows a document filled are zeroed before the next
//   accumulation (zero_hits).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace rt {

// Widest slab row the kernels take (build_lexical_slabs' default width);
// the wrappers refuse wider slabs.
constexpr int SLAB_MAX = 16;

namespace lex {

constexpr int UCAP = 257;           // hit rows: distinct query terms + the zero row
constexpr int ZERO_ROW = UCAP - 1;  // never written: the hit of a pad slot
constexpr int EMPTY = -1;           // key of an empty dictionary slot
constexpr int MAX_T = 64;           // query term slots (bm25.MAX_T)

static_assert(ZERO_ROW <= 256, "a hit row's number fits a byte");

// A term's first dictionary slot: the top `bits` bits of a multiplicative
// hash, so ids equal in their low bits still spread.
__device__ __forceinline__ unsigned term_slot(int term, int bits) {
  return ((unsigned)term * 0x9E3779B1u) >> (32 - bits);
}

// Shared-memory state of a block's query dictionaries (built by
// build_dict, read by every tile).
struct Dict {
  int* dkey;        // [1 << dict_bits] the dictionaries' keys ...
  int* dval;        // ... and each key's hit row
  int2* qinfo;      // [BQ][T] a query's scored slots in order: (hit row * BN, weight bits)
  int* nq;          // [BQ] how many
  int* distinct;    // [groups] each group's distinct terms
  int* reach;       // [groups] ... and its longest probe
  int G;            // queries a group
  int gbits;        // bits of a group's share of the slots
};

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

// Build the dictionaries of the block's queries q0 .. q0 + BQ - 1 (T term
// slots each, weights already staged in qws [BQ][T]); qts [BQ][T] is
// scratch.  GROUPS_MAX is the most groups the halving may reach.  Every
// thread calls it; it synchronises, and returns with dc.G / dc.gbits set
// and the qinfo lists written (visible after the caller's next barrier).
template <int BQ, int BN, int THREADS, int GROUPS_MAX>
__device__ __forceinline__ void build_dict(Dict& dc, const int* __restrict__ q_terms,
                                           const float* qws, int* qts, int q0, int B, int T,
                                           int dict_bits, int tid) {
  const int dict_size = 1 << dict_bits;
  int G = BQ, gbits = dict_bits;
  for (;;) {
    for (int e = tid; e < dict_size; e += THREADS) dc.dkey[e] = EMPTY;
    if (tid < GROUPS_MAX) {
      dc.distinct[tid] = 0;
      dc.reach[tid] = 0;
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
          const int old = atomicCAS(dc.dkey + base + s, EMPTY, term);
          if (old == EMPTY) {
            dc.dval[base + s] = atomicAdd(&dc.distinct[g], 1);
            atomicMax(&dc.reach[g], d);
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
    for (int g = 0; g < BQ / G; ++g) fits = fits && dc.distinct[g] <= ZERO_ROW;
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
        dc.qinfo[tid * T + n++] =
            make_int2((h >= 0 ? dc.dval[h] : ZERO_ROW) * BN, __float_as_int(w));
    }
    dc.nq[tid] = n;
  }
  dc.G = G;
  dc.gbits = gbits;
}

// The hit row of each of this thread's four slots (t4 / f4, slots 4 qg ..
// 4 qg + 3 of document `row`) in the dictionary of the group at `base`
// (-1: no query of the group holds the term), with its tf, into s_su /
// s_tf ([SLAB_MAX][BN]).  A term sits within `reach` slots of its hash, so
// a fixed window of loads finds it.
template <int BN>
__device__ __forceinline__ void lookup_quarter(const Dict& dc, const int4& t4, const float4& f4,
                                               int qg, int row, int base, int reach, int g_bits,
                                               short* s_su, float* s_tf) {
  const unsigned gmask = (1u << g_bits) - 1u;
  const int t[4] = {t4.x, t4.y, t4.z, t4.w};
  const float f[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    int u = -1;
    if (t[v] >= 0) {
      const unsigned h = term_slot(t[v], g_bits);
      for (int d = 0; d <= reach; ++d) {
        const int e = base + (int)((h + d) & gmask);
        if (dc.dkey[e] == t[v]) u = dc.dval[e];
      }
    }
    s_su[(4 * qg + v) * BN + row] = (short)u;
    s_tf[(4 * qg + v) * BN + row] = f[v];
  }
}

// Document `row`'s hits, in slot order: each slot with a hit row adds its
// tf to that row, from 0.0f.  Returns how many rows it filled, listed in
// s_rows ([SLAB_MAX][BN]) for zero_hits.
template <int BN>
__device__ __forceinline__ int accumulate_hits(int row, const short* s_su, const float* s_tf,
                                               float* hits, unsigned char* s_rows) {
  int us[SLAB_MAX];   // all slots read first: one wait, not sixteen
#pragma unroll
  for (int s = 0; s < SLAB_MAX; ++s) us[s] = s_su[s * BN + row];
  int filled = 0;
#pragma unroll
  for (int s = 0; s < SLAB_MAX; ++s) {
    if (us[s] >= 0) {
      float* p = hits + us[s] * BN + row;
      *p = __fadd_rn(*p, s_tf[s * BN + row]);
      s_rows[filled++ * BN + row] = (unsigned char)us[s];
    }
  }
  return filled;
}

// Zero the `filled` hit rows document `row` filled (only its accumulating
// thread writes them).
template <int BN>
__device__ __forceinline__ void zero_hits(int filled, int row, const unsigned char* s_rows,
                                          float* hits) {
  for (int j = 0; j < filled; ++j) hits[s_rows[j * BN + row] * BN + row] = 0.f;
}

// Score queries qa .. qa + per - 1 against document `row`: a hit-row read
// a scored slot (a pad of non-finite weight reads the zero row).  Writes
// sign * score to out[b * ld + row], or +inf for a dead document.
template <int BN>
__device__ __forceinline__ void score_queries(const Dict& dc, int T, const float* hits, int row,
                                              int qa, int per, bool live, float sign,
                                              float* out, int ld) {
  if (!live) {
    for (int b = qa; b < qa + per; ++b) out[b * ld + row] = CUDART_INF_F;
    return;
  }
  const float* col = hits + row;
#pragma unroll 2
  for (int b = qa; b < qa + per; ++b) {
    const int2* qi = dc.qinfo + b * T;
    const int n = dc.nq[b];
    float score = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int2 e = qi[i];
      score = __fadd_rn(score, __fmul_rn(col[e.x], __int_as_float(e.y)));
    }
    out[b * ld + row] = sign * score;
  }
}

}  // namespace lex
}  // namespace rt
