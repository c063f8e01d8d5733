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
#pragma once

#include <cuda_runtime.h>

namespace rt {

// Widest slab row the kernels take (build_lexical_slabs' default width);
// the wrappers refuse wider slabs.
constexpr int SLAB_MAX = 16;

// One document's slab row in registers.  Slots >= S hold (-1, 0.0): a
// query term is >= 0 whenever it is compared, so they never match.
struct SlabRow {
  int t[SLAB_MAX];
  float f[SLAB_MAX];

  __device__ __forceinline__ void load(const int* terms, const float* tf, int S) {
#pragma unroll
    for (int s = 0; s < SLAB_MAX; ++s) {
      t[s] = s < S ? terms[s] : -1;
      f[s] = s < S ? tf[s] : 0.f;
    }
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < SLAB_MAX; ++s) {
      t[s] = -1;
      f[s] = 0.f;
    }
  }
};

// BM25 score of one document for one query: qt / qw are the query's T
// term ids (-1 padded) and weights.  The pad slots add +0.0 to a hit sum,
// which never changes it (a sum that starts at +0.0 is never -0.0).
__device__ __forceinline__ float lexical_score(const SlabRow& row, const int* qt,
                                               const float* qw, int T) {
  float score = 0.f;
  for (int t = 0; t < T; ++t) {
    const int term = qt[t];
    float hit = 0.f;
    if (term >= 0) {
#pragma unroll
      for (int s = 0; s < SLAB_MAX; ++s) hit = __fadd_rn(hit, row.t[s] == term ? row.f[s] : 0.f);
    }
    score = __fadd_rn(score, __fmul_rn(hit, qw[t]));
  }
  return score;
}

}  // namespace rt
