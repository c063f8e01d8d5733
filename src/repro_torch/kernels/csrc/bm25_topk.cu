// Fused BM25 scan over fixed-shape postings slabs + streaming top-k for
// Hopper (sm_90a).
//
// Replaces: repro/kernels/bm25.py::bm25_topk_pallas (the TPU kernel).
//   For each query b (T term ids qt_b, -1 padded, and their weights qw_b)
//   and document n (S slab slots: term ids, -1 padded, and saturated tf):
//   dist = -score(b, n), score as in lexical.cuh (query slot t outer,
//   document slot s inner, two roundings per term); +inf for rows with
//   valid == 0; the k smallest under the (distance, id) order, (inf, -1)
//   in slots no live row fills.  An unmatched document scores -0.0, and
//   lexical scores tie massively (every document sharing a set of matched
//   terms and tf): the (distance, id) rule makes the ids agree exactly.
//
// Design.  There is no matrix product here: each (query, document) pair is
// T x S compare-selects and adds.  The grid is (query tiles of BQ) x
// (splits of N), as in l2_topk.cu, whose partial/merge scheme this kernel
// shares (rt::merge_partials).  A block stages its queries' terms and
// weights in shared memory once; per BN-row tile, each thread holds one
// document's slab row in registers (16 ids + 16 tf, 128 bytes) and scores
// it against half of the block's queries, which every thread of a warp
// reads at the same address (a shared-memory broadcast); the scores go to
// a BQ x BN distance tile in shared memory, which SEL selector threads per
// query scan into their running top-KT lists in registers.
//
// Bound at the main path's shapes (B = 64, N = 1M, S = 16, T = 8): the
// bytes are 64 MB of terms + 64 MB of tf + 4 MB of valid = 39 us at
// 3.35 TB/s; the naive compare count B N T S = 8.2e9 (one compare-select
// and one fp32 add each, 2 x 8.2e9 operations against 67 TFLOP/s = 245 us)
// sets the pace, so the kernel is operations-bound.  Left on the table:
// skipping the T x S loop for a document that shares no term with any
// query of the tile (a per-tile term bitmap), and vectorised slab loads.
#include <cuda_runtime.h>

#include "lexical.cuh"
#include "topk_common.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BN = 128;       // documents per tile
constexpr int THREADS = 256;
constexpr int QG = THREADS / BN;    // query groups: threads scoring one document
constexpr int SEL = THREADS / BQ;   // selector threads per query
constexpr int DS_LD = BN + 1;       // padded stride of the distance tile
constexpr int MERGE_THREADS = 128;

template <int KT>
__global__ void __launch_bounds__(THREADS)
bm25_topk_partial(const int* __restrict__ q_terms, const float* __restrict__ q_weights,
                  const int* __restrict__ terms, const float* __restrict__ tf_sat,
                  const int* __restrict__ valid, float* __restrict__ part_d,
                  int* __restrict__ part_i, int B, int N, int T, int S, int rows_per_split) {
  extern __shared__ float4 smem4[];
  float* ds = reinterpret_cast<float*>(smem4);       // [BQ][DS_LD]
  float* qws = ds + BQ * DS_LD;                      // [BQ][T]
  int* qts = reinterpret_cast<int*>(qws + BQ * T);   // [BQ][T]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);

  for (int e = tid; e < BQ * T; e += THREADS) {
    const int gq = q0 + e / T;
    qts[e] = gq < B ? q_terms[(size_t)q0 * T + e] : -1;
    qws[e] = gq < B ? q_weights[(size_t)q0 * T + e] : 0.f;
  }
  __syncthreads();

  const int row = tid % BN;           // scorer: the document of the tile
  const int qg = tid / BN;            // scorer: queries qg*(BQ/QG) ..
  const int sel_q = tid / SEL;        // selector: query of the tile
  const int sel_c = tid % SEL;        // selector: first column it scans

  rt::TopK<KT> top;
  top.init();

  for (int r0 = r_begin; r0 < r_end; r0 += BN) {
    const int gr = r0 + row;
    const bool in = gr < r_end;
    const bool live = in && (valid == nullptr || valid[gr] != 0);
    rt::SlabRow slab;
    if (in)
      slab.load(terms + (size_t)gr * S, tf_sat + (size_t)gr * S, S);
    else
      slab.clear();
#pragma unroll 1
    for (int b = 0; b < BQ / QG; ++b) {
      const int qq = qg * (BQ / QG) + b;
      const float score = rt::lexical_score(slab, qts + qq * T, qws + qq * T, T);
      ds[qq * DS_LD + row] = live ? -score : CUDART_INF_F;
    }
    __syncthreads();

    const int lim = min(BN, r_end - r0);
    for (int c = sel_c; c < lim; c += SEL) {
      const float dist = ds[sel_q * DS_LD + c];
      if (dist < CUDART_INF_F) top.push(dist, r0 + c);
    }
    __syncthreads();
  }

  const int gq = q0 + sel_q;
  if (gq < B) {
    const size_t base = ((size_t)gq * gridDim.y * SEL + (size_t)split * SEL + sel_c) * KT;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      part_d[base + j] = top.d[j];
      part_i[base + j] = top.i[j];
    }
  }
}

template <int KT>
int launch(const int* q_terms, const float* q_weights, const int* terms, const float* tf_sat,
           const int* valid, float* part_d, int* part_i, float* out_d, int* out_i, int B,
           int N, int T, int S, int k, int splits, int rows_per_split, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * DS_LD + 2 * (size_t)BQ * T);
  cudaError_t err = cudaFuncSetAttribute(
      bm25_topk_partial<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  bm25_topk_partial<KT><<<grid, THREADS, smem, stream>>>(
      q_terms, q_weights, terms, tf_sat, valid, part_d, part_i, B, N, T, S, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rt::merge_partials<KT, MERGE_THREADS><<<B, MERGE_THREADS, 0, stream>>>(
      part_d, part_i, splits * SEL, out_d, out_i, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Partial lists per query and split: the wrapper sizes part_d/part_i as
// (B, splits * bm25_topk_selectors(), kt).
int bm25_topk_selectors() { return SEL; }

// Returns a cudaError_t as int (0 = launched).  valid may be null (all
// rows live).  S <= rt::SLAB_MAX; kt is 8, 16 or 32, with k <= kt.
int bm25_topk_launch(const int* q_terms, const float* q_weights, const int* terms,
                     const float* tf_sat, const int* valid, float* part_d, int* part_i,
                     float* out_d, int* out_i, int B, int N, int T, int S, int k, int kt,
                     int splits, int rows_per_split, cudaStream_t stream) {
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
