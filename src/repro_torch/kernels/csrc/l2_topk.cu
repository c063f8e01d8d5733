// Fused brute-force scans + streaming top-k for Hopper (sm_90a): one tile
// loop, instantiated for three row types.
//
// Replaces (the TPU kernels):
//   F32Rows    repro/kernels/l2_topk.py::l2_topk_pallas
//              d2 = (qn_b + xn_n) - 2 q_b.x_n
//   Int8Rows   repro/kernels/l2_topk.py::l2_topk_int8_pallas
//              d2 = (qn_b + (s_n s_n) xn8_n) - (2 s_n) q_b.x8_n, the rows
//              stored as int8 codes x8 with one fp32 scale s_n per row
//   HybridRows repro/kernels/bm25.py::hybrid_topk_pallas
//              dist = a d2 - (1 - a) bm25(b, n), with a read from a (1, 1)
//              device operand and bm25 the slab score of lexical.cuh
// each +inf for rows with valid == 0; the k smallest under the (distance,
// id) order, (inf, -1) in slots no live row fills.
//
// Design.  The TPU kernels carry their running top-k through a sequential
// grid axis over N.  Blocks on Hopper run in no order, so that carry does
// not port: the grid is (query tiles) x (S splits of N), every block streams
// its own row range in BN-row tiles and keeps a running top-KT per
// (query, selector thread) in registers, and writes it out as a partial.
// A second kernel (rt::merge_partials) merges the partials of each query
// under the same order.  S is chosen by the wrapper so that B = 64 against
// N = 1M still fills all 132 SMs.
//
// Per block: the query tile (BQ x D) is staged once, transposed, in shared
// memory; each row tile is loaded BK dims at a time (int8 rows as one
// 16-byte load of 16 codes per row, widened to fp32 as they are staged);
// every thread owns a TQ x TR micro-tile of dot products accumulated in
// fp32 FMA (no TF32, which would break id parity with the reference); the
// epilogue forms the distance in the reference's order with round-to-
// nearest intrinsics (no contraction into an FMA), masks pad and dead rows
// to +inf, and writes the BQ x BN distance tile to shared memory, which SEL
// threads per query then scan into their running lists.  The hybrid scan
// first stages the row tile's slab rows in shared memory and parks each
// micro-tile pair's BM25 score in the distance tile, where its epilogue
// reads it back: alpha = 1 gives the fp32 scan's distances exactly (the
// same tile code), alpha = 0 the BM25 scan's.  The code-space norm
// ||x8||^2 <= 128 * 127^2 < 2^24 is exact in fp32 in any order.
//
// Bound at the main path's shapes (B = 64, N = 1M, d = 128; 3.35 TB/s, 67
// TFLOP/s fp32 outside the tensor cores):
//   fp32:   16.4 GFLOP = 245 us against 512 MB = 153 us  -> operations;
//   int8:   16.4 GFLOP = 245 us against 136 MB = 41 us   -> operations
//           (on this card int8 buys footprint, 132 MB placed against
//           516 MB, not time: the TPU kernel's "bandwidth-bound" is a TPU
//           statement);
//   hybrid: the fp32 FMA plus B N T S slab compares (8.2e9 at T = 8,
//           S = 16) against 644 MB = 192 us -> operations.
//
// Left on the table by this simple design: the tensor cores (3xTF32 or a
// split-bf16 scheme that keeps fp32 accuracy; int8 x int8 would quantize
// the queries too), cp.async/TMA double buffering of the row tiles,
// bank-conflict-free shared layouts, and merging the SEL selector lists
// inside the block before writing partials.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lexical.cuh"
#include "topk_common.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BN = 128;       // corpus rows per tile
constexpr int BK = 16;        // dims per staged chunk
constexpr int THREADS = 256;
constexpr int TQ = 4;         // queries per thread micro-tile
constexpr int TR = 8;         // rows per thread micro-tile
constexpr int SEL = THREADS / BQ;   // selector threads per query
constexpr int XS_LD = BN + 4;       // padded stride of the row chunk
constexpr int DS_LD = BN + 1;       // padded stride of the distance tile
constexpr int LX_LD = rt::SLAB_MAX + 1;   // padded stride of the staged slab rows
constexpr int MERGE_THREADS = 128;

static_assert((BQ / TQ) * (BN / TR) == THREADS, "micro-tiles must cover the block tile");
static_assert(BK == 16, "an int8 row chunk is one 16-byte load");

struct F32Rows {
  using T = float;
};
struct Int8Rows {
  using T = signed char;
};
struct HybridRows {
  using T = float;
};

// Operands of one scan; the pointers a row type does not read are null.
struct Operands {
  const float* q;          // (B, D) fp32
  const void* x;           // (N, D) fp32, or int8 codes
  const float* scales;     // (N,) int8 row scales
  const int* valid;        // (N,) or null: all rows live
  const int* q_terms;      // (B, T) hybrid: query term ids, -1 padded
  const float* q_weights;  // (B, T) hybrid: their weights
  const int* terms;        // (N, S) hybrid: slab term ids, -1 padded
  const float* tf_sat;     // (N, S) hybrid: saturated tf
  const float* alpha;      // (1, 1) hybrid: the blend
  float* part_d;           // (B, splits * SEL, KT)
  int* part_i;
  int B, N, D, d_pad, rows_per_split, T, S;
};

template <class Rows, int KT>
__global__ void __launch_bounds__(THREADS) l2_topk_partial(const Operands op) {
  constexpr bool kInt8 = std::is_same<Rows, Int8Rows>::value;
  constexpr bool kHybrid = std::is_same<Rows, HybridRows>::value;
  const float* __restrict__ q = op.q;
  const typename Rows::T* __restrict__ x = static_cast<const typename Rows::T*>(op.x);
  const int* __restrict__ valid = op.valid;
  const int B = op.B, N = op.N, D = op.D, d_pad = op.d_pad;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                    // [d_pad][BQ]
  float* xs = qs + d_pad * BQ;         // [BK][XS_LD]
  float* ds = xs + BK * XS_LD;         // [BQ][DS_LD]
  float* qn = ds + BQ * DS_LD;         // [BQ]
  float* xn = qn + BQ;                 // [BN]
  float* sc = xn + BN;                 // int8: [BN] row scales of the tile
  int* qts = reinterpret_cast<int*>(xn + BN);        // hybrid: [BQ][T]
  float* qws = reinterpret_cast<float*>(qts + BQ * op.T);
  int* lts = reinterpret_cast<int*>(qws + BQ * op.T);  // hybrid: [BN][LX_LD]
  float* lfs = reinterpret_cast<float*>(lts + BN * LX_LD);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int r_begin = split * op.rows_per_split;
  const int r_end = min(N, r_begin + op.rows_per_split);

  for (int e = tid; e < BQ * d_pad; e += THREADS) {
    const int qq = e / d_pad, dd = e % d_pad;
    const int gq = q0 + qq;
    qs[dd * BQ + qq] = (gq < B && dd < D) ? q[(size_t)gq * D + dd] : 0.f;
  }
  if constexpr (kHybrid) {
    for (int e = tid; e < BQ * op.T; e += THREADS) {
      const int gq = q0 + e / op.T;
      qts[e] = gq < B ? op.q_terms[(size_t)q0 * op.T + e] : -1;
      qws[e] = gq < B ? op.q_weights[(size_t)q0 * op.T + e] : 0.f;
    }
  }
  __syncthreads();
  if (tid < BQ) {
    float s = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float v = qs[dd * BQ + tid];
      s = fmaf(v, v, s);
    }
    qn[tid] = s;
  }
  float a = 0.f, one_minus_a = 0.f;
  if constexpr (kHybrid) {
    a = op.alpha[0];
    one_minus_a = __fsub_rn(1.f, a);
  }
  // int8 rows: one 16-byte load per row and chunk when the rows allow it
  const bool vec16 = kInt8 && (D % BK) == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0;

  const int tq = tid / (BN / TR);     // micro-tile queries tq*TQ ..
  const int tr = tid % (BN / TR);     // micro-tile rows tr*TR ..
  const int sel_q = tid / SEL;        // selector: query of the tile
  const int sel_c = tid % SEL;        // selector: first column it scans

  rt::TopK<KT> top;
  top.init();

  for (int r0 = r_begin; r0 < r_end; r0 += BN) {
    if constexpr (kHybrid) {
      // stage the tile's slab rows, then park each micro-tile pair's BM25
      // score in the distance tile; the epilogue reads back only its own
      for (int e = tid; e < BN * op.S; e += THREADS) {
        const int row = e / op.S, s = e % op.S;
        const int gr = r0 + row;
        lts[row * LX_LD + s] = gr < r_end ? op.terms[(size_t)gr * op.S + s] : -1;
        lfs[row * LX_LD + s] = gr < r_end ? op.tf_sat[(size_t)gr * op.S + s] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < TR; ++j) {
        const int row = tr * TR + j;
        rt::SlabRow slab;
        slab.load(lts + row * LX_LD, lfs + row * LX_LD, op.S);
#pragma unroll 1
        for (int i = 0; i < TQ; ++i) {
          const int qq = tq * TQ + i;
          ds[qq * DS_LD + row] = rt::lexical_score(slab, qts + qq * op.T, qws + qq * op.T, op.T);
        }
      }
    }
    if constexpr (kInt8) {
      // read by the epilogue, after the chunk loop's barriers
      if (tid < BN) sc[tid] = r0 + tid < r_end ? op.scales[r0 + tid] : 1.f;
    }

    float acc[TQ][TR];
#pragma unroll
    for (int a_ = 0; a_ < TQ; ++a_)
#pragma unroll
      for (int c = 0; c < TR; ++c) acc[a_][c] = 0.f;
    float xn_acc = 0.f;   // thread tid < BN: norm of row r0 + tid

    for (int k0 = 0; k0 < d_pad; k0 += BK) {
      if (vec16) {
        if (tid < BN) {
          int4 v = make_int4(0, 0, 0, 0);
          if (r0 + tid < r_end)
            v = *reinterpret_cast<const int4*>(
                reinterpret_cast<const signed char*>(x) + (size_t)(r0 + tid) * D + k0);
          const signed char* c = reinterpret_cast<const signed char*>(&v);
#pragma unroll
          for (int kk = 0; kk < BK; ++kk) xs[kk * XS_LD + tid] = static_cast<float>(c[kk]);
        }
      } else {
        for (int e = tid; e < BN * BK; e += THREADS) {
          const int row = e / BK, kk = e % BK;
          const int gr = r0 + row, gk = k0 + kk;
          xs[kk * XS_LD + row] =
              (gr < r_end && gk < D) ? static_cast<float>(x[(size_t)gr * D + gk]) : 0.f;
        }
      }
      __syncthreads();
      if (tid < BN) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float v = xs[kk * XS_LD + tid];
          xn_acc = fmaf(v, v, xn_acc);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 av4 = *reinterpret_cast<const float4*>(&qs[(k0 + kk) * BQ + tq * TQ]);
        const float4 b0 = *reinterpret_cast<const float4*>(&xs[kk * XS_LD + tr * TR]);
        const float4 b1 = *reinterpret_cast<const float4*>(&xs[kk * XS_LD + tr * TR + 4]);
        const float av[TQ] = {av4.x, av4.y, av4.z, av4.w};
        const float bv[TR] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < BN) xn[tid] = xn_acc;
    __syncthreads();

#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int row = tr * TR + j;
      const int gr = r0 + row;
      const bool live = gr < r_end && (valid == nullptr || valid[gr] != 0);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int qq = tq * TQ + i;
        float dist;
        if constexpr (kInt8) {
          const float s = sc[row];
          dist = __fsub_rn(__fadd_rn(qn[qq], __fmul_rn(__fmul_rn(s, s), xn[row])),
                           __fmul_rn(__fmul_rn(2.f, s), acc[i][j]));
        } else {
          dist = __fsub_rn(__fadd_rn(qn[qq], xn[row]), __fmul_rn(2.f, acc[i][j]));
          if constexpr (kHybrid)
            dist = __fsub_rn(__fmul_rn(a, dist), __fmul_rn(one_minus_a, ds[qq * DS_LD + row]));
        }
        ds[qq * DS_LD + row] = live ? dist : CUDART_INF_F;
      }
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
      op.part_d[base + j] = top.d[j];
      op.part_i[base + j] = top.i[j];
    }
  }
}

template <class Rows, int KT>
int launch(const Operands& op, float* out_d, int* out_i, int k, int splits,
           cudaStream_t stream) {
  size_t words = (size_t)op.d_pad * BQ + BK * XS_LD + BQ * DS_LD + BQ + BN;
  if (std::is_same<Rows, Int8Rows>::value) words += BN;
  if (std::is_same<Rows, HybridRows>::value) words += 2 * ((size_t)BQ * op.T + BN * LX_LD);
  const size_t smem = sizeof(float) * words;
  cudaError_t err = cudaFuncSetAttribute(
      l2_topk_partial<Rows, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((op.B + BQ - 1) / BQ, splits);
  l2_topk_partial<Rows, KT><<<grid, THREADS, smem, stream>>>(op);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rt::merge_partials<KT, MERGE_THREADS><<<op.B, MERGE_THREADS, 0, stream>>>(
      op.part_d, op.part_i, splits * SEL, out_d, out_i, k);
  return (int)cudaGetLastError();
}

template <class Rows>
int dispatch(const Operands& op, float* out_d, int* out_i, int k, int kt, int splits,
             cudaStream_t stream) {
  switch (kt) {
    case 8:
      return launch<Rows, 8>(op, out_d, out_i, k, splits, stream);
    case 16:
      return launch<Rows, 16>(op, out_d, out_i, k, splits, stream);
    case 32:
      return launch<Rows, 32>(op, out_d, out_i, k, splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

Operands scan_operands(const float* q, const void* x, const int* valid, float* part_d,
                       int* part_i, int B, int N, int D, int rows_per_split) {
  Operands op = {};
  op.q = q;
  op.x = x;
  op.valid = valid;
  op.part_d = part_d;
  op.part_i = part_i;
  op.B = B;
  op.N = N;
  op.D = D;
  op.d_pad = (D + BK - 1) / BK * BK;
  op.rows_per_split = rows_per_split;
  return op;
}

}  // namespace

extern "C" {

// Partial lists per query and split: the wrappers size part_d/part_i as
// (B, splits * l2_topk_selectors(), kt).
int l2_topk_selectors() { return SEL; }

// Each launcher returns a cudaError_t as int (0 = launched).  valid may be
// null (all rows live).  kt is the list length: 8, 16 or 32, with k <= kt.

int l2_topk_launch(const float* q, const float* x, const int* valid, float* part_d,
                   int* part_i, float* out_d, int* out_i, int B, int N, int D, int k, int kt,
                   int splits, int rows_per_split, cudaStream_t stream) {
  const Operands op = scan_operands(q, x, valid, part_d, part_i, B, N, D, rows_per_split);
  return dispatch<F32Rows>(op, out_d, out_i, k, kt, splits, stream);
}

int l2_topk_int8_launch(const float* q, const signed char* codes, const float* scales,
                        const int* valid, float* part_d, int* part_i, float* out_d, int* out_i,
                        int B, int N, int D, int k, int kt, int splits, int rows_per_split,
                        cudaStream_t stream) {
  Operands op = scan_operands(q, codes, valid, part_d, part_i, B, N, D, rows_per_split);
  op.scales = scales;
  return dispatch<Int8Rows>(op, out_d, out_i, k, kt, splits, stream);
}

// S <= rt::SLAB_MAX; alpha is a (1, 1) device tensor, read by the kernel.
int hybrid_topk_launch(const float* q, const float* x, const int* q_terms,
                       const float* q_weights, const int* terms, const float* tf_sat,
                       const float* alpha, const int* valid, float* part_d, int* part_i,
                       float* out_d, int* out_i, int B, int N, int D, int T, int S, int k,
                       int kt, int splits, int rows_per_split, cudaStream_t stream) {
  Operands op = scan_operands(q, x, valid, part_d, part_i, B, N, D, rows_per_split);
  op.q_terms = q_terms;
  op.q_weights = q_weights;
  op.terms = terms;
  op.tf_sat = tf_sat;
  op.alpha = alpha;
  op.T = T;
  op.S = S;
  return dispatch<HybridRows>(op, out_d, out_i, k, kt, splits, stream);
}

}  // extern "C"
