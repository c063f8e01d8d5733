// Fused brute-force L2 distance + streaming top-k for Hopper (sm_90a).
//
// Replaces: repro/kernels/l2_topk.py::l2_topk_pallas (the TPU kernel).
//   For each query b and corpus row n: d2 = (qn_b + xn_n) - 2 q_b.x_n,
//   +inf for rows with valid == 0; the k smallest under the (distance, id)
//   order, (inf, -1) in slots no live row fills.
//
// Design.  The TPU kernel carries its running top-k through a sequential
// grid axis over N.  Blocks on Hopper run in no order, so that carry does
// not port: the grid is (query tiles) x (S splits of N), every block streams
// its own row range in BN-row tiles and keeps a running top-KT per
// (query, selector thread) in registers, and writes it out as a partial.
// A second kernel merges the partials of each query under the same order.
// S is chosen by the wrapper so that B = 64 against N = 1M still fills all
// 132 SMs.
//
// Per block: the query tile (BQ x D) is staged once, transposed, in shared
// memory; each row tile is loaded BK dims at a time; every thread owns a
// TQ x TR micro-tile of dot products accumulated in fp32 FMA (no TF32,
// which would break id parity with the reference); the epilogue forms
// (qn + xn) - 2 dot in that order with round-to-nearest intrinsics (no
// contraction into an FMA), masks pad and dead rows to +inf, and writes
// the BQ x BN distance tile to shared memory, which SEL threads per query
// then scan into their running lists.
//
// Bound at the main path's shapes (B = 64, N = 1M, d = 128): 2 B N d =
// 16.4 GFLOP of fp32 FMA against 67 TFLOP/s outside the tensor cores is
// 245 us; reading the 512 MB corpus once at 3.35 TB/s is 153 us.  So the
// kernel is compute-bound.
//
// Left on the table by this simple design: the tensor cores (3xTF32 or a
// split-bf16 scheme that keeps fp32 accuracy), cp.async/TMA double
// buffering of the row tiles, bank-conflict-free shared layouts, and
// merging the SEL selector lists inside the block before writing partials.
#include <cuda_runtime.h>

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
constexpr int MERGE_THREADS = 128;

static_assert((BQ / TQ) * (BN / TR) == THREADS, "micro-tiles must cover the block tile");

template <int KT>
__global__ void __launch_bounds__(THREADS)
l2_topk_partial(const float* __restrict__ q, const float* __restrict__ x,
                const int* __restrict__ valid, float* __restrict__ part_d,
                int* __restrict__ part_i, int B, int N, int D, int d_pad,
                int rows_per_split) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                    // [d_pad][BQ]
  float* xs = qs + d_pad * BQ;         // [BK][XS_LD]
  float* ds = xs + BK * XS_LD;         // [BQ][DS_LD]
  float* qn = ds + BQ * DS_LD;         // [BQ]
  float* xn = qn + BQ;                 // [BN]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);

  for (int e = tid; e < BQ * d_pad; e += THREADS) {
    const int qq = e / d_pad, dd = e % d_pad;
    const int gq = q0 + qq;
    qs[dd * BQ + qq] = (gq < B && dd < D) ? q[(size_t)gq * D + dd] : 0.f;
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

  const int tq = tid / (BN / TR);     // micro-tile queries tq*TQ ..
  const int tr = tid % (BN / TR);     // micro-tile rows tr*TR ..
  const int sel_q = tid / SEL;        // selector: query of the tile
  const int sel_c = tid % SEL;        // selector: first column it scans

  rt::TopK<KT> top;
  top.init();

  for (int r0 = r_begin; r0 < r_end; r0 += BN) {
    float acc[TQ][TR];
#pragma unroll
    for (int a = 0; a < TQ; ++a)
#pragma unroll
      for (int c = 0; c < TR; ++c) acc[a][c] = 0.f;
    float xn_acc = 0.f;   // thread tid < BN: norm of row r0 + tid

    for (int k0 = 0; k0 < d_pad; k0 += BK) {
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int row = e / BK, kk = e % BK;
        const int gr = r0 + row, gk = k0 + kk;
        xs[kk * XS_LD + row] = (gr < r_end && gk < D) ? x[(size_t)gr * D + gk] : 0.f;
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
        const float4 a = *reinterpret_cast<const float4*>(&qs[(k0 + kk) * BQ + tq * TQ]);
        const float4 b0 = *reinterpret_cast<const float4*>(&xs[kk * XS_LD + tr * TR]);
        const float4 b1 = *reinterpret_cast<const float4*>(&xs[kk * XS_LD + tr * TR + 4]);
        const float av[TQ] = {a.x, a.y, a.z, a.w};
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
        const float dist =
            __fsub_rn(__fadd_rn(qn[qq], xn[row]), __fmul_rn(2.f, acc[i][j]));
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
      part_d[base + j] = top.d[j];
      part_i[base + j] = top.i[j];
    }
  }
}

// One block per query: merge its L sorted partial lists into the top-k.
template <int KT>
__global__ void __launch_bounds__(MERGE_THREADS)
l2_topk_merge(const float* __restrict__ part_d, const int* __restrict__ part_i, int L,
              float* __restrict__ out_d, int* __restrict__ out_i, int k) {
  __shared__ float sd[(MERGE_THREADS / 2) * KT];
  __shared__ int si[(MERGE_THREADS / 2) * KT];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pd = part_d + (size_t)b * L * KT;
  const int* pi = part_i + (size_t)b * L * KT;

  rt::TopK<KT> top;
  top.init();
  for (int e = tid; e < L * KT; e += MERGE_THREADS) {
    const float dist = pd[e];
    if (dist < CUDART_INF_F) top.push(dist, pi[e]);
  }
  rt::block_merge<KT, false>(top, tid, true, MERGE_THREADS, sd, si);
  if (tid == 0) top.store(out_d + (size_t)b * k, out_i + (size_t)b * k, k);
}

template <int KT>
int launch(const float* q, const float* x, const int* valid, float* part_d, int* part_i,
           float* out_d, int* out_i, int B, int N, int D, int k, int splits,
           int rows_per_split, cudaStream_t stream) {
  const int d_pad = (D + BK - 1) / BK * BK;
  const size_t smem =
      sizeof(float) * ((size_t)d_pad * BQ + BK * XS_LD + BQ * DS_LD + BQ + BN);
  cudaError_t err = cudaFuncSetAttribute(
      l2_topk_partial<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  l2_topk_partial<KT><<<grid, THREADS, smem, stream>>>(q, x, valid, part_d, part_i, B, N, D,
                                                       d_pad, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  l2_topk_merge<KT><<<B, MERGE_THREADS, 0, stream>>>(part_d, part_i, splits * SEL, out_d,
                                                      out_i, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Partial lists per query and split: the wrapper sizes part_d/part_i as
// (B, splits * l2_topk_selectors(), kt).
int l2_topk_selectors() { return SEL; }

// Returns a cudaError_t as int (0 = launched).  valid may be null (all
// rows live).  kt is the list length: 8, 16 or 32, with k <= kt.
int l2_topk_launch(const float* q, const float* x, const int* valid, float* part_d,
                   int* part_i, float* out_d, int* out_i, int B, int N, int D, int k, int kt,
                   int splits, int rows_per_split, cudaStream_t stream) {
  switch (kt) {
    case 8:
      return launch<8>(q, x, valid, part_d, part_i, out_d, out_i, B, N, D, k, splits,
                       rows_per_split, stream);
    case 16:
      return launch<16>(q, x, valid, part_d, part_i, out_d, out_i, B, N, D, k, splits,
                        rows_per_split, stream);
    case 32:
      return launch<32>(q, x, valid, part_d, part_i, out_d, out_i, B, N, D, k, splits,
                        rows_per_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
