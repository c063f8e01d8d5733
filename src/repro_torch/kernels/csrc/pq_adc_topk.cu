// PQ asymmetric-distance (ADC) scan + streaming top-k for Hopper (sm_90a).
//
// Replaces: repro/kernels/pq_adc.py::pq_adc_topk_pallas (the TPU kernel).
//   score(b, n) = sum_{m = 0..M-1} lut[b, m, code[n, m]], summed in order
//   from 0.0f with round-to-nearest adds (the Pallas kernel's fori_loop
//   order, so the plain version ref.pq_adc_topk_ref equals this kernel bit
//   for bit); +inf where valid == 0; the k smallest under the (distance,
//   id) order, k <= 64 (the nprobe sweep of fig2d_deep.py reaches 64).
//
// Design.  The TPU kernel turns the gather into M one-hot (B, 256) x
// (256, BN) products on the MXU.  Hopper has no reason for that: each
// query's LUT (M x 256 fp32, 8 KB at M = 8) is staged in shared memory and
// gathered directly.  A block holds 8 queries, one warp each, so its
// dynamic shared memory is 8 LUTs, 64 KB at M = 8, above the default
// 48 KB: the launcher raises the limit with cudaFuncSetAttribute.  The
// grid is (query groups) x (S splits of N).  Each lane takes rows lane,
// lane + 32, ... of its split, reads a row's M code bytes with 8-byte
// loads, sums the M LUT entries and pushes the score into its own register
// list (rt::TopK, KT = 8..64 entries); the warp's 32 lists are then folded
// into lane 0's by shuffles, halving the lanes each round.  With S = 1 that
// list is the answer; otherwise it is the split's partial, and
// rt::merge_partials folds the S partials of each query.  The wrapper picks
// S = 1 when the query groups alone fill the card (B = 1,024 gives 128
// blocks), so a served batch of 64 queries still spreads over the SMs.
//
// Bound at the main path's shapes (the PQ top level of DEEP-10M: B = 1024
// queries of a query chunk, N = 32,768 centroid codes, M = 8, k = nprobe
// <= 64): 2.7e8 fp32 adds = 4.0 us at 67 TFLOP/s against 8.6 MB of LUTs
// and codes = 2.6 us at 3.35 TB/s -> operations.  Every LUT entry is read
// from shared memory, 8 per (query, row).
//
// Left on the table by this simple design: sharing each code load among
// the block's queries, a warp-level pre-filter against the list's worst
// entry before the unrolled insertion (a 64-entry insertion costs 64
// steps, and early in the scan some lane of the warp inserts at almost
// every row), and a merge that is not quadratic in KT.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;   // queries per block
constexpr int MERGE_THREADS = 128;
constexpr int C = 256;                // codewords per subspace

// Shift a list one entry to the front, refilling its tail with the empty
// slot.
template <int KT>
__device__ __forceinline__ void drop_first(rt::TopK<KT>& top) {
#pragma unroll
  for (int j = 0; j < KT - 1; ++j) {
    top.d[j] = top.d[j + 1];
    top.i[j] = top.i[j + 1];
  }
  top.d[KT - 1] = CUDART_INF_F;
  top.i[KT - 1] = rt::ID_NONE;
}

template <int KT>
__global__ void __launch_bounds__(THREADS)
pq_adc_partial(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
               const int* __restrict__ valid, float* __restrict__ out_d,
               int* __restrict__ out_i, int B, int N, int M, int rows, int k, int splits) {
  extern __shared__ float smem[];   // one LUT [M][C] per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  const int split = blockIdx.y;
  if (b >= B) return;   // whole warps leave; nothing below syncs the block

  float* lw = smem + (size_t)warp * M * C;
  const float* lb = lut + (size_t)b * M * C;
  for (int e = lane; e < M * C; e += 32) lw[e] = lb[e];
  __syncwarp();

  rt::TopK<KT> top;
  top.init();
  const int r0 = split * rows;
  const int r1 = min(N, r0 + rows);
  const bool wide = (M % 8) == 0;   // rows are 8-byte aligned: M bytes each
  for (int r = r0 + lane; r < r1; r += 32) {
    if (valid != nullptr && valid[r] == 0) continue;
    const uint8_t* row = codes + (size_t)r * M;
    float acc = 0.f;
    if (wide) {
      for (int m0 = 0; m0 < M; m0 += 8) {
        const uint2 w = *reinterpret_cast<const uint2*>(row + m0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t word = j < 4 ? w.x : w.y;
          const int code = (word >> (8 * (j & 3))) & 0xff;
          acc = __fadd_rn(acc, lw[(m0 + j) * C + code]);
        }
      }
    } else {
      for (int m = 0; m < M; ++m) acc = __fadd_rn(acc, lw[m * C + row[m]]);
    }
    top.push(acc, r);
  }

  // fold the lanes' lists into lane 0's: in each round lanes below
  // `stride` take, one entry a step, the list of lane + stride, whose
  // lanes hand over their first entry and drop it (one insertion and one
  // shift in the loop body, not KT insertions unrolled: the build stays
  // short at KT = 64)
  for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll 1
    for (int j = 0; j < KT; ++j) {
      const float dd = __shfl_down_sync(0xffffffffu, top.d[0], stride);
      const int ii = __shfl_down_sync(0xffffffffu, top.i[0], stride);
      if (lane < stride) {
        if (dd < CUDART_INF_F) top.push(dd, ii);
      } else {
        drop_first(top);
      }
    }
  }
  if (lane == 0) {
    if (splits == 1)
      top.store(out_d + (size_t)b * k, out_i + (size_t)b * k, k);
    else
      top.store(out_d + ((size_t)b * splits + split) * KT,
                out_i + ((size_t)b * splits + split) * KT, KT);
  }
}

template <int KT>
int launch(const float* lut, const uint8_t* codes, const int* valid, float* part_d,
           int* part_i, float* out_d, int* out_i, int B, int N, int M, int k, int splits,
           int rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)WARPS * M * C;
  cudaError_t err = cudaFuncSetAttribute(
      pq_adc_partial<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + WARPS - 1) / WARPS, splits);
  if (splits == 1) {
    pq_adc_partial<KT><<<grid, THREADS, smem, stream>>>(lut, codes, valid, out_d, out_i, B, N,
                                                        M, rows, k, 1);
    return (int)cudaGetLastError();
  }
  pq_adc_partial<KT><<<grid, THREADS, smem, stream>>>(lut, codes, valid, part_d, part_i, B, N,
                                                      M, rows, k, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rt::merge_partials<KT, MERGE_THREADS><<<B, MERGE_THREADS, 0, stream>>>(
      part_d, part_i, splits, out_d, out_i, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  lut (B, M, 256) fp32, codes
// (N, M) uint8, valid (N,) int32 or null; out (B, k) with k <= kt, kt the
// list length 8, 16, 32 or 64.  With splits > 1, part_d / part_i are
// (B, splits, kt) scratch; with splits == 1 they are not read.
int pq_adc_topk_launch(const float* lut, const uint8_t* codes, const int* valid, float* part_d,
                       int* part_i, float* out_d, int* out_i, int B, int N, int M, int k,
                       int kt, int splits, int rows, cudaStream_t stream) {
  switch (kt) {
    case 8:
      return launch<8>(lut, codes, valid, part_d, part_i, out_d, out_i, B, N, M, k, splits,
                       rows, stream);
    case 16:
      return launch<16>(lut, codes, valid, part_d, part_i, out_d, out_i, B, N, M, k, splits,
                        rows, stream);
    case 32:
      return launch<32>(lut, codes, valid, part_d, part_i, out_d, out_i, B, N, M, k, splits,
                        rows, stream);
    case 64:
      return launch<64>(lut, codes, valid, part_d, part_i, out_d, out_i, B, N, M, k, splits,
                        rows, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
