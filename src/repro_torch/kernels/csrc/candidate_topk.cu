// Per-query candidate-tile L2 + running top-k for Hopper (sm_90a).
//
// Replaces: repro/kernels/bucket_topk.py::candidate_topk_pallas (the TPU
//   kernel).  Each query row b scores its own C candidates:
//   d2 = (vn - 2 v.q) + qn, +inf where id < 0, and merges them into the
//   carried best list (best_d, best_i) when one is given, else into the
//   (inf, -1) sentinel.  The result is the k smallest under the
//   (distance, id) order; a candidate duplicated with an identical
//   distance is emitted once, as the Pallas kernel does.  No clamp: k > C
//   fills the sentinel.
//
// Design.  One block per query row.  The query is staged in shared memory;
// each warp takes candidates c = warp, warp + WARPS, ...: its lanes read
// the candidate's d floats side by side (one coalesced line per 32 dims),
// accumulate v.v and v.q in fp32 FMA, and reduce with shuffles, so every
// lane holds the distance and all lanes push it, in step, into the warp's
// running list in registers.  The warp lists are then merged through
// shared memory.  The IVF probe chain calls this once per probe step with
// the carried best.
//
// Bound at the main path's shapes (one probe step: B = 64, C = 306,
// d = 128, k = 10): the candidate tile is 10 MB, read once at 3.35 TB/s in
// 3 us, while its 10 MFLOP take 0.15 us at 67 TFLOP/s.  So the kernel is
// bandwidth-bound; 32 probe steps move 320 MB, 96 us per batch.
//
// Left on the table by this simple design: only B blocks are launched
// (64 of 132 SMs at the serving batch), so splitting C over several
// blocks per query would fill the card; the torch gather that builds the
// (B, C, d) tile before each launch writes and re-reads the tile, and
// fusing the gather (read bucket rows by probe id inside the kernel) or
// the whole probe loop into one launch would remove that traffic and 31
// launches per batch.
#include <cuda_runtime.h>

#include "topk_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int KT>
__global__ void __launch_bounds__(THREADS)
candidate_topk_kernel(const float* __restrict__ q, const float* __restrict__ vecs,
                      const int* __restrict__ ids, const float* __restrict__ best_d,
                      const int* __restrict__ best_i, float* __restrict__ out_d,
                      int* __restrict__ out_i, int C, int D, int k) {
  extern __shared__ float qs[];   // [D]
  __shared__ float sd[(WARPS / 2) * KT];
  __shared__ int si[(WARPS / 2) * KT];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < D; e += THREADS) qs[e] = q[(size_t)b * D + e];
  __syncthreads();

  // every warp forms ||q||^2 itself, in the same lane order
  float qp = 0.f;
  for (int e = lane; e < D; e += 32) qp = fmaf(qs[e], qs[e], qp);
  const float qn = rt::warp_sum(qp);

  rt::TopK<KT> top;
  top.init();
  if (warp == 0 && best_d != nullptr) {
    for (int j = 0; j < k; ++j) {
      const float dist = best_d[(size_t)b * k + j];
      if (dist < CUDART_INF_F) top.push_unique(dist, best_i[(size_t)b * k + j]);
    }
  }

  const float* vb = vecs + (size_t)b * C * D;
  const int* ib = ids + (size_t)b * C;
  for (int c = warp; c < C; c += WARPS) {
    const int id = ib[c];
    if (id < 0) continue;   // the same c for the whole warp
    const float* v = vb + (size_t)c * D;
    float vn = 0.f, dot = 0.f;
#pragma unroll 4
    for (int e = lane; e < D; e += 32) {
      const float a = v[e];
      vn = fmaf(a, a, vn);
      dot = fmaf(a, qs[e], dot);
    }
    vn = rt::warp_sum(vn);
    dot = rt::warp_sum(dot);
    const float dist = __fadd_rn(__fsub_rn(vn, __fmul_rn(2.f, dot)), qn);
    top.push_unique(dist, id);
  }

  rt::block_merge<KT, true>(top, warp, lane == 0, WARPS, sd, si);
  if (tid == 0) top.store(out_d + (size_t)b * k, out_i + (size_t)b * k, k);
}

template <int KT>
int launch(const float* q, const float* vecs, const int* ids, const float* best_d,
           const int* best_i, float* out_d, int* out_i, int B, int C, int D, int k,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)D;
  candidate_topk_kernel<KT><<<B, THREADS, smem, stream>>>(q, vecs, ids, best_d, best_i, out_d,
                                                          out_i, C, D, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  best_d/best_i are both
// null (start from the sentinel) or both (B, k).  kt is the list length:
// 8, 16 or 32, with k <= kt.
int candidate_topk_launch(const float* q, const float* vecs, const int* ids,
                          const float* best_d, const int* best_i, float* out_d, int* out_i,
                          int B, int C, int D, int k, int kt, cudaStream_t stream) {
  switch (kt) {
    case 8:
      return launch<8>(q, vecs, ids, best_d, best_i, out_d, out_i, B, C, D, k, stream);
    case 16:
      return launch<16>(q, vecs, ids, best_d, best_i, out_d, out_i, B, C, D, k, stream);
    case 32:
      return launch<32>(q, vecs, ids, best_d, best_i, out_d, out_i, B, C, D, k, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
