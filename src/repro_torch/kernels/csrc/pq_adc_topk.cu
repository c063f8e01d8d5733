// PQ asymmetric-distance (ADC) scan + top-k for Hopper (sm_90a).
//
// Replaces: repro/kernels/pq_adc.py::pq_adc_topk_pallas (the TPU kernel).
//   score(b, n) = sum_{m = 0..M-1} lut[b, m, code[n, m]], summed in order
//   from 0.0f with round-to-nearest adds (the Pallas kernel's fori_loop
//   order, so the plain version ref.pq_adc_topk_ref equals this kernel bit
//   for bit); rows with valid == 0 never rank; the k smallest under the
//   (distance, id) order, (inf, -1) in slots no live row fills.  One launch
//   serves k <= 64 (the nprobe sweep of fig2d_deep.py reaches 64); a larger
//   k is taken in passes of 64 (kernels/common.py: topk_passes), each
//   bounded by the last pair of the one before (after_d / after_i:
//   rt::WarpTopK::beats).
//
// Bound at the main path's shape (the PQ top level of DEEP-10M: B = 1,024
// queries of a query chunk, N = 32,768 centroid codes, M = 8, k = nprobe
// <= 64): 2.7e8 fp32 adds = 4.0 us at 67 TFLOP/s against 8.6 MB of LUTs
// and codes = 2.6 us at 3.35 TB/s.  Each add reads its LUT entry from
// shared memory at a data-dependent code, so the 2.7e8 lookups at 32 a
// clock per SM (132 SMs) take about 32 us at 1.98 GHz with no bank
// conflicts: the lookups, not the adds, are the floor.  chip_smoke.py
// reports both.
//
// Design.  The TPU kernel turns the gather into M one-hot (B, 256) x
// (256, BN) products on the MXU; here each query's LUT (M x 256 fp32,
// 8 KB at M = 8) is staged in shared memory and gathered directly.
// * Filling the card: a block is one query and one split of N, its WARPS
//   warps each scanning a quarter of the split against the query's staged
//   LUT (8 KB at M = 8, so a dozen blocks fit an SM).  The wrapper adds
//   splits until the grid holds about 4 blocks (16 warps) per SM: at
//   B = 1,024 the queries alone give 7.8 blocks (31 warps) a SM and N is
//   not split across blocks; at B = 64 it is split 9 ways.  Each split and
//   warp keeps its own list, so splitting further costs merges (the
//   smoke times the doubled split count beside the chosen one).  With
//   more than one split, a second pass (a block of warps a query,
//   rt::warp_merge_partials) folds the (B, S, KT) partials, linear in
//   S x KT.
// * Selection: one list per warp, spread over its lanes (rt::WarpTopK:
//   entry j in lane j, two registers a lane at k = 64), its k-th pair the
//   threshold.  A pass scores 32 rows, one a lane; a ballot keeps the rows
//   that beat the threshold and they wait in a 32-entry buffer in shared
//   memory.  A full buffer is sorted across the lanes (a bitonic network of
//   shuffles) and merged into the list by rank (binary searches), so 32
//   insertions cost one sort and one merge, not 32 rounds of ballot and
//   shuffles.  A warp sees R rows and keeps about k (1 + ln(R / k)) of
//   them.  At the end of the split the warps fold their lists into warp
//   0's; the old per-lane lists and their 5-round fold are gone.
// * Loads: lane l reads a row's M code bytes with 8-byte loads (32 rows of
//   8 bytes: 256 contiguous bytes a pass); at M = 8 the next pass's row is
//   loaded while the current one is summed.
//
// Left on the table: at k = 64 the merges still cost a good share of the
// scan (a warp keeps about 380 of its 8,192 rows, four lists a query); a
// threshold shared across a query's warps would cut that.  The lookups' bank conflicts (32 lanes
// at 32 random codes of one subspace, about 3.5 wavefronts a lookup) put
// the scan's floor near 110 us; a layout that gives each lane its own bank
// costs instructions of its own, and the scan is not yet at that floor.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int WARPS = 4;              // warps per block, one query
constexpr int THREADS = WARPS * 32;
constexpr int MERGE_WARPS = 8;        // warps merging one query's partials
constexpr int C = 256;                // codewords per subspace

constexpr unsigned FULL = 0xffffffffu;

// A warp's rt::WarpTopK fed in batches: the rows of a pass that beat the
// list's k-th pair go to a 32-entry buffer in shared memory, and a full
// buffer is sorted across the lanes (a bitonic network of shuffles) and
// merged into the list by rank (each entry's place is its index plus the
// count of the other side's entries ahead of it, found by binary search),
// in place of one ballot-and-shift insertion a row.
template <int NR, bool BOUNDED>
struct BatchedList {
  static constexpr int KT = 32 * NR;
  rt::WarpTopK<NR, false, BOUNDED> list;
  float* bd;   // [32] the buffer, then [KT] the list while merging
  int* bi;
  int cnt;     // rows in the buffer (warp-uniform)

  __device__ __forceinline__ void init(float* d, int* i) {
    list.init();
    bd = d;
    bi = i;
    cnt = 0;
  }

  // Buffer this lane's row if it beats the k-th pair; merge once 32 wait.
  __device__ __forceinline__ void push(bool cand, float dd, int ii, int k, int lane) {
    const bool want = cand && dd < CUDART_INF_F && list.beats(dd, ii);
    const unsigned m = __ballot_sync(FULL, want);
    if (m == 0) return;
    const int pos = cnt + __popc(m & ((1u << lane) - 1u));
    if (want && pos < 32) {
      bd[pos] = dd;
      bi[pos] = ii;
    }
    cnt += __popc(m);
    if (cnt >= 32) {
      flush(k, lane);   // merges the first 32
      if (want && pos >= 32) {
        bd[pos - 32] = dd;
        bi[pos - 32] = ii;
      }
      cnt -= 32;
    }
  }

  // Merge the buffered rows (the first min(cnt, 32)) into the list.
  __device__ __forceinline__ void flush(int k, int lane) {
    __syncwarp();
    const int n = min(cnt, 32);
    if (n == 0) return;
    float xd = lane < n ? bd[lane] : CUDART_INF_F;
    int xi = lane < n ? bi[lane] : rt::ID_NONE;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const float od = __shfl_xor_sync(FULL, xd, stride);
        const int oi = __shfl_xor_sync(FULL, xi, stride);
        const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0 || size == 32);
        const bool other_first = rt::lex_less(od, oi, xd, xi);
        if (other_first == keep_min) {
          xd = od;
          xi = oi;
        }
      }
    }
    // the list beside the sorted batch: ld / li after the batch's 32
    float* ld = bd + 32;
    int* li = bi + 32;
    __syncwarp();
    bd[lane] = xd;
    bi[lane] = xi;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      ld[r * 32 + lane] = list.d[r];
      li[r * 32 + lane] = list.i[r];
    }
    __syncwarp();
    // ranks: a list entry goes before batch entries equal to it
    int rank[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      int lo = 0;   // batch entries strictly ahead of list entry r*32+lane
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (rt::lex_less(bd[lo + step - 1], bi[lo + step - 1], list.d[r], list.i[r])) lo += step;
      if (rt::lex_less(bd[lo], bi[lo], list.d[r], list.i[r])) ++lo;
      rank[r] = r * 32 + lane + lo;
    }
    int lo = 0;     // list entries at or ahead of batch entry lane
#pragma unroll
    for (int step = KT / 2; step > 0; step >>= 1)
      if (!rt::lex_less(xd, xi, ld[lo + step - 1], li[lo + step - 1])) lo += step;
    if (!rt::lex_less(xd, xi, ld[lo], li[lo])) ++lo;
    const int xrank = lane + lo;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (rank[r] < k) {
        ld[rank[r]] = list.d[r];
        li[rank[r]] = list.i[r];
      }
    }
    if (xrank < k) {
      ld[xrank] = xd;
      li[xrank] = xi;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int e = r * 32 + lane;
      list.d[r] = e < k ? ld[e] : CUDART_INF_F;
      list.i[r] = e < k ? li[e] : rt::ID_NONE;
    }
    const int last = k - 1;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (last / 32 == r) {
        list.thr_d = __shfl_sync(FULL, list.d[r], last & 31);
        list.thr_i = __shfl_sync(FULL, list.i[r], last & 31);
      }
    }
    __syncwarp();
  }
};

// BOUNDED: the launch carries a pass's bound (a first pass runs the lists
// without its test).
template <int NR, bool BOUNDED>
__global__ void __launch_bounds__(THREADS)
pq_adc_scan(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
            const int* __restrict__ valid, const float* __restrict__ after_d,
            const int* __restrict__ after_i, float* __restrict__ out_d,
            int* __restrict__ out_i, int N, int M, int rows, int k, int kt, int splits) {
  extern __shared__ float smem[];   // the query's LUT [M][C], then the fold
  __shared__ float s_buf_d[WARPS][32 + 32 * NR];   // each warp's batch, then its list
  __shared__ int s_buf_i[WARPS][32 + 32 * NR];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int split = blockIdx.y;

  const float* lb = lut + (size_t)b * M * C;
  for (int e = threadIdx.x; e < M * C; e += THREADS) smem[e] = lb[e];
  __syncthreads();

  BatchedList<NR, BOUNDED> top;
  top.init(s_buf_d[warp], s_buf_i[warp]);
  if (BOUNDED) rt::after_of(after_d, after_i, b, top.list.aft_d, top.list.aft_i);
  const int r0 = split * rows;
  const int r1 = min(N, r0 + rows);
  const bool wide = (M % 8) == 0;   // rows are 8-byte aligned: M bytes each
  // every lane of a warp runs the same trip count (the ballots need them);
  // with M = 8 a lane's next row (its 8 code bytes and liveness) is loaded
  // while the current one is summed
  const int step = WARPS * 32;
  int r = r0 + warp * 32 + lane;
  uint2 w8 = make_uint2(0u, 0u);
  bool ok8 = false;
  if (M == 8 && r < r1) {
    w8 = *reinterpret_cast<const uint2*>(codes + (size_t)r * 8);
    ok8 = valid == nullptr || valid[r] != 0;
  }
  for (int base = r0 + warp * 32; base < r1; base += step, r += step) {
    bool live;
    float acc = 0.f;
    if (M == 8) {
      const uint2 w = w8;
      live = r < r1 && ok8;
      if (r + step < r1) {
        w8 = *reinterpret_cast<const uint2*>(codes + (size_t)(r + step) * 8);
        ok8 = valid == nullptr || valid[r + step] != 0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t word = j < 4 ? w.x : w.y;
        acc = __fadd_rn(acc, smem[j * C + ((word >> (8 * (j & 3))) & 0xff)]);
      }
    } else {
      live = r < r1 && (valid == nullptr || valid[r] != 0);
      if (live) {
        const uint8_t* row = codes + (size_t)r * M;
        if (wide) {
          for (int m0 = 0; m0 < M; m0 += 8) {
            const uint2 w = *reinterpret_cast<const uint2*>(row + m0);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const uint32_t word = j < 4 ? w.x : w.y;
              acc = __fadd_rn(acc, smem[(m0 + j) * C + ((word >> (8 * (j & 3))) & 0xff)]);
            }
          }
        } else {
          for (int m = 0; m < M; ++m) acc = __fadd_rn(acc, smem[m * C + row[m]]);
        }
      }
    }
    top.push(live, acc, r, k, lane);
  }
  top.flush(k, lane);

  // fold warps 1 .. WARPS-1 into warp 0 through the (now free) LUT space
  __syncthreads();
  float* fd = smem;
  int* fi = reinterpret_cast<int*>(smem + (WARPS - 1) * NR * 32);
  if (warp > 0)
    top.list.store(fd + (warp - 1) * NR * 32, fi + (warp - 1) * NR * 32, NR * 32, lane, false);
  __syncthreads();
  if (warp == 0) {
    for (int e0 = 0; e0 < (WARPS - 1) * NR * 32; e0 += 32)
      top.list.offer(true, fd[e0 + lane], fi[e0 + lane], k, lane);
    if (splits == 1)
      top.list.store(out_d + (size_t)b * k, out_i + (size_t)b * k, k, lane, true);
    else
      top.list.store(out_d + ((size_t)b * splits + split) * kt,
                     out_i + ((size_t)b * splits + split) * kt, kt, lane, false);
  }
}

template <int NR, bool BOUNDED>
int launch(const float* lut, const uint8_t* codes, const int* valid, const float* after_d,
           const int* after_i, float* part_d, int* part_i, float* out_d, int* out_i, int B,
           int N, int M, int k, int kt, int splits, int rows, cudaStream_t stream) {
  // the LUT; the fold's (WARPS - 1) lists of 32 NR pairs fit inside it
  // whenever M >= 2, and the max covers M = 1
  const size_t smem = sizeof(float) * (size_t)max(M * C, 2 * (WARPS - 1) * NR * 32);
  cudaError_t err = cudaFuncSetAttribute(
      pq_adc_scan<NR, BOUNDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, splits);
  const bool one = splits == 1;
  pq_adc_scan<NR, BOUNDED><<<grid, THREADS, smem, stream>>>(lut, codes, valid, after_d, after_i,
                                                   one ? out_d : part_d, one ? out_i : part_i,
                                                   N, M, rows, k, kt, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || one) return (int)err;
  rt::warp_merge_partials<NR, MERGE_WARPS><<<B, MERGE_WARPS * 32, 0, stream>>>(
          part_d, part_i, splits * kt, out_d, out_i, B, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  lut (B, M, 256) fp32, codes
// (N, M) uint8, valid (N,) int32 or null; after_d / after_i (B,) or both
// null: the pass's bound; out (B, k) with 1 <= k <= kt, kt the list length
// 8, 16, 32 or 64.  With splits > 1, part_d / part_i are (B, splits, kt)
// scratch; with splits == 1 they are not read.
int pq_adc_topk_launch(const float* lut, const uint8_t* codes, const int* valid,
                       const float* after_d, const int* after_i, float* part_d, int* part_i,
                       float* out_d, int* out_i, int B, int N, int M, int k, int kt, int splits,
                       int rows, cudaStream_t stream) {
  if (k < 1 || k > kt || kt > 64) return (int)cudaErrorInvalidValue;
#define RT_PQ_LAUNCH(NR, BOUNDED)                                                            \
  launch<NR, BOUNDED>(lut, codes, valid, after_d, after_i, part_d, part_i, out_d, out_i, B, N, \
                      M, k, kt, splits, rows, stream)
  const bool bounded = after_d != nullptr;
  if (kt <= 32) return bounded ? RT_PQ_LAUNCH(1, true) : RT_PQ_LAUNCH(1, false);
  return bounded ? RT_PQ_LAUNCH(2, true) : RT_PQ_LAUNCH(2, false);
#undef RT_PQ_LAUNCH
}

}  // extern "C"
