// Packed-bit Hamming scan + exact top-k by histogram select, for Hopper
// (sm_90a).
//
// Replaces: repro/kernels/hamming.py::hamming_topk_pallas (the TPU kernel).
//   ham(b, n) = sum_w popcount(q[b, w] ^ code[n, w]) over W 32-bit words,
//   rows with valid == 0 never rank; the k smallest under the (distance,
//   id) order as fp32 distances, (inf, -1) in slots no live row fills; k
//   is any value up to N (the LSH shortlist runs k = 64 .. 1,024).
//
// Design.  The distances are whole numbers in [0, 32 W], so ties are
// massive and k runs far past a register list.  A histogram select is
// exact for every k and has no list at all:
//   1. count: each warp owns a contiguous run of rows of one query and
//      counts its rows per distance (at most 32 W + 1 bins) in shared
//      memory; __match_any_sync groups the lanes of a 32-row chunk that
//      share a distance, so one lane adds the group's size;
//   2. offsets: one block per query turns the (warp, bin) counts into
//      output offsets in place: bin d of warp u starts after every row of
//      a smaller distance and every row of distance d in warps before u,
//      and fills the slots past the live row count with (inf, -1);
//   3. emit: each warp recomputes its rows' distances in the same chunks;
//      a row's slot is its (warp, bin) offset plus its rank among the
//      chunk's lanes of the same distance, the offset advancing by the
//      group's size after each chunk, and the row is written if its slot
//      is below k.
// Runs are in id order, chunks in id order within a run, lanes in id order
// within a chunk, so the slots follow (distance, id) exactly: a stable
// counting sort cut at k.  The distances are computed twice (passes 1 and
// 3) rather than stored.
//
// Bound at the main path's shapes (the one-level LSH scan of SIFT-1M:
// B = 1,024 queries, N = 1M codes, W = 3 words, k up to 1,024): the codes
// and the live mask, 16 MB, are read once (4.8 us at 3.35 TB/s); the
// 3 B N W = 9.4e9 XOR / popcount / add operations take 140 us at the
// 67e12 operations a second of the card's fp32 rate -> operations.
//
// Left on the table by this simple design: several queries per warp
// sharing each code load, skipping pass 3's writes for rows above the
// threshold distance, and keeping pass 1's distances for pass 3.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_W = 8;                 // 256 bits: 257 bins
constexpr int MAX_BINS = 32 * MAX_W + 1;

// The distance of row r, or `bins` (no bin) for a dead or absent row.
__device__ __forceinline__ int row_distance(const uint32_t* q, const int* __restrict__ codes,
                                            const int* __restrict__ valid, int r, int r1,
                                            int W, int bins) {
  if (r >= r1 || (valid != nullptr && valid[r] == 0)) return bins;
  const int* c = codes + (size_t)r * W;
  int d = 0;
  for (int w = 0; w < W; ++w) d += __popc(q[w] ^ (uint32_t)c[w]);
  return d;
}

// Rows [r0, r1) of warp `unit` of query b: every `rows` rows form one unit.
__device__ __forceinline__ void unit_rows(int unit, int rows, int N, int& r0, int& r1) {
  r0 = min(N, unit * rows);
  r1 = min(N, r0 + rows);
}

__global__ void __launch_bounds__(THREADS)
hamming_count(const int* __restrict__ qcodes, const int* __restrict__ codes,
              const int* __restrict__ valid, int* __restrict__ hist, int N, int W, int bins,
              int units, int rows) {
  __shared__ int cnt[WARPS][MAX_BINS];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int unit = blockIdx.x * WARPS + warp;
  for (int e = lane; e < bins; e += 32) cnt[warp][e] = 0;
  uint32_t q[MAX_W];
  for (int w = 0; w < W; ++w) q[w] = (uint32_t)qcodes[(size_t)b * W + w];
  __syncwarp();

  int r0, r1;
  unit_rows(unit, rows, N, r0, r1);
  for (int base = r0; base < r1; base += 32) {
    const int d = row_distance(q, codes, valid, base + lane, r1, W, bins);
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < bins && lane == __ffs(peers) - 1) cnt[warp][d] += __popc(peers);
    __syncwarp();
  }
  int* h = hist + ((size_t)b * units + unit) * bins;
  for (int e = lane; e < bins; e += 32) h[e] = cnt[warp][e];
}

__global__ void __launch_bounds__(THREADS)
hamming_offsets(int* __restrict__ hist, float* __restrict__ out_d, int* __restrict__ out_i,
                int units, int bins, int k) {
  __shared__ int total[MAX_BINS];
  __shared__ int start[MAX_BINS];
  __shared__ int live;
  const int b = blockIdx.x;
  int* h = hist + (size_t)b * units * bins;
  for (int d = threadIdx.x; d < bins; d += THREADS) {
    int s = 0;
    for (int u = 0; u < units; ++u) s += h[(size_t)u * bins + d];
    total[d] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int d = 0; d < bins; ++d) {
      start[d] = run;
      run += total[d];
    }
    live = run;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < bins; d += THREADS) {
    int run = start[d];
    for (int u = 0; u < units; ++u) {
      const int c = h[(size_t)u * bins + d];
      h[(size_t)u * bins + d] = run;
      run += c;
    }
  }
  for (int j = live + threadIdx.x; j < k; j += THREADS) {
    out_d[(size_t)b * k + j] = CUDART_INF_F;
    out_i[(size_t)b * k + j] = -1;
  }
}

__global__ void __launch_bounds__(THREADS)
hamming_emit(const int* __restrict__ qcodes, const int* __restrict__ codes,
             const int* __restrict__ valid, const int* __restrict__ hist,
             float* __restrict__ out_d, int* __restrict__ out_i, int N, int W, int bins,
             int units, int rows, int k) {
  __shared__ int next[WARPS][MAX_BINS];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int unit = blockIdx.x * WARPS + warp;
  const int* h = hist + ((size_t)b * units + unit) * bins;
  for (int e = lane; e < bins; e += 32) next[warp][e] = h[e];
  uint32_t q[MAX_W];
  for (int w = 0; w < W; ++w) q[w] = (uint32_t)qcodes[(size_t)b * W + w];
  __syncwarp();

  const unsigned below = (1u << lane) - 1u;
  int r0, r1;
  unit_rows(unit, rows, N, r0, r1);
  for (int base = r0; base < r1; base += 32) {
    const int r = base + lane;
    const int d = row_distance(q, codes, valid, r, r1, W, bins);
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < bins) {
      const int slot = next[warp][d] + __popc(peers & below);
      if (slot < k) {
        out_d[(size_t)b * k + slot] = (float)d;
        out_i[(size_t)b * k + slot] = r;
      }
    }
    __syncwarp();
    if (d < bins && lane == __ffs(peers) - 1) next[warp][d] += __popc(peers);
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  qcodes (B, W) and codes
// (N, W) int32 packed bits, valid (N,) int32 or null, W <= 8; hist (B,
// units, 32 W + 1) int32 scratch with units = blocks * 8 warps, each warp
// taking `rows` rows (a multiple of 32); out (B, k) with k <= N.
int hamming_topk_launch(const int* qcodes, const int* codes, const int* valid, int* hist,
                        float* out_d, int* out_i, int B, int N, int W, int k, int blocks,
                        int rows, cudaStream_t stream) {
  if (W < 1 || W > MAX_W || rows % 32 != 0) return (int)cudaErrorInvalidValue;
  const int bins = 32 * W + 1;
  const int units = blocks * WARPS;
  const dim3 grid(blocks, B);
  hamming_count<<<grid, THREADS, 0, stream>>>(qcodes, codes, valid, hist, N, W, bins, units,
                                              rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hamming_offsets<<<B, THREADS, 0, stream>>>(hist, out_d, out_i, units, bins, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hamming_emit<<<grid, THREADS, 0, stream>>>(qcodes, codes, valid, hist, out_d, out_i, N, W,
                                             bins, units, rows, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
