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
// exact for every k and has no list at all.  The grid is (S splits of N) x
// (groups of G = 32 queries): a block stages its split's codes and
// liveness CH = 512 rows at a time in shared memory by cp.async (two
// buffers, one barrier a chunk), and every query of its group reads each
// staged code from there, so a code crosses L2 once a group (B / 32 times
// a call), not once a query.
//   1. count: lane j of every warp holds query j of the group; the warps
//      take the chunk's rows in turn, each row's words a broadcast read,
//      and each lane adds its row's distance to its query's histogram
//      (32 W + 1 bins) with a shared atomicAdd: column j of a [bin][G]
//      table, so the lanes of a warp never share a bank.  The count needs
//      no order;
//   2. offsets: one block a query sums its (split, bin) counts, finds the
//      threshold bin t (the smallest distance whose running count reaches
//      k; the last bin when fewer than k rows are live), turns the counts
//      of bins <= t into output offsets in place (bin d of split s starts
//      after every row of a smaller distance and every row of distance d
//      in splits before s) and fills the slots past the live row count
//      with (inf, -1);
//   3. emit: warp w holds queries w, w + 8, w + 16, w + 24 of the group and
//      walks the split's rows in id order, 32 a run (lane i: row i of the
//      run), recomputing their distances; a ballot of d <= t ends the work
//      on a run with no such row (at k = 1,024 of 1M rows, nearly all).
//      Only a run with one ranks its hits of equal d (__match_any_sync over
//      the hits, unless one lane hit): a row's slot is its (split, bin)
//      offset plus its rank, the offset then advancing by the group's
//      size, and the row is written if its slot is below k.  Once the
//      threshold bin's offset reaches k (in this split, or before it), the
//      query's bound drops to t - 1, so the rest of a large threshold bin
//      (LSH codes tie by the thousand) costs no ranking.
// Splits are in id order, runs in id order within a split, lanes in id
// order within a run, so the slots follow (distance, id) exactly: a stable
// counting sort cut at k, bit for bit the plain version's.  The distances
// are computed twice (passes 1 and 3) rather than stored.  Three words'
// popcounts are summed as popc(a ^ b ^ c) + 2 popc(maj(a, b, c)): two
// POPC for three words (a carry-save adder), so W = 3 takes two.
//
// Bound at the main path's shapes (the one-level LSH scan of SIFT-1M:
// B = 1,024 queries, N = 1M codes, W = 3 words, k up to 1,024): the codes
// and the live mask, 16 MB, are read once (4.8 us at 3.35 TB/s); the
// popcounts issue at 16 a clock an SM on compute capability 9.0 (the CUDA
// C++ Programming Guide's arithmetic-instruction table), against 64 for
// XOR and add: 2 B N = 2.1e9 POPC at 16 x 132 x 1.98 GHz take 0.51 ms ->
// operations, and the design's two passes twice that.  chip_smoke.py
// computes it from the run's operands.
//
// Left on the table: keeping pass 1's distances (a byte each, B N bytes)
// in place of the recompute; the tensor cores' binary MMA (popc of AND).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int G = 32;                    // queries a group (a lane each in the count)
constexpr int QW = G / WARPS;            // queries a warp in the emit
constexpr int CH = 512;                  // rows a staged chunk
constexpr int BLOCKS_PER_SM = 4;         // the wrapper's grid is one wave of this many an SM
constexpr int MAX_W = 8;                 // 256 bits: 257 bins
constexpr int MAX_BINS = 32 * MAX_W + 1;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// The Hamming distance of two W-word codes; words three at a time through
// a carry-save adder (two POPC for three words).
template <int W>
__device__ __forceinline__ int ham(const uint32_t (&q)[W], const uint32_t (&c)[W]) {
  int d = 0;
  int w = 0;
#pragma unroll
  for (; w + 3 <= W; w += 3) {
    const uint32_t a = q[w] ^ c[w], b = q[w + 1] ^ c[w + 1], e = q[w + 2] ^ c[w + 2];
    d += __popc(a ^ b ^ e) + 2 * __popc((a & b) | (e & (a ^ b)));
  }
#pragma unroll
  for (; w < W; ++w) d += __popc(q[w] ^ c[w]);
  return d;
}

// The operands of one call, and the block's rows.
struct Args {
  const int* qcodes;   // (B, W)
  const int* codes;    // (N, W), 16-byte aligned
  const int* valid;    // (N,) or null: every row live
  int* hist;           // (B, S, 32 W + 1): counts, then offsets
  int* thr;            // (B,) threshold bins
  float* out_d;        // (B, k)
  int* out_i;
  int B, N, k, rows_per_split;
};

// A chunk's codes (n rows from row c0) and liveness, staged in shared
// memory by 16-byte copies (the last one short); c0 is a multiple of 32,
// so every copy starts aligned.
template <int W>
__device__ __forceinline__ void stage(const Args& a, int c0, int n, uint32_t* cs, int* vs,
                                      int tid) {
  const int words = n * W;
  for (int e = tid; 4 * e < words; e += THREADS)
    cp_async16(cs + 4 * e, a.codes + (size_t)c0 * W + 4 * e, 4 * min(4, words - 4 * e));
  if (a.valid != nullptr)
    for (int e = tid; 4 * e < n; e += THREADS)
      cp_async16(vs + 4 * e, a.valid + c0 + 4 * e, 4 * min(4, n - 4 * e));
  cp_commit();
}

template <int W>
struct Smem {
  static constexpr int BINS = 32 * W + 1;
  static constexpr int TABLE = (BINS * G + 3) / 4 * 4;   // ints: the [bin][G] / [G][bin] table
  static constexpr size_t BYTES = 4ull * (TABLE + 2 * CH * W + 2 * CH);
};

template <int W>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) hamming_count(const Args a) {
  using M = Smem<W>;
  extern __shared__ int4 smem4[];
  int* hist = reinterpret_cast<int*>(smem4);                     // [BINS][G]
  uint32_t* cs = reinterpret_cast<uint32_t*>(hist + M::TABLE);   // [2][CH * W]
  int* vs = reinterpret_cast<int*>(cs + 2 * CH * W);             // [2][CH]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, g0 = blockIdx.y * G;
  const int r_begin = split * a.rows_per_split;
  const int r_end = min(a.N, r_begin + a.rows_per_split);
  const int chunks = (r_end - r_begin + CH - 1) / CH;
  const bool has_q = g0 + lane < a.B;
  uint32_t q[W];
#pragma unroll
  for (int w = 0; w < W; ++w) q[w] = has_q ? (uint32_t)a.qcodes[(size_t)(g0 + lane) * W + w] : 0u;
  for (int e = tid; e < M::BINS * G; e += THREADS) hist[e] = 0;
  stage<W>(a, r_begin, min(CH, r_end - r_begin), cs, vs, tid);

  for (int c = 0; c < chunks; ++c) {
    cp_wait_all();
    __syncthreads();   // chunk c has landed; the other buffer is free
    const int c0 = r_begin + c * CH, n = min(CH, r_end - c0);
    const int buf = c & 1;
    if (c + 1 < chunks)
      stage<W>(a, c0 + CH, min(CH, r_end - c0 - CH), cs + (buf ^ 1) * CH * W,
               vs + (buf ^ 1) * CH, tid);
    const uint32_t* cb = cs + buf * CH * W;
    const int* vb = vs + buf * CH;
#pragma unroll 4
    for (int r = warp; r < n; r += WARPS) {
      if (a.valid != nullptr && vb[r] == 0) continue;
      uint32_t x[W];
#pragma unroll
      for (int w = 0; w < W; ++w) x[w] = cb[r * W + w];
      const int d = ham<W>(q, x);
      if (has_q) atomicAdd(hist + d * G + lane, 1);
    }
  }
  __syncthreads();
  for (int e = tid; e < M::BINS * G; e += THREADS) {
    const int b = g0 + e / M::BINS, d = e % M::BINS;
    if (b < a.B) a.hist[((size_t)b * gridDim.x + split) * M::BINS + d] = hist[d * G + e / M::BINS];
  }
}

// One block a query: the threshold bin, the offsets of bins <= t in place,
// the sentinel past the live rows.
__global__ void __launch_bounds__(THREADS)
hamming_offsets(int* __restrict__ hist, int* __restrict__ thr, float* __restrict__ out_d,
                int* __restrict__ out_i, int splits, int bins, int k) {
  __shared__ int total[MAX_BINS];
  __shared__ int start[MAX_BINS];
  __shared__ int live, t;
  const int b = blockIdx.x;
  int* h = hist + (size_t)b * splits * bins;
  for (int d = threadIdx.x; d < bins; d += THREADS) {
    int s = 0;
    for (int u = 0; u < splits; ++u) s += h[(size_t)u * bins + d];
    total[d] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0, at = bins - 1;
    for (int d = 0; d < bins; ++d) {
      start[d] = run;
      if (run < k && run + total[d] >= k) at = d;
      run += total[d];
    }
    live = run;
    t = at;
    thr[b] = at;
  }
  __syncthreads();
  for (int d = threadIdx.x; d <= t; d += THREADS) {
    int run = start[d];
    for (int u = 0; u < splits; ++u) {
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

template <int W>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) hamming_emit(const Args a) {
  using M = Smem<W>;
  extern __shared__ int4 smem4[];
  int* next = reinterpret_cast<int*>(smem4);                     // [G][BINS] running offsets
  uint32_t* cs = reinterpret_cast<uint32_t*>(next + M::TABLE);   // [2][CH * W]
  int* vs = reinterpret_cast<int*>(cs + 2 * CH * W);             // [2][CH]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, g0 = blockIdx.y * G;
  const int r_begin = split * a.rows_per_split;
  const int r_end = min(a.N, r_begin + a.rows_per_split);
  const int chunks = (r_end - r_begin + CH - 1) / CH;
  for (int e = tid; e < M::BINS * G; e += THREADS) {
    const int b = g0 + e / M::BINS;
    if (b < a.B) next[e] = a.hist[((size_t)b * gridDim.x + split) * M::BINS + e % M::BINS];
  }
  // the warp's queries g0 + warp + 8 j; an absent query's bound -1 takes no row
  uint32_t q[QW][W];
  int bound[QW];
#pragma unroll
  for (int j = 0; j < QW; ++j) {
    const int b = g0 + warp + WARPS * j;
    bound[j] = b < a.B ? a.thr[b] : -1;
#pragma unroll
    for (int w = 0; w < W; ++w) q[j][w] = b < a.B ? (uint32_t)a.qcodes[(size_t)b * W + w] : 0u;
  }
  stage<W>(a, r_begin, min(CH, r_end - r_begin), cs, vs, tid);
  __syncthreads();   // the offsets are in place
  // a threshold bin whose slots the splits before this one filled takes
  // no row here: the bound drops below it (a bin under the threshold
  // never fills k slots)
#pragma unroll
  for (int j = 0; j < QW; ++j)
    if (bound[j] >= 0 && next[(warp + WARPS * j) * M::BINS + bound[j]] >= a.k) --bound[j];

  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < chunks; ++c) {
    cp_wait_all();
    __syncthreads();   // chunk c has landed; the other buffer is free
    const int c0 = r_begin + c * CH, n = min(CH, r_end - c0);
    const int buf = c & 1;
    if (c + 1 < chunks)
      stage<W>(a, c0 + CH, min(CH, r_end - c0 - CH), cs + (buf ^ 1) * CH * W,
               vs + (buf ^ 1) * CH, tid);
    const uint32_t* cb = cs + buf * CH * W;
    const int* vb = vs + buf * CH;
    for (int r0 = 0; r0 < n; r0 += 32) {
      const int r = r0 + lane;
      const bool in = r < n && (a.valid == nullptr || vb[r] != 0);
      uint32_t x[W];
#pragma unroll
      for (int w = 0; w < W; ++w) x[w] = r < n ? cb[r * W + w] : 0u;
#pragma unroll
      for (int j = 0; j < QW; ++j) {
        const int d = ham<W>(q[j], x);
        const bool hit = in && d <= bound[j];
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (m == 0u) continue;
        int* nx = next + (warp + WARPS * j) * M::BINS;
        if (hit) {
          // rank the run's rows of equal distance among the hits (a lone
          // hit, the common case, needs no match)
          const unsigned peers = __popc(m) == 1 ? m : __match_any_sync(m, d);
          const int slot = nx[d] + __popc(peers & below);
          if (slot < a.k) {
            const size_t o = (size_t)(g0 + warp + WARPS * j) * a.k + slot;
            a.out_d[o] = (float)d;
            a.out_i[o] = c0 + r;
          }
          __syncwarp(m);
          if (lane == __ffs(peers) - 1) nx[d] += __popc(peers);
        }
        __syncwarp();
        if (nx[bound[j]] >= a.k) --bound[j];   // the threshold bin is full
      }
    }
  }
}

template <int W>
int launch(const Args& a, int splits, int groups, cudaStream_t stream) {
  const size_t smem = Smem<W>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(hamming_count<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hamming_emit<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, groups);
  hamming_count<W><<<grid, THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hamming_offsets<<<a.B, THREADS, 0, stream>>>(a.hist, a.thr, a.out_d, a.out_i, splits,
                                               Smem<W>::BINS, a.k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hamming_emit<W><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  qcodes (B, W) and codes
// (N, W) int32 packed bits, codes 16-byte aligned, valid (N,) int32 or
// null, 1 <= W <= 8; hist (B, splits, 32 W + 1) and thr (B,) int32
// scratch; splits of rows_per_split rows each (a multiple of 32), B
// queries in groups of 32; out (B, k) with 1 <= k <= N.
int hamming_topk_launch(const int* qcodes, const int* codes, const int* valid, int* hist,
                        int* thr, float* out_d, int* out_i, int B, int N, int W, int k,
                        int splits, int rows_per_split, cudaStream_t stream) {
  if (W < 1 || W > MAX_W || rows_per_split % 32 != 0 || k < 1 ||
      (reinterpret_cast<uintptr_t>(codes) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{qcodes, codes, valid, hist, thr, out_d, out_i, B, N, k, rows_per_split};
  const int groups = (B + G - 1) / G;
  switch (W) {
    case 1: return launch<1>(a, splits, groups, stream);
    case 2: return launch<2>(a, splits, groups, stream);
    case 3: return launch<3>(a, splits, groups, stream);
    case 4: return launch<4>(a, splits, groups, stream);
    case 5: return launch<5>(a, splits, groups, stream);
    case 6: return launch<6>(a, splits, groups, stream);
    case 7: return launch<7>(a, splits, groups, stream);
    default: return launch<8>(a, splits, groups, stream);
  }
}

}  // extern "C"
