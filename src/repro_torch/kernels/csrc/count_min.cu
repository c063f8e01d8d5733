// Decayed count-min sketch update with its heavy-hitter re-rank, for Hopper (sm_90a).
//
// Replaces: the jitted _update of repro/adaptive/sketch.py (src/repro/
//   adaptive/sketch.py:39-65), which XLA compiles into one program for each
//   power-of-two batch shape; it reaches no Pallas kernel.  One launch
//   computes, for a (depth, width) fp32 table (width 2^log2w), the uint32
//   multipliers a / b of each row, the current top-k ids hh_ids and a batch
//   of m ids with weights w:
//   (a) new = old * decay in fp32 (decay the float32 of 0.5 ** (m_real /
//       halflife), computed on the host); the old table is never written;
//   (b) the hash of id j in row r: ((a_r * (uint32)x_j + b_r) mod 2^32) >>
//       (32 - log2w), where x_j is the id, or 0 for an invalid id (< 0 as an
//       int32: the host passes the low 32 bits of every id, as the
//       reference's 32-bit arrays hold it); an invalid id adds weight 0;
//   (c) the adds: each cell takes its weights in batch order,
//       ((t * decay + w_j1) + w_j2) + ..., each sum rounded to fp32, the
//       order of the reference's scatter-add;
//   (d) the candidates hh_ids ++ ids, each estimated by the minimum over
//       rows of new[r, hash_r(id)]; -inf for a negative candidate and for
//       every repeat of a non-negative id after its first in candidate order
//       (the reference's stable argsort rule);
//   (e) the topk largest estimates, ties to the lower candidate index
//       (lax.top_k's order); a slot whose estimate is -inf gives id -1 and
//       estimate 0.
//
// Design (a simple kernel that is right; one block of 1,024 threads, the
// phases separated by __syncthreads):
// * The batch comes by value (Batch, up to INLINE ids and weights in the
//   kernel's parameters, copied to shared memory) or, above INLINE, as one
//   (2m,) int32 buffer on the card: ids, then the weights' bits.  So a
//   served update (m <= 64) needs no copy at all.
// * The scratch (the (depth, m) hash columns, the topk + m candidates and
//   their estimates) lives in dynamic shared memory when it fits in 48 KB
//   (every served size: 4 KB at m = 64), else in the wrapper's scratch in
//   device memory; the loops below read it once an iteration, so its
//   latency sets the kernel's time.
// * Phase 1 writes the decayed table (float4 where aligned), the batch's
//   hash columns and the candidates.
// * Phase 2 folds the adds: the thread of item (r, j) whose column has no
//   earlier occurrence in row r's batch order adds every weight of that
//   column from j on, in order, and writes the cell once.  No two threads
//   write one cell, so no atomics and no order to lose.  O(depth m^2)
//   compares, 2m a thread; its loops, and phase 3's, take the same number
//   of steps in every lane, so a warp never diverges on them.
// * Phase 3 estimates each candidate and masks repeats (O((topk + m)^2)).
// * Phase 4 is a stable rank selection: candidate c's rank is the number of
//   candidates j with est_j > est_c, or est_j == est_c and j < c; those
//   ranks are a permutation, so each slot below topk is written once.
//   O((topk + m)^2) compares, cut off at rank topk.
//
// Bound at the served shape (width 4,096, depth 4, topk 64, m 1 to 64):
// bytes, the table read and written once (128 KB) plus the candidates and
// outputs, 0.04 us at 3.35 TB/s; the work is a few thousand operations.
// The kernel is launch- and latency-bound instead: one block, four
// barriers, each phase waiting on the last.  Left on the table: phase 1
// across more than one block (a 2 MB table at width 65,536 and depth 8 is
// one SM's copy), a sort for very large m.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 1024;
constexpr int INLINE = 256;   // ids a batch passes by value (kernels/count_min.py)
// dynamic shared memory a block may take without an opt-in, less the
// static 2 KB of the inline batch
constexpr size_t SHARED_SCRATCH = 46 * 1024;

struct Batch {
  int ids[INLINE];
  float w[INLINE];
};

struct Args {
  const float* old_table;  // (depth, width)
  const long long* a;      // (depth,) uint32 values in int64
  const long long* b;      // (depth,)
  const int* hh_ids;       // (topk,)
  const int* staged;       // (2m,) ids then weight bits on the card, or null
  float* out_table;        // (depth, width)
  int* out_ids;            // (topk,)
  float* out_est;          // (topk,)
  int* scratch;            // depth m + 2 (topk + m) words, or null: shared memory
  int depth, log2w, topk, m;
  float decay;
};

// Scratch words of one launch: the columns, the candidates, their estimates.
inline size_t scratch_words(int depth, int topk, int m) {
  return (size_t)depth * m + 2 * ((size_t)topk + m);
}

__device__ __forceinline__ int column(uint32_t a, uint32_t b, uint32_t x, int log2w) {
  const uint32_t h = a * x + b;  // uint32 wraparound
  return log2w == 0 ? 0 : (int)(h >> (32 - log2w));
}

__global__ void __launch_bounds__(THREADS)
    count_min_update(const Args p, const __grid_constant__ Batch in) {
  __shared__ int s_ids[INLINE];
  __shared__ float s_w[INLINE];
  extern __shared__ int s_scratch[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int m = p.m, depth = p.depth, topk = p.topk;
  const int width = 1 << p.log2w;
  const int C = topk + m;
  int* cols = p.scratch ? p.scratch : s_scratch;   // (depth, m)
  int* cand = cols + (size_t)depth * m;              // (C,)
  float* est = reinterpret_cast<float*>(cand + C);   // (C,)
  const int* ids = p.staged ? p.staged : s_ids;
  const float* w = p.staged ? reinterpret_cast<const float*>(p.staged + m) : s_w;
  if (!p.staged) {
    for (int j = tid; j < m; j += T) {
      s_ids[j] = in.ids[j];
      s_w[j] = in.w[j];
    }
  }
  // phase 1: the decayed table, and the batch's columns
  const size_t cells = (size_t)depth * width;
  if (cells % 4 == 0 && ((uintptr_t)p.old_table % 16) == 0 && ((uintptr_t)p.out_table % 16) == 0) {
    const float4* src = reinterpret_cast<const float4*>(p.old_table);
    float4* dst = reinterpret_cast<float4*>(p.out_table);
    for (size_t i = tid; i < cells / 4; i += T) {
      const float4 v = src[i];
      dst[i] = make_float4(__fmul_rn(v.x, p.decay), __fmul_rn(v.y, p.decay),
                           __fmul_rn(v.z, p.decay), __fmul_rn(v.w, p.decay));
    }
  } else {
    for (size_t i = tid; i < cells; i += T) p.out_table[i] = __fmul_rn(p.old_table[i], p.decay);
  }
  __syncthreads();  // the inline batch is in shared memory
  const int items = depth * m;
  for (int it = tid; it < items; it += T) {
    const int r = it / m, j = it - r * m;
    const int id = ids[j];
    cols[it] = column((uint32_t)p.a[r], (uint32_t)p.b[r], id >= 0 ? (uint32_t)id : 0u, p.log2w);
  }
  for (int c = tid; c < C; c += T) cand[c] = c < topk ? p.hh_ids[c] : ids[c - topk];
  __syncthreads();
  // phase 2: each cell's adds in batch order, by the thread of its first
  // add.  Both loops run all m steps in every lane, predicated rather than
  // cut short: lanes whose loops end at different steps leave the warp
  // diverged, and the fold then runs lane by lane.
  for (int it = tid; it < items; it += T) {
    const int r = it / m, j = it - r * m;
    const int* cr = cols + (size_t)r * m;
    const int c = cr[j];
    bool first = true;
    for (int j2 = 0; j2 < m; ++j2) first &= !((j2 < j) & (cr[j2] == c));
    float* cell = p.out_table + (size_t)r * width + c;
    float acc = first ? *cell : 0.0f;
    for (int j2 = 0; j2 < m; ++j2) {
      if (first & (j2 >= j) & (cr[j2] == c)) acc = __fadd_rn(acc, ids[j2] >= 0 ? w[j2] : 0.0f);
    }
    if (first) *cell = acc;
  }
  __syncthreads();
  // phase 3: the candidates' estimates, repeats masked
  for (int c = tid; c < C; c += T) {
    const int id = cand[c];
    float e = -CUDART_INF_F;
    if (id >= 0) {
      bool dup = false;  // every step in every lane, as in phase 2
      for (int c2 = 0; c2 < C; ++c2) dup |= (c2 < c) & (cand[c2] == id);
      if (!dup) {
        for (int r = 0; r < depth; ++r) {
          const float v = p.out_table[(size_t)r * width +
                                      column((uint32_t)p.a[r], (uint32_t)p.b[r], (uint32_t)id,
                                             p.log2w)];
          e = (r == 0 || v < e || v != v) && e == e ? v : e;  // NaN propagates, as amin
        }
      }
    }
    est[c] = e;
  }
  __syncthreads();
  // phase 4: the stable rank selection of the topk largest (a NaN estimate,
  // from a NaN weight, ranks after -inf, as the plain version's sort puts
  // it; the order stays total, so the ranks stay a permutation)
  for (int c = tid; c < C; c += T) {
    const float e = est[c];
    int rank = 0;
    for (int j = 0; j < C && rank < topk; ++j) {
      const float f = est[j];
      const bool ahead = e != e ? (f == f || j < c) : (f > e || (f == e && j < c));
      rank += ahead;
    }
    if (rank < topk) {
      const bool gone = e == -CUDART_INF_F;
      p.out_ids[rank] = gone ? -1 : cand[c];
      p.out_est[rank] = gone ? 0.0f : e;
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  depth >= 1, 0 <= log2w <=
// 30, topk >= 0, m >= 0.  The batch is either on the host (ids and weights
// non-null for m > 0, m <= INLINE: copied into the launch's parameters
// before this returns) or staged on the card (staged non-null: (2m,) int32,
// the ids then the weights' bits).  Every card array contiguous; scratch
// holds scratch_words(depth, topk, m) words, used only when they do not fit
// in the block's shared memory.

int count_min_launch(const float* old_table, const long long* a, const long long* b,
                     const int* hh_ids, const int* ids, const float* weights, const int* staged,
                     float* out_table, int* out_ids, float* out_est, int* scratch, int depth,
                     int log2w, int topk, int m, float decay, cudaStream_t stream) {
  if (depth < 1 || log2w < 0 || log2w > 30 || topk < 0 || m < 0) return (int)cudaErrorInvalidValue;
  Batch batch;
  if (staged == nullptr) {
    if (m > INLINE || (m > 0 && (ids == nullptr || weights == nullptr)))
      return (int)cudaErrorInvalidValue;
    memcpy(batch.ids, ids, sizeof(int) * (size_t)m);
    memcpy(batch.w, weights, sizeof(float) * (size_t)m);
  }
  const size_t bytes = sizeof(int) * scratch_words(depth, topk, m);
  const bool shared = bytes <= SHARED_SCRATCH;
  const Args p{old_table, a, b, hh_ids, staged, out_table, out_ids, out_est,
               shared ? nullptr : scratch, depth, log2w, topk, m, decay};
  count_min_update<<<1, THREADS, shared ? bytes : 0, stream>>>(p, batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
