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
//       (lax.top_k's order, a NaN estimate from a NaN weight above every
//       number); a slot whose estimate is -inf gives id -1 and estimate
//       0.
//
// Design (redesigned for the card: one launch, two roles, no dependence
// between blocks):
// * Blocks 1..G decay-copy a slice of SLICE cells each of the old table
//   into the new one (float4 where aligned).  Each first hashes the batch
//   into a bitmap of its slice in shared memory and skips every cell the
//   batch touches: exactly the cells block 0 writes, the column an invalid
//   id hashes to included.  G is the table's cells over SLICE (16 for the
//   served 64 KB table), so the copy runs on G SMs beside block 0.
// * Block 0 does everything that depends on the batch, reading only the
//   old table and its own writes, never a copy block's:
//   - it hashes the batch's (depth, m) columns and the candidates' and
//     reads every old cell it needs, decayed, into its scratch, all in
//     one round trip to memory;
//   - a thread an item (r, j): one pass over row r's m items decides
//     whether its column occurs earlier and, where it does not, folds
//     that column's adds, fold(old * decay, w_j1, w_j2, ...) in batch
//     order, and writes the cell once, keeping its value in the scratch;
//   - LANES (4) lanes a candidate share the test for an earlier copy of
//     its id, then each takes a contiguous block of rows (a cell's value:
//     the fold if the batch touched it, found as the row's first item
//     with that column, else the old cell decayed) and the first lane
//     folds the blocks' minima in row order;
//   - LANES lanes a candidate count the candidates ahead of it in the
//     stable (estimate desc, index asc) order, summed by shuffles, and
//     it writes itself to that slot when it is below topk.
//   Every loop runs the same steps in all lanes of a warp (m, the
//   candidates, the rows a lane: the same in a warp but at the last row
//   block), so no warp diverges on it: loops cut short in some lanes
//   leave a warp diverged, and a fold in it then runs lane by lane.
// * So every cell is written once, by one block, with (a)-(e)'s fp32
//   operations in their order: bit for bit with the plain version, and
//   the old table is never written (a snapshot reader holds it).
// * The batch comes by value (Batch, up to INLINE ids and weights in the
//   kernel's parameters; block 0 copies it to shared memory, the copy
//   blocks read their columns' ids straight from the parameters) or,
//   above INLINE, as one (2m,) int32 buffer on the card: ids, then the
//   weights' bits.  So a served update (m <= 64) needs no copy at all.
// * Block 0's scratch (scratch_words: the (depth, m) columns and folded
//   values, the topk + m candidates, their estimates, and their
//   (topk + m, depth) columns and old cells) lives in dynamic shared
//   memory when it fits in 46 KB (every served size: 7 KB at m = 64;
//   batch_role<true>, whose accesses the compiler then knows are to
//   shared memory), else in the wrapper's scratch in device memory.
//
// Bound at the served shape (width 4,096, depth 4, topk 64, m 1 to 64):
// bytes, the table read and written once (128 KB) plus the candidates and
// outputs, 0.04 us at 3.35 TB/s; the work is a few thousand operations.
// The kernel is launch- and latency-bound instead: block 0's chain of
// three barriers, each phase a few dependent shared-memory steps.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 1024;
constexpr int INLINE = 256;   // ids a batch passes by value (kernels/count_min.py)
constexpr int SLICE = 1024;   // cells a copy block decays (a multiple of 128)
constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 4;      // block 0's lanes a candidate
// dynamic shared memory a block may take without an opt-in, less the
// static 2 KB of the inline batch and the slice's bitmap
constexpr size_t SHARED_SCRATCH = 46 * 1024 - SLICE / 8;

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
  int* scratch;            // scratch_words(depth, topk, m) words, or null: shared memory
  int depth, log2w, topk, m;
  float decay;
};

// Scratch words of one launch: block 0's columns and folded values, the
// candidates, their estimates, and their columns and decayed old cells
// (kernels/count_min.py: scratch_words).
inline size_t scratch_words(int depth, int topk, int m) {
  return 2 * (size_t)depth * m + ((size_t)topk + m) * (2 + 2 * (size_t)depth);
}

__device__ __forceinline__ int column(uint32_t a, uint32_t b, uint32_t x, int log2w) {
  const uint32_t h = a * x + b;  // uint32 wraparound
  return log2w == 0 ? 0 : (int)(h >> (32 - log2w));
}

// Blocks 1..G: the decayed copy of one slice, the batch's cells skipped.
__device__ void copy_slice(const Args& p, const Batch& in, unsigned* bits) {
  const int tid = threadIdx.x, T = blockDim.x;
  const size_t cells = (size_t)p.depth << p.log2w;
  const size_t lo = (size_t)(blockIdx.x - 1) * SLICE;
  const int n = (int)(cells - lo < (size_t)SLICE ? cells - lo : (size_t)SLICE);
  for (int i = tid; i < SLICE / 32; i += T) bits[i] = 0u;
  __syncthreads();
  const int m = p.m, items = p.depth * m;
  const int* ids = p.staged ? p.staged : in.ids;
  for (int it = tid; it < items; it += T) {
    const int r = it / m, j = it - r * m;
    const int id = ids[j];
    const size_t cell = ((size_t)r << p.log2w) +
                        column((uint32_t)p.a[r], (uint32_t)p.b[r], id >= 0 ? (uint32_t)id : 0u,
                               p.log2w);
    if (cell >= lo && cell < lo + n) {
      const int k = (int)(cell - lo);
      atomicOr(bits + (k >> 5), 1u << (k & 31));
    }
  }
  __syncthreads();
  const float* src = p.old_table + lo;
  float* dst = p.out_table + lo;
  if (n % 4 == 0 && ((uintptr_t)src % 16) == 0 && ((uintptr_t)dst % 16) == 0) {
    for (int i = tid; i < n / 4; i += T) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      const unsigned skip = (bits[i >> 3] >> (4 * (i & 7))) & 0xfu;
      const float4 d = make_float4(__fmul_rn(v.x, p.decay), __fmul_rn(v.y, p.decay),
                                   __fmul_rn(v.z, p.decay), __fmul_rn(v.w, p.decay));
      if (skip == 0u) {
        reinterpret_cast<float4*>(dst)[i] = d;
      } else {
        if (!(skip & 1u)) dst[4 * i] = d.x;
        if (!(skip & 2u)) dst[4 * i + 1] = d.y;
        if (!(skip & 4u)) dst[4 * i + 2] = d.z;
        if (!(skip & 8u)) dst[4 * i + 3] = d.w;
      }
    }
  } else {
    for (int k = tid; k < n; k += T) {
      if (!((bits[k >> 5] >> (k & 31)) & 1u)) dst[k] = __fmul_rn(src[k], p.decay);
    }
  }
}

// Block 0: the batch's cells folded from the old table, the candidates'
// estimates and the stable top-k.  SMEM: the batch came by value and the
// scratch fits in shared memory (every served size), so the compiler sees
// every scratch access as a shared-memory one; else they are generic.
template <bool SMEM>
__device__ void batch_role(const Args& p, const Batch& in, int* s_ids, float* s_w,
                           int* s_scratch) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int sub = tid & (LANES - 1);
  const int m = p.m, depth = p.depth, topk = p.topk;
  const int width = 1 << p.log2w;
  const int C = topk + m, items = depth * m;
  const size_t pairs = (size_t)C * depth;
  int* cols = SMEM ? s_scratch : (p.scratch ? p.scratch : s_scratch);  // (depth, m)
  float* val = reinterpret_cast<float*>(cols + (size_t)items);    // (depth, m)
  int* cand = reinterpret_cast<int*>(val + (size_t)items);        // (C,)
  float* est = reinterpret_cast<float*>(cand + C);                // (C,)
  int* hcol = reinterpret_cast<int*>(est + C);                    // (C, depth)
  float* cells = reinterpret_cast<float*>(hcol + pairs);          // (C, depth)
  const int* ids = SMEM || !p.staged ? s_ids : p.staged;
  const float* w = SMEM || !p.staged ? s_w : reinterpret_cast<const float*>(p.staged + m);
  if (SMEM || !p.staged) {
    for (int j = tid; j < m; j += T) {
      s_ids[j] = in.ids[j];
      s_w[j] = in.w[j];
    }
  }
  // Every hash and every read of the old table at once, one round trip:
  // each item's cell and each candidate's cell of every row, decayed (the
  // batch's ids read where they came, s_ids being written meanwhile)
  const int* src_ids = SMEM || !p.staged ? in.ids : p.staged;
  for (int it = tid; it < items; it += T) {
    const int r = it / m, j = it - r * m;
    const int id = src_ids[j];
    const int c = column((uint32_t)p.a[r], (uint32_t)p.b[r], id >= 0 ? (uint32_t)id : 0u, p.log2w);
    cols[it] = c;
    val[it] = __fmul_rn(p.old_table[(size_t)r * width + c], p.decay);
  }
  for (size_t k = tid; k < pairs; k += T) {
    const int c = (int)(k / depth), r = (int)(k - (size_t)c * depth);
    const int id = c < topk ? p.hh_ids[c] : src_ids[c - topk];
    if (r == 0) cand[c] = id;
    const int h = column((uint32_t)p.a[r], (uint32_t)p.b[r], id >= 0 ? (uint32_t)id : 0u, p.log2w);
    hcol[k] = h;
    cells[k] = __fmul_rn(p.old_table[(size_t)r * width + h], p.decay);
  }
  __syncthreads();
  // the adds: a thread an item; the item of a column's first occurrence
  // folds every add of that column in batch order.  One pass over the
  // row's m items in every thread: the earlier ones decide whether this
  // item is the first, the later ones (itself included) are its adds.
  for (int it = tid; it < items; it += T) {
    const int r = it / m, j = it - r * m;
    const int* cr = cols + (size_t)r * m;
    const int c = cr[j];
    bool first = true;
    float acc = val[it];  // the old cell, decayed
#pragma unroll 4
    for (int j2 = 0; j2 < m; ++j2) {
      const bool hit = cr[j2] == c;
      first &= !(hit & (j2 < j));
      if (first & hit & (j2 >= j)) acc = __fadd_rn(acc, ids[j2] >= 0 ? w[j2] : 0.0f);
    }
    if (first) {
      p.out_table[(size_t)r * width + c] = acc;
      val[it] = acc;
    }
  }
  __syncthreads();
  // the candidates' estimates, LANES lanes a candidate: the lanes split
  // the test for an earlier copy of its id, then each folds a contiguous
  // block of rows (its cell: the value folded if the batch touched it,
  // from the row's first item with that column, else the old cell
  // decayed), and the first lane folds the blocks in row order, which is
  // the rows' fold (NaN propagates, as amin, and a tie keeps the earlier)
  const int span = (depth + LANES - 1) / LANES;
  for (int base = 0; base < C; base += T / LANES) {
    const int c = base + tid / LANES;
    const bool on = c < C;
    const int id = on ? cand[c] : -1;
    bool dup = false;
#pragma unroll 4
    for (int c2 = sub; c2 < C; c2 += LANES) dup |= (c2 < c) & (cand[c2] == id);
    float e = 0.0f;
    bool any = false;  // this lane's block holds a row
    for (int r = sub * span; r < sub * span + span; ++r) {
      if (r >= depth) break;  // the same in every lane of a warp but the last block
      const size_t k = (size_t)(on ? c : 0) * depth + r;
      const int h = hcol[k];
      const int* cr = cols + (size_t)r * m;
      int f = -1;  // the row's first item on this cell, if the batch touched it
#pragma unroll 4
      for (int j = 0; j < m; ++j) f = (f < 0 && cr[j] == h) ? j : f;
      const float v = f >= 0 ? val[(size_t)r * m + f] : cells[k];
      e = (!any || v < e || v != v) && e == e ? v : e;
      any = true;
    }
#pragma unroll
    for (int o = 1; o < LANES; o <<= 1) dup |= __shfl_xor_sync(FULL, dup, o);
    float acc = e;
    bool acc_any = any;
#pragma unroll
    for (int l = 1; l < LANES; ++l) {
      const float v = __shfl_sync(FULL, e, (tid & 31 & ~(LANES - 1)) + l);
      const bool has = __shfl_sync(FULL, any, (tid & 31 & ~(LANES - 1)) + l);
      if (has) {
        acc = (!acc_any || v < acc || v != v) && acc == acc ? v : acc;
        acc_any = true;
      }
    }
    if (on && sub == 0) est[c] = id >= 0 && !dup ? acc : -CUDART_INF_F;
  }
  __syncthreads();
  // the stable rank selection of the topk largest, in lax.top_k's order:
  // a NaN estimate (from a NaN weight) ranks above every number, as the
  // reference ranks the NaN a NaN weight leaves (its sign bit clear);
  // equal estimates, and NaNs, go to the lower index.  The order is
  // total, so the ranks are a permutation.  LANES lanes a candidate, each
  // counting every LANES-th candidate ahead of it.
  for (int base = 0; base < C; base += T / LANES) {
    const int c = base + tid / LANES;
    const bool on = c < C;
    const float e = on ? est[c] : 0.0f;
    int rank = 0;
#pragma unroll 4
    for (int j = sub; j < C; j += LANES) {
      const float f = est[j];
      rank += e != e ? f != f && j < c : f != f || f > e || (f == e && j < c);
    }
#pragma unroll
    for (int o = 1; o < LANES; o <<= 1) rank += __shfl_xor_sync(FULL, rank, o);
    if (on && sub == 0 && rank < topk) {
      const bool gone = e == -CUDART_INF_F;
      p.out_ids[rank] = gone ? -1 : cand[c];
      p.out_est[rank] = gone ? 0.0f : e;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    count_min_update(const Args p, const __grid_constant__ Batch in) {
  __shared__ int s_ids[INLINE];
  __shared__ float s_w[INLINE];
  __shared__ unsigned s_bits[SLICE / 32];
  extern __shared__ int s_scratch[];
  if (blockIdx.x == 0) {
    if (!p.scratch && !p.staged) {
      batch_role<true>(p, in, s_ids, s_w, s_scratch);
    } else {
      batch_role<false>(p, in, s_ids, s_w, s_scratch);
    }
  } else {
    copy_slice(p, in, s_bits);
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
  const size_t cells = (size_t)depth << log2w;
  const unsigned grid = 1u + (unsigned)((cells + SLICE - 1) / SLICE);
  count_min_update<<<grid, THREADS, shared ? bytes : 0, stream>>>(p, batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
