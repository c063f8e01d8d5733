// Candidate-row L2 + top-k for Hopper (sm_90a): the per-query candidate
// tile and the whole IVF probe chain, one scan and one merge.
//
// Replaces: repro/kernels/bucket_topk.py::candidate_topk_pallas (the TPU
//   kernel).  Each query row b scores candidate rows v with id >= 0:
//   d2 = (vn - 2 v.q) + qn, rounded in that order; dead slots (id < 0)
//   never rank.  The result is the k smallest (distance, id) pairs, a pair
//   seen twice emitted once (as the Pallas merge retires every copy of the
//   pair it selects), (inf, -1) in slots nothing fills.  One launch serves
//   k <= 32; a larger k is taken in passes (kernels/common.py:
//   topk_passes), each bounded by the last pair of the one before
//   (after_d / after_i: rt::WarpTopK::beats), the carried best filtered by
//   the same bound.  Three entries share the device code:
//   candidate_topk_launch     a per-query (B, C, D) tile, merged with an
//                             optional carried best (the Pallas kernel's
//                             contract);
//   bucket_probe_topk_launch  the probe chain: query b's candidates are
//                             the slots of buckets probe[b, 0..nprobe), ids
//                             from bucket_ids (K, cap), rows either from
//                             bucket_vecs (K, cap, D) by (bucket, slot)
//                             (BucketRows, the served IVF layout) or from
//                             db (N, D) by entity id (IndirectRows, the
//                             index layout: no bucket-major copy).
//   candidate_rows_topk_launch
//                             a per-query (B, C) list of row ids into rows
//                             (N, D), read inside the kernel (IndirectRows
//                             on the tile's segments): the served forest's
//                             rerank, whose candidates are bucket-slot ids
//                             of the placed (Kloc cap, D) table, without
//                             the (B, C, D) gather.  An id outside [0, N)
//                             is a dead slot.
//   On disjoint buckets the chain equals nprobe launches of the tile entry
//   carrying the best, bit for bit: the same per-candidate arithmetic and
//   the same order.
//
// Bound.  Reading the candidate rows: each probed row is D fp32 (512 B at
// SIFT's d = 128, 384 B at DEEP's 96) against 4 D FLOP of FMA, about 1/32
// FLOP per byte, so the scan is bandwidth-bound at 3.35 TB/s:
//   one tile step (B 64, C 306, about 122 live a query): about 4 MB, 1.2 us;
//   the served chain (B 64, nprobe 32): about 250K (query, row) pairs, at
//     most 128 MB, less where queries share buckets (L2 catches repeats);
//   DEEP-10M (B 1,024, nprobe 32, cap 763): about 10M pairs, 3.9 GB read
//     pair by pair, 1.2 ms; the distinct probed rows are fewer;
//   the served forest rerank (B 64, C = nprobe 32 x beam 8 x leaf 8 =
//     2,048 ids a query, most live): at most 131K rows, 64 MiB, 20 us;
//     the gather it replaces writes and reads that tile once more.
// chip_smoke.py computes each bound from the run's operands.
//
// Design.
// * Blocks: a grid of (B, S) scan blocks of two warps, then one merge warp
//   per query.  The tile entry splits C into S segments, S chosen so that
//   B = 64 still puts several blocks on each of the 132 SMs; the chain
//   gives every (query, probed bucket) pair its own block (S = nprobe:
//   2,048 blocks at the served shape, 32,768 at DEEP).  Each scan block
//   writes its sorted list of at most k pairs into a (B, S, KT) partial
//   (KT = list_len(k), the wrapper's scratch); the merge warp folds the S
//   partials and the carried best into the result with de-duplication.
// * Dead slots cost no row load: a block reads its segment's ids 512 at a
//   time, compacts the live (slot, id) pairs into shared memory with a warp
//   ballot, and the warps walk only the live list.
// * Loads: a candidate row is split across a group of 8 lanes, each lane
//   reading 16-byte float4s (neighbouring lanes on neighbouring addresses,
//   a 128-byte line per group), and each group has two rows in flight, so
//   a warp keeps 8 rows and, at d = 128, 8 float4 loads a lane
//   outstanding.  The query sits in shared memory.  A lane sums its
//   elements in fp32 FMA in a fixed order and the group's 8 partials are
//   summed by an xor butterfly (commutative at each level, so every lane
//   of the group holds the same bits).  A d that is not a multiple of 4
//   takes the same shape with scalar loads (the wrapper passes a 16-byte
//   aligned copy where d is a multiple of 4, so the rounding depends on d
//   alone).  The distance is __fadd_rn(__fsub_rn(vn, __fmul_rn(2, dot)),
//   qn): no contraction, no TF32, no tensor cores (ROADMAP faults 4, 7).
// * Selection: each warp keeps its list spread over its lanes, entry j in
//   lane j (k <= 32 = KMAX fits a warp).  Its k-th pair is the threshold,
//   held by every lane; a ballot picks the rows of a pass that beat it, and
//   only those pay an insertion (a duplicate check, a ballot for the
//   position and one shuffle to shift), one at a time, re-checked against
//   the tightened threshold.  At the served shape a warp inserts about
//   k ln(rows / k) of its rows after the first k.
//
// Left on the table: persistent blocks, TMA or cp.async staging of the
// rows, a threshold shared across the warps of a block, and a CUDA graph
// around the serve.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int WARPS = 2;              // warps per scan block
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = 8;              // lanes per candidate row
constexpr int GROUPS = 32 / GROUP;    // row groups per warp
constexpr int PASS = 2 * GROUPS;      // rows per warp per pass (two per group)
constexpr int CHUNK = 512;            // slots compacted per round
constexpr int MERGE_WARPS = 4;        // queries per merge block
constexpr unsigned FULL = 0xffffffffu;

static_assert(CHUNK % THREADS == 0, "a compaction round covers whole blocks");

// Operands of one scan.  Direct rows: slot c of a segment is row
// (row_base + c) of `rows`; indirect rows: row `id` of `rows`.
struct ScanArgs {
  const float* q;        // (B, D)
  const float* rows;     // vecs (B, C, D) | bucket_vecs (K, cap, D) | db (N, D)
  const int* ids;        // ids (B, C) | bucket_ids (K, cap)
  const int* probe;      // (B, nprobe) probed buckets, or null: the tile entry
  const float* after_d;  // (B,) the pass's bound, or null: none
  const int* after_i;
  float* part_d;         // (B, S, kt)
  int* part_i;
  int B, D, k, kt, S;
  int width;             // C (tile) or cap (chain)
  int per;               // tile: slots per segment
  int n_buckets;         // chain: K
  int nprobe;            // chain: probes per query
  int n_rows;            // rows by id: N, ids >= N dead (0: unchecked)
};

// The warp's running top-k: entry j of the sorted list in lane j (lanes
// j >= k stay (inf, ID_NONE)) and the k-th pair in every lane, a pair held
// already never inserted twice; BOUNDED: a pass's bound is tested too.
template <bool BOUNDED>
using WarpList = rt::WarpTopK<1, true, BOUNDED>;

// ||q||^2 in the rows' order: lane l of the group sums its elements, the
// group's partials are summed by the butterfly.
template <bool VEC>
__device__ __forceinline__ float group_norm(const float* qs, int D, int l) {
  float s = 0.f;
  if (VEC) {
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int c = l; c < (D >> 2); c += GROUP) {
      const float4 v = q4[c];
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
  } else {
    for (int e = l; e < D; e += GROUP) s = fmaf(qs[e], qs[e], s);
  }
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

__device__ __forceinline__ void acc4(const float4 v, const float4 qq, float& vn, float& dot) {
  vn = fmaf(v.x, v.x, vn);
  dot = fmaf(v.x, qq.x, dot);
  vn = fmaf(v.y, v.y, vn);
  dot = fmaf(v.y, qq.y, dot);
  vn = fmaf(v.z, v.z, vn);
  dot = fmaf(v.z, qq.z, dot);
  vn = fmaf(v.w, v.w, vn);
  dot = fmaf(v.w, qq.w, dot);
}

// One pass of a warp: live entries p0 + g and p0 + GROUPS + g of the
// compacted list, scored by lane group g and offered to the warp's list.
template <bool VEC, bool INDIRECT, bool BOUNDED>
__device__ __forceinline__ void scan_pass(const ScanArgs& a, const float* qs, float qn,
                                          const int* s_slot, const int* s_id, int cnt,
                                          size_t row_base, int p0, int lane,
                                          WarpList<BOUNDED>& top) {
  const int g = lane / GROUP, l = lane % GROUP;
  const int pa = p0 + g, pb = p0 + GROUPS + g;
  const bool va = pa < cnt, vb = pb < cnt;
  const int ia = va ? s_id[pa] : rt::ID_NONE;
  const int ib = vb ? s_id[pb] : rt::ID_NONE;
  const int D = a.D;
  const float* ra = a.rows;
  const float* rb = a.rows;
  if (va) ra += (INDIRECT ? (size_t)ia : row_base + (size_t)s_slot[pa]) * D;
  if (vb) rb += (INDIRECT ? (size_t)ib : row_base + (size_t)s_slot[pb]) * D;
  float vna = 0.f, dta = 0.f, vnb = 0.f, dtb = 0.f;
  if (VEC) {
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const float4* a4 = reinterpret_cast<const float4*>(ra);
    const float4* b4 = reinterpret_cast<const float4*>(rb);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = l; c < (D >> 2); c += GROUP) {
      const float4 x = va ? __ldg(a4 + c) : zero;
      const float4 y = vb ? __ldg(b4 + c) : zero;
      const float4 qq = q4[c];
      acc4(x, qq, vna, dta);
      acc4(y, qq, vnb, dtb);
    }
  } else {
#pragma unroll 4
    for (int e = l; e < D; e += GROUP) {
      const float x = va ? __ldg(ra + e) : 0.f;
      const float y = vb ? __ldg(rb + e) : 0.f;
      const float qq = qs[e];
      vna = fmaf(x, x, vna);
      dta = fmaf(x, qq, dta);
      vnb = fmaf(y, y, vnb);
      dtb = fmaf(y, qq, dtb);
    }
  }
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) {
    vna += __shfl_xor_sync(FULL, vna, off);
    dta += __shfl_xor_sync(FULL, dta, off);
    vnb += __shfl_xor_sync(FULL, vnb, off);
    dtb += __shfl_xor_sync(FULL, dtb, off);
  }
  const float da = __fadd_rn(__fsub_rn(vna, __fmul_rn(2.f, dta)), qn);
  const float db = __fadd_rn(__fsub_rn(vnb, __fmul_rn(2.f, dtb)), qn);
  // the group's first lane offers its rows
  top.offer(l == 0 && va, da, ia, a.k, lane);
  top.offer(l == 0 && vb, db, ib, a.k, lane);
}

// Scan block (b, s): the live slots of its segments into a sorted partial.
template <bool VEC, bool INDIRECT, bool BOUNDED>
__global__ void __launch_bounds__(THREADS) candidate_scan(const ScanArgs a) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [D rounded up to 4]
  __shared__ int s_slot[CHUNK];
  __shared__ int s_id[CHUNK];
  __shared__ int s_count;
  __shared__ float s_ld[(WARPS - 1) * 32];
  __shared__ int s_li[(WARPS - 1) * 32];

  const int b = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D;
  for (int e = tid; e < D; e += THREADS) qs[e] = a.q[(size_t)b * D + e];
  __syncthreads();
  const float qn = group_norm<VEC>(qs, D, lane % GROUP);

  // this block's segment: a run of the query's tile, or one probed bucket
  const int* seg_ids;
  int n;
  size_t row_base;
  if (a.probe == nullptr) {
    const int c0 = s * a.per;
    n = max(0, min(a.per, a.width - c0));
    row_base = (size_t)b * a.width + c0;
    seg_ids = a.ids + row_base;
  } else {
    const int bucket = a.probe[(size_t)b * a.nprobe + s];
    const bool ok = bucket >= 0 && bucket < a.n_buckets;
    n = ok ? a.width : 0;
    row_base = ok ? (size_t)bucket * a.width : 0;
    seg_ids = a.ids + row_base;
  }

  WarpList<BOUNDED> top;
  if (BOUNDED) {
    float ad;
    int ai;
    rt::after_of(a.after_d, a.after_i, b, ad, ai);
    top.init(ad, ai);
  } else {
    top.init();
  }
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int m = min(CHUNK, n - c0);
    if (tid == 0) s_count = 0;
    __syncthreads();
    for (int r = 0; r < m; r += THREADS) {   // the same trip count in every warp
      const int c = c0 + r + tid;
      const int id = r + tid < m ? seg_ids[c] : -1;
      const bool live = id >= 0 && (a.n_rows == 0 || id < a.n_rows);
      const unsigned mask = __ballot_sync(FULL, live);
      int base = 0;
      if (lane == 0 && mask) base = atomicAdd(&s_count, __popc(mask));
      base = __shfl_sync(FULL, base, 0);
      if (live) {
        const int pos = base + __popc(mask & ((1u << lane) - 1u));
        s_slot[pos] = c;
        s_id[pos] = id;
      }
    }
    __syncthreads();
    const int cnt = s_count;
    for (int p0 = warp * PASS; p0 < cnt; p0 += WARPS * PASS)
      scan_pass<VEC, INDIRECT, BOUNDED>(a, qs, qn, s_slot, s_id, cnt, row_base, p0, lane, top);
    __syncthreads();
  }

  // fold the other warps' lists into warp 0's, then write the partial
  if (warp > 0) {
    s_ld[(warp - 1) * 32 + lane] = top.d[0];
    s_li[(warp - 1) * 32 + lane] = top.i[0];
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 0; w < WARPS - 1; ++w)
      top.offer(lane < a.k, s_ld[w * 32 + lane], s_li[w * 32 + lane], a.k, lane);
    const size_t o = ((size_t)b * a.S + s) * a.kt;
    top.store(a.part_d + o, a.part_i + o, a.kt, lane, false);
  }
}

// One warp per query: the carried best (B, kb) and the L = S * kt partial
// entries into the top-k, a pair seen twice kept once; the carried best is
// held to the pass's bound like every other pair.
template <bool BOUNDED>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
candidate_merge(const float* __restrict__ part_d, const int* __restrict__ part_i, int L,
                const float* __restrict__ best_d, const int* __restrict__ best_i, int kb,
                const float* __restrict__ after_d, const int* __restrict__ after_i,
                float* __restrict__ out_d, int* __restrict__ out_i, int B, int k) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;   // the whole warp leaves together
  WarpList<BOUNDED> top;
  if (BOUNDED) {
    float ad;
    int ai;
    rt::after_of(after_d, after_i, b, ad, ai);
    top.init(ad, ai);
  } else {
    top.init();
  }
  if (best_d != nullptr) {
    for (int e0 = 0; e0 < kb; e0 += 32) {
      const int e = e0 + lane;
      const bool in = e < kb;
      top.offer(in, in ? best_d[(size_t)b * kb + e] : CUDART_INF_F,
                in ? best_i[(size_t)b * kb + e] : rt::ID_NONE, k, lane);
    }
  }
  const float* pd = part_d + (size_t)b * L;
  const int* pi = part_i + (size_t)b * L;
  for (int e0 = 0; e0 < L; e0 += 32) {
    const int e = e0 + lane;
    const bool in = e < L;
    top.offer(in, in ? pd[e] : CUDART_INF_F, in ? pi[e] : rt::ID_NONE, k, lane);
  }
  top.store(out_d + (size_t)b * k, out_i + (size_t)b * k, k, lane, true);
}

template <bool BOUNDED>
int scan_and_merge_bounded(const ScanArgs& a, bool indirect, const float* best_d,
                           const int* best_i, int kb, float* out_d, int* out_i,
                           cudaStream_t stream) {
  if (a.S > 0) {
    const bool vec = (a.D % 4) == 0;
    const size_t smem = sizeof(float) * (size_t)((a.D + 3) / 4 * 4);
    const dim3 grid(a.B, a.S);
    if (vec && indirect)
      candidate_scan<true, true, BOUNDED><<<grid, THREADS, smem, stream>>>(a);
    else if (vec)
      candidate_scan<true, false, BOUNDED><<<grid, THREADS, smem, stream>>>(a);
    else if (indirect)
      candidate_scan<false, true, BOUNDED><<<grid, THREADS, smem, stream>>>(a);
    else
      candidate_scan<false, false, BOUNDED><<<grid, THREADS, smem, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.B + MERGE_WARPS - 1) / MERGE_WARPS;
  candidate_merge<BOUNDED><<<blocks, MERGE_WARPS * 32, 0, stream>>>(
      a.part_d, a.part_i, a.S * a.kt, best_d, best_i, kb, a.after_d, a.after_i, out_d, out_i,
      a.B, a.k);
  return (int)cudaGetLastError();
}

// A first pass (no bound) runs the lists without the bound's test.
int scan_and_merge(const ScanArgs& a, bool indirect, const float* best_d, const int* best_i,
                   int kb, float* out_d, int* out_i, cudaStream_t stream) {
  return a.after_d != nullptr
             ? scan_and_merge_bounded<true>(a, indirect, best_d, best_i, kb, out_d, out_i, stream)
             : scan_and_merge_bounded<false>(a, indirect, best_d, best_i, kb, out_d, out_i,
                                             stream);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t as int (0 = launched); B >= 1, 1 <= k <= kt
// <= 32, the partials (B, splits, kt) / (B, nprobe, kt) scratch; after_d /
// after_i are (B,) or both null: the pass's bound.

// The tile entry: C slots a query in `splits` segments of `per`.  best_d /
// best_i are both null (start from the sentinel) or both (B, kb).
int candidate_topk_launch(const float* q, const float* vecs, const int* ids,
                          const float* best_d, const int* best_i, int kb, const float* after_d,
                          const int* after_i, float* part_d, int* part_i, float* out_d,
                          int* out_i, int B, int C, int D, int k, int kt, int splits, int per,
                          cudaStream_t stream) {
  if (k < 1 || k > kt || kt > rt::KMAX) return (int)cudaErrorInvalidValue;
  ScanArgs a{q, vecs, ids, nullptr, after_d, after_i, part_d, part_i, B, D, k, kt, splits, C,
             per, 0, 0};
  return scan_and_merge(a, false, best_d, best_i, kb, out_d, out_i, stream);
}

// The probe chain: rows are bucket_vecs (K, cap, D) when indirect == 0,
// db (N, D) by entity id when indirect == 1.
int bucket_probe_topk_launch(const float* q, const int* probe, const int* bucket_ids,
                             const float* rows, int indirect, const float* after_d,
                             const int* after_i, float* part_d, int* part_i, float* out_d,
                             int* out_i, int B, int nprobe, int K, int cap, int D, int k, int kt,
                             cudaStream_t stream) {
  if (k < 1 || k > kt || kt > rt::KMAX) return (int)cudaErrorInvalidValue;
  ScanArgs a{q, rows, bucket_ids, probe, after_d, after_i, part_d, part_i, B, D, k, kt, nprobe,
             cap, 0, K, nprobe};
  return scan_and_merge(a, indirect != 0, nullptr, nullptr, 0, out_d, out_i, stream);
}

// The tile entry with rows read by id: query b's C candidates are rows
// ids[b, c] of rows (n_rows, D), in `splits` segments of `per`.
int candidate_rows_topk_launch(const float* q, const float* rows, int n_rows, const int* ids,
                               const float* after_d, const int* after_i, float* part_d,
                               int* part_i, float* out_d, int* out_i, int B, int C, int D, int k,
                               int kt, int splits, int per, cudaStream_t stream) {
  if (k < 1 || k > kt || kt > rt::KMAX || n_rows < 1) return (int)cudaErrorInvalidValue;
  ScanArgs a{q,  rows, ids, nullptr, after_d, after_i, part_d, part_i, B, D, k, kt, splits,
             C,  per,  0,   0,       n_rows};
  return scan_and_merge(a, true, nullptr, nullptr, 0, out_d, out_i, stream);
}

}  // extern "C"
