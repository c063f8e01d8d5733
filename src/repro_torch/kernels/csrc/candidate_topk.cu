// Candidate-row L2 + top-k for Hopper (sm_90a): the per-query candidate
// tile and the whole IVF probe chain, one scan and one merge; the tile
// read by row id, one cluster launch.
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
//   the same bound.  Three entries share the per-row arithmetic:
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
//                             (N, D), read inside the kernel: the served
//                             forest's rerank (bucket-slot ids of the
//                             placed (Kloc cap, D) table) and the index
//                             path's (core/two_level.py _rerank, the
//                             rerank of core/tree.py tree_search and of
//                             core/lsh.py lsh_search), without the
//                             (B, C, D) gather.  An id outside [0, N) is a
//                             dead slot.  Its own kernel (below).
//   On disjoint buckets the chain equals nprobe launches of the tile entry
//   carrying the best, bit for bit: the same per-candidate arithmetic and
//   the same order.  The rows entry equals the tile entry on the gathered
//   rows bit for bit: the same arithmetic, and the top-k of the same set
//   of distinct pairs.
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
//     2,048 ids a query, most live): at most 131K rows, 64 MiB, 20 us
//     pair by pair, the distinct rows about a third of that;
//   the index path's tree bottom (B 1,024, C 2,048): 2M pairs, 1 GiB pair
//     by pair, 0.32 ms; the gather it replaces writes and reads that tile.
// chip_smoke.py computes each bound from the run's operands.
//
// Design of the tile entry and the chain.
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
// Design of the rows entry (candidate_rows_cluster).  Its first design ran
// the scan and merge above: two launches handing over a (B, S, KT) partial
// in global memory, two warps a block each waiting one load round trip a
// pass of 8 rows, two block barriers and a shared atomic a 512-slot chunk;
// 34 us at the forest shape against a 5.75 us bytes bound, its reads
// latency-bound (1.9 TB/s of pair bytes).  Now (each choice timed on the
// card, PERF.md):
// * One launch a pass: the S <= 8 segments of a query are one thread block
//   cluster (cudaLaunchKernelEx with a cluster dimension).  Each block's
//   warps merge their lists pairwise in shared memory; after a cluster
//   barrier rank 0's warps merge the blocks' lists, read through
//   distributed shared memory, pairwise too (a pair held twice kept once,
//   so an id repeated across blocks is emitted once), and write (B, k); a
//   second barrier keeps the blocks resident until those reads end.  The
//   wrapper picks S from B and the SM count, about 4 blocks a SM over the
//   batch: 8 at B 64, 1 at B 1,024.
// * Bytes in flight: each warp stages its rows by 16-byte cp.async.cg into
//   its own shared-memory ring of STAGES = 2 passes of 8 rows, one pass
//   ahead of the one it scores (8 KB a warp at d 128).  A third stage left
//   62 clusters of 8 resident, fewer than B 64 needs, and took a second
//   wave; TMA bulk copies of whole rows gained nothing over cp.async.  The
//   scoring reads the staged rows with the tile entry's lanes, loads,
//   FMAs and butterfly (ring_pass, scan_pass's arithmetic), so the result
//   stays bit for bit the tile entry's on the gathered rows.
// * Selection: a warp's rows are few (64 at the forest shape), so with
//   WarpList's one-at-a-time insertion most of them were inserted.  Here a
//   row that beats the warp's k-th pair is appended to a 32-pair buffer
//   by a ballot, and a full buffer is merged into the list at once by a
//   bitonic sort and merge (BufferedList); the block and cluster folds are
//   the same merges (fold_tree).
// * Compaction inside the warp: each warp takes its own 32-slot chunks of
//   the segment, loads their ids together and ballots the live ones into
//   its own list, 256 slots a round: no block barrier and no shared atomic
//   in the scan.
// * A d that is not a multiple of 4 (the kd top's 2-d partition features)
//   keeps scan_pass's scalar loads from global memory, and a d whose rings
//   would pass RING_MAX_BYTES its float4 loads; no ring in either.
// At the index path's shape (B 1,024, one block a query) the kernel reads
// the pairs' rows from device memory near its rate; only rows shared by
// queries scanned together would read fewer bytes.
//
// Left on the table: persistent blocks, grouping queries that share rows,
// TMA for the chain's rows, and a CUDA graph around the serve.
#include <cooperative_groups.h>
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
  int n_rows;            // the rows entry: N, ids >= N dead
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
// compacted list, scored by lane group g and offered to the warp's list
// (a WarpList, or the rows entry's BufferedList).
template <bool VEC, bool INDIRECT, bool BOUNDED, class List = WarpList<BOUNDED>>
__device__ __forceinline__ void scan_pass(const ScanArgs& a, const float* qs, float qn,
                                          const int* s_slot, const int* s_id, int cnt,
                                          size_t row_base, int p0, int lane, List& top) {
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
      const bool live = id >= 0;
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

// ------------------------------------------------ the rows entry's cluster
// One cluster of S blocks a query, block r scanning segment r of its ids;
// each warp compacts the live ids of its own 32-slot chunks (chunks warp,
// warp + RW, ...) into its own list, RCH chunks a round, and scores them
// PASS rows at a time.  MODE: ROWS_RING, rows staged by cp.async into the
// warp's ring of STAGES passes (D a multiple of 4, the ring within
// RING_MAX_BYTES); ROWS_VEC, float4 loads from global memory (scan_pass);
// ROWS_SCALAR, scalar loads (scan_pass).
constexpr int RW = 4;                  // warps per block
constexpr int RTHREADS = RW * 32;
constexpr int RCH = 8;                 // 32-slot chunks a warp compacts a round
constexpr int ROUND = RCH * 32;        // list entries a warp holds
constexpr int STAGES = 2;              // passes in a warp's ring
constexpr int CLUSTER_MAX = 8;         // the portable cluster size
constexpr int RING_MAX_BYTES = 64 * 1024;   // d <= 256 staged
enum { ROWS_RING = 0, ROWS_VEC = 1, ROWS_SCALAR = 2 };

struct RowsArgs {
  ScanArgs s;            // probe, part_d / part_i unused; S: the cluster size
  float* out_d;          // (B, k)
  int* out_i;
};

// A warp's running top-k for the rows entry, k <= 32: entry j of the
// sorted list in lane j (lanes j >= k hold (inf, ID_NONE)), the k-th pair
// the threshold.  A pair offered that beats it is appended to the warp's
// 32-entry buffer in shared memory (a ballot, no insertion); a full buffer
// is merged into the list at once (flush: a bitonic sort of the buffer, a
// bitonic merge with the list, a pair held twice kept once).  WarpList
// inserts pairs one at a time, at about a hundred cycles of shuffles and
// ballots each, and the rows entry's warps see few rows each, so most of
// their rows were inserted (PERF.md).  All lanes call in step.
template <bool BOUNDED>
struct BufferedList {
  float d;          // entry `lane`
  int i;
  float thr_d;      // entry k - 1
  int thr_i;
  float aft_d;      // the pass's lower bound
  int aft_i;
  int n;            // pairs in the buffer
  float* bd;        // the buffer: 32 pairs in shared memory
  int* bi;

  __device__ __forceinline__ void init(float* buf_d, int* buf_i, float ad, int ai) {
    d = CUDART_INF_F;
    i = rt::ID_NONE;
    thr_d = CUDART_INF_F;
    thr_i = rt::ID_NONE;
    aft_d = ad;
    aft_i = ai;
    n = 0;
    bd = buf_d;
    bi = buf_i;
  }

  __device__ __forceinline__ bool beats(float dd, int ii) const {
    return rt::lex_less(dd, ii, thr_d, thr_i) && (!BOUNDED || rt::lex_less(aft_d, aft_i, dd, ii));
  }

  // Compare-exchange with the lane `lane ^ stride`: keep the smaller pair
  // where keep_min, else the larger (equal pairs stay).
  static __device__ __forceinline__ void exchange(float& xd, int& xi, int stride, bool keep_min) {
    const float od = __shfl_xor_sync(FULL, xd, stride);
    const int oi = __shfl_xor_sync(FULL, xi, stride);
    const bool mine = rt::lex_less(xd, xi, od, oi);
    if (keep_min ? !mine : mine) {
      xd = od;
      xi = oi;
    }
  }

  // Merge the buffer into the list and empty it.
  __device__ __forceinline__ void flush(int k, int lane) {
    __syncwarp();
    float xd = lane < n ? bd[lane] : CUDART_INF_F;
    int xi = lane < n ? bi[lane] : rt::ID_NONE;
    // the buffer sorted descending (a bitonic sort of 32)
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        exchange(xd, xi, stride, ((lane & stride) == 0) == ((lane & size) != 0));
    }
    merge_desc(xd, xi, k, lane);
    n = 0;
  }

  // Take another warp's list (entry `lane`, ascending) as this one.
  __device__ __forceinline__ void load(float ld, int li, int k, int lane) {
    d = lane < k ? ld : CUDART_INF_F;
    i = lane < k ? li : rt::ID_NONE;
    thr_d = __shfl_sync(FULL, d, k - 1);
    thr_i = __shfl_sync(FULL, i, k - 1);
    n = 0;
  }

  // Merge another warp's list (entry `lane`, ascending) into this one.
  __device__ __forceinline__ void merge_list(float od, int oi, int k, int lane) {
    merge_desc(__shfl_sync(FULL, od, 31 - lane), __shfl_sync(FULL, oi, 31 - lane), k, lane);
  }

  // Merge 32 pairs sorted descending (entry 31 - lane in lane) into the
  // list: [list ascending | them] is bitonic, merged ascending; the buffer
  // is scratch (empty, or read into registers, before the call).
  __device__ __forceinline__ void merge_desc(float xd, int xi, int k, int lane) {
    float lo_d = d, hi_d = xd;
    int lo_i = i, hi_i = xi;
    if (rt::lex_less(xd, xi, d, i)) {
      lo_d = xd;
      lo_i = xi;
      hi_d = d;
      hi_i = i;
    }
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      exchange(lo_d, lo_i, stride, (lane & stride) == 0);
      exchange(hi_d, hi_i, stride, (lane & stride) == 0);
    }
    // the 64 pairs ascending: lo in lanes 0..31, then hi; drop a pair
    // equal to the one before it
    const float pd0 = __shfl_up_sync(FULL, lo_d, 1), pd1 = __shfl_up_sync(FULL, hi_d, 1);
    const int pi0 = __shfl_up_sync(FULL, lo_i, 1), pi1 = __shfl_up_sync(FULL, hi_i, 1);
    const float ld = __shfl_sync(FULL, lo_d, 31);
    const int li = __shfl_sync(FULL, lo_i, 31);
    const bool dup0 = lane > 0 && pd0 == lo_d && pi0 == lo_i;
    const bool dup1 = lane > 0 ? (pd1 == hi_d && pi1 == hi_i) : (ld == hi_d && li == hi_i);
    const unsigned m0 = __ballot_sync(FULL, dup0);
    if (m0 == 0) {       // no pair repeated among the 32 smallest
      d = lo_d;
      i = lo_i;
    } else {             // keep the first 32 distinct pairs, through the buffer
      const unsigned m1 = __ballot_sync(FULL, dup1);
      const unsigned below = (1u << lane) - 1u;
      const int p0 = lane - __popc(m0 & below);
      const int p1 = 32 + lane - __popc(m0) - __popc(m1 & below);
      __syncwarp();
      bd[lane] = CUDART_INF_F;
      bi[lane] = rt::ID_NONE;
      __syncwarp();
      if (!dup0) {
        bd[p0] = lo_d;
        bi[p0] = lo_i;
      }
      if (!dup1 && p1 < 32) {
        bd[p1] = hi_d;
        bi[p1] = hi_i;
      }
      __syncwarp();
      d = bd[lane];
      i = bi[lane];
    }
    if (lane >= k) {
      d = CUDART_INF_F;
      i = rt::ID_NONE;
    }
    thr_d = __shfl_sync(FULL, d, k - 1);
    thr_i = __shfl_sync(FULL, i, k - 1);
    __syncwarp();
  }

  // Offer one pair a lane (cand false: none); +inf and NaN never rank.
  __device__ __forceinline__ void offer(bool cand, float dd, int ii, int k, int lane) {
    bool take = cand && dd < CUDART_INF_F && beats(dd, ii);
    unsigned m = __ballot_sync(FULL, take);
    if (m == 0) return;
    if (n + __popc(m) > 32) {
      flush(k, lane);
      take = take && beats(dd, ii);
      m = __ballot_sync(FULL, take);
    }
    if (take) {
      const int pos = n + __popc(m & ((1u << lane) - 1u));
      bd[pos] = dd;
      bi[pos] = ii;
    }
    n += __popc(m);
  }

  // The list, the buffer merged in.
  __device__ __forceinline__ void finish(int k, int lane) {
    if (n > 0) flush(k, lane);
  }
};

__device__ __forceinline__ void rows_cp16(float4* smem, const float4* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem));
}

__device__ __forceinline__ void rows_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void rows_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
}

// Stage the rows of pass p (list entries p PASS ..) into ring slot
// p % STAGES, lane by lane along each row; then close the pass's group
// (empty past the list, so the wait below counts groups uniformly).
__device__ __forceinline__ void stage_pass(float4* ring, const float4* rows4, int D4,
                                           const int* list, int cnt, int p, int lane) {
  const int p0 = p * PASS;
  if (p0 < cnt) {
    float4* st = ring + (size_t)(p % STAGES) * PASS * D4;
    const int n = min(PASS, cnt - p0);
    for (int r = 0; r < n; ++r) {
      const float4* src = rows4 + (size_t)list[p0 + r] * D4;
      for (int c = lane; c < D4; c += 32) rows_cp16(st + r * D4 + c, src + c);
    }
  }
  rows_commit();
}

// scan_pass on rows staged in shared memory: slots g and GROUPS + g of the
// stage are list entries p0 + g and p0 + GROUPS + g, scored by lane group
// g with the same loads, FMAs, butterfly and rounding as scan_pass<true>.
template <bool BOUNDED>
__device__ __forceinline__ void ring_pass(const float4* st, int D4, const float* qs, float qn,
                                          const int* list, int cnt, int p0, int k, int lane,
                                          BufferedList<BOUNDED>& top) {
  const int g = lane / GROUP, l = lane % GROUP;
  const int pa = p0 + g, pb = p0 + GROUPS + g;
  const bool va = pa < cnt, vb = pb < cnt;
  const int ia = va ? list[pa] : rt::ID_NONE;
  const int ib = vb ? list[pb] : rt::ID_NONE;
  const float4* a4 = st + g * D4;
  const float4* b4 = st + (GROUPS + g) * D4;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float vna = 0.f, dta = 0.f, vnb = 0.f, dtb = 0.f;
#pragma unroll 4
  for (int c = l; c < D4; c += GROUP) {
    const float4 x = va ? a4[c] : zero;
    const float4 y = vb ? b4[c] : zero;
    const float4 qq = q4[c];
    acc4(x, qq, vna, dta);
    acc4(y, qq, vnb, dtb);
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
  top.offer(l == 0 && va, da, ia, k, lane);
  top.offer(l == 0 && vb, db, ib, k, lane);
}

// Merge the lists of warps 0 .. n - 1, each in `top` and at s_wd / s_wi +
// 32 w (stored before a block barrier), into warp 0's, pairwise in a
// tree: log2 n merges in turn.  Every thread of the block calls it.
template <bool BOUNDED>
__device__ __forceinline__ void fold_tree(BufferedList<BOUNDED>& top, float* s_wd, int* s_wi,
                                          int n, int warp, int k, int lane) {
  for (int step = 1; step < n; step <<= 1) {
    if (warp % (2 * step) == 0 && warp + step < n) {
      top.merge_list(s_wd[(warp + step) * 32 + lane], s_wi[(warp + step) * 32 + lane], k, lane);
      s_wd[warp * 32 + lane] = top.d;
      s_wi[warp * 32 + lane] = top.i;
    }
    __syncthreads();
  }
}

// Block (b, r) of the grid (B S): query b = cluster b, segment r = the
// block's rank.  The block's warps' lists fold into the block's list
// (fold_tree), s_wd / s_wi's first 32 entries; after a cluster barrier
// rank 0's warp w merges the lists of ranks 2w and 2w + 1, read through
// distributed shared memory, and those fold into warp 0's, which writes
// the result; the second cluster barrier keeps every block's list alive
// until those reads are done.
template <int MODE, bool BOUNDED>
__global__ void __launch_bounds__(RTHREADS) candidate_rows_cluster(const RowsArgs ra) {
  namespace cg = cooperative_groups;
  constexpr bool VEC = MODE != ROWS_SCALAR;
  extern __shared__ float4 smem4[];
  __shared__ float s_wd[RW * 32];        // the warps' lists; the block's
  __shared__ int s_wi[RW * 32];          // first, read by rank 0
  __shared__ float s_buf_d[RW * 32];     // each warp's BufferedList buffer
  __shared__ int s_buf_i[RW * 32];

  const ScanArgs& a = ra.s;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / a.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, D4 = (D + 3) / 4;
  float* qs = reinterpret_cast<float*>(smem4);                 // [D4 float4s]
  int* list = reinterpret_cast<int*>(smem4 + D4) + warp * ROUND;
  float4* ring = smem4 + D4 + RW * ROUND / 4 + (size_t)warp * STAGES * PASS * D4;
  for (int e = tid; e < D; e += RTHREADS) qs[e] = a.q[(size_t)b * D + e];
  __syncthreads();
  const float qn = group_norm<VEC>(qs, D, lane % GROUP);

  const int c0 = rank * a.per;
  const int n = max(0, min(a.per, a.width - c0));
  const int* seg = a.ids + (size_t)b * a.width + c0;
  const int nchunks = (n + 31) / 32;
  const float4* rows4 = reinterpret_cast<const float4*>(a.rows);

  BufferedList<BOUNDED> top;
  {
    float ad;
    int ai;
    rt::after_of(a.after_d, a.after_i, b, ad, ai);
    top.init(s_buf_d + warp * 32, s_buf_i + warp * 32, ad, ai);
  }
  for (int j0 = warp; j0 < nchunks; j0 += RW * RCH) {
    // compact the round's live ids in order, one ballot a chunk (the
    // chunks' ids loaded first, all in flight together)
    int idv[RCH];
#pragma unroll
    for (int u = 0; u < RCH; ++u) {
      const int c = (j0 + u * RW) * 32 + lane;
      idv[u] = c < n ? __ldg(seg + c) : -1;
    }
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < RCH; ++u) {
      const int id = idv[u];
      const bool live = id >= 0 && id < a.n_rows;
      const unsigned m = __ballot_sync(FULL, live);
      if (live) list[cnt + __popc(m & ((1u << lane) - 1u))] = id;
      cnt += __popc(m);
    }
    __syncwarp();
    if (MODE == ROWS_RING) {
      const int npass = (cnt + PASS - 1) / PASS;
      for (int p = 0; p < STAGES - 1; ++p) stage_pass(ring, rows4, D4, list, cnt, p, lane);
      for (int p = 0; p < npass; ++p) {
        // ring slot (p - 1) % STAGES was read by every lane before the
        // __syncwarp that ended the last pass
        stage_pass(ring, rows4, D4, list, cnt, p + STAGES - 1, lane);
        rows_wait();       // pass p's group is complete: STAGES - 1 newer ones may not be
        __syncwarp();      // and every lane's copies of it are visible
        ring_pass<BOUNDED>(ring + (size_t)(p % STAGES) * PASS * D4, D4, qs, qn, list, cnt,
                           p * PASS, a.k, lane, top);
        __syncwarp();
      }
    } else {
      for (int p0 = 0; p0 < cnt; p0 += PASS)
        scan_pass<VEC, true, BOUNDED>(a, qs, qn, nullptr, list, cnt, 0, p0, lane, top);
      __syncwarp();
    }
  }
  top.finish(a.k, lane);

  // the block's warps' lists into the block's list
  s_wd[warp * 32 + lane] = top.d;
  s_wi[warp * 32 + lane] = top.i;
  __syncthreads();
  fold_tree(top, s_wd, s_wi, RW, warp, a.k, lane);
  cluster.sync();
  // the cluster's blocks' lists into the result, a pair held twice kept
  // once (rank 0's warp 0 reads its own block's list as rank 0's)
  if (rank == 0) {
    const int lists = (a.S + 1) / 2;
    if (warp < lists) {
      const int r0 = 2 * warp, r1 = r0 + 1;
      const float d0 = *cluster.map_shared_rank(s_wd + lane, r0);
      const int i0 = *cluster.map_shared_rank(s_wi + lane, r0);
      const float d1 = r1 < a.S ? *cluster.map_shared_rank(s_wd + lane, r1) : CUDART_INF_F;
      const int i1 = r1 < a.S ? *cluster.map_shared_rank(s_wi + lane, r1) : rt::ID_NONE;
      top.load(d0, i0, a.k, lane);
      if (r1 < a.S) top.merge_list(d1, i1, a.k, lane);
    }
    __syncthreads();   // every rank-0 list read before it is overwritten
    if (warp < lists) {
      s_wd[warp * 32 + lane] = top.d;
      s_wi[warp * 32 + lane] = top.i;
    }
    __syncthreads();
    fold_tree(top, s_wd, s_wi, lists, warp, a.k, lane);
    if (warp == 0 && lane < a.k) {
      const bool filled = top.d < CUDART_INF_F;
      ra.out_d[(size_t)b * a.k + lane] = filled ? top.d : CUDART_INF_F;
      ra.out_i[(size_t)b * a.k + lane] = filled ? top.i : -1;
    }
  }
  cluster.sync();
}

template <int MODE, bool BOUNDED>
int rows_cluster_mode(const RowsArgs& a, size_t smem, cudaStream_t stream) {
  const auto kernel = candidate_rows_cluster<MODE, BOUNDED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.s.B * (unsigned)a.s.S);
  cfg.blockDim = dim3(RTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.s.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The mode from D: staged through the ring where D is a multiple of 4 and
// RW rings fit RING_MAX_BYTES; the query, the lists and the rings are the
// dynamic shared memory.
template <bool BOUNDED>
int rows_cluster_launch(const RowsArgs& a, cudaStream_t stream) {
  const size_t d4 = (size_t)(a.s.D + 3) / 4;
  const size_t base = sizeof(float4) * d4 + sizeof(int) * RW * ROUND;
  const size_t ring = sizeof(float4) * RW * STAGES * PASS * d4;
  if (a.s.D % 4 != 0) return rows_cluster_mode<ROWS_SCALAR, BOUNDED>(a, base, stream);
  if (ring <= (size_t)RING_MAX_BYTES)
    return rows_cluster_mode<ROWS_RING, BOUNDED>(a, base + ring, stream);
  return rows_cluster_mode<ROWS_VEC, BOUNDED>(a, base, stream);
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

// The rows entry: query b's C candidates are rows ids[b, c] of rows
// (n_rows, D), in `splits` segments of `per`, one cluster of `splits`
// blocks a query (1 <= splits <= CLUSTER_MAX); one launch, no scratch.
int candidate_rows_topk_launch(const float* q, const float* rows, int n_rows, const int* ids,
                               const float* after_d, const int* after_i, float* out_d,
                               int* out_i, int B, int C, int D, int k, int splits, int per,
                               cudaStream_t stream) {
  if (k < 1 || k > rt::KMAX || n_rows < 1 || splits < 1 || splits > CLUSTER_MAX)
    return (int)cudaErrorInvalidValue;
  const ScanArgs s{q,  rows, ids, nullptr, after_d, after_i, nullptr, nullptr, B, D, k, k,
                   splits, C, per, 0,   0,       n_rows};
  const RowsArgs a{s, out_d, out_i};
  return after_d != nullptr ? rows_cluster_launch<true>(a, stream)
                            : rows_cluster_launch<false>(a, stream);
}

}  // extern "C"
