// Fused brute-force scans + streaming top-k for Hopper (sm_90a): one tile
// loop, `tile::l2_tile_scan`, for three row types.
//
// Replaces (the TPU kernels):
//   F32Rows    repro/kernels/l2_topk.py::l2_topk_pallas
//              d2 = (qn_b + xn_n) - 2 q_b.x_n
//   HybridRows repro/kernels/bm25.py::hybrid_topk_pallas
//              dist = a d2 - (1 - a) bm25(b, n), with a read from a (1, 1)
//              device operand and bm25 the slab score of lexical.cuh
//   Int8Rows   repro/kernels/l2_topk.py::l2_topk_int8_pallas
//              d2 = (qn_b + (s_n s_n) xn8_n) - (2 s_n) q_b.x8_n, the rows
//              stored as int8 codes x8 with one fp32 scale s_n per row
// each +inf for rows with valid == 0; the k smallest under the (distance,
// id) order, (inf, -1) in slots no live row fills.  One launch serves
// k <= 32; a larger k is taken in passes (kernels/common.py: topk_passes),
// each bounded by the last pair of the pass before (after_d / after_i,
// held where a pair is offered: rt::WarpTopK::beats).
//
// Blocks on Hopper run in no order, so the TPU kernels' carry of the
// running top-k through a sequential grid axis does not port: the grid is
// (query tiles of BQ = 64) x (S splits of N), every block streams its own
// row range in tiles and writes a partial list per query, and a second
// kernel merges the partials of each query under the same order.  S is
// chosen by the wrapper so that B = 64 against N = 1M still fills all 132
// SMs.
//
// * Staging: row tiles (BN = 128 rows; 64 for the hybrid) and the query
//   tile are copied BK = 16 dimensions at a time by cp.async (16-byte
//   cp.async.cg; 4-byte cp.async.ca when d is not a multiple of 4), in a
//   ring of STAGES = 3 buffers over the flattened (tile, K-chunk) steps, so
//   there is one barrier a chunk and two chunks in flight.  Rows and
//   queries are staged [row][k] with a stride of BK + 4 floats, which makes
//   the threads' float4 reads of rows 32 apart free of bank conflicts.
//   Queries are staged by chunk like the rows, so d has no ceiling (the
//   first tile kept the whole query tile in shared memory: d <= 512).
// * Int8 rows: a row's 16 codes of a chunk are one 16-byte cp.async.cg (a
//   stage of rows is 2 KB, a quarter of the fp32 one; byte copies when d is
//   not a multiple of 16).  The block widens each landed chunk once into an
//   fp32 chunk of the fp32 layout (two of them, alternating), one step
//   ahead of the products: at step s, after the step's barrier, the threads
//   widen chunk s + 1 (so the ring is one stage longer and waits for one
//   chunk more) while the products read chunk s's.  The products and norms
//   then run the fp32 code unchanged, and no conversion sits in the FMA
//   loop (I2F issues at a fraction of the FMA rate).  The row scales are
//   read with the liveness mask as a tile starts.
// * Products: register-blocked fp32 FMA.  Thread (lane, warp w) owns
//   queries 8 w .. 8 w + 7 and rows lane, lane + 32, ... of the tile (8 x 4
//   for the 128-row tiles, 8 x 2 for the hybrid's 64-row tile), and adds
//   q[k] x[k] into each dot with fmaf over the dims in order: the same
//   sequence as the first tile loop, so every d2 (int8 included) is that
//   loop's bit for bit.  An 8 x 8 micro-tile (a 256-row tile) fed the FMAs
//   better but left no registers for the selection at two blocks an SM: it
//   spilled, and took 0.83-0.93 ms against 0.35 ms without selection
//   (kernels/tile_ablation.py).  The products were first taken on the
//   tensor cores (3xTF32: a split of each operand into two TF32 parts and
//   three mma.sync products).  At sift magnitudes its d2 differed from the
//   plain path's fp32 products by up to 7.1e-7 of qn + xn (fp32 FMA:
//   1.8e-7), so near-tied neighbours swapped with the unfused path's far
//   more often, and the options cells' unchanged hybrid parity check (ids
//   equal to the unfused path's on 0.99 of slots) failed on 0.981 (PERF.md).
// * Norms: xn and qn are fp32 FMA over the dimensions in order (warp w
//   computes row lane + 32 w's; lanes 0-7 of each warp their queries', in
//   the first tile); the code-space norm ||x8||^2 <= 128 * 127^2 < 2^24 is
//   exact in any order.  The epilogue forms d2 in the reference's order
//   with round-to-nearest intrinsics (nothing contracted into an FMA); dead
//   and pad rows read +inf.  So a row's d2 depends on the query, the row
//   and d only: not on the tile, the split or N (testing.hybrid_by_parts
//   relies on that), and alpha = 1 gives the fp32 scan's distances exactly.
// * Selection: each warp selects for its own 8 queries (no barrier: it
//   computed their distances), one rt::WarpTopK a query kept in shared
//   memory between tiles.  Its epilogue writes the distances to the
//   queries' rows of a distance tile and ballots each run of 32 rows
//   against a bound on the query's k-th distance; only a query with such
//   a run loads its list, in a loop over the queries that is not unrolled
//   (unrolled, the list code of eight queries cost the scan 0.35 ms). The
//   bound is the smaller of the block's own k-th and the splits' shared
//   one, which every block tightens with an atomicMin on an order-keyed
//   int (any split's k-th bounds the query's k-th from above, so no pair
//   over it is an answer).  One partial list a query and split, folded by
//   rt::warp_merge_partials.
// * The hybrid's lexical half (lexical.cuh): the block's query dictionary
//   is built once; at the first chunk of each tile every document's slab
//   slots are looked up once, its hits accumulated in slot order, and each
//   (query, document) pair scored by one shared load, one __fmul_rn and
//   one __fadd_rn a scored query slot, into a score tile the epilogue reads
//   back; alpha = 0 gives the BM25 scan's distances (by value).  The T x S
//   compare loop is gone.
//
// Bound at the main path's shapes (B = 64, N = 1M, d = 128; 3.35 TB/s, 67
// TFLOP/s fp32 outside the tensor cores):
//   fp32:   16.4 GFLOP = 245 us against 512 MB = 153 us -> operations;
//   hybrid: the fp32 work plus a multiply and an add a (live query term
//           slot, live document) pair against 644 MB = 192 us ->
//           operations;
//   int8:   16.4 GFLOP = 245 us against 136 MB = 41 us -> operations.
// chip_smoke.py computes each from the run's operands.
//
// Left on the table: the scan issues a shared load a 16 FMAs and waits at
// a barrier every 16 dims; deeper chunks, a warp-specialised producer and
// TMA copies would hide more; the hybrid's lexical half runs between the
// tiles' products with three barriers of its own; int8 could take its
// products on the tensor cores exactly in bf16 parts (x8 is exact in bf16),
// but their accumulation does not round at each add.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lexical.cuh"
#include "topk_common.cuh"

namespace {

struct F32Rows {};
struct Int8Rows {};
struct HybridRows {};

constexpr int BQ = 64;             // queries per block
constexpr int MERGE_WARPS = 8;     // warps merging one query's partials

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A float's place in the order of floats as an int (atomicMin on it is a
// min on the floats; -0.0 sorts just below +0.0), and back.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float order_float(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// ============================================ the fp32 and hybrid tile loop
namespace tile {

constexpr int BK = 16;                 // dims a pipeline stage
constexpr int STAGES = 3;              // ring of staged chunks
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LDK = BK + 4;            // staged stride: conflict-free float4 reads
constexpr int QPT = BQ / WARPS;        // queries a warp (and a thread) owns
constexpr int LIST = 32;               // entries of a query's list (k <= 32 a pass)
constexpr int DICT_BITS_MAX = 12;      // the hybrid's dictionary: at most 4,096 slots

template <class Rows>
struct Shape {
  static constexpr bool kHybrid = std::is_same<Rows, HybridRows>::value;
  static constexpr bool kInt8 = std::is_same<Rows, Int8Rows>::value;
  static constexpr int BN = kHybrid ? 64 : 128;   // rows a tile
  static constexpr int RPT = BN / 32;             // rows a thread: lane, lane + 32, ...
  static constexpr int LDS = BN + 4;              // the distance tile's stride
  // a stage holds the chunk's rows (fp32 [row][LDK], or int8 [row][BK]
  // bytes), then the queries' (fp32 [query][LDK])
  static constexpr int ROW_BYTES = kInt8 ? BN * BK : 4 * BN * LDK;
  static constexpr int STAGE_BYTES = ROW_BYTES + 4 * BQ * LDK;
  // int8: one stage more, since the chunk after the current one is widened
  // ahead of its products
  static constexpr int RING = kInt8 ? STAGES + 1 : STAGES;
  static constexpr int MIN_BLOCKS = kHybrid ? 1 : 2;
  static constexpr int QG = THREADS / BN;         // hybrid: threads a document
  static constexpr int GROUPS_MAX = BQ / QG;      // hybrid: query groups at most
};

static_assert(BQ == WARPS * 8, "eight queries a warp");
static_assert(Shape<F32Rows>::RPT <= WARPS && Shape<Int8Rows>::RPT <= WARPS &&
                  Shape<HybridRows>::RPT <= WARPS,
              "one warp a row slot computes the rows' norms");
static_assert(Shape<Int8Rows>::BN * BK == THREADS * 8, "a thread widens 8 codes a chunk");
static_assert((rt::lex::MAX_T * (BQ / Shape<HybridRows>::GROUPS_MAX)) <= rt::lex::ZERO_ROW,
              "the hybrid's smallest query group always fits the hit rows");

struct Args {
  const float* q;          // (B, D)
  const float* x;          // (N, D), fp32 and hybrid
  const signed char* x8;   // (N, D), int8 codes
  const float* scales;     // (N,), int8: each row's scale
  const int* valid;        // (N,) or null
  const float* after_d;    // (B,) the pass's bound, or null
  const int* after_i;
  const int* q_terms;      // hybrid: (B, T) query term ids, -1 padded
  const float* q_weights;  // hybrid: (B, T)
  const int* terms;        // hybrid: (N, S) slab term ids, -1 padded
  const float* tf_sat;     // hybrid: (N, S)
  const float* alpha;      // hybrid: (1, 1)
  int* thr_g;              // (B,) each query's k-th distance over the splits, as order_key
  float* part_d;           // (B, splits, kt)
  int* part_i;
  int B, N, D, k, kt, rows_per_split, T, S, dict_bits;
};

// Byte offsets of the block's shared memory (every one a multiple of 16).
struct Layout {
  size_t stages, wide, ds, sl_d, sl_i, xn, aft_d, aft_i;       // every row type (wide: int8)
  size_t hits, qinfo, dkey, dval, su, tf, rows, small, total;  // hybrid
};

__host__ __device__ constexpr size_t up16(size_t b) { return (b + 15) / 16 * 16; }

template <class Rows>
__host__ __device__ Layout layout(int T, int dict_bits) {
  using S = Shape<Rows>;
  Layout l{};
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o += up16(bytes);
    return at;
  };
  l.stages = take(1ull * S::RING * S::STAGE_BYTES);
  if (S::kInt8) l.wide = take(2ull * 4 * S::BN * LDK);
  l.ds = take(4ull * BQ * S::LDS);
  l.sl_d = take(4ull * BQ * LIST);
  l.sl_i = take(4ull * BQ * LIST);
  l.xn = take(4ull * S::BN);
  l.aft_d = take(4ull * BQ);
  l.aft_i = take(4ull * BQ);
  if (S::kHybrid) {
    l.hits = take(4ull * rt::lex::UCAP * S::BN);
    l.qinfo = take(8ull * BQ * T);
    l.dkey = take(4ull << dict_bits);
    l.dval = take(4ull << dict_bits);
    l.su = take(2ull * rt::SLAB_MAX * S::BN);
    l.tf = take(4ull * rt::SLAB_MAX * S::BN);
    l.rows = take(1ull * rt::SLAB_MAX * S::BN);
    l.small = take(4ull * (2 * S::GROUPS_MAX + BQ));   // distinct, reach, nq
  }
  l.total = o;
  return l;
}

// Copy the chunk of dims k0 .. k0 + BK - 1 of rows r0 .. r0 + BN - 1 and
// of the block's queries into a stage; what lies past r_end, B or D reads
// as zero.  VEC: 16-byte copies (int8 rows: d a multiple of 16).
template <class Rows, bool VEC>
__device__ __forceinline__ void load_step(unsigned char* stage, const Args& a, int r0, int r_end,
                                          int q0, int k0, int tid) {
  constexpr int BN = Shape<Rows>::BN;
  const int B = a.B, D = a.D;
  const float* __restrict__ q = a.q;
  float* qs = reinterpret_cast<float*>(stage + Shape<Rows>::ROW_BYTES);
  if constexpr (Shape<Rows>::kInt8) {
    const signed char* __restrict__ x = a.x8;
    signed char* xs = reinterpret_cast<signed char*>(stage);
    if (VEC) {
      if (tid < BN) {
        const int gr = r0 + tid;
        const bool ok = gr < r_end;
        cp_async16(xs + tid * BK, ok ? x + (size_t)gr * D + k0 : x, ok);
      }
    } else {   // byte copies, landed by the barriers before the chunk is widened
#pragma unroll 4
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int row = e / BK, kk = e % BK;
        const int gr = r0 + row, gk = k0 + kk;
        xs[e] = gr < r_end && gk < D ? x[(size_t)gr * D + gk] : 0;
      }
    }
  } else {
    const float* __restrict__ x = a.x;
    float* xs = reinterpret_cast<float*>(stage);
    if (VEC) {
#pragma unroll
      for (int e = tid; e < BN * (BK / 4); e += THREADS) {
        const int row = e / (BK / 4), j = e % (BK / 4);
        const int gr = r0 + row, gk = k0 + 4 * j;
        const bool ok = gr < r_end && gk < D;
        cp_async16(xs + row * LDK + 4 * j, ok ? x + (size_t)gr * D + gk : x, ok);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int row = e / BK, kk = e % BK;
        const int gr = r0 + row, gk = k0 + kk;
        const bool ok = gr < r_end && gk < D;
        cp_async4(xs + row * LDK + kk, ok ? x + (size_t)gr * D + gk : x, ok);
      }
    }
  }
  // the queries are fp32 for every row type; 16-byte copies need d % 4 == 0
  if (VEC) {
#pragma unroll
    for (int e = tid; e < BQ * (BK / 4); e += THREADS) {
      const int qq = e / (BK / 4), j = e % (BK / 4);
      const int gq = q0 + qq, gk = k0 + 4 * j;
      const bool ok = gq < B && gk < D;
      cp_async16(qs + qq * LDK + 4 * j, ok ? q + (size_t)gq * D + gk : q, ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < BQ * BK; e += THREADS) {
      const int qq = e / BK, kk = e % BK;
      const int gq = q0 + qq, gk = k0 + kk;
      const bool ok = gq < B && gk < D;
      cp_async4(qs + qq * LDK + kk, ok ? q + (size_t)gq * D + gk : q, ok);
    }
  }
}

// Widen a landed int8 chunk of rows into the fp32 layout the products
// read ([row][LDK]): thread t takes 8 codes of row t % BN.
template <int BN>
__device__ __forceinline__ void widen(const unsigned char* stage, float* wide, int tid) {
  const int row = tid % BN, half = tid / BN;
  const int2 v = *reinterpret_cast<const int2*>(stage + row * BK + 8 * half);
  const signed char* c = reinterpret_cast<const signed char*>(&v);
  float4* w = reinterpret_cast<float4*>(wide + row * LDK + 8 * half);
  w[0] = make_float4(c[0], c[1], c[2], c[3]);
  w[1] = make_float4(c[4], c[5], c[6], c[7]);
}

// s + v.v over four dims in order.
__device__ __forceinline__ float norm4(float4 v, float s) {
  s = fmaf(v.x, v.x, s);
  s = fmaf(v.y, v.y, s);
  s = fmaf(v.z, v.z, s);
  return fmaf(v.w, v.w, s);
}

// BOUNDED: the launch carries a pass's bound (a first pass runs the lists
// without its test).
template <class Rows, bool VEC, bool BOUNDED>
__global__ void __launch_bounds__(THREADS, Shape<Rows>::MIN_BLOCKS)
l2_tile_scan(const Args a) {
  using S = Shape<Rows>;
  constexpr int BN = S::BN, RPT = S::RPT, LDS = S::LDS, RING = S::RING;
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  const Layout L = layout<Rows>(a.T, a.dict_bits);
  unsigned char* stages = base + L.stages;
  float* wide = reinterpret_cast<float*>(base + L.wide);    // int8: [2][BN][LDK] widened rows
  float* ds = reinterpret_cast<float*>(base + L.ds);        // [BQ][LDS] the tile's distances
  float* sl_d = reinterpret_cast<float*>(base + L.sl_d);    // [BQ][LIST] the lists
  int* sl_i = reinterpret_cast<int*>(base + L.sl_i);
  float* xn_s = reinterpret_cast<float*>(base + L.xn);      // [BN]
  float* aft_d = reinterpret_cast<float*>(base + L.aft_d);  // [BQ] the pass's bounds
  int* aft_i = reinterpret_cast<int*>(base + L.aft_i);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, D = a.D;
  const int q0 = blockIdx.x * BQ;
  const int qb = warp * QPT;          // the warp's queries qb .. qb + 7 of the tile
  const int split = blockIdx.y;
  const int r_begin = split * a.rows_per_split;
  const int r_end = min(a.N, r_begin + a.rows_per_split);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + BN - 1) / BN : 0;
  const int nk = (D + BK - 1) / BK;
  const int steps = n_tiles * nk;

  if (tid < BQ) {
    float ad;
    int ai;
    rt::after_of(a.after_d, a.after_i, min(q0 + tid, B - 1), ad, ai);
    aft_d[tid] = ad;
    aft_i[tid] = ai;
  }

  // the hybrid's lexical state: the dictionary, built once; each thread's
  // quarter of its document's slab row, loaded a tile ahead
  rt::lex::Dict dc;
  float* hits = nullptr;
  short* s_su = nullptr;
  float* s_tf = nullptr;
  unsigned char* s_rows = nullptr;
  float al = 0.f, one_minus_al = 0.f;
  int4 t4 = make_int4(-1, -1, -1, -1);
  float4 f4 = make_float4(0.f, 0.f, 0.f, 0.f);
  bool lex_live = false;
  int filled = 0;
  const int lrow = tid % BN, lqg = tid / BN;   // hybrid: document and slot quarter
  bool lvec = false;
  if constexpr (S::kHybrid) {
    hits = reinterpret_cast<float*>(base + L.hits);
    dc.qinfo = reinterpret_cast<int2*>(base + L.qinfo);
    dc.dkey = reinterpret_cast<int*>(base + L.dkey);
    dc.dval = reinterpret_cast<int*>(base + L.dval);
    s_su = reinterpret_cast<short*>(base + L.su);
    s_tf = reinterpret_cast<float*>(base + L.tf);
    s_rows = base + L.rows;
    dc.distinct = reinterpret_cast<int*>(base + L.small);
    dc.reach = dc.distinct + S::GROUPS_MAX;
    dc.nq = dc.reach + S::GROUPS_MAX;
    // the dictionary's scratch (2 BQ T words, 32 KB at T = 64) lies in the
    // stages and the distance tile that follows them, free until then
    static_assert(RING * S::STAGE_BYTES + 4 * BQ * S::LDS >= 8 * BQ * rt::lex::MAX_T,
                  "the dictionary's scratch fits the stages and the distance tile");
    float* qws = reinterpret_cast<float*>(stages);
    int* qts = reinterpret_cast<int*>(qws + BQ * a.T);
    for (int e = tid; e < rt::lex::UCAP * BN; e += THREADS) hits[e] = 0.f;
    for (int e = tid; e < BQ * a.T; e += THREADS)
      qws[e] = q0 + e / a.T < B ? a.q_weights[(size_t)q0 * a.T + e] : 0.f;
    rt::lex::build_dict<BQ, BN, THREADS, S::GROUPS_MAX>(dc, a.q_terms, qws, qts, q0, B, a.T,
                                                        a.dict_bits, tid);
    al = a.alpha[0];
    one_minus_al = __fsub_rn(1.f, al);
    lvec = a.S == rt::SLAB_MAX && ((reinterpret_cast<uintptr_t>(a.terms) |
                                    reinterpret_cast<uintptr_t>(a.tf_sat)) & 15) == 0;
    lex_live = rt::lex::load_quarter(t4, f4, a.terms, a.tf_sat, a.valid, r_begin + lrow, r_end,
                                     a.S, lvec, lqg);
    __syncthreads();   // the dictionary's scratch is read
  }
  for (int e = tid; e < BQ * LIST; e += THREADS) {
    sl_d[e] = CUDART_INF_F;
    sl_i[e] = rt::ID_NONE;
  }
  __syncthreads();   // lists, bounds and dictionary set; the stages free

#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < steps)
      load_step<Rows, VEC>(stages + s * S::STAGE_BYTES, a, r_begin + (s / nk) * BN, r_end, q0,
                           (s % nk) * BK, tid);
    cp_commit();
  }
  if constexpr (S::kInt8) {   // chunk 0 widened ahead of the loop
    cp_wait<RING - 2>();
    __syncthreads();
    if (steps > 0) widen<BN>(stages, wide, tid);
  }

  // thread (lane, warp): queries qb .. qb + 7, rows lane + 32 j of the tile
  float acc[QPT][RPT];
  bool live[RPT];          // its rows, read as a tile starts
  float scl[RPT];          // int8: their scales, read as a tile starts
  float thr = CUDART_INF_F;  // lane i < 8: a bound on query qb + i's k-th distance
  int g_key = 0;           // lane i < 8: the splits' shared bound, read as a tile starts
  float norm = 0.f;        // warp w < RPT: the norm of row lane + 32 w of the tile
  float qnorm = 0.f;       // lane i < 8: the norm of query qb + i (the first tile)
  int tile = 0, kc = 0;
  int ld_tile = (RING - 1) / nk, ld_kc = (RING - 1) % nk;   // the next step to load

  for (int step = 0; step < steps; ++step) {
    // this step's chunk (int8: also the next one, widened below) has landed;
    // the oldest stage is free, and so is the widened chunk of the step before
    cp_wait<S::kInt8 ? RING - 3 : RING - 2>();
    __syncthreads();
    if (step + RING - 1 < steps)
      load_step<Rows, VEC>(stages + ((step + RING - 1) % RING) * S::STAGE_BYTES, a,
                           r_begin + ld_tile * BN, r_end, q0, ld_kc * BK, tid);
    cp_commit();
    if (++ld_kc == nk) {
      ld_kc = 0;
      ++ld_tile;
    }
    if constexpr (S::kInt8)
      if (step + 1 < steps)
        widen<BN>(stages + ((step + 1) % RING) * S::STAGE_BYTES,
                  wide + ((step + 1) & 1) * BN * LDK, tid);
    const int r0 = r_begin + tile * BN;

    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int gr = r0 + lane + 32 * j;
        live[j] = gr < r_end && (a.valid == nullptr || a.valid[gr] != 0);
        if constexpr (S::kInt8) scl[j] = gr < r_end ? a.scales[gr] : 0.f;
      }
      if (lane < QPT)
        g_key = q0 + qb + lane < B ? __ldcg(a.thr_g + q0 + qb + lane) : order_key(CUDART_INF_F);
      norm = 0.f;
      if constexpr (S::kHybrid) {
        // the tile's lexical scores into ds, a query group at a time (one
        // group unless the tile holds more than 256 distinct terms); a
        // document's hit rows are zeroed by its own thread just before
        // its next accumulation
        const bool was_live = lex_live;
        const int per = dc.G / S::QG;
        for (int g0 = 0; g0 < BQ; g0 += dc.G) {
          const int grp = g0 / dc.G;
          rt::lex::lookup_quarter<BN>(dc, t4, f4, lqg, lrow, grp << dc.gbits, dc.reach[grp],
                                      dc.gbits, s_su, s_tf);
          if (g0 + dc.G >= BQ)
            lex_live = rt::lex::load_quarter(t4, f4, a.terms, a.tf_sat, a.valid,
                                             r0 + lrow + BN, r_end, a.S, lvec, lqg);
          __syncthreads();
          if (lqg == 0) {
            rt::lex::zero_hits<BN>(filled, lrow, s_rows, hits);
            filled = was_live ? rt::lex::accumulate_hits<BN>(lrow, s_su, s_tf, hits, s_rows)
                              : 0;
          }
          __syncthreads();
          rt::lex::score_queries<BN>(dc, a.T, hits, lrow, g0 + lqg * per, per, was_live, 1.f,
                                     ds, LDS);
        }
      }
    }

    // the products: an 8 x RPT micro-tile of fp32 FMA a thread, over the
    // chunk's dims in order (so each dot is the sequential fmaf sum over
    // d); the rows' norms by warp w < RPT (row lane + 32 w), the warp's
    // queries' in the first tile by its lanes 0-7
    const unsigned char* stage = stages + (step % RING) * S::STAGE_BYTES;
    const float* xs = S::kInt8 ? wide + (step & 1) * BN * LDK
                               : reinterpret_cast<const float*>(stage);
    const float* qs = reinterpret_cast<const float*>(stage + S::ROW_BYTES);
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 xv[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        xv[j] = *reinterpret_cast<const float4*>(xs + (lane + 32 * j) * LDK + kq);
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (qb + i) * LDK + kq);
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          acc[i][j] = fmaf(qv.x, xv[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv.y, xv[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv.z, xv[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv.w, xv[j].w, acc[i][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        if (warp == j) norm = norm4(xv[j], norm);
      if (tile == 0 && lane < QPT)
        qnorm = norm4(*reinterpret_cast<const float4*>(qs + (qb + lane) * LDK + kq), qnorm);
    }

    if (kc == nk - 1) {
      if (warp < RPT) xn_s[lane + 32 * warp] = norm;
      // any split's k-th distance bounds the query's k-th from above: no
      // pair over it can be an answer
      if (lane < QPT) thr = fminf(thr, order_float(g_key));
      __syncthreads();   // the rows' norms (and the hybrid's scores) are in place
      // each row's term and the factor of its dot: xn and 2, or for int8
      // rows (s s) xn8 and 2 s
      float xn[RPT], two[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        xn[j] = xn_s[lane + 32 * j];
        two[j] = 2.f;
        if constexpr (S::kInt8) {
          xn[j] = __fmul_rn(__fmul_rn(scl[j], scl[j]), xn[j]);
          two[j] = __fmul_rn(2.f, scl[j]);
        }
      }
      // the distances of the warp's queries into its rows of the tile (the
      // hybrid's over its lexical scores: each read and written by the
      // same thread), and a ballot a run of 32 rows against the query's
      // bound: bit RPT i + j of `runs` marks run j of query i
      unsigned runs = 0;
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int qq = qb + i;
        const float qn = __shfl_sync(0xffffffffu, qnorm, i);
        const float bound = __shfl_sync(0xffffffffu, thr, i);
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          float* dp = ds + qq * LDS + lane + 32 * j;
          float d = __fsub_rn(__fadd_rn(qn, xn[j]), __fmul_rn(two[j], acc[i][j]));
          if constexpr (S::kHybrid) d = __fsub_rn(__fmul_rn(al, d), __fmul_rn(one_minus_al, *dp));
          const float dist = live[j] ? d : CUDART_INF_F;
          *dp = dist;
          if (__ballot_sync(0xffffffffu, dist <= bound)) runs |= 1u << (RPT * i + j);
        }
      }
      __syncwarp();
      // select: only a query with a run at or under its bound loads its
      // list (one copy of the list code, not one a query)
#pragma unroll 1
      for (int i = 0; i < QPT; ++i) {
        const unsigned mine = runs >> (RPT * i) & ((1u << RPT) - 1u);
        if (mine == 0) continue;
        const int qq = qb + i;
        rt::WarpTopK<1, false, BOUNDED> top;
        top.load(sl_d + qq * LIST, sl_i + qq * LIST, aft_d[qq], aft_i[qq], a.k, lane);
        const float* dq = ds + qq * LDS;
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          if (mine >> j & 1u) top.offer(true, dq[lane + 32 * j], r0 + lane + 32 * j, a.k, lane);
        top.save(sl_d + qq * LIST, sl_i + qq * LIST, lane);
        // publish a k-th distance that tightens the bound to the other splits
        if (lane == i && top.thr_d < thr) {
          thr = top.thr_d;
          if (q0 + qq < B) atomicMin(a.thr_g + q0 + qq, order_key(thr));
        }
      }
    }
    if (++kc == nk) {
      kc = 0;
      ++tile;
    }
  }
  cp_wait<0>();

  // each warp writes its queries' lists (only it has touched them)
  for (int i = 0; i < QPT; ++i) {
    const int qq = qb + i;
    const int gq = q0 + qq;
    if (gq < B && lane < a.kt) {
      const size_t o = ((size_t)gq * gridDim.y + split) * a.kt + lane;
      a.part_d[o] = sl_d[qq * LIST + lane];
      a.part_i[o] = sl_i[qq * LIST + lane];
    }
  }
}

template <class Rows, bool VEC, bool BOUNDED>
int launch_vec(const Args& a, size_t smem, int splits, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(l2_tile_scan<Rows, VEC, BOUNDED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(l2_tile_scan<Rows, VEC, BOUNDED>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + BQ - 1) / BQ, splits);
  l2_tile_scan<Rows, VEC, BOUNDED><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch(Args a, float* out_d, int* out_i, int splits, cudaStream_t stream) {
  if (a.k < 1 || a.k > a.kt || a.kt > LIST) return (int)cudaErrorInvalidValue;
  if (Shape<Rows>::kHybrid) {
    if (a.T > rt::lex::MAX_T || a.S > rt::SLAB_MAX) return (int)cudaErrorInvalidValue;
    int bits = 1;   // twice the block's term slots, at most 4,096
    while ((1 << bits) < 2 * BQ * a.T && bits < DICT_BITS_MAX) ++bits;
    a.dict_bits = bits;
  }
  const size_t smem = layout<Rows>(a.T, a.dict_bits).total;
  // 16-byte copies: every row and query chunk starts 16-byte aligned
  const bool vec = a.D % (Shape<Rows>::kInt8 ? 16 : 4) == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.x) |
                     reinterpret_cast<uintptr_t>(a.x8)) & 15) == 0;
  const bool bounded = a.after_d != nullptr;
  const int rc = vec ? (bounded ? launch_vec<Rows, true, true>(a, smem, splits, stream)
                                : launch_vec<Rows, true, false>(a, smem, splits, stream))
                     : (bounded ? launch_vec<Rows, false, true>(a, smem, splits, stream)
                                : launch_vec<Rows, false, false>(a, smem, splits, stream));
  if (rc != 0) return rc;
  rt::warp_merge_partials<1, MERGE_WARPS><<<a.B, MERGE_WARPS * 32, 0, stream>>>(
          a.part_d, a.part_i, splits * a.kt, out_d, out_i, a.B, a.k);
  return (int)cudaGetLastError();
}

// The operands every row type takes (the rows themselves are set by the
// launcher).
Args args(const float* q, const int* valid, const float* after_d, const int* after_i,
          int* thr_g, float* part_d, int* part_i, int B, int N, int D, int k, int kt,
          int rows_per_split) {
  Args a{};
  a.thr_g = thr_g;
  a.q = q;
  a.valid = valid;
  a.after_d = after_d;
  a.after_i = after_i;
  a.part_d = part_d;
  a.part_i = part_i;
  a.B = B;
  a.N = N;
  a.D = D;
  a.k = k;
  a.kt = kt;
  a.rows_per_split = rows_per_split;
  return a;
}

}  // namespace tile

}  // namespace

extern "C" {

// Each launcher returns a cudaError_t as int (0 = launched).  valid may be
// null (all rows live); after_d / after_i are (B,) or both null: the
// pass's bound.  kt is the list length 8, 16 or 32, with 1 <= k <= kt.
// thr_g is (B,) int32 scratch holding 0x7f800000 (+inf) at the launch:
// the splits' shared bound on each query's k-th distance.  part_d /
// part_i are (B, splits, kt): one partial list a query and split.

// Shared memory of a block of the tile loop for rows 0 (fp32), 1 (hybrid,
// with T query term slots and a dictionary of 2^dict_bits slots) or 2
// (int8).
size_t l2_tile_smem_bytes(int rows, int T, int dict_bits) {
  return rows == 1   ? tile::layout<HybridRows>(T, dict_bits).total
         : rows == 2 ? tile::layout<Int8Rows>(T, dict_bits).total
                     : tile::layout<F32Rows>(T, dict_bits).total;
}

// The fp32 scan.
int l2_topk_launch(const float* q, const float* x, const int* valid, const float* after_d,
                   const int* after_i, int* thr_g, float* part_d, int* part_i, float* out_d,
                   int* out_i, int B, int N, int D, int k, int kt, int splits,
                   int rows_per_split, cudaStream_t stream) {
  tile::Args a = tile::args(q, valid, after_d, after_i, thr_g, part_d, part_i, B, N, D, k, kt,
                            rows_per_split);
  a.x = x;
  return tile::launch<F32Rows>(a, out_d, out_i, splits, stream);
}

// The hybrid scan; S <= rt::SLAB_MAX, T <= 64; alpha is a (1, 1) device
// tensor, read by the kernel.
int hybrid_topk_launch(const float* q, const float* x, const int* q_terms,
                       const float* q_weights, const int* terms, const float* tf_sat,
                       const float* alpha, const int* valid, const float* after_d,
                       const int* after_i, int* thr_g, float* part_d, int* part_i,
                       float* out_d, int* out_i, int B, int N, int D, int T, int S, int k,
                       int kt, int splits, int rows_per_split, cudaStream_t stream) {
  tile::Args a = tile::args(q, valid, after_d, after_i, thr_g, part_d, part_i, B, N, D, k, kt,
                            rows_per_split);
  a.x = x;
  a.q_terms = q_terms;
  a.q_weights = q_weights;
  a.terms = terms;
  a.tf_sat = tf_sat;
  a.alpha = alpha;
  a.T = T;
  a.S = S;
  return tile::launch<HybridRows>(a, out_d, out_i, splits, stream);
}

// The int8 scan over codes (N, D) with one fp32 scale a row.
int l2_topk_int8_launch(const float* q, const signed char* codes, const float* scales,
                        const int* valid, const float* after_d, const int* after_i, int* thr_g,
                        float* part_d, int* part_i, float* out_d, int* out_i, int B, int N,
                        int D, int k, int kt, int splits, int rows_per_split,
                        cudaStream_t stream) {
  tile::Args a = tile::args(q, valid, after_d, after_i, thr_g, part_d, part_i, B, N, D, k, kt,
                            rows_per_split);
  a.x8 = codes;
  a.scales = scales;
  return tile::launch<Int8Rows>(a, out_d, out_i, splits, stream);
}

}  // extern "C"
