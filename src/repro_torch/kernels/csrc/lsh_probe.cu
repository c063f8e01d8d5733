// The LSH bottom's probe scan: each query's Hamming shortlist over the
// slots of its probed buckets, in one launch, for Hopper (sm_90a).
//
// Replaces: repro/core/two_level.py::_probe_scan_lsh, the reference's
// jitted lax.scan over the nprobe probe slots (no Pallas kernel there:
// XLA's loop), which the port ran as a Python loop of gathers, a popcount,
// two concatenations and a stable sort a probe slot.
//   Query b's sign bits are qproj[b] > 0, packed little-endian into W
//   words (bit i of word w is bit 32 w + i; the pad bits 0).  Slot (j, c)
//   of the query is id = bucket_ids[probe[b, j], c]; it is dead when
//   id < 0, else its distance is sum_w popcount(qbits[w] ^ codes[id, w]).
//   The scan keeps [carried best | bucket row] ranked by lax.top_k, ties
//   to the lower column, so by induction the list it returns is the S
//   smallest slots under the key (distance, j, c), dead slots after every
//   live one, and -1 in the slots no live slot fills.  Ids are written as
//   they stand: a bucket probed twice gives every id twice (the rerank
//   drops the repeats; dropping them here would let another candidate in
//   and change the answers).  A probe or an id outside its table is read
//   clamped into it, as the reference's gathers clamp; the id written is
//   the one in the bucket table.
//
// Design: one block of 256 threads a query, the query's P cap slots cut
// into 8 contiguous segments of whole 32-slot runs, one a warp.  A stable
// counting sort cut at S:
//   0. the prologue packs the query's bits: warp w ballots qproj > 0 over
//      bits 32 w .. 32 w + 31, which is word w (the product q @ proj
//      itself stays a matmul outside, as in the reference);
//   1. count: each warp walks its segment 32 slots at a time in slot
//      order (lane i: slot s0 + i, so the bucket row reads coalesce),
//      computes each slot's distance (a byte; two for W = 8, whose 257
//      live distances and the dead code do not fit one) and, where the
//      wrapper asks (STORE: the query's distances fit in shared memory),
//      keeps it there.  Equal distances of a run are grouped by
//      __match_any_sync and one lane adds the group's size to the warp's
//      own histogram of 32 W + 1 live bins; dead slots carry the code
//      32 W + 1 and are counted nowhere (nothing emits them);
//   2. offsets: the bins' totals, their exclusive scan by warp 0 (32 bins
//      a shuffle scan), the threshold bin t (the one bin whose running
//      count crosses S; the last live bin when fewer than S slots are
//      live), each warp's offset in every bin (the bin's start plus the
//      counts of the warps before it), and -1 in the slots past the live
//      count;
//   3. emit: each warp walks its segment again in slot order (the stored
//      distances, or recomputed), ballots the slots of distance <= its
//      bound (t), ranks equal distances among a run's hits by
//      __match_any_sync and writes a hit at its bin's offset plus its
//      rank, when below S; the group's first lane then advances the
//      offset.  Once the warp's offset in bin t reaches S the bound drops
//      to t - 1: a bin below t never fills S slots, so the rest of the
//      threshold bin (LSH distances tie by the thousand) costs nothing.
// Segments are in slot order, runs in slot order within a segment, lanes
// in slot order within a run, so the output follows (distance, j, c)
// exactly: bit for bit the plain chain's.  The distances W = 3 sums as
// popc(a ^ b ^ c) + 2 popc(maj(a, b, c)), as csrc/hamming_topk.cu does.
//
// Bound at the main path's shapes (sift-1m's LSH bottom under the PQ top:
// B = 1,024 queries, P = 32 probes, cap = 306, W = 2, S = 128 of 9,792
// slots a query, about 4,550 live): the distinct bucket rows and live
// codes the probes reach, read once, are about 16.5 MB (4.9 us at 3.35
// TB/s: bytes); read slot by slot (a 4 B id every slot, an 8 B code a
// live slot) 78 MB, 23 us; the popcounts, W a live slot at 16 a clock an
// SM on compute capability 9.0 (the CUDA C++ Programming Guide's
// arithmetic-instruction table), 2.2 us.  The reads are gathers that L2
// mostly serves (the code table is 8 MB, the bucket table 10 MB), so the
// slot-by-slot figure is the one to beat.  chip_smoke.py computes all
// three from the run's operands.
//
// Left on the table: staging each distinct bucket row once a block where
// queries share probes; the dead pad slots' id reads (about half the
// slots of a sift-1m query's probed rows are pad); more slots in flight
// a thread, as each slot is a dependent probe -> id -> code load chain.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_W = 8;                 // 256 bits: 257 live distances

// a slot's distance as stored: a byte up to W = 7 (225 codes with the
// dead one), two bytes at W = 8
template <int W>
using Dist = typename std::conditional<(32 * W + 2 <= 256), uint8_t, uint16_t>::type;

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

// The operands of one call.
struct Args {
  const float* qproj;     // (B, n_bits) queries @ projections
  const int* codes;       // (N, W) packed sign bits
  const int* bucket_ids;  // (K, cap), -1 pads
  const int* probe;       // (B, P) bucket ids
  int* out;               // (B, S) ids
  int n_bits, N, K, cap, P, S;
  int seg;                // slots a warp's segment, a multiple of 32
};

// The id in slot s of the query whose probe row is ``prow``.
__device__ __forceinline__ int slot_id(const Args& a, const int* prow, int s) {
  const int j = s / a.cap, c = s - j * a.cap;
  const int bkt = min(max(__ldg(prow + j), 0), a.K - 1);
  return __ldg(a.bucket_ids + (size_t)bkt * a.cap + c);
}

// An id's distance to the query's bits, or the dead code for a negative id.
template <int W>
__device__ __forceinline__ int slot_dist(const Args& a, const uint32_t (&q)[W], int id) {
  constexpr int DEAD = 32 * W + 1;
  if (id < 0) return DEAD;
  const int* code = a.codes + (size_t)min(id, a.N - 1) * W;
  uint32_t x[W];
#pragma unroll
  for (int w = 0; w < W; ++w) x[w] = (uint32_t)__ldg(code + w);
  return ham<W>(q, x);
}

template <int W, bool STORE>
__global__ void __launch_bounds__(THREADS) lsh_probe_scan(const Args a) {
  constexpr int BINS = 32 * W + 1;       // live distances 0 .. 32 W
  constexpr int DEAD = BINS;             // a dead slot's code, in no bin
  using D = Dist<W>;
  __shared__ int hist[WARPS][BINS];      // counts, then each warp's offsets
  __shared__ int start[BINS];            // totals, then each bin's start
  __shared__ uint32_t qs[MAX_W];
  __shared__ int t_bin, live;
  extern __shared__ int4 smem4[];
  D* dist = reinterpret_cast<D*>(smem4);  // [P cap] when STORE

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu;
  if (warp < W) {
    const int bit = warp * 32 + lane;
    const float v = bit < a.n_bits ? a.qproj[(size_t)b * a.n_bits + bit] : 0.f;
    const unsigned m = __ballot_sync(full, v > 0.f);
    if (lane == 0) qs[warp] = m;
  }
  for (int e = tid; e < WARPS * BINS; e += THREADS) (&hist[0][0])[e] = 0;
  if (tid == 0) t_bin = BINS - 1;
  __syncthreads();
  uint32_t q[W];
#pragma unroll
  for (int w = 0; w < W; ++w) q[w] = qs[w];

  const int n = a.P * a.cap;
  const int lo = warp * a.seg, hi = min(n, lo + a.seg);
  const int* prow = a.probe + (size_t)b * a.P;
  int* h = hist[warp];

  // 1. count
  for (int s0 = lo; s0 < hi; s0 += 32) {
    const int s = s0 + lane;
    int d = DEAD;
    if (s < hi) {
      d = slot_dist<W>(a, q, slot_id(a, prow, s));
      if (STORE) dist[s] = (D)d;
    }
    const bool in = d != DEAD;
    const unsigned m = __ballot_sync(full, in);
    if (in) {
      const unsigned peers = __match_any_sync(m, d);
      if (lane == __ffs(peers) - 1) h[d] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();

  // 2. offsets
  for (int d = tid; d < BINS; d += THREADS) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c += hist[w][d];
    start[d] = c;
  }
  __syncthreads();
  if (warp == 0) {
    int run = 0;
    for (int d0 = 0; d0 < BINS; d0 += 32) {
      const int d = d0 + lane;
      const int c = d < BINS ? start[d] : 0;
      int x = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(full, x, o);
        if (lane >= o) x += y;
      }
      const int before = run + x - c;
      if (d < BINS) {
        start[d] = before;
        if (before < a.S && before + c >= a.S) t_bin = d;
      }
      run += __shfl_sync(full, x, 31);
    }
    if (lane == 0) live = run;
  }
  __syncthreads();
  const int t = t_bin;
  for (int d = tid; d <= t; d += THREADS) {
    int off = start[d];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = hist[w][d];
      hist[w][d] = off;
      off += c;
    }
  }
  for (int p = live + tid; p < a.S; p += THREADS) a.out[(size_t)b * a.S + p] = -1;
  __syncthreads();

  // 3. emit
  int bound = h[t] >= a.S ? t - 1 : t;
  const unsigned below = (1u << lane) - 1u;
  for (int s0 = lo; s0 < hi && bound >= 0; s0 += 32) {
    const int s = s0 + lane;
    int id = -1, d = DEAD;
    if (s < hi) {
      if (STORE) {
        d = dist[s];
        if (d <= bound) id = slot_id(a, prow, s);
      } else {
        id = slot_id(a, prow, s);
        d = slot_dist<W>(a, q, id);
      }
    }
    const bool hit = d <= bound;
    const unsigned m = __ballot_sync(full, hit);
    if (m == 0u) continue;
    if (hit) {
      // rank the run's hits of equal distance (a lone hit needs no match)
      const unsigned peers = __popc(m) == 1 ? m : __match_any_sync(m, d);
      const int slot = h[d] + __popc(peers & below);
      if (slot < a.S) a.out[(size_t)b * a.S + slot] = id;
      __syncwarp(m);
      if (lane == __ffs(peers) - 1) h[d] += __popc(peers);
    }
    __syncwarp();
    if (h[bound] >= a.S) --bound;   // the threshold bin is full
  }
}

template <int W, bool STORE>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = STORE ? (size_t)a.P * a.cap * sizeof(Dist<W>) : 0;
  if (smem > 32 * 1024) {   // with the static tables, above the 48 KB default
    const cudaError_t err = cudaFuncSetAttribute(
        lsh_probe_scan<W, STORE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lsh_probe_scan<W, STORE><<<B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int W>
int launch_w(const Args& a, int B, bool store, cudaStream_t stream) {
  return store ? launch<W, true>(a, B, stream) : launch<W, false>(a, B, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  qproj (B, n_bits) fp32
// with 1 <= n_bits <= 256, codes (N, W) int32 with W = ceil(n_bits / 32),
// bucket_ids (K, cap) int32, probe (B, P) int32, out (B, S) int32; S >= 1,
// N, K, cap, P >= 1 and P cap below 2**31; store != 0 keeps each query's
// P cap distances in dynamic shared memory (a byte each, two at W = 8).
int lsh_probe_launch(const float* qproj, const int* codes, const int* bucket_ids,
                     const int* probe, int* out, int B, int n_bits, int N, int K, int cap,
                     int P, int S, int store, cudaStream_t stream) {
  const int W = (n_bits + 31) / 32;
  if (n_bits < 1 || W > MAX_W || B < 1 || N < 1 || K < 1 || cap < 1 || P < 1 || S < 1 ||
      (long long)P * cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int n = P * cap;
  const int per_warp = (n + WARPS - 1) / WARPS;
  const Args a{qproj, codes, bucket_ids, probe, out, n_bits, N, K, cap, P, S,
               (per_warp + 31) / 32 * 32};
  switch (W) {
    case 1: return launch_w<1>(a, B, store != 0, stream);
    case 2: return launch_w<2>(a, B, store != 0, stream);
    case 3: return launch_w<3>(a, B, store != 0, stream);
    case 4: return launch_w<4>(a, B, store != 0, stream);
    case 5: return launch_w<5>(a, B, store != 0, stream);
    case 6: return launch_w<6>(a, B, store != 0, stream);
    case 7: return launch_w<7>(a, B, store != 0, stream);
    default: return launch_w<8>(a, B, store != 0, stream);
  }
}

}  // extern "C"
