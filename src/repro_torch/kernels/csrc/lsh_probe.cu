// The LSH bottom's probe scan: each query's Hamming shortlist over the
// live slots of its probed buckets, in one launch, for Hopper (sm_90a).
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
// The extents operand (K,) int32: extents[k] is one past the last column
// of bucket row k that may hold a live id (the index passes its
// bucket_counts: every mutation keeps a row's live ids in columns
// [0, bucket_counts[k]) and -1 after them).  Columns at or past a row's
// extent are never read; a table with a live id there is outside the
// contract.  A -1 inside an extent is a dead slot like any other.  An
// extent is read clamped into [0, cap].
//
// Design (the first design walked every slot of P cap, pads included,
// one probe -> id -> code chain a lane): one block of 256
// threads a query.  A stable counting sort cut at S over the query's
// compacted slot space, the live columns of its probe rows in (j, c)
// order:
//   0. prologue: warp w ballots qproj > 0 over bits 32 w .. 32 w + 31,
//      which is word w (the product q @ proj stays a matmul outside, as in
//      the reference); the block stages its probe rows in shared memory
//      (the bucket, clamped, and its extent) and scans the extents: row j
//      starts at compacted slot rstart[j], and the query has n slots.
//      Above PSTAGE probe rows the rows are staged PSTAGE at a time, once
//      a pass (n from a first sum over all of them);
//   1. count: the compacted space cut into 8 contiguous segments of whole
//      32-slot runs, one a warp; lane i of a run takes its slot s0 + i,
//      finds its row from the staged starts (a cursor that only moves
//      forward), and loads the slot's id, then its code: two loads a slot
//      (a row's ids are contiguous, so they coalesce).  Each slot's
//      distance (a byte; two for W = 8, whose 257
//      live distances and the dead code do not fit one) goes into the
//      warp's own histogram of 32 W + 1 live bins by a shared-memory
//      atomic; dead slots carry the code 32 W + 1 and are counted nowhere.
//      Where the query's n distances fit the slot store (dynamic shared
//      memory, `store` bytes from the host) they are kept there (path
//      "distances stored"), else the emit recomputes them ("recompute");
//   2. offsets: the bins' totals, their exclusive scan by warp 0 (32 bins
//      a shuffle scan), the threshold bin t (the one bin whose running
//      count crosses S; the last live bin when fewer than S slots are
//      live), each warp's offset in every bin (the bin's start plus the
//      counts of the warps before it), and -1 in the slots past the live
//      count;
//   3. emit: each warp walks its segment again in slot order, 32 slots a
//      run, from the stored distances (or recomputing them as in the
//      count).  It ballots the slots of distance <= its bound (t),
//      ranks equal distances among a run's hits by __match_any_sync and
//      writes a hit at its bin's offset plus its rank, when below S: its
//      compacted slot where the distances are stored, its id where they
//      are recomputed.  The group's first lane then advances the offset.
//      Once the warp's offset in bin t reaches S the bound drops to t - 1:
//      a bin below t never fills S slots, so the rest of the threshold bin
//      (LSH distances tie by the thousand) costs nothing;
//   4. ids (distances stored): each of the min(live, S) winners' slots
//      becomes its id, one load each, the block's 256 threads side by side
//      (one round trip, where reading a hit's id in the emit cost one a
//      run with a hit).
// Segments are in slot order, runs in slot order within a segment, lanes
// in slot order within a run, so the output follows (distance, j, c)
// exactly: bit for bit the plain chain's.  The distances W = 3 sums as
// popc(a ^ b ^ c) + 2 popc(maj(a, b, c)), as csrc/hamming_topk.cu does.
//
// Bound at the main path's shapes (sift-1m's LSH bottom under the PQ top:
// B = 1,024 queries, P = 32 probes, cap = 306, W = 2, S = 128 of 9,792
// slots a query, about 4,550 live; the distances a byte a slot, 9,792 B
// of store, 8 blocks an SM): the distinct bucket rows and live
// codes the probes reach, read once, are about 16.5 MB (4.9 us at 3.35
// TB/s: bytes); read slot by slot (a 4 B id every slot, an 8 B code a
// live slot) 78 MB, 23 us; live slot by live slot (a 4 B id and a W x 4 B
// code a live slot: what this design reads) about 56 MB, 17 us; the
// popcounts, W a live slot at 16 a clock an SM on compute capability 9.0
// (the CUDA C++ Programming Guide's arithmetic-instruction table), 2.2
// us.  chip_smoke.py computes all four from the run's operands.
//
// Where the time goes (tools/kernel_ab_torch.py --lsh-ablation and
// --lsh-spans at that shape): the count pass, about three quarters of a
// block's cycles, is bound by the code gather's L2 sectors (a 32 B sector
// fetched for each 8 B code), not by its latency: two or four runs a lane
// in flight timed within 2 % of one, and spilled at W = 8.  Left on
// the table: reading each distinct bucket row's codes once for every
// query that probes it (6,986 distinct rows of 32,768 probes at sift), or
// a copy of the codes in bucket order placed with the index's tables (a
// row's codes contiguous: a quarter of the sectors), the ways toward the
// bytes bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_W = 8;                 // 256 bits: 257 live distances
constexpr int PSTAGE = 1024;             // probe rows staged at once

// The blocks an SM the register budget is set for, by W: 8 (32
// registers) up to W = 4, without spills; above it the shared tables hold
// at most 7 blocks an SM and a 32-register budget spills into the code
// gather's way (about 2x slower), so 6 (40 registers).
constexpr int min_blocks(int W) { return W <= 4 ? 8 : 6; }

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

// A code's W words, by 16 B or 8 B loads where W allows (the launcher
// asks for a code table aligned to them).
template <int W>
__device__ __forceinline__ void load_code(const int* code, uint32_t (&x)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int v = 0; v < W / 4; ++v) {
      const int4 c = __ldg(reinterpret_cast<const int4*>(code) + v);
      x[4 * v] = c.x, x[4 * v + 1] = c.y, x[4 * v + 2] = c.z, x[4 * v + 3] = c.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int v = 0; v < W / 2; ++v) {
      const int2 c = __ldg(reinterpret_cast<const int2*>(code) + v);
      x[2 * v] = c.x, x[2 * v + 1] = c.y;
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) x[w] = (uint32_t)__ldg(code + w);
  }
}

// The operands of one call.
struct Args {
  const float* qproj;     // (B, n_bits) queries @ projections
  const int* codes;       // (N, W) packed sign bits
  const int* bucket_ids;  // (K, cap), live ids before each row's extent
  const int* extents;     // (K,) one past each row's last live column
  const int* probe;       // (B, P) bucket ids
  int* out;               // (B, S) ids
  int n_bits, N, K, cap, P, S;
  int ps;                 // probe rows staged at once: min(P, PSTAGE)
  int store;              // bytes of the slot store
};

// The staged probe rows of a chunk: bkt[j] the bucket (clamped), rstart[j]
// the compacted slot where row j begins, rstart[m] the chunk's slots.
struct Rows {
  int* bkt;
  int* rstart;
};

// Stage probe rows j0 .. j0 + m - 1 of the query (m = min(ps, P - j0)):
// each thread loads up to PSTAGE / THREADS consecutive rows and their
// extents, then a block scan of the extents.  Ends in a block barrier.
__device__ __forceinline__ void stage(const Args& a, const int* prow, int j0, const Rows& rows,
                                      int* wsum) {
  constexpr int G = PSTAGE / THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = min(a.ps, a.P - j0);
  const int per = (m + THREADS - 1) / THREADS;
  const int i0 = tid * per;
  int e[G];
  int sum = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    e[g] = 0;
    const int i = i0 + g;
    if (g < per && i < m) {
      const int k = min(max(__ldg(prow + j0 + i), 0), a.K - 1);
      rows.bkt[i] = k;
      e[g] = min(max(__ldg(a.extents + k), 0), a.cap);
    }
    sum += e[g];
  }
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = x - sum;
  for (int w = 0; w < warp; ++w) before += wsum[w];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int i = i0 + g;
    if (g < per && i < m) rows.rstart[i] = before;
    before += e[g];
  }
  if (tid == THREADS - 1) rows.rstart[m] = before;
  __syncthreads();
}

// The row of chunk slot s (rstart[0] <= s < rstart[m]): the last row that
// starts at or before s, by binary search.
__device__ __forceinline__ int row_of(const int* rstart, int m, int s) {
  int lo = 0, hi = m;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (rstart[mid] <= s) lo = mid; else hi = mid;
  }
  return lo;
}

// Run s0 of a warp's chunk range ending at x1: the lane's id (its row
// cursor j moving forward), then its code; returns the distance, DEAD
// past x1 or for a dead id.
template <int W>
__device__ __forceinline__ int load_run(const Args& a, const Rows& rows, const uint32_t (&q)[W],
                                        int s0, int x1, int lane, int& j, int& id) {
  const int s = s0 + lane;
  id = -1;
  if (s < x1) {
    while (rows.rstart[j + 1] <= s) ++j;
    id = __ldg(a.bucket_ids + (size_t)rows.bkt[j] * a.cap + (s - rows.rstart[j]));
  }
  if (id < 0) return 32 * W + 1;
  uint32_t x[W];
  load_code<W>(a.codes + (size_t)min(id, a.N - 1) * W, x);
  return ham<W>(q, x);
}

template <int W>
__global__ void __launch_bounds__(THREADS, min_blocks(W)) lsh_probe_scan(const Args a) {
  constexpr int BINS = 32 * W + 1;       // live distances 0 .. 32 W
  constexpr int DEAD = BINS;             // a dead slot's code, in no bin
  using D = Dist<W>;
  __shared__ int hist[WARPS][BINS];      // counts, then each warp's offsets
  __shared__ int start[BINS];            // totals, then each bin's start
  __shared__ uint32_t qs[MAX_W];
  __shared__ int wsum[WARPS];
  __shared__ int t_bin, live, total;
  extern __shared__ int4 smem4[];
  const Rows rows{reinterpret_cast<int*>(smem4), reinterpret_cast<int*>(smem4) + a.ps};
  char* store = reinterpret_cast<char*>(smem4) + ((2 * a.ps + 1) * 4 + 15) / 16 * 16;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu;
  const int* prow = a.probe + (size_t)b * a.P;
  const bool chunked = a.P > a.ps;
  if (warp < W) {
    const int bit = warp * 32 + lane;
    const float v = bit < a.n_bits ? a.qproj[(size_t)b * a.n_bits + bit] : 0.f;
    const unsigned m = __ballot_sync(full, v > 0.f);
    if (lane == 0) qs[warp] = m;
  }
  for (int e = tid; e < WARPS * BINS; e += THREADS) (&hist[0][0])[e] = 0;
  if (tid == 0) t_bin = BINS - 1, total = 0;
  __syncthreads();
  if (chunked) {   // the query's slots over all its rows, before the first chunk
    int sum = 0;
    for (int j = tid; j < a.P; j += THREADS)
      sum += min(max(__ldg(a.extents + min(max(__ldg(prow + j), 0), a.K - 1)), 0), a.cap);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(full, sum, o);
    if (lane == 0) atomicAdd(&total, sum);
  }
  stage(a, prow, 0, rows, wsum);
  const int n = chunked ? total : rows.rstart[a.ps];
  uint32_t q[W];
#pragma unroll
  for (int w = 0; w < W; ++w) q[w] = qs[w];

  // the slot store: the query's distances where they fit, by its own n
  const bool stored = (long long)n * (int)sizeof(D) <= a.store;
  D* sdist = reinterpret_cast<D*>(store);

  const int per_warp = (n + WARPS - 1) / WARPS;
  const int seg = (per_warp + 31) / 32 * 32;
  const int lo = warp * seg, hi = min(n, lo + seg);
  int* h = hist[warp];

  // 1. count
  for (int j0 = 0, base = 0; j0 < a.P; j0 += a.ps) {
    if (j0 > 0) {
      __syncthreads();
      stage(a, prow, j0, rows, wsum);
    }
    const int m = min(a.ps, a.P - j0), cnt = rows.rstart[m];
    const int x0 = max(lo, base) - base, x1 = min(hi, base + cnt) - base;
    int j = x0 + lane < x1 ? row_of(rows.rstart, m, x0 + lane) : 0;
    for (int s0 = x0; s0 < x1; s0 += 32) {
      int id;
      const int d = load_run<W>(a, rows, q, s0, x1, lane, j, id);
      if (stored && s0 + lane < x1) sdist[base + s0 + lane] = (D)d;
      if (d != DEAD) atomicAdd(&h[d], 1);
    }
    base += cnt;
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

  // 3. emit: each hit's compacted slot at its place (its id on the
  // recompute path)
  int bound = h[t] >= a.S ? t - 1 : t;
  const unsigned below = (1u << lane) - 1u;
  int* out = a.out + (size_t)b * a.S;
  // one run's hits (distance <= bound) written at their offsets
  auto emit = [&](int d, int v) {
    const bool hit = d <= bound;
    const unsigned m = __ballot_sync(full, hit);
    if (m == 0u) return;
    if (hit) {
      // rank the run's hits of equal distance (a lone hit needs no match)
      const unsigned peers = __popc(m) == 1 ? m : __match_any_sync(m, d);
      const int slot = h[d] + __popc(peers & below);
      if (slot < a.S) out[slot] = v;
      __syncwarp(m);
      if (lane == __ffs(peers) - 1) h[d] += __popc(peers);
    }
    __syncwarp();
    if (h[bound] >= a.S) --bound;   // the threshold bin is full
  };
  if (stored) {
    for (int s0 = lo; s0 < hi && bound >= 0; s0 += 32) {
      const int s = s0 + lane;
      emit(s < hi ? (int)sdist[s] : DEAD, s);
    }
    // 4. the winners' ids: one load each, the block's threads side by
    // side; a winner converted in an earlier chunk is held as -2 - id
    const int wins = min(live, a.S);
    for (int j0 = 0, base = 0; j0 < a.P; j0 += a.ps) {
      __syncthreads();
      if (chunked) stage(a, prow, j0, rows, wsum);
      const int m = min(a.ps, a.P - j0), cnt = rows.rstart[m];
      for (int p = tid; p < wins; p += THREADS) {
        const int s = out[p] - base;
        if (s >= 0 && s < cnt) {
          const int jr = row_of(rows.rstart, m, s);
          const int id = __ldg(a.bucket_ids + (size_t)rows.bkt[jr] * a.cap + (s - rows.rstart[jr]));
          out[p] = chunked ? -2 - id : id;
        }
      }
      base += cnt;
    }
    if (chunked) {
      __syncthreads();
      for (int p = tid; p < wins; p += THREADS) out[p] = -2 - out[p];
    }
    return;
  }
  for (int j0 = 0, base = 0; j0 < a.P; j0 += a.ps) {
    if (chunked) {
      __syncthreads();
      stage(a, prow, j0, rows, wsum);
    }
    const int m = min(a.ps, a.P - j0), cnt = rows.rstart[m];
    const int x0 = max(lo, base) - base, x1 = min(hi, base + cnt) - base;
    int j = x0 + lane < x1 ? row_of(rows.rstart, m, x0 + lane) : 0;
    for (int s0 = x0; s0 < x1 && bound >= 0; s0 += 32) {
      int id;
      const int d = load_run<W>(a, rows, q, s0, x1, lane, j, id);
      emit(d, id);
    }
    base += cnt;
  }
}

// The dynamic shared memory of a launch: the staged rows, then the store.
size_t smem_bytes(int ps, int store) { return ((2 * ps + 1) * 4 + 15) / 16 * 16 + store; }

template <int W>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.ps, a.store);
  // with the static tables, above the 48 KB default; the limit is the
  // function's from then on, so it is only ever raised above 32 KB
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsh_probe_scan<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lsh_probe_scan<W><<<B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int W>
int info(int ps, int store, int* out) {
  const size_t smem = smem_bytes(ps, store);
  cudaError_t err = cudaSuccess;
  if (smem > 32 * 1024) {   // as launch raises it: never below the default
    err = cudaFuncSetAttribute(lsh_probe_scan<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, lsh_probe_scan<W>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lsh_probe_scan<W>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)(attr.sharedSizeBytes + smem);
  return 0;
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  qproj (B, n_bits) fp32
// with 1 <= n_bits <= 256, codes (N, W) int32 with W = ceil(n_bits / 32)
// (16 B aligned where W is a multiple of 4, 8 B where it is even),
// bucket_ids (K, cap) int32, extents (K,) int32, probe (B, P) int32, out
// (B, S) int32; S >= 1, N, K, cap, P >= 1 and P cap below 2**31; store:
// the bytes of dynamic shared memory a block keeps its distances in (a
// query of n slots keeps them when n d fits, d the distance's bytes, two
// at W = 8; else its emit recomputes them).
int lsh_probe_launch(const float* qproj, const int* codes, const int* bucket_ids,
                     const int* extents, const int* probe, int* out, int B, int n_bits, int N,
                     int K, int cap, int P, int S, int store, cudaStream_t stream) {
  const int W = (n_bits + 31) / 32;
  if (n_bits < 1 || W > MAX_W || B < 1 || N < 1 || K < 1 || cap < 1 || P < 1 || S < 1 ||
      store < 0 || (long long)P * cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const Args a{qproj, codes, bucket_ids, extents, probe, out, n_bits, N, K, cap, P, S,
               P < PSTAGE ? P : PSTAGE, store};
  switch (W) {
    case 1: return launch<1>(a, B, stream);
    case 2: return launch<2>(a, B, stream);
    case 3: return launch<3>(a, B, stream);
    case 4: return launch<4>(a, B, stream);
    case 5: return launch<5>(a, B, stream);
    case 6: return launch<6>(a, B, stream);
    case 7: return launch<7>(a, B, stream);
    default: return launch<8>(a, B, stream);
  }
}

// The kernel for n_bits as the launcher would launch it at P probes with
// `store` bytes: out[0] registers a thread, out[1] local (spilled) bytes a
// thread, out[2] resident blocks an SM, out[3] shared memory a block.  Returns a cudaError_t as int.
int lsh_probe_info(int n_bits, int P, int store, int* out) {
  const int W = (n_bits + 31) / 32;
  if (n_bits < 1 || W > MAX_W || P < 1 || store < 0) return (int)cudaErrorInvalidValue;
  const int ps = P < PSTAGE ? P : PSTAGE;
  switch (W) {
    case 1: return info<1>(ps, store, out);
    case 2: return info<2>(ps, store, out);
    case 3: return info<3>(ps, store, out);
    case 4: return info<4>(ps, store, out);
    case 5: return info<5>(ps, store, out);
    case 6: return info<6>(ps, store, out);
    case 7: return info<7>(ps, store, out);
    default: return info<8>(ps, store, out);
  }
}

// The runtime's name of a cudaError_t the two calls above return.
const char* lsh_probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
