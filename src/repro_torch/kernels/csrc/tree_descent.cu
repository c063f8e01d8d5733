// Batched multi-probe tree beam descent + leaf gather for Hopper (sm_90a).
//
// Replaces: the compiled jax.lax.while_loop of repro/core/tree.py::
//   tree_search (src/repro/core/tree.py:964-1004), which XLA runs as one
//   loop on the device; it reaches no Pallas kernel.  Row r (a query, or a
//   (query, probed bucket) pair of the forest) starts from node roots[r]
//   (node 0 without roots) at priority 0 in slot 0, the other W - 1 beam
//   slots dead (-1, -inf).  One step, exactly the reference's `body`:
//     alpha = proj[n] . q - tau[n]      ("rp": projection trees, QLBT)
//           = q[dims[n]] - tau[n]       ("kd": coordinate splits)
//     near = alpha <= 0 ? left : right, far the other child;
//     slot A of beam slot w: an internal live node goes to its near child
//       at the same priority, a leaf keeps itself, a dead slot is -inf;
//     slot B: an internal live node's far child at prio - |alpha|, else
//       dead (-1, -inf);
//     the new beam is the top W of the 2W candidates [A_0..A_{W-1},
//       B_0..B_{W-1}] by (priority descending, column ascending), which is
//       lax.top_k's order; a slot whose priority is -inf becomes -1;
//     steps += 1 and internal_visits += (number of internal live slots).
//   After the descent each beam slot's leaf row is read out: the (W,
//   leaf) entity ids of the beam's leaves, -1 for an internal or dead
//   slot or a pad, and the count of ids >= 0.
//
// The exit.  The reference loops while some row of the batch still holds
// an internal live node and steps.max() < max_steps.  Here each row stops
// on its own: when none of its live slots is internal, or when its steps
// reach max_steps.  The two agree row for row.  Once a row's beam holds
// only leaves and dead slots, a further step is the identity: slot A
// copies every leaf at its priority, every slot B is dead, the priorities
// are already in descending order with ties in column order (the output
// of the last selection), so the stable selection returns the same beam,
// and steps / internal_visits do not move.  So a row's active steps form
// a prefix of the loop: the row with the longest prefix is active in
// every iteration the batch loop runs, hence steps.max() equals the
// iterations run, the batch loop runs min(max_steps, longest prefix)
// iterations, and each row ends after min(max_steps, its own prefix)
// active steps, where this kernel leaves it.
//
// The selection by merge.  After every selection the beam is in rank
// order: priority descending, ties by column, a dead slot -inf at the
// end.  So the W slot-A candidates are already sorted (slot A keeps its
// slot's priority, or -inf where the slot is dead), and only the W slot-B
// candidates need sorting, by (priority desc, w asc).  Then, in the full
// stable order of [A_0..A_{W-1}, B_0..B_{W-1}]:
//   rank(A_w) = w + #{B strictly above A_w's priority},
//   rank(B)   = its place in sorted B + #{A at or above its priority}
//               (A's columns come before B's, so a tie goes to A),
// the same permutation as the full stable rank, each count a binary
// search in the other sorted list: O(W log^2 W) a step in place of the
// full rank's O(4 W^2).
//
// Design (redesigned for the card):
// * W <= 32: a warp a row, ROWS rows a block (descend_warp).  Lane w holds
//   beam slot w in registers (node, priority, and whether the node is
//   known to be a leaf: slot A of a live slot that was not internal).
//   One step makes one round trip to memory: every lane loads its slot's
//   children, tau (and dims for "kd") while the warp loads the proj rows
//   of every slot not known to be a leaf, all as soon as the beam is
//   known.  The margin of a slot is one warp's dot product in a fixed
//   order: lane i sums proj[n][i + 32 j] * q[i + 32 j] over j by fmaf in
//   order from 0 (one accumulator a slot, so the slots' loads are in
//   flight together), then a butterfly of __shfl_xor_sync (16, 8, 4, 2,
//   1) adds the lanes, and the slot subtracts tau: plain fp32 FMA in a
//   fixed order, no TF32 (ROADMAP faults 4 and 11).  The slots'
//   butterflies run transposed (reduce_slots): the same additions, about
//   W shuffles in place of 5 W.  B is sorted by a bitonic sort over the
//   lanes in shuffles, the counts are binary searches by shuffles, and
//   the new beam goes through the warp's shared memory under __syncwarp:
//   no block barrier at all.
// * W > 32: a block of 256 threads a row (descend_block).  A thread a slot
//   loads and scores it ("kd"; for "rp" a warp a slot, as above), and
//   writes its two candidates; one __syncthreads_or is the barrier and
//   the row's exit test at once.  Each warp sorts 32 of the B candidates
//   by shuffles into shared memory; after a barrier the ranks come from
//   binary searches in the sorted chunks and in the beam, A's by threads
//   0..W-1 and B's by threads W..2W-1 (as far as the block reaches); the
//   new beam is written to the other of two buffers.  Three barriers a
//   step.
// * The row's steps are counted by the row; its internal visits are
//   summed from each thread's share after the loop.
// * The leaf gather is the epilogue: the row's lanes or threads write ids
//   t, t + T, ... of its (W leaf) candidates and a reduction counts them.
//
// Bound at the served forest's shapes (sift-1m, 64 queries x nprobe 32 =
// 2,048 rows, W 8, d 128, leaf 8): bytes.  The proj / tau / children row
// ((d + 3) x 4 B) of each distinct internal node the rows visit, read
// once, the queries, roots, final leaf rows and the outputs, at 3.35
// TB/s; the dot products are 2 d FLOP a visit, far below the fp32 rate.
// chip_smoke.py computes it from the run's visits (and beside it the
// figure that reads a row at every visit).  The kernel is latency-bound
// instead: every step waits on the loads of the beam the last one chose.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;            // rows a block of the warp path
constexpr int BLOCK_THREADS = 256; // the block path's threads
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 227 * 1024;  // dynamic shared memory a block

struct Args {
  const int* children;       // (N, 2)
  const float* tau;          // (N,)
  const float* proj;         // (N, d), "rp"; null for "kd"
  const int* dims;           // (N,), "kd"; null for "rp"
  const float* queries;      // (R, d)
  const int* roots;          // (R,) or null: node 0
  const int* leaf_row;       // (N,)
  const int* leaf_entities;  // (L, leaf)
  int* out_nodes;            // (R, W)
  int* out_steps;            // (R,)
  int* out_visits;           // (R,)
  int* out_cand;             // (R, W leaf)
  int* out_ncand;            // (R,)
  int R, d, W, max_steps, leaf;
};

// (pa, ia) before (pb, ib) in the selection's order: priority descending,
// column ascending.
__device__ __forceinline__ bool before(float pa, int ia, float pb, int ib) {
  return pa > pb || (pa == pb && ia < ib);
}

// Bitonic sort of (p, i) over the first n2 lanes (a power of two <= 32)
// into the selection's order; lanes at and above n2 exchange among
// themselves.  Keys are distinct (the columns are).
__device__ __forceinline__ void warp_sort(float& p, int& i, int n2, int lane) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float po = __shfl_xor_sync(FULL, p, j);
      const int io = __shfl_xor_sync(FULL, i, j);
      const bool lower = (lane & j) == 0, up = (lane & k) == 0;
      const bool other_first = before(po, io, p, i);
      if (lower == up ? other_first : !other_first) {
        p = po;
        i = io;
      }
    }
  }
}

// How many of the n <= 32 descending values held one a lane (lane t the
// t-th) are above x (or at or above it, ge): a binary search by shuffles.
__device__ __forceinline__ int lanes_above(float v, float x, int n, bool ge) {
  int pos = 0;
#pragma unroll
  for (int step = 32; step >= 1; step >>= 1) {
    const int probe = pos + step - 1;
    const float e = __shfl_sync(FULL, v, probe & 31);
    if (probe < n && (ge ? e >= x : e > x)) pos += step;
  }
  return pos;
}

// The same over n descending values in shared memory.
__device__ __forceinline__ int smem_above(const float* e, int n, float x, bool ge) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ge ? e[mid] >= x : e[mid] > x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The butterfly sums of MAXW slots' partial sums, one a lane each, in
// the order of the one-slot butterfly (lane L adds lane L ^ o's value at
// o = 16, 8, 4, 2, 1; each addition is commutative, so which lane of a
// pair adds gives the same bits), transposed: at each of the first
// log2(MAXW) levels a lane keeps half of its slots (the upper half where
// its bit o is set) and adds its partner's values of them (MAXW - 1
// shuffles in all), then the remaining levels are the one-slot
// butterfly.  Returns the sum of the slot slot_lane maps to this lane,
// the same bits as the one-slot butterfly of that slot.
template <int MAXW>
__device__ __forceinline__ float reduce_slots(float (&s)[MAXW], int lane) {
  int o = 16;
#pragma unroll
  for (int k = MAXW; k > 1; k >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < k / 2; ++i) {
      const float send = upper ? s[i] : s[k / 2 + i];
      const float keep = upper ? s[k / 2 + i] : s[i];
      s[i] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
  float v = s[0];
#pragma unroll
  for (; o > 0; o >>= 1) v = v + __shfl_xor_sync(FULL, v, o);
  return v;
}

// The lane whose reduce_slots result is slot w's sum: slot w's bits, most
// significant first, in lane bits 4, 3, ... (the halves kept).
template <int MAXW>
__device__ __forceinline__ int slot_lane(int w) {
  int lane = 0;
#pragma unroll
  for (int k = MAXW / 2, o = 16; k >= 1; k >>= 1, o >>= 1) {
    if (w & k) lane |= o;
  }
  return lane;
}

__device__ __forceinline__ int next_pow2(int n) {
  int k = 1;
  while (k < n) k <<= 1;
  return k;
}

// W <= MAXW <= 32: a warp a row, blockDim / 32 rows a block.  Shared
// memory a warp: the query (d), then the beam's nodes, priorities and
// leaf flags (32 each).
template <int MAXW>
__global__ void __launch_bounds__(ROWS * 32) descend_warp(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int W = a.W, d = a.d;
  const size_t r = (size_t)blockIdx.x * (blockDim.x >> 5) + wid;
  if (r >= (size_t)a.R) return;  // no block barrier below
  float* q = smem + (size_t)wid * (d + 96);
  int* snode = reinterpret_cast<int*>(q + d);
  float* sprio = reinterpret_cast<float*>(snode + 32);
  int* sleaf = reinterpret_cast<int*>(sprio + 32);
  const float* qr = a.queries + r * d;
  for (int i = lane; i < d; i += 32) q[i] = qr[i];
  const bool mine = lane < W;
  int n = lane == 0 ? (a.roots ? a.roots[r] : 0) : -1;
  float prio = lane == 0 ? 0.0f : -CUDART_INF_F;
  bool known_leaf = false;
  const int n2 = next_pow2(W);
  int steps = 0, visits = 0;
  __syncwarp();
  for (;;) {
    // one round trip: this slot's children and tau (and dims), and the
    // proj rows of every slot that may be internal
    const bool look = mine && n >= 0 && !known_leaf;
    int c0 = -1, c1 = -1, dim = 0;
    float t = 0.0f;
    if (look) {
      c0 = a.children[2 * (size_t)n];
      c1 = a.children[2 * (size_t)n + 1];
      t = a.tau[n];
      if (a.dims) dim = a.dims[n];
    }
    float alpha = 0.0f;
    if (a.dims) {
      if (look) alpha = q[dim] - t;
    } else {
      const unsigned want = __ballot_sync(FULL, look);
      int nn[MAXW];
      float s[MAXW];
#pragma unroll
      for (int w = 0; w < MAXW; ++w) {
        nn[w] = __shfl_sync(FULL, n, w);
        s[w] = 0.0f;
      }
#pragma unroll 4
      for (int i = lane; i < d; i += 32) {
        const float qi = q[i];
#pragma unroll
        for (int w = 0; w < MAXW; ++w) {
          if ((want >> w) & 1u) s[w] = fmaf(a.proj[(size_t)nn[w] * d + i], qi, s[w]);
        }
      }
      // lane w's slot sum from the lane that holds it after the reduction
      const float sum = __shfl_sync(FULL, reduce_slots<MAXW>(s, lane),
                                    slot_lane<MAXW>(lane & (MAXW - 1)));
      if (look) alpha = sum - t;
    }
    const bool act = look && c0 >= 0;
    const unsigned actm = __ballot_sync(FULL, act);
    if (actm == 0u || steps >= a.max_steps) break;
    ++steps;
    visits += __popc(actm);
    // the candidates: A in lane w's registers, B sorted over the lanes
    const int an = act ? (alpha <= 0.0f ? c0 : c1) : n;
    const bool a_leaf = !act;  // a live slot that is not internal is a leaf
    const int bn = act ? (alpha <= 0.0f ? c1 : c0) : -1;
    float bp = act ? prio - fabsf(alpha) : -CUDART_INF_F;
    int bi = lane;  // the lanes at and above W are pads, after every real B
    warp_sort(bp, bi, n2, lane);
    const int bnode = __shfl_sync(FULL, bn, bi & 31);
    const int ra = lane + lanes_above(bp, prio, W, false);
    const int rb = lane + lanes_above(prio, bp, W, true);
    __syncwarp();  // every lane has read the last beam from its registers
    if (mine && ra < W) {
      snode[ra] = prio == -CUDART_INF_F ? -1 : an;
      sprio[ra] = prio;
      sleaf[ra] = a_leaf;
    }
    if (mine && rb < W) {
      snode[rb] = bp == -CUDART_INF_F ? -1 : bnode;
      sprio[rb] = bp;
      sleaf[rb] = 0;
    }
    __syncwarp();
    if (mine) {
      n = snode[lane];
      prio = sprio[lane];
      known_leaf = sleaf[lane] != 0;
    }
  }
  // epilogue: the beam, the counters and the leaf gather
  if (mine) {
    snode[lane] = n;
    a.out_nodes[r * W + lane] = n;
  }
  __syncwarp();
  const size_t WL = (size_t)W * a.leaf;
  int live = 0;
  for (size_t e = lane; e < WL; e += 32) {
    const int nd = snode[e / a.leaf];
    const int row = nd >= 0 ? a.leaf_row[nd] : -1;
    const int v = row >= 0 ? a.leaf_entities[(size_t)row * a.leaf + e % a.leaf] : -1;
    a.out_cand[r * WL + e] = v;
    live += v >= 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) live += __shfl_xor_sync(FULL, live, o);
  if (lane == 0) {
    a.out_ncand[r] = live;
    a.out_steps[r] = steps;
    a.out_visits[r] = visits;
  }
}

// W > 32: a block a row.  Shared memory: the query (d), the beam twice
// (nodes, priorities: 4W), the B candidates (2W), the A nodes (W) and B
// sorted in chunks of 32 (priorities, columns: 2W).
__global__ void __launch_bounds__(BLOCK_THREADS) descend_block(Args a) {
  extern __shared__ float smem[];
  __shared__ int s_warp[BLOCK_THREADS / 32];
  __shared__ int s_visits[BLOCK_THREADS / 32];
  const int W = a.W, d = a.d;
  float* q = smem;
  int* nodes = reinterpret_cast<int*>(q + d);
  float* prio = reinterpret_cast<float*>(nodes + W);
  int* nodes2 = reinterpret_cast<int*>(prio + W);
  float* prio2 = reinterpret_cast<float*>(nodes2 + W);
  float* bp = prio2 + W;
  int* bn = reinterpret_cast<int*>(bp + W);
  int* an = bn + W;
  float* sp = reinterpret_cast<float*>(an + W);
  int* si = reinterpret_cast<int*>(sp + W);

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = T >> 5;
  const size_t r = blockIdx.x;
  const float* qr = a.queries + r * d;
  for (int i = tid; i < d; i += T) q[i] = qr[i];
  for (int w = tid; w < W; w += T) {
    nodes[w] = w == 0 ? (a.roots ? a.roots[r] : 0) : -1;
    prio[w] = w == 0 ? 0.0f : -CUDART_INF_F;
  }
  const int chunks = (W + 31) / 32;
  int steps = 0, visits = 0;
  __syncthreads();
  for (;;) {
    // each slot loaded and scored in one round trip, and its two
    // candidates written
    int mine = 0;
    if (a.dims) {
      for (int w = tid; w < W; w += T) {
        const int n = nodes[w];
        int c0 = -1, c1 = -1, dim = 0;
        float t = 0.0f;
        if (n >= 0) {
          c0 = a.children[2 * (size_t)n];
          c1 = a.children[2 * (size_t)n + 1];
          t = a.tau[n];
          dim = a.dims[n];
        }
        const bool act = n >= 0 && c0 >= 0;
        const float al = act ? q[dim] - t : 0.0f;
        mine += act;
        an[w] = act ? (al <= 0.0f ? c0 : c1) : n;
        bn[w] = act ? (al <= 0.0f ? c1 : c0) : -1;
        bp[w] = act ? prio[w] - fabsf(al) : -CUDART_INF_F;
      }
    } else {
      for (int w = warp; w < W; w += warps) {
        const int n = nodes[w];  // warp-uniform
        int c0 = -1, c1 = -1;
        float t = 0.0f, s = 0.0f;
        if (n >= 0) {
          c0 = a.children[2 * (size_t)n];
          c1 = a.children[2 * (size_t)n + 1];
          t = a.tau[n];
          const float* pr = a.proj + (size_t)n * d;
          for (int i = lane; i < d; i += 32) s = fmaf(pr[i], q[i], s);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(FULL, s, o);
        const bool act = n >= 0 && c0 >= 0;
        const float al = s - t;
        if (lane == 0) {
          mine += act;
          an[w] = act ? (al <= 0.0f ? c0 : c1) : n;
          bn[w] = act ? (al <= 0.0f ? c1 : c0) : -1;
          bp[w] = act ? prio[w] - fabsf(al) : -CUDART_INF_F;
        }
      }
    }
    if (!__syncthreads_or(mine) || steps >= a.max_steps) break;
    ++steps;
    visits += mine;
    // B sorted in chunks of 32, a warp a chunk
    for (int c = warp; c < chunks; c += warps) {
      const int w = 32 * c + lane;
      float p = w < W ? bp[w] : -CUDART_INF_F;
      int i = w;  // a pad's column is past every real one
      warp_sort(p, i, 32, lane);
      if (w < W) {
        sp[w] = p;
        si[w] = i;
      }
    }
    __syncthreads();
    // the ranks, by binary search in the other lists, A's by threads 0..W
    // and B's by threads W..2W (as far as the block reaches); the new beam
    // into the other buffers
    for (int k = tid; k < 2 * W; k += T) {
      if (k < W) {
        const float pa = prio[k];
        int ra = k;
        for (int c = 0; c < chunks; ++c) {
          ra += smem_above(sp + 32 * c, min(32, W - 32 * c), pa, false);
        }
        if (ra < W) {
          nodes2[ra] = pa == -CUDART_INF_F ? -1 : an[k];
          prio2[ra] = pa;
        }
      } else {
        const int w = k - W;
        const float pb = sp[w];
        const int own = w >> 5;
        int rb = (w & 31) + smem_above(prio, W, pb, true);
        for (int c = 0; c < chunks; ++c) {
          if (c != own) rb += smem_above(sp + 32 * c, min(32, W - 32 * c), pb, c < own);
        }
        if (rb < W) {
          nodes2[rb] = pb == -CUDART_INF_F ? -1 : bn[si[w]];
          prio2[rb] = pb;
        }
      }
    }
    __syncthreads();
    int* tn = nodes;
    nodes = nodes2;
    nodes2 = tn;
    float* tp = prio;
    prio = prio2;
    prio2 = tp;
  }
  // epilogue: the beam, the counters and the leaf gather (the loop ended
  // on a barrier after the last write of the beam)
  const size_t WL = (size_t)W * a.leaf;
  for (int w = tid; w < W; w += T) a.out_nodes[r * W + w] = nodes[w];
  int live = 0;
  for (size_t e = tid; e < WL; e += T) {
    const int n = nodes[e / a.leaf];
    const int row = n >= 0 ? a.leaf_row[n] : -1;
    const int v = row >= 0 ? a.leaf_entities[(size_t)row * a.leaf + e % a.leaf] : -1;
    a.out_cand[r * WL + e] = v;
    live += v >= 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    live += __shfl_xor_sync(FULL, live, o);
    visits += __shfl_xor_sync(FULL, visits, o);
  }
  if (lane == 0) {
    s_warp[warp] = live;
    s_visits[warp] = visits;
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0, vis = 0;
    for (int w = 0; w < warps; ++w) {
      total += s_warp[w];
      vis += s_visits[w];
    }
    a.out_ncand[r] = total;
    a.out_steps[r] = steps;
    a.out_visits[r] = vis;
  }
}

template <int MAXW>
cudaError_t launch_warp(const Args& a, cudaStream_t stream) {
  int rows = ROWS;  // fewer where the queries are too wide for ROWS a block
  while (rows > 1 && sizeof(float) * (size_t)rows * (a.d + 96) > MAX_SMEM) rows >>= 1;
  const size_t smem = sizeof(float) * (size_t)rows * (a.d + 96);
  cudaError_t err = cudaFuncSetAttribute(descend_warp<MAXW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((a.R + rows - 1) / rows);
  descend_warp<MAXW><<<blocks, rows * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  R >= 1 rows, 1 <= W, d >=
// 1, max_steps >= 0, leaf >= 0; exactly one of proj (N, d) fp32 ("rp") and
// dims (N,) int32 ("kd") is non-null; roots (R,) int32 or null; every
// table contiguous.  W <= 32 runs a warp a row (ROWS rows a block, 4 (d +
// 96) words of shared memory a row), W > 32 a block of 256 threads a row
// (4 (d + 9 W) bytes; kernels/tree_descent.py: smem_bytes).
int tree_descent_launch(const int* children, const float* tau, const float* proj,
                        const int* dims, const float* queries, const int* roots,
                        const int* leaf_row, const int* leaf_entities, int* out_nodes,
                        int* out_steps, int* out_visits, int* out_cand, int* out_ncand, int R,
                        int d, int W, int max_steps, int leaf, cudaStream_t stream) {
  if (R < 1 || d < 1 || W < 1 || max_steps < 0 || leaf < 0 || (proj == nullptr) == (dims == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{children, tau, proj, dims, queries, roots, leaf_row, leaf_entities, out_nodes,
               out_steps, out_visits, out_cand, out_ncand, R, d, W, max_steps, leaf};
  if (W <= 8) return (int)launch_warp<8>(a, stream);
  if (W <= 16) return (int)launch_warp<16>(a, stream);
  if (W <= 32) return (int)launch_warp<32>(a, stream);
  const size_t smem = sizeof(float) * ((size_t)d + 9 * (size_t)W);
  cudaError_t err = cudaFuncSetAttribute(descend_block,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  descend_block<<<R, BLOCK_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
