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
// Design (a simple kernel that is right; one block a row).
// * The row's query, its beam (nodes, priorities), the margins, the
//   active flags and the 2W candidates live in dynamic shared memory, so
//   any W and any d work (the kd top runs W = 128, the forest W = 8).
// * The margin of a slot is one warp's: lane i sums proj[n][i + 32 j] *
//   q[i + 32 j] over j by fmaf in order from 0, then a butterfly of
//   __shfl_xor_sync (16, 8, 4, 2, 1) adds the lanes (each addition is
//   commutative, so every lane holds the same sum), and lane 0 subtracts
//   tau.  Plain fp32 FMA in a fixed order; no TF32 (ROADMAP fault 4).
//   Only internal live slots are scored: the others' margins are unused.
// * The selection is a stable rank: candidate c's rank is the number of
//   candidates j with p_j > p_c, or p_j == p_c and j < c.  Ranks are a
//   permutation of 0..2W-1 (priorities are finite or -inf), exact for any
//   W; candidate c writes itself to slot rank when rank < W.
// * The step count and the exit test are block-uniform: the active slots
//   are counted into shared memory by atomicAdd between two barriers.
// * The leaf gather is the epilogue: thread t writes ids t, t + T, ... of
//   the row's (W leaf) candidates, and a block reduction counts them.
//
// Bound at the served forest's shapes (sift-1m, 64 queries x nprobe 32 =
// 2,048 rows, W 8, d 128, leaf 8): bytes.  The proj / tau / children row
// ((d + 3) x 4 B) of each distinct internal node the rows visit, read
// once, the queries, roots, final leaf rows and the outputs, at 3.35
// TB/s; the dot products are 2 d FLOP a visit, far below the fp32 rate.
// chip_smoke.py computes it from the run's visits (and beside it the
// figure that reads a row at every visit).  The kernel is latency-bound
// instead: every step waits on the children and proj rows of the last.
//
// Left on the table: a warp a row for small W (the forest's W = 8 leaves
// seven of eight warps of a block idle in the selection); prefetching a
// child's proj row while the selection runs; float4 loads of proj.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

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
  int d, W, max_steps, leaf;
};

__global__ void tree_descent(Args a) {
  extern __shared__ float smem[];
  __shared__ int s_count;
  __shared__ int s_warp[MAX_THREADS / 32];
  const int W = a.W, d = a.d;
  float* q = smem;                                  // d
  int* nodes = reinterpret_cast<int*>(q + d);       // W
  float* prio = reinterpret_cast<float*>(nodes + W);  // W
  float* alpha = prio + W;                          // W
  int* act = reinterpret_cast<int*>(alpha + W);     // W
  int* cn = act + W;                                // 2W
  float* cp = reinterpret_cast<float*>(cn + 2 * W);   // 2W

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = T >> 5;
  const size_t r = blockIdx.x;
  const float* qr = a.queries + r * d;
  for (int i = tid; i < d; i += T) q[i] = qr[i];
  for (int w = tid; w < W; w += T) {
    nodes[w] = w == 0 ? (a.roots ? a.roots[r] : 0) : -1;
    prio[w] = w == 0 ? 0.0f : -CUDART_INF_F;
  }
  int steps = 0, visits = 0;
  for (;;) {
    if (tid == 0) s_count = 0;
    __syncthreads();  // the beam (and q) written, s_count cleared
    int mine = 0;
    for (int w = tid; w < W; w += T) {
      const int n = nodes[w];
      const int on = n >= 0 && a.children[2 * (size_t)n] >= 0;
      act[w] = on;
      mine += on;
    }
    if (mine) atomicAdd(&s_count, mine);
    __syncthreads();
    const int count = s_count;  // block-uniform
    if (count == 0 || steps >= a.max_steps) break;
    // margins, a warp a slot, internal live slots only
    for (int w = warp; w < W; w += warps) {
      if (!act[w]) continue;
      const int n = nodes[w];
      if (a.dims) {
        if (lane == 0) alpha[w] = q[a.dims[n]] - a.tau[n];
      } else {
        const float* p = a.proj + (size_t)n * d;
        float s = 0.0f;
        for (int i = lane; i < d; i += 32) s = fmaf(p[i], q[i], s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) alpha[w] = s - a.tau[n];
      }
    }
    __syncthreads();
    // the 2W candidates
    for (int w = tid; w < W; w += T) {
      const int n = nodes[w];
      if (act[w]) {
        const float al = alpha[w];
        const int left = a.children[2 * (size_t)n], right = a.children[2 * (size_t)n + 1];
        cn[w] = al <= 0.0f ? left : right;
        cp[w] = prio[w];
        cn[W + w] = al <= 0.0f ? right : left;
        cp[W + w] = prio[w] - fabsf(al);
      } else {
        cn[w] = n;
        cp[w] = n >= 0 ? prio[w] : -CUDART_INF_F;
        cn[W + w] = -1;
        cp[W + w] = -CUDART_INF_F;
      }
    }
    __syncthreads();
    // stable rank selection of the top W
    for (int c = tid; c < 2 * W; c += T) {
      const float pc = cp[c];
      int rank = 0;
      for (int j = 0; j < 2 * W; ++j) {
        const float pj = cp[j];
        rank += (pj > pc) || (pj == pc && j < c);
      }
      if (rank < W) {
        nodes[rank] = pc == -CUDART_INF_F ? -1 : cn[c];
        prio[rank] = pc;
      }
    }
    ++steps;
    visits += count;
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
  for (int o = 16; o > 0; o >>= 1) live += __shfl_xor_sync(0xffffffffu, live, o);
  if (lane == 0) s_warp[warp] = live;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < warps; ++w) total += s_warp[w];
    a.out_ncand[r] = total;
    a.out_steps[r] = steps;
    a.out_visits[r] = visits;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  One block a row, R >= 1
// rows, 1 <= W, d >= 1, max_steps >= 0, leaf >= 0; exactly one of proj
// (N, d) fp32 ("rp") and dims (N,) int32 ("kd") is non-null; roots (R,)
// int32 or null; every table contiguous.
int tree_descent_launch(const int* children, const float* tau, const float* proj,
                        const int* dims, const float* queries, const int* roots,
                        const int* leaf_row, const int* leaf_entities, int* out_nodes,
                        int* out_steps, int* out_visits, int* out_cand, int* out_ncand, int R,
                        int d, int W, int max_steps, int leaf, cudaStream_t stream) {
  if (R < 1 || d < 1 || W < 1 || max_steps < 0 || leaf < 0 || (proj == nullptr) == (dims == nullptr))
    return (int)cudaErrorInvalidValue;
  // the query and the beam's tables (kernels/tree_descent.py: smem_bytes)
  const int smem = (int)(sizeof(float) * ((size_t)d + 8 * (size_t)W));
  cudaError_t err = cudaFuncSetAttribute(tree_descent,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 2 * W <= 128 ? 128 : MAX_THREADS;
  const Args a{children, tau, proj, dims, queries, roots, leaf_row, leaf_entities, out_nodes,
               out_steps, out_visits, out_cand, out_ncand, d, W, max_steps, leaf};
  tree_descent<<<R, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
