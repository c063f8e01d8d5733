// The LM serving path's two attentions, for Hopper (sm_90a): the chunked
// prefill attention (attention_chunked) and the one-token GQA decode
// attention over a KV cache (attention_decode).
//
// Replaces (no Pallas kernel there: the reference's LM path is plain jnp):
//   attention_chunked: repro/models/attention.py's lax.scan over KV blocks
//     (:96, the jax.checkpoint'ed step :73-91), which the port ran as a
//     Python loop of eager ops over each block's fp32 score tile;
//   attention_decode: repro/models/attention.py::decode_attention
//     (:104-123), whose einsums the port ran with the cache permuted into
//     copies a layer.
//
// What attention_chunked computes, per (batch b, query head h, position),
// with GQA (head h reads KV head h / R) and the reference's rounding
// points a block of `chunk` slots (the last block padded: pads masked, V
// zero):
//   1. s = float(round_T(q . k)) * scale, the product accumulated in fp32
//      and rounded to the inputs' type T; a masked slot (kv_mask 0, a pad,
//      or a causal slot past the query's position) is -1e30;
//   2. m_new = max(m, the block's max over all its slots), before any exp;
//   3. p = exp(s - m_new) in fp32; l = l corr + sum p, corr = exp(m - m_new);
//   4. pv = round_T(sum over the block of round_T(p) v), fp32 accumulation
//      over the whole block; acc = acc corr + float(pv);
//   5. o = round_T(acc / max(l, 1e-30)).
// fp32 inputs round nowhere (round_T is the identity).
//
// Design (attention_chunked, bf16): one block of 128 threads a tile of 64
// query rows of one (batch, KV head): the rows are the (position, head)
// pairs flattened position-major, so the R query heads of a KV head share
// every K and V tile.  The block walks the reference's blocks in inner
// tiles of 64 slots and takes two passes over each block: the first
// computes the scores (mma.sync m16n8k16, bf16 in, fp32 out) and the
// block's max, the second computes them again, then p, its sum and the
// block's P.V into fp32 registers, rounded once at the block's end into
// the running accumulator (registers too).  Recomputing Q K^T costs a
// third more tensor work and keeps the reference's 1,024-slot max and P.V
// rounding without holding a block's score rows.  K and V are read where
// they lie, by their strides (no pad, permute or transpose copies): the
// inner tiles come by cp.async into a ring of two stages, the next tile's
// loads in flight while the current one's products run, and the
// fragments by ldmatrix (V's transposed).  A tile masked for every
// row of the query tile is skipped when every row of the tile has a live
// slot somewhere (a causal tile past the tile's last position ends the
// walk): such work adds exactly 0 (p = exp(-1e30 - m) = 0, corr = 1, and
// what a row sums before its first live slot is wiped by corr = 0 there).
// A tile with a row that has no live slot anywhere skips nothing, so that
// row gets the reference's uniform answer over every slot, pads included.
// dv above 128 is cut into slices of 128 (grid z), each slice computing
// its own scores.  fp32 inputs take a SIMT kernel of the same walk (32 x
// 32 tiles, FMA, no TF32: 64-wide dv slices).
//
// Design (attention_decode): three launches over each (batch, KV head)'s
// live slots (t < lengths[b]; all S slots where lengths[b] is 0, whose
// row gets the uniform softmax) cut into splits of 512 slots, one block a
// split serving all R query heads, so K and V are read once:
//   1. scores: a group of lanes a slot (a lane an 8-element chunk), each
//      head's dot reduced by shuffles, round_T, scaled, into an fp32
//      scratch; the split's max m_i and z_i = sum exp(s - m_i) a head;
//   2. p and P.V: M = max m_i and Z = sum z_i exp(m_i - M) in split order,
//      p = round_T(exp(s - M) / Z), each split's fp32 P.V (a thread eight
//      columns of one head over every few slots, V read straight from the
//      cache, the partial sums added in a fixed order);
//   3. combine: the splits' sum in split order, rounded once.
// Masked slots past lengths[b] are never read: exp(-1e30 - M) = 0 there.
//
// Bounds (PERF.md; on-chip numbers from chip_smoke.py): attention_chunked
// by operations, the causal half's Q K^T and P.V at the dense bf16 tensor
// rate (989 TFLOP/s); attention_decode by bytes, the live slots' K and V
// read once at 3.35 TB/s.  The kernel's recompute (a third more tensor
// work) and mma.sync (not wgmma) keep it above the first; the scratch
// (fp32 scores, partial outputs) adds a few percent to the second.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;
constexpr int NT = 128;            // threads a block, every kernel here
constexpr int NWARP = NT / 32;
constexpr int BM = 64;             // bf16 kernel: query rows a tile
constexpr int BN = 64;             // bf16 kernel: KV slots an inner tile
constexpr int TDV = 128;           // bf16 kernel: the widest dv slice
constexpr int FM = 32;             // fp32 kernel: query rows a tile
constexpr int FN = 32;             // fp32 kernel: KV slots an inner tile
constexpr int FDV = 64;            // fp32 kernel: dv slice
constexpr int SPLIT = 512;         // decode: slots a block
constexpr int SMEM_MAX = 200 * 1024;  // the opt-in every launch raises to (under
                                   // the card's 227 KB less static shared memory)

struct Chunked {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* qpos;                 // (Sq,) positions, or null: 0..Sq-1
  const uint8_t* mask;             // (B, Sk) 1 = valid, or null: all
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;   // strides
  int B, Sq, Sk, G, R, dh, dv, chunk, causal, vec;
  float scale;
};

struct Decode {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* len;                  // (B,) valid slots a row
  float* sc;                       // (B G, R, S) scores
  float* ms;                       // (B G, R, ns) each split's max
  float* zs;                       // (B G, R, ns) each split's sum
  float* part;                     // (B G, R, ns, dv) each split's P.V
  long long qb, qh, kb, ks, kh, vb, vs, vh, ob, oh;
  int B, S, G, R, dh, dv, ns, gl, vec;
  float scale;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<bf16>(float x) { return round_bf16(x); }
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Elements [0, 8) of a row at p (those at or past `left` read as 0); vec:
// one 16-byte load (the caller guarantees 8 elements and the alignment).
__device__ __forceinline__ uint4 load8(const bf16* p, int left, int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = 2 * e < left ? __bfloat16_as_ushort(p[2 * e]) : 0u;
    const uint32_t hi = 2 * e + 1 < left ? __bfloat16_as_ushort(p[2 * e + 1]) : 0u;
    w[e] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void load8f(const bf16* p, int left, int vec, float* out) {
  const uint4 x = load8(p, left, vec);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {   // a bf16 is the high half of its fp32
    out[2 * e] = __uint_as_float(w[e] << 16);
    out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8f(const float* p, int left, int vec, float* out) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = e < left ? p[e] : 0.f;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 fp32
__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------- the chunked walk

// A query tile's prologue: pos[i] the position of tile row i (INT_MIN past
// the rows), *qmax the tile's last position, and whether the tile may skip
// masked work: every row has a live slot somewhere (causal: the batch
// row's first live slot at or before its position).
__device__ int tile_prologue(const Chunked& a, int b, int t0, int nrows, int tm, int* pos,
                             int* qmax) {
  __shared__ int s_first, s_qmax;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_first = a.mask ? a.Sk : 0;
    s_qmax = INT_MIN;
  }
  __syncthreads();
  if (a.mask) {
    for (int base = 0; base < a.Sk; base += NT) {
      const int n = base + tid;
      if (n < a.Sk && a.mask[(long long)b * a.Sk + n]) atomicMin(&s_first, n);
      __syncthreads();
      const int f = s_first;
      __syncthreads();
      if (f < a.Sk) break;
    }
  }
  for (int i = tid; i < tm; i += NT) {
    int p = INT_MIN;
    if (i < nrows) {
      const int sq = (t0 + i) / a.R;
      p = a.qpos ? a.qpos[sq] : sq;
      atomicMax(&s_qmax, p);
    }
    pos[i] = p;
  }
  __syncthreads();
  const int first = s_first;
  int live = 1;
  for (int i = tid; i < nrows; i += NT)
    if (a.causal ? first > pos[i] : first >= a.Sk) live = 0;
  *qmax = s_qmax;
  return __syncthreads_and(live);
}

// What the walk does with inner tile [k0, k1): 0 walk it, 1 skip it, 2
// skip the rest of the block (pads), 3 stop (causal: past the tile's last
// position).  Uniform over the block; every thread calls it.
__device__ int tile_state(const Chunked& a, int b, int k0, int k1, int skip_ok, int qmax) {
  if (!skip_ok) return 0;
  if (a.causal && k0 > qmax) return 3;
  if (k0 >= a.Sk) return 2;
  if (!a.mask) return 0;
  int any = 0;
  const int kend = min(k1, a.Sk);
  for (int n = k0 + (int)threadIdx.x; n < kend; n += NT) any |= a.mask[(long long)b * a.Sk + n];
  return __syncthreads_or(any) ? 0 : 1;
}

// slot[j] of inner tile [k0, k1): 0 absent (past the block), 1 masked (a
// pad or kv_mask 0), 2 live unless causal masks it for a row
__device__ void stage_slots(const Chunked& a, int b, int k0, int k1, int tn, int* slot) {
  for (int j = threadIdx.x; j < tn; j += NT) {
    const int n = k0 + j;
    slot[j] = n >= k1 ? 0 : (n >= a.Sk || (a.mask && !a.mask[(long long)b * a.Sk + n])) ? 1 : 2;
  }
}

__device__ __forceinline__ float score_of(float x, int st, int n, int p, int causal, float scale) {
  if (st == 0) return -INFINITY;
  if (st == 1 || (causal && n > p)) return NEG;
  return x * scale;
}

template <int DHP>
struct BfTile {
  static constexpr int DVT = TDV;
  static constexpr int QST = DHP + 8;   // Q and K rows, bf16 (no bank conflicts)
  static constexpr int VST = DVT + 8;   // V rows, bf16
  static constexpr size_t smem = (size_t)BM * QST * 2 + (size_t)2 * BN * QST * 2 +
                                 (size_t)2 * BN * VST * 2 + (size_t)(2 * BN + BM) * 4;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !pred (nothing
// is read then: `src` need only be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// bf16 inputs.  Warp w holds query rows 16 w .. 16 w + 15 of the tile;
// lane (gid, tig) = (lane / 4, lane % 4) rows 16 w + gid and + 8.  K and
// V tiles (and their slot flags) come in a ring of two stages by
// cp.async, the next walked tile's loads in flight while the current
// one's products run; fragments by ldmatrix (V's transposed).
template <int DHP>
__global__ void __launch_bounds__(NT) chunked_bf16(Chunked a) {
  typedef BfTile<DHP> L;
  constexpr int DVT = L::DVT, QST = L::QST, VST = L::VST, QC = DHP / 8, VC = DVT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * QST;                       // [2][BN][QST]
  bf16* Vs = Ks + 2 * BN * QST;                   // [2][BN][VST]
  int* slot = reinterpret_cast<int*>(Vs + 2 * BN * VST);   // [2][BN]
  int* pos = slot + 2 * BN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rows = a.Sq * a.R;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BM;   // the longest causal walks first
  const int nrows = min(BM, rows - t0);
  const int b = blockIdx.y / a.G, g = blockIdx.y % a.G;
  const int dv0 = blockIdx.z * DVT;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qb;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.kb + g * a.kh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vb + g * a.vh + dv0;

  int qmax;
  const int skip_ok = tile_prologue(a, b, t0, nrows, BM, pos, &qmax);
  for (int c = tid; c < BM * QC; c += NT) {
    const int i = c / QC, d = (c % QC) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (i < nrows && d < a.dh) {
      const int t = t0 + i;
      x = load8(qg + (t / a.R) * a.qs + (g * a.R + t % a.R) * a.qh + d, a.dh - d, a.vec);
    }
    *reinterpret_cast<uint4*>(Qs + i * QST + d) = x;
  }
  __syncthreads();

  const int r0 = warp * 16 + gid;        // this thread's rows: r0, r0 + 8
  const int p0 = pos[r0], p1 = pos[r0 + 8];
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  float acc[VC][4], pv[VC][4], s[8][4];
#pragma unroll
  for (int jj = 0; jj < VC; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;

  // stage `st` <- inner tile [k0, k1): K rows (and V rows), slot flags
  auto fetch = [&](int st, int k0, int k1, bool with_v) {
    const int kend = min(k1, a.Sk);
    bf16* kd = Ks + st * BN * QST;
    for (int c = tid; c < BN * QC; c += NT) {
      const int j = c / QC, d = (c % QC) * 8, n = k0 + j;
      const bool ok = n < kend && d < a.dh;
      if (a.vec) {
        cp_async16(kd + j * QST + d, ok ? kg + n * a.ks + d : kg, ok);
      } else {
        *reinterpret_cast<uint4*>(kd + j * QST + d) =
            ok ? load8(kg + n * a.ks + d, a.dh - d, 0) : make_uint4(0, 0, 0, 0);
      }
    }
    if (with_v) {
      bf16* vd = Vs + st * BN * VST;
      for (int c = tid; c < BN * VC; c += NT) {
        const int j = c / VC, d = (c % VC) * 8, n = k0 + j;
        const bool ok = n < kend && dv0 + d < a.dv;
        if (a.vec) {
          cp_async16(vd + j * VST + d, ok ? vg + n * a.vs + d : vg, ok);
        } else {
          *reinterpret_cast<uint4*>(vd + j * VST + d) =
              ok ? load8(vg + n * a.vs + d, a.dv - dv0 - d, 0) : make_uint4(0, 0, 0, 0);
        }
      }
    }
    stage_slots(a, b, k0, k1, BN, slot + st * BN);
    cp_async_commit();
  };
  // the tile's scores for this thread's rows from stage `st`: s[j][e]
  // row r0 + 8 (e / 2), slot k0 + 8 j + 2 tig + e % 2
  auto scores = [&](int st, int k0) {
    const bf16* kd = Ks + st * BN * QST;
    const int* sl = slot + st * BN;
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DHP; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, Qs + (warp * 16 + (lane & 15)) * QST + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bfr[4];
        ldsm_x4(bfr, kd + (j * 8 + (lane & 7) + (lane >> 4) * 8) * QST + kk +
                         ((lane >> 3) & 1) * 8);
        mma16816(s[j], af[0], af[1], af[2], af[3], bfr[0], bfr[1]);
        mma16816(s[j + 1], af[0], af[1], af[2], af[3], bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tig * 2 + (e & 1);
        s[j][e] = score_of(round_bf16(s[j][e]), sl[col], k0 + col, e < 2 ? p0 : p1, a.causal,
                           a.scale);
      }
  };

  const int n_blk = (a.Sk + a.chunk - 1) / a.chunk;
  int done = 0;
  for (int blk = 0; blk < n_blk && !done; ++blk) {
    const int blo = blk * a.chunk, bhi = blo + a.chunk;
    // the block's next walked inner tile at or after k, or -1
    auto next_tile = [&](int k) {
      for (; k < bhi; k += BN) {
        const int st = tile_state(a, b, k, min(k + BN, bhi), skip_ok, qmax);
        if (st == 3) done = 1;
        if (st >= 2) return -1;
        if (st == 0) return k;
      }
      return -1;
    };
    const int first = next_tile(blo);
    if (first < 0) continue;
    // pass 1: the block's max
    float x0 = -INFINITY, x1 = -INFINITY;
    int st = 0;
    fetch(st, first, min(first + BN, bhi), false);
    for (int k0 = first; k0 >= 0; st ^= 1) {
      const int nx = next_tile(k0 + BN);
      if (nx >= 0) {
        fetch(st ^ 1, nx, min(nx + BN, bhi), false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      scores(st, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x0 = fmaxf(x0, fmaxf(s[j][0], s[j][1]));
        x1 = fmaxf(x1, fmaxf(s[j][2], s[j][3]));
      }
      __syncthreads();
      k0 = nx;
    }
    const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
    // pass 2: p, its sum and the block's P.V
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < VC; ++jj) pv[jj][0] = pv[jj][1] = pv[jj][2] = pv[jj][3] = 0.f;
    st = 0;
    fetch(st, first, min(first + BN, bhi), true);
    for (int k0 = first; k0 >= 0; st ^= 1) {
      const int nx = next_tile(k0 + BN);
      if (nx >= 0) {
        fetch(st ^ 1, nx, min(nx + BN, bhi), true);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      scores(st, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = expf(s[j][0] - n0);
        s[j][1] = expf(s[j][1] - n0);
        s[j][2] = expf(s[j][2] - n1);
        s[j][3] = expf(s[j][3] - n1);
        ls0 += s[j][0] + s[j][1];
        ls1 += s[j][2] + s[j][3];
      }
      const bf16* vd = Vs + st * BN * VST;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t a0 = pack_bf16(s[2 * c][0], s[2 * c][1]);
        const uint32_t a1 = pack_bf16(s[2 * c][2], s[2 * c][3]);
        const uint32_t a2 = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
        const uint32_t a3 = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
        for (int jj = 0; jj < VC; jj += 2) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, vd + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VST +
                             (jj + (lane >> 4)) * 8);
          mma16816(pv[jj], a0, a1, a2, a3, bfr[0], bfr[1]);
          mma16816(pv[jj + 1], a0, a1, a2, a3, bfr[2], bfr[3]);
        }
      }
      __syncthreads();
      k0 = nx;
    }
    const float c0 = expf(m0 - n0), c1 = expf(m1 - n1);
    l0 = l0 * c0 + quad_sum(ls0);
    l1 = l1 * c1 + quad_sum(ls1);
#pragma unroll
    for (int jj = 0; jj < VC; ++jj) {
      acc[jj][0] = acc[jj][0] * c0 + round_bf16(pv[jj][0]);
      acc[jj][1] = acc[jj][1] * c0 + round_bf16(pv[jj][1]);
      acc[jj][2] = acc[jj][2] * c1 + round_bf16(pv[jj][2]);
      acc[jj][3] = acc[jj][3] * c1 + round_bf16(pv[jj][3]);
    }
    m0 = n0;
    m1 = n1;
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* og = static_cast<bf16*>(a.o) + b * a.ob + dv0;
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int row = r0 + (e >> 1) * 8;
    if (row >= nrows) continue;
    const int t = t0 + row;
    bf16* orow = og + (t / a.R) * a.os + (g * a.R + t % a.R) * a.oh;
#pragma unroll
    for (int jj = 0; jj < VC; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = jj * 8 + tig * 2 + h;
        if (dv0 + col < a.dv) orow[col] = __float2bfloat16_rn(acc[jj][e + h] / (e ? d1 : d0));
      }
  }
}

inline size_t f32_smem(int dh) {
  return ((size_t)(FM + FN) * (dh + 1) + (size_t)FN * FDV + (size_t)FM * (FN + 1)) * 4 +
         (size_t)(FM + FN) * 4;
}

// fp32 inputs: the same walk with SIMT FMA (no TF32).  Thread (ty, tx) =
// (tid / 8, tid % 8) holds rows 2 ty, 2 ty + 1, slots tx + 8 j (j < 4) of
// a score tile and dv columns tx + 8 c (c < 8) of the slice.
__global__ void __launch_bounds__(NT) chunked_f32(Chunked a) {
  extern __shared__ __align__(16) float fsm[];
  const int DS = a.dh + 1;
  float* Qf = fsm;
  float* Kf = Qf + FM * DS;
  float* Vf = Kf + FN * DS;
  float* Pf = Vf + FN * FDV;
  int* slot = reinterpret_cast<int*>(Pf + FM * (FN + 1));
  int* pos = slot + FN;

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int rows = a.Sq * a.R;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * FM;
  const int nrows = min(FM, rows - t0);
  const int b = blockIdx.y / a.G, g = blockIdx.y % a.G;
  const int dv0 = blockIdx.z * FDV;
  const float* qg = static_cast<const float*>(a.q) + b * a.qb;
  const float* kg = static_cast<const float*>(a.k) + b * a.kb + g * a.kh;
  const float* vg = static_cast<const float*>(a.v) + b * a.vb + g * a.vh + dv0;

  int qmax;
  const int skip_ok = tile_prologue(a, b, t0, nrows, FM, pos, &qmax);
  for (int c = tid; c < FM * a.dh; c += NT) {
    const int i = c / a.dh, d = c % a.dh;
    float x = 0.f;
    if (i < nrows) {
      const int t = t0 + i;
      x = qg[(t / a.R) * a.qs + (g * a.R + t % a.R) * a.qh + d];
    }
    Qf[i * DS + d] = x;
  }
  __syncthreads();

  const int i0 = 2 * ty;
  const int pr[2] = {pos[i0], pos[i0 + 1]};
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[2][8] = {};
  float s[2][4];
  auto scores = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < a.dh; ++d) {
      const float q0 = Qf[i0 * DS + d], q1 = Qf[(i0 + 1) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = Kf[(tx + 8 * j) * DS + d];
        s[0][j] = fmaf(q0, kv, s[0][j]);
        s[1][j] = fmaf(q1, kv, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 8 * j;
        s[i][j] = score_of(s[i][j], slot[col], k0 + col, pr[i], a.causal, a.scale);
      }
  };
  auto stage_k = [&](int k0, int k1) {
    const int kend = min(k1, a.Sk);
    for (int c = tid; c < FN * a.dh; c += NT) {
      const int j = c / a.dh, d = c % a.dh, n = k0 + j;
      Kf[j * DS + d] = n < kend ? kg[n * a.ks + d] : 0.f;
    }
    stage_slots(a, b, k0, k1, FN, slot);
  };
  auto row8 = [](float x, bool is_max) {   // over the 8 lanes of a row pair
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, off);
      x = is_max ? fmaxf(x, y) : x + y;
    }
    return x;
  };

  const int n_blk = (a.Sk + a.chunk - 1) / a.chunk;
  int done = 0;
  for (int blk = 0; blk < n_blk && !done; ++blk) {
    const int blo = blk * a.chunk, bhi = blo + a.chunk;
    float x[2] = {-INFINITY, -INFINITY};
    int walked = 0;
    for (int k0 = blo; k0 < bhi; k0 += FN) {
      const int k1 = min(k0 + FN, bhi);
      const int st = tile_state(a, b, k0, k1, skip_ok, qmax);
      if (st == 3) done = 1;
      if (st >= 2) break;
      if (st == 1) continue;
      stage_k(k0, k1);
      __syncthreads();
      scores(k0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[i] = fmaxf(x[i], s[i][j]);
      __syncthreads();
      ++walked;
    }
    if (!walked) continue;
    const float mn[2] = {fmaxf(m[0], row8(x[0], true)), fmaxf(m[1], row8(x[1], true))};
    float ls[2] = {0.f, 0.f}, pv[2][8] = {};
    for (int k0 = blo; k0 < bhi; k0 += FN) {
      const int k1 = min(k0 + FN, bhi);
      const int st = tile_state(a, b, k0, k1, skip_ok, qmax);
      if (st >= 2) break;
      if (st == 1) continue;
      stage_k(k0, k1);
      const int kend = min(k1, a.Sk);
      for (int c = tid; c < FN * FDV; c += NT) {
        const int j = c / FDV, d = c % FDV, n = k0 + j;
        Vf[c] = (n < kend && dv0 + d < a.dv) ? vg[n * a.vs + d] : 0.f;
      }
      __syncthreads();
      scores(k0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - mn[i]);
          ls[i] += p;
          Pf[(i0 + i) * (FN + 1) + tx + 8 * j] = p;
        }
      __syncthreads();
      for (int j = 0; j < FN; ++j) {
        const float pa = Pf[i0 * (FN + 1) + j], pb = Pf[(i0 + 1) * (FN + 1) + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float vv = Vf[j * FDV + tx + 8 * c];
          pv[0][c] = fmaf(pa, vv, pv[0][c]);
          pv[1][c] = fmaf(pb, vv, pv[1][c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float corr = expf(m[i] - mn[i]);
      l[i] = l[i] * corr + row8(ls[i], false);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = acc[i][c] * corr + pv[i][c];
      m[i] = mn[i];
    }
  }

  float* og = static_cast<float*>(a.o) + b * a.ob + dv0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + i;
    if (row >= nrows) continue;
    const int t = t0 + row;
    float* orow = og + (t / a.R) * a.os + (g * a.R + t % a.R) * a.oh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (dv0 + tx + 8 * c < a.dv) orow[tx + 8 * c] = acc[i][c] / den;
  }
}

// ------------------------------------------------------------- the decode

__device__ float block_reduce(float x, float* red, bool is_max) {
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARP; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// the live range of batch row b: [0, end), all S slots where lengths is 0
__device__ __forceinline__ int live_end(const Decode& a, int b) {
  const int L = a.len[b];
  return L <= 0 ? a.S : min(L, a.S);
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_scores(Decode a) {
  extern __shared__ __align__(16) float qf[];   // (R, 8 ceil(dh / 8))
  __shared__ float red[NWARP];
  const int split = blockIdx.x, bg = blockIdx.y, b = bg / a.G, g = bg % a.G;
  const int L = a.len[b];
  const int end = live_end(a, b);
  const int t0 = split * SPLIT;
  if (t0 >= end) return;
  const int t1 = min(t0 + SPLIT, end);
  const int ch = (a.dh + 7) / 8, dp = ch * 8;
  const T* qb = static_cast<const T*>(a.q) + b * a.qb + (long long)g * a.R * a.qh;
  for (int c = threadIdx.x; c < a.R * dp; c += NT) {
    const int r = c / dp, d = c % dp;
    qf[c] = d < a.dh ? to_f(qb[r * a.qh + d]) : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = a.gl, grp = lane / gl, li = lane % gl, per = 32 / gl;
  const T* kb = static_cast<const T*>(a.k) + b * a.kb + g * a.kh + li * 8;
  float* sc = a.sc + (long long)bg * a.R * a.S;
  for (int base = t0 + warp * per; base < t1; base += NWARP * per) {   // warp-uniform
    const int t = base + grp;
    const bool ok = t < t1 && li < ch && L > 0;
    float kf[8];
    if (ok) {
      load8f(kb + t * a.ks, a.dh - li * 8, a.vec, kf);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = 0.f;
    }
    for (int r = 0; r < a.R; ++r) {
      float d = 0.f;
      if (ok) {
        const float* qr = qf + r * dp + li * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(kf[e], qr[e], d);
      }
      for (int off = gl >> 1; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (li == 0 && t < t1) sc[(long long)r * a.S + t] = L > 0 ? round_to<T>(d) * a.scale : NEG;
    }
  }
  __syncthreads();
  for (int r = 0; r < a.R; ++r) {
    const float* sr = sc + (long long)r * a.S;
    float mx = -INFINITY;
    for (int t = t0 + threadIdx.x; t < t1; t += NT) mx = fmaxf(mx, sr[t]);
    mx = block_reduce(mx, red, true);
    float z = 0.f;
    for (int t = t0 + threadIdx.x; t < t1; t += NT) z += expf(sr[t] - mx);
    z = block_reduce(z, red, false);
    if (threadIdx.x == 0) {
      const long long at = ((long long)bg * a.R + r) * a.ns + split;
      a.ms[at] = mx;
      a.zs[at] = z;
    }
  }
}

inline size_t decode_pv_smem(int R) { return ((size_t)2 * R + (size_t)NT * 8) * 4; }

// Thread (group, pair): pair = (head r, 8 columns of dv), its group's
// share of the split's slots (every groups-th one), V read straight from
// the cache; the groups' partial sums then added in group order.
template <typename T>
__global__ void __launch_bounds__(NT) decode_pv(Decode a) {
  extern __shared__ __align__(16) float dsm[];
  float* Mz = dsm;                 // (R, 2): M and Z a head
  float* red = Mz + 2 * a.R;       // (NT, 8): each thread's partial sums
  const int split = blockIdx.x, bg = blockIdx.y, b = bg / a.G, g = bg % a.G;
  const int end = live_end(a, b);
  const int t0 = split * SPLIT;
  if (t0 >= end) return;
  const int t1 = min(t0 + SPLIT, end);
  const int nl = (end + SPLIT - 1) / SPLIT;
  for (int r = threadIdx.x; r < a.R; r += NT) {
    const long long at = ((long long)bg * a.R + r) * a.ns;
    float M = -INFINITY, Z = 0.f;
    for (int i = 0; i < nl; ++i) M = fmaxf(M, a.ms[at + i]);
    for (int i = 0; i < nl; ++i) Z += a.zs[at + i] * expf(a.ms[at + i] - M);
    Mz[2 * r] = M;
    Mz[2 * r + 1] = Z;
  }
  __syncthreads();
  const float* sc = a.sc + (long long)bg * a.R * a.S;
  const T* vb = static_cast<const T*>(a.v) + b * a.vb + g * a.vh;
  const int oc = (a.dv + 7) / 8, npair = a.R * oc;
  for (int p0 = 0; p0 < npair; p0 += NT) {
    const int np = min(NT, npair - p0), groups = NT / np;
    const int grp = threadIdx.x / np, pi = threadIdx.x % np;
    const int r = (p0 + pi) / oc, d = ((p0 + pi) % oc) * 8;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    if (grp < groups) {
      const float M = Mz[2 * r], Z = Mz[2 * r + 1];
      const float* sr = sc + (long long)r * a.S;
      for (int t = t0 + grp; t < t1; t += groups) {
        const float p = round_to<T>(expf(sr[t] - M) / Z);
        float vf[8];
        load8f(vb + t * a.vs + d, a.dv - d, a.vec, vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) red[threadIdx.x * 8 + e] = acc[e];
    __syncthreads();
    if (threadIdx.x < np) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
      for (int gi = 0; gi < groups; ++gi)
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] += red[(gi * np + threadIdx.x) * 8 + e];
      float* out = a.part + (((long long)bg * a.R + r) * a.ns + split) * a.dv + d;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (d + e < a.dv) out[e] = x[e];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_combine(Decode a) {
  const int bg = blockIdx.x, b = bg / a.G, g = bg % a.G;
  const int nl = (live_end(a, b) + SPLIT - 1) / SPLIT;
  T* ob = static_cast<T*>(a.o) + b * a.ob + (long long)g * a.R * a.oh;
  for (int oi = blockIdx.y * NT + threadIdx.x; oi < a.R * a.dv; oi += gridDim.y * NT) {
    const int r = oi / a.dv, d = oi % a.dv;
    const float* p = a.part + ((long long)bg * a.R + r) * a.ns * a.dv + d;
    float x = 0.f;
#pragma unroll 8
    for (int i = 0; i < nl; ++i) x += p[(long long)i * a.dv];
    store(ob + r * a.oh + d, x);
  }
}

// ------------------------------------------------------------- launchers

template <typename F>
cudaError_t opt_in(F* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  // always the same ceiling, so no call lowers what another launch needs
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

template <typename F>
int info_of(F* kernel, size_t smem, int* out) {
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)(attr.sharedSizeBytes + smem);
  return 0;
}

typedef void (*ChunkedKernel)(Chunked);

// the bf16 instantiation for dh: dh padded to 64, 128, 192 or 256; dv in
// slices of 128
ChunkedKernel bf16_kernel(int dh, size_t* smem) {
#define ATTN_CASE(DHP)                \
  if (dh <= DHP) {                    \
    *smem = BfTile<DHP>::smem;        \
    return chunked_bf16<DHP>;         \
  }
  ATTN_CASE(64)
  ATTN_CASE(128)
  ATTN_CASE(192)
  ATTN_CASE(256)
#undef ATTN_CASE
  return nullptr;
}

ChunkedKernel chunked_kernel(int dtype, int dh, size_t* smem, int* dvt) {
  if (dtype == 0) {
    *dvt = TDV;
    return bf16_kernel(dh, smem);
  }
  *smem = f32_smem(dh);
  *dvt = FDV;
  return chunked_f32;
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  q (B, Sq, Hq, dh), k (B,
// Sk, Hkv, dh), v (B, Sk, Hkv, dv), o (B, Sq, Hq, dv), all of one type
// (dtype 0 bf16, 1 fp32), their last dim contiguous, the other strides in
// elements; Hq = G R with G = Hkv; qpos (Sq,) int32 or null; mask (B, Sk)
// uint8 or null; 1 <= dh, dv <= 256; vec: 16-byte loads allowed (dh and
// dv multiples of 8, the strides too, the pointers 16-byte aligned).
int attention_chunked_launch(const void* q, const void* k, const void* v, void* o,
                             const int* qpos, const uint8_t* mask, long long qb, long long qs,
                             long long qh, long long kb, long long ks, long long kh, long long vb,
                             long long vs, long long vh, long long ob, long long os, long long oh,
                             int B, int Sq, int Sk, int G, int R, int dh, int dv, int chunk,
                             int causal, float scale, int vec, int dtype, cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || G < 1 || R < 1 || dh < 1 || dh > 256 || dv < 1 || dv > 256 ||
      chunk < 1 || (long long)Sk + chunk >= (1ll << 31) || (long long)Sq * R >= (1ll << 31) ||
      (long long)B * G > 65535 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  int dvt = 0;
  ChunkedKernel kern = chunked_kernel(dtype, dh, &smem, &dvt);
  if (!kern) return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int tm = dtype == 0 ? BM : FM;
  const Chunked a{q,  k,  v,  o,  qpos, mask, qb,    qs,     qh,  kb,  ks,  kh,  vb,    vs, vh,
                  ob, os, oh, B,  Sq,   Sk,   G,     R,      dh,  dv,  chunk, causal, vec, scale};
  const dim3 grid((unsigned)((Sq * (long long)R + tm - 1) / tm), (unsigned)(B * G),
                  (unsigned)((dv + dvt - 1) / dvt));
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t as int (0 = launched).  q (B, 1, Hq, dh), the
// caches (B, S, Hkv, dh|dv), o (B, 1, Hq, dv), one type (dtype 0 bf16, 1
// fp32), last dims contiguous; lengths (B,) int32; the scratch sc (B G R
// S), ms and zs (B G R ns), part (B G R ns dv) fp32 with ns = ceil(S /
// 512); gl: lanes a slot (a power of two >= ceil(dh / 8), at most 32).
int attention_decode_launch(const void* q, const void* k, const void* v, void* o,
                            const int* lengths, float* sc, float* ms, float* zs, float* part,
                            long long qb, long long qh, long long kb, long long ks, long long kh,
                            long long vb, long long vs, long long vh, long long ob, long long oh,
                            int B, int S, int G, int R, int dh, int dv, int gl, float scale,
                            int vec, int dtype, cudaStream_t stream) {
  const int ns = (S + SPLIT - 1) / SPLIT;
  if (B < 1 || S < 1 || G < 1 || R < 1 || dh < 1 || dh > 256 || dv < 1 || dv > 256 ||
      gl < 1 || gl > 32 || (gl & (gl - 1)) || gl * 8 < dh || (long long)B * G > 65535 ||
      dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Decode a{q,  k,  v,  o,  lengths, sc, ms, zs, part, qb, qh, kb, ks, kh, vb,
                 vs, vh, ob, oh, B,       S,  G,  R,  dh,   dv, ns, gl, vec, scale};
  const size_t s1 = (size_t)R * ((dh + 7) / 8) * 8 * 4, s2 = decode_pv_smem(R);
  const dim3 grid(ns, B * G);
  cudaError_t err;
#define DECODE_RUN(T)                                                  \
  err = opt_in(decode_scores<T>, s1);                                  \
  if (err != cudaSuccess) return (int)err;                             \
  err = opt_in(decode_pv<T>, s2);                                      \
  if (err != cudaSuccess) return (int)err;                             \
  decode_scores<T><<<grid, NT, s1, stream>>>(a);                       \
  err = cudaGetLastError();                                            \
  if (err != cudaSuccess) return (int)err;                             \
  decode_pv<T><<<grid, NT, s2, stream>>>(a);                           \
  err = cudaGetLastError();                                            \
  if (err != cudaSuccess) return (int)err;                             \
  decode_combine<T><<<dim3(B * G, (R * dv + NT - 1) / NT), NT, 0, stream>>>(a);
  if (dtype == 0) {
    DECODE_RUN(bf16)
  } else {
    DECODE_RUN(float)
  }
#undef DECODE_RUN
  return (int)cudaGetLastError();
}

// The kernel a launch would run, as it runs it: kind 0 the chunked kernel
// for (dtype, dh, dv), 1 the decode's scores, 2 its P.V, 3 its combine (R
// query heads a KV head).  out[0] registers a thread, out[1] local
// (spilled) bytes a thread, out[2] resident blocks an SM, out[3] shared
// memory a block.  Returns a cudaError_t as int.
int attention_info(int kind, int dtype, int dh, int dv, int R, int* out) {
  if (dh < 1 || dh > 256 || dv < 1 || dv > 256 || R < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (kind == 0) {
    size_t smem = 0;
    int dvt = 0;
    ChunkedKernel kern = chunked_kernel(dtype, dh, &smem, &dvt);
    return kern ? info_of(kern, smem, out) : (int)cudaErrorInvalidValue;
  }
  const size_t s1 = (size_t)R * ((dh + 7) / 8) * 8 * 4, s2 = decode_pv_smem(R);
  switch (kind * 2 + dtype) {
    case 2: return info_of(decode_scores<bf16>, s1, out);
    case 3: return info_of(decode_scores<float>, s1, out);
    case 4: return info_of(decode_pv<bf16>, s2, out);
    case 5: return info_of(decode_pv<float>, s2, out);
    case 6: return info_of(decode_combine<bf16>, 0, out);
    case 7: return info_of(decode_combine<float>, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The runtime's name of a cudaError_t the calls above return.
const char* attention_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
