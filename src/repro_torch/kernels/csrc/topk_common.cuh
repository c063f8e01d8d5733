// Device-side running top-k shared by the search kernels.
//
// The counterpart of repro/kernels/common.py::merge_topk.  The Pallas
// kernels merge each score tile into the running best with K masked mins
// over [best | tile]; here every thread (or every warp, all lanes in step)
// keeps its own sorted list in registers and pushes candidates into it one
// at a time.  Both follow one order: ascending on the (distance, id) pair,
// so equal distances break toward the smaller id whatever the tiling.
//
// A list holds KT >= k entries, KT a compile-time constant so the arrays
// stay in registers (every loop below is fully unrolled).  The top-KT of a
// subset of the candidates contains that subset's share of the global
// top-k, so merging per-thread lists gives the exact result.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rt {

// Compile-time ceiling on k: the wrappers refuse a larger k.
constexpr int KMAX = 32;

// Id of an empty slot.  It sorts after every real id, and the writers turn
// it (and any slot whose distance is +inf) into the -1 of the (inf, -1)
// sentinel.
constexpr int ID_NONE = 0x7fffffff;

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int KT>
struct TopK {
  float d[KT];
  int i[KT];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      d[j] = CUDART_INF_F;
      i[j] = ID_NONE;
    }
  }

  // Insert (dd, ii) if it ranks among the KT best held; the list stays
  // sorted ascending on (distance, id).  NaN never ranks.
  __device__ __forceinline__ void push(float dd, int ii) {
    if (!lex_less(dd, ii, d[KT - 1], i[KT - 1])) return;
    bool placed = false;
#pragma unroll
    for (int j = KT - 1; j > 0; --j) {
      if (!placed) {
        if (lex_less(dd, ii, d[j - 1], i[j - 1])) {
          d[j] = d[j - 1];
          i[j] = i[j - 1];
        } else {
          d[j] = dd;
          i[j] = ii;
          placed = true;
        }
      }
    }
    if (!placed) {
      d[0] = dd;
      i[0] = ii;
    }
  }

  // As push, but a pair equal in distance and id to one already held is
  // dropped: a candidate duplicated with an identical distance is emitted
  // once, as the Pallas merge retires every copy of the pair it selects.
  __device__ __forceinline__ void push_unique(float dd, int ii) {
    bool dup = false;
#pragma unroll
    for (int j = 0; j < KT; ++j) dup |= (d[j] == dd) & (i[j] == ii);
    if (!dup) push(dd, ii);
  }

  // Write the first k entries as (distance, id), the sentinel as (inf, -1).
  __device__ __forceinline__ void store(float* out_d, int* out_i, int k) const {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < k) {
        const bool filled = d[j] < CUDART_INF_F;
        out_d[j] = filled ? d[j] : CUDART_INF_F;
        out_i[j] = filled ? i[j] : -1;
      }
    }
  }
};

// Merge the lists of `n` groups (threads or warps) into group 0's list.
// Group g's list lives in `top` of the threads with `leader` set for g;
// sd/si hold n/2 lists of KT entries.  n is a power of two.  Every thread
// of the block calls this (it synchronises); afterwards group 0 holds the
// merged list.
template <int KT, bool UNIQUE>
__device__ __forceinline__ void block_merge(TopK<KT>& top, int group, bool leader, int n,
                                            float* sd, int* si) {
  for (int stride = n / 2; stride > 0; stride >>= 1) {
    if (leader && group >= stride && group < 2 * stride) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        sd[(group - stride) * KT + j] = top.d[j];
        si[(group - stride) * KT + j] = top.i[j];
      }
    }
    __syncthreads();
    if (group < stride) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float dd = sd[group * KT + j];
        const int ii = si[group * KT + j];
        if (dd < CUDART_INF_F) {
          if (UNIQUE)
            top.push_unique(dd, ii);
          else
            top.push(dd, ii);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace rt
