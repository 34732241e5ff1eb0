// Device code shared by the three k-nearest-neighbour kernels for Hopper
// (`knn.cu`, `knn_tiled.cu`, `knn_exact.cu`): one warp owns one query, the
// block streams reference points through shared memory in tiles, and the
// warp keeps ONE running top-k for its query, spread over its lanes: lane
// j < k holds the j-th best (d^2, index) so far, ascending.
//
// A step of the scan gives every lane one point. The lanes whose point beats
// the warp's current k-th best are found with one ballot; almost always
// there is none and the step costs the distance arithmetic and the ballot.
// Each candidate that is left is broadcast and inserted by the whole warp:
// every lane compares it with its own entry, the entries behind the
// insertion point move one lane up (`shfl_up`), the first of them takes the
// candidate. All control flow is uniform across the warp. A query sees about
// k (1 + ln(N / k)) insertions in all. For k = 1 there is nothing to keep
// sorted: every lane keeps the minimum of its own slice, with no warp
// traffic per step, and the 32 minima are offered to the list at the end.
// That scan is its own instantiation (`kOne`), picked at launch: as a branch
// inside the general one it cost the k = 16 scan a sixth of its speed.
//
// (A top-k per lane in registers, merged at the end, was the first design:
// every lane's list fills from empty, so for the first few hundred points
// of a lane's slice nearly every step is an insertion, and one inserting
// lane stalls the other 31. It took 76 registers per thread at k = 16 and
// was paced by those insertions, not by the distances.)
//
// d^2 is the direct sum of squared differences in fp32 with no FMA
// contraction, (dx*dx + dy*dy) + dz*dz, exact up to one rounding per
// operation; the plain PyTorch versions compute the same expression.
//
// `kLex` picks the order of the candidates. false: by d^2 alone; among equal
// distances the one offered first stays in front. true: by (d^2, index), a
// total order, so equal distances come out lowest index first whatever the
// order of the offers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr int kWarps = 8;      // queries per block, one warp each
constexpr int kTile = 2048;    // reference points per shared-memory tile
constexpr int kMaxK = 32;      // one list entry per lane
constexpr float kBig = 1e30f;  // d^2 of the fill for ranks past the cloud
constexpr unsigned kFull = 0xffffffffu;

// Does candidate (d, i) come before list entry (bd, bi)?
template <bool kLex>
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  if constexpr (kLex) {
    return d < bd || (d == bd && i < bi);
  } else {
    return d < bd;
  }
}

// The warp's running top-k. `d`, `i`: this lane's entry (lanes >= k keep the
// fill and never change). `tau_d`, `tau_i`: the k-th best, the same in every
// lane.
struct TopK {
  float d = kBig;
  int i = 0;
  float tau_d = kBig;
  int tau_i = 0;
};

// Offer one candidate per lane ((kBig, 0) for none); every lane of the warp
// must take part. Candidates are taken in lane order.
template <bool kLex>
__device__ __forceinline__ void offer(TopK& top, float d, int i, int k) {
  const int lane = threadIdx.x & 31;
  unsigned mask = __ballot_sync(kFull, before<kLex>(d, i, top.tau_d, top.tau_i));
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cd = __shfl_sync(kFull, d, src);
    const int ci = __shfl_sync(kFull, i, src);
    if (!before<kLex>(cd, ci, top.tau_d, top.tau_i)) continue;  // the k-th best moved on
    const bool stays = lane >= k || !before<kLex>(cd, ci, top.d, top.i);
    const float up_d = __shfl_up_sync(kFull, top.d, 1);
    const int up_i = __shfl_up_sync(kFull, top.i, 1);
    const bool up_stays = __shfl_up_sync(kFull, static_cast<int>(stays), 1) != 0;
    if (!stays) {
      const bool first = lane == 0 || up_stays;  // the insertion point
      top.d = first ? cd : up_d;
      top.i = first ? ci : up_i;
    }
    top.tau_d = __shfl_sync(kFull, top.d, k - 1);
    if constexpr (kLex) top.tau_i = __shfl_sync(kFull, top.i, k - 1);
  }
}

// Scan reference points [begin, end) of one batch's cloud `r` ([N, 3]) for
// the warp's query, in index order. Every thread of the block must call this
// with the same range: the tiles are loaded by the whole block into sx, sy,
// sz (kTile floats each, structure of arrays, so lane p reads point p
// without bank conflicts). `active` is uniform across a warp. `kOne` is the
// scan for k == 1.
template <bool kLex, bool kOne>
__device__ __forceinline__ void scan_range(const float* __restrict__ r, int begin, int end,
                                           float qx, float qy, float qz, bool active,
                                           float* sx, float* sy, float* sz, TopK& top, int k) {
  const int lane = threadIdx.x & 31;
  float lane_d = kBig;  // kOne: the best of this lane's own slice
  int lane_i = 0;
  for (int base = begin; base < end; base += kTile) {
    const int cnt = min(kTile, end - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < cnt * 3; t += blockDim.x) {
      const float v = r[(size_t)base * 3 + t];
      const int p = t / 3;
      const int c = t - p * 3;
      float* dst = c == 0 ? sx : (c == 1 ? sy : sz);
      dst[p] = v;
    }
    __syncthreads();
    if constexpr (kOne) {
      for (int p = lane; active && p < cnt; p += 32) {
        const float dx = __fsub_rn(sx[p], qx);
        const float dy = __fsub_rn(sy[p], qy);
        const float dz = __fsub_rn(sz[p], qz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (d < lane_d) {  // a lane meets its points in index order
          lane_d = d;
          lane_i = base + p;
        }
      }
    } else if (active) {
      for (int p0 = 0; p0 < cnt; p0 += 32) {
        const int p = p0 + lane;
        float d = kBig;
        if (p < cnt) {
          const float dx = __fsub_rn(sx[p], qx);
          const float dy = __fsub_rn(sy[p], qy);
          const float dz = __fsub_rn(sz[p], qz);
          d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        }
        offer<kLex>(top, d, p < cnt ? base + p : 0, k);
      }
    }
  }
  if (kOne && active) offer<kLex>(top, lane_d, lane_i, k);
}

// Lane j < k writes rank j as (sqrt(max(d^2, 1e-12)), index). A rank past the
// cloud still holds the fill: distance 1e15, index 0.
__device__ __forceinline__ void write_result(const TopK& top, float* __restrict__ dq,
                                             int64_t* __restrict__ iq, int k) {
  const int lane = threadIdx.x & 31;
  if (lane < k) {
    dq[lane] = sqrtf(fmaxf(top.d, 1e-12f));
    iq[lane] = top.i;
  }
}

}  // namespace knn
