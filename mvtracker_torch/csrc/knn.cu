// Batched k-nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the TPU kernel `mvtracker_tpu/ops/knn.py::knn_pallas_fused`
// (`_knn_kernel_fused`): for every query of every batch, the k nearest
// reference points, ascending, as (sqrt(max(d^2, 1e-12)), index).
//
// What bounds it on the card: the reference cloud of one batch is small
// (16384 points x 12 B at the tracker's finest level) and is read from L2
// many times, so DRAM bytes are negligible; the work is B*M*N distance
// evaluations plus the top-k compares, i.e. fp32 ALU instruction throughput.
//
// Design: one warp per query, eight queries per block. The block streams
// the batch's reference points through shared memory in tiles of TILE
// points (structure of arrays, so lane p reads point p without bank
// conflicts). Every lane scans a stride-32 slice of the tile and keeps its
// own sorted top-K in registers (K a template parameter, fully unrolled
// insertion, no local-memory arrays); a candidate costs one compare unless
// it beats the lane's current K-th. At the end the 32 lane lists are merged
// by a shuffle tree (5 rounds), leaving the warp's answer in lane 0.
//
// The TPU kernel computed d^2 as |q|^2 - 2 q.r + |r|^2 on the matrix unit,
// after centring, and packed the column into the low mantissa bits. Hopper
// needs neither: d^2 is the direct sum of squared differences in fp32 with
// no FMA contraction, which is exact up to one rounding per term. Ties keep
// the earlier-scanned point first; tie order is not part of the contract.
// Ranks >= N keep the fill value d^2 = 1e30 (distance 1e15) and index 0,
// the same fill as the JAX package's `knn_reference`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;      // queries per block, one warp each
constexpr int kTile = 2048;    // reference points per shared-memory tile
constexpr float kBig = 1e30f;  // fill for ranks past the cloud
constexpr unsigned kFull = 0xffffffffu;

// Insert (d, i) into the ascending list; caller guarantees d < bd[K-1].
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int i) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool shift = d < bd[j - 1];
    const bool place = !shift && d < bd[j];
    bd[j] = shift ? bd[j - 1] : (place ? d : bd[j]);
    bi[j] = shift ? bi[j - 1] : (place ? i : bi[j]);
  }
  if (d < bd[0]) {
    bd[0] = d;
    bi[0] = i;
  }
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
knn_kernel(const float* __restrict__ ref, const float* __restrict__ query,
           float* __restrict__ dist, int64_t* __restrict__ idx, int n, int m, int k) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;
  const bool active = q < m;

  const float* r = ref + (size_t)b * n * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = query + ((size_t)b * m + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = kBig;
    bi[j] = 0;
  }

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < cnt * 3; t += blockDim.x) {
      const float v = r[(size_t)base * 3 + t];
      const int p = t / 3;
      const int c = t - p * 3;
      float* dst = c == 0 ? sx : (c == 1 ? sy : sz);
      dst[p] = v;
    }
    __syncthreads();
    if (active) {
      for (int p = lane; p < cnt; p += 32) {
        const float dx = __fsub_rn(sx[p], qx);
        const float dy = __fsub_rn(sy[p], qy);
        const float dz = __fsub_rn(sz[p], qz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        if (d < bd[K - 1]) insert<K>(bd, bi, d, base + p);
      }
    }
  }

  // Shuffle-tree merge: after the round with offset o, lane l < o holds
  // the merged lists of lanes l, l + o, l + 2o, ...
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float od[K];
    int oi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      od[j] = __shfl_down_sync(kFull, bd[j], off);
      oi[j] = __shfl_down_sync(kFull, bi[j], off);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (od[j] < bd[K - 1]) insert<K>(bd, bi, od[j], oi[j]);
    }
  }

  if (active && lane == 0) {
    float* dq = dist + ((size_t)b * m + q) * k;
    int64_t* iq = idx + ((size_t)b * m + q) * k;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        dq[j] = sqrtf(fmaxf(bd[j], 1e-12f));
        iq[j] = bi[j];
      }
    }
  }
}

template <int K>
cudaError_t launch(const float* ref, const float* query, float* dist, int64_t* idx,
                   int b, int n, int m, int k, cudaStream_t stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  knn_kernel<K><<<grid, kWarps * 32, 0, stream>>>(ref, query, dist, idx, n, m, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_forward(const float* ref, const float* query, float* dist, int64_t* idx,
                           int b, int n, int m, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) return launch<1>(ref, query, dist, idx, b, n, m, k, s);
  if (k <= 2) return launch<2>(ref, query, dist, idx, b, n, m, k, s);
  if (k <= 4) return launch<4>(ref, query, dist, idx, b, n, m, k, s);
  if (k <= 8) return launch<8>(ref, query, dist, idx, b, n, m, k, s);
  if (k <= 16) return launch<16>(ref, query, dist, idx, b, n, m, k, s);
  if (k <= 32) return launch<32>(ref, query, dist, idx, b, n, m, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
