// Backward of the neighbour correlation select for Hopper (sm_90a).
//
// Replaces the backward that sits under the TPU kernel's `custom_vjp`,
// `mvtracker_tpu/ops/corr_pallas.py::_corr_select_bwd`. With
// corr[b, n, k] = <targets[b, n, :], fvec[b, idx[b, n, k], :]> and the
// incoming gradient g[b, n, k] (fp32):
//
//     d_targets[b, n, :] = sum_k g[b, n, k] * fvec[b, idx[b, n, k], :]
//     d_fvec[b, p, :]    = sum over (n, k) with idx[b, n, k] == p of
//                          g[b, n, k] * targets[b, n, :]
//
// An index outside [0, P) adds nothing to either. fvec and targets are the
// uncast tensors the forward was given: the cloud fp32 or bf16, the targets
// fp32 (the tracker carries its track features in fp32 in both models). All
// products and sums are fp32, and d_targets is written in fp32.
// d_fvec is accumulated into an fp32 [B, P, C] buffer that the wrapper hands
// over zeroed and afterwards casts to fvec's type.
//
// What bounds it on the card: memory. Per (b, n, k) it reads one row of C
// features and adds one row of C floats: 2 multiply-adds per element moved.
// The least it must move is the distinct gathered rows, g, idx, targets, and
// the dense d_fvec and d_targets.
//
// Design: the forward's layout turned around, and no [B, N*K, C] update
// tensor in device memory (the JAX backward materialises one, and a gathered
// [B, N, K, C] copy besides). One warp owns one (b, n). The warp is split
// into 32/L groups of L lanes; a lane owns one 16-byte chunk of the fvec row
// (8 bf16 or 4 fp32 features), its slice of the target row held in registers.
// Each group walks the neighbours k = group, group + 32/L, ...: it reads the
// neighbour's row chunk with one 16-byte load, adds g * chunk to its fp32
// d_targets registers, and adds g * target slice into the neighbour's d_fvec
// row with 16-byte vector atomics (`atomicAdd(float4*)`, sm_90). The groups'
// d_targets registers are then summed with shuffles and written once,
// coalesced.
//
// The atomics make the order of d_fvec's fp32 sums vary from run to run, so
// d_fvec is reproducible to fp32 rounding only, not bit for bit. d_targets
// is summed in a fixed order and is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // (b, n) rows per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

// N consecutive elements (N = 4 or 8) -> fp32 registers, widest aligned loads.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    out[4 * q + 0] = x.x;
    out[4 * q + 1] = x.y;
    out[4 * q + 2] = x.z;
    out[4 * q + 3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  alignas(16) __nv_bfloat162 pairs[N / 2];
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(pairs) = *reinterpret_cast<const uint4*>(p);
  } else {
    *reinterpret_cast<uint2*>(pairs) = *reinterpret_cast<const uint2*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 u = __bfloat1622float2(pairs[i]);
    out[2 * i + 0] = u.x;
    out[2 * i + 1] = u.y;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "corr_bwd.cu needs CUDA 12.1 or later for atomicAdd(float4*)"
#endif

template <typename TF, int L>
__global__ void __launch_bounds__(kWarps * 32)
corr_bwd_kernel(const TF* __restrict__ fvec, const float* __restrict__ targets,
                const int64_t* __restrict__ idx, const float* __restrict__ g,
                float* __restrict__ d_targets, float* __restrict__ d_fvec,
                int rows, int n, int p, int k, int c) {
  constexpr int kVec = 16 / sizeof(TF);  // features per lane and pass
  constexpr int kGroups = 32 / L;        // neighbours handled at once

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * n + i
  if (row >= rows) return;  // uniform across the warp
  const int b = row / n;
  const int sub = lane % L;
  const int grp = lane / L;
  const int nvec = c / kVec;

  const float* trow = targets + (size_t)row * c;
  float* drow = d_targets + (size_t)row * c;
  const TF* cloud = fvec + (size_t)b * p * c;
  float* dcloud = d_fvec + (size_t)b * p * c;
  const int64_t* irow = idx + (size_t)row * k;
  const float* grow = g + (size_t)row * k;

  for (int v0 = 0; v0 < nvec; v0 += L) {  // same trip count for every lane
    const int v = v0 + sub;
    const bool own = v < nvec;
    float t[kVec];
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    if (own) {
      load_vec<kVec>(trow + v * kVec, t);
      for (int kk = grp; kk < k; kk += kGroups) {
        const int64_t j = irow[kk];
        if (j < 0 || j >= p) continue;
        const float gk = grow[kk];
        float f[kVec];
        load_vec<kVec>(cloud + (size_t)j * c + v * kVec, f);
        float* dst = dcloud + (size_t)j * c + v * kVec;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] += gk * f[i];
#pragma unroll
        for (int q = 0; q < kVec / 4; ++q) {
          atomicAdd(reinterpret_cast<float4*>(dst) + q,
                    make_float4(gk * t[4 * q], gk * t[4 * q + 1], gk * t[4 * q + 2], gk * t[4 * q + 3]));
        }
      }
    }
    // Sum the groups' partial d_targets; every lane takes part.
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
    }
    if (own && grp == 0) store_vec<kVec>(drow + v * kVec, acc);
  }
}

template <typename TF, int L>
cudaError_t launch(const void* fvec, const float* targets, const int64_t* idx, const float* g,
                   float* d_targets, float* d_fvec, int b, int n, int p, int k, int c,
                   cudaStream_t stream) {
  const int rows = b * n;
  const int blocks = (rows + kWarps - 1) / kWarps;
  corr_bwd_kernel<TF, L><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const TF*>(fvec), targets, idx, g, d_targets, d_fvec, rows, n, p, k, c);
  return cudaGetLastError();
}

template <typename TF>
cudaError_t dispatch(const void* fvec, const float* targets, const int64_t* idx, const float* g,
                     float* d_targets, float* d_fvec, int b, int n, int p, int k, int c,
                     cudaStream_t s) {
  const int nvec = c / (16 / static_cast<int>(sizeof(TF)));
  if (nvec <= 1) return launch<TF, 1>(fvec, targets, idx, g, d_targets, d_fvec, b, n, p, k, c, s);
  if (nvec <= 2) return launch<TF, 2>(fvec, targets, idx, g, d_targets, d_fvec, b, n, p, k, c, s);
  if (nvec <= 4) return launch<TF, 4>(fvec, targets, idx, g, d_targets, d_fvec, b, n, p, k, c, s);
  if (nvec <= 8) return launch<TF, 8>(fvec, targets, idx, g, d_targets, d_fvec, b, n, p, k, c, s);
  if (nvec <= 16) return launch<TF, 16>(fvec, targets, idx, g, d_targets, d_fvec, b, n, p, k, c, s);
  return launch<TF, 32>(fvec, targets, idx, g, d_targets, d_fvec, b, n, p, k, c, s);
}

}  // namespace

// fvec_dtype: 0 = float32, 1 = bfloat16. c must be a multiple of 16 bytes'
// worth of fvec elements, fvec and targets 16-byte aligned (checked by the
// Python wrapper). d_fvec must arrive zeroed.
extern "C" int corr_backward(const void* fvec, const float* targets, const int64_t* idx,
                             const float* g, float* d_targets, float* d_fvec, int b, int n,
                             int p, int k, int c, int fvec_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fvec_dtype == 0)
    return dispatch<float>(fvec, targets, idx, g, d_targets, d_fvec, b, n, p, k, c, s);
  if (fvec_dtype == 1)
    return dispatch<__nv_bfloat16>(fvec, targets, idx, g, d_targets, d_fvec, b, n, p, k, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
