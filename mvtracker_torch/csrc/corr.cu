// Neighbour correlation select for Hopper (sm_90a).
//
// Replaces the forward of the TPU kernel
// `mvtracker_tpu/ops/corr_pallas.py::corr_select_pallas` (`_corr_kernel`):
//
//     corr[b, n, k] = <targets[b, n, :], fvec[b, idx[b, n, k], :]>
//
// unscaled, accumulated in fp32, 0 for an index outside [0, P) (the JAX
// kernel's -1 padding). Inputs are fp32 or bf16, both of the same type;
// the output is fp32.
//
// The kernel sits inside the autograd function `CorrSelect`
// (`ops/corr.py`): that function is handed the uncast tensors, casts both to
// the compute type and calls this kernel, so the cast happens inside the
// differentiated function as in the JAX package's `custom_vjp`. Its backward
// is `csrc/corr_bwd.cu`.
//
// What bounds it on the card: memory. Each output needs one row of C
// features gathered from a cloud of P rows and C multiply-adds, so the
// work is a few hundred operations per 256-byte row (bf16, C = 128): far
// below the ~20 fp32 operations per byte at which the card's ALUs would
// bind. The least it must move is the distinct rows the indices name.
//
// Design: a gather, not the TPU's trick. The TPU kernel computed the full
// [N, P] correlation tile on its matrix unit and selected k entries with
// masks, because TPU gathers are slow; on Hopper that would spend B*N*P*C
// multiply-adds to produce B*N*K outputs. Here one warp owns one (b, n).
// The warp is split into 32/L groups of L lanes; each group takes one
// neighbour at a time, its lanes read the neighbour's row with 16-byte
// vector loads (L lanes cover one row of C = 128 bf16 in a single pass),
// multiply with the matching slice of the target row, and reduce with
// shuffles inside the group. Neighbouring rows of one query are often
// close in memory (neighbours of nearby points), so L2 absorbs repeats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // (b, n) rows per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xa[i]);
    const float2 v = __bfloat1622float2(ya[i]);
    acc += u.x * v.x + u.y * v.y;
  }
  return acc;
}

template <typename T, int L>
__global__ void __launch_bounds__(kWarps * 32)
corr_kernel(const T* __restrict__ fvec, const T* __restrict__ targets,
            const int64_t* __restrict__ idx, float* __restrict__ out,
            int rows, int n, int p, int k, int c) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kGroups = 32 / L;       // neighbours handled at once

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * n + i
  if (row >= rows) return;  // uniform across the warp
  const int b = row / n;
  const int sub = lane % L;
  const int grp = lane / L;
  const int nvec = c / kVec;

  const T* trow = targets + (size_t)row * c;
  const T* cloud = fvec + (size_t)b * p * c;
  const int64_t* irow = idx + (size_t)row * k;
  float* orow = out + (size_t)row * k;

  for (int k0 = 0; k0 < k; k0 += kGroups) {
    const int kk = k0 + grp;
    float acc = 0.f;
    if (kk < k) {
      const int64_t j = irow[kk];
      if (j >= 0 && j < p) {
        const T* frow = cloud + (size_t)j * c;
        for (int v = sub; v < nvec; v += L) acc += dot16(frow + v * kVec, trow + v * kVec);
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off, L);
    if (sub == 0 && kk < k) orow[kk] = acc;
  }
}

template <typename T, int L>
cudaError_t launch(const void* fvec, const void* targets, const int64_t* idx, float* out,
                   int b, int n, int p, int k, int c, cudaStream_t stream) {
  const int rows = b * n;
  const int blocks = (rows + kWarps - 1) / kWarps;
  corr_kernel<T, L><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(fvec), static_cast<const T*>(targets), idx, out, rows, n, p, k, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* fvec, const void* targets, const int64_t* idx, float* out,
                     int b, int n, int p, int k, int c, cudaStream_t s) {
  const int nvec = c / (16 / static_cast<int>(sizeof(T)));
  if (nvec <= 1) return launch<T, 1>(fvec, targets, idx, out, b, n, p, k, c, s);
  if (nvec <= 2) return launch<T, 2>(fvec, targets, idx, out, b, n, p, k, c, s);
  if (nvec <= 4) return launch<T, 4>(fvec, targets, idx, out, b, n, p, k, c, s);
  if (nvec <= 8) return launch<T, 8>(fvec, targets, idx, out, b, n, p, k, c, s);
  if (nvec <= 16) return launch<T, 16>(fvec, targets, idx, out, b, n, p, k, c, s);
  return launch<T, 32>(fvec, targets, idx, out, b, n, p, k, c, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. c must be a multiple of 16 bytes' worth
// of elements and every row 16-byte aligned (checked by the Python wrapper).
extern "C" int corr_forward(const void* fvec, const void* targets, const int64_t* idx,
                            float* out, int b, int n, int p, int k, int c, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(fvec, targets, idx, out, b, n, p, k, c, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(fvec, targets, idx, out, b, n, p, k, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
