// Neighbour correlation select for Hopper (sm_90a).
//
// Replaces the forward of the TPU kernel
// `mvtracker_tpu/ops/corr_pallas.py::corr_select_pallas` (`_corr_kernel`):
//
//     corr[b, n, k] = <targets[b, n, :], fvec[b, idx[b, n, k], :]>
//
// unscaled, accumulated in fp32, 0 for an index outside [0, P) (the JAX
// kernel's -1 padding). fvec is fp32 or bf16; targets are of fvec's type or,
// with a bf16 fvec, fp32: the kernel then rounds them to bf16 in registers
// (`__float2bfloat16_rn`, the rounding of `tensor.to(torch.bfloat16)`), so
// the products are the same bits as on targets cast first. The output is fp32.
//
// The kernel sits inside the autograd function `CorrSelect` (`ops/corr.py`),
// which hands it the stored cloud features and the fp32 track features as
// they are; its backward is `csrc/corr_bwd.cu`.
//
// What bounds it on the card: memory latency, not bytes. Each output needs
// one row of C features gathered from a cloud of P rows and C multiply-adds,
// far below the ~20 fp32 operations per byte at which the ALUs would bind,
// and the path's launches move 0.6 to 2.1 us worth of bytes. 3072 warps fill
// the card in one wave, so a launch lasts as long as one warp's chain of
// dependent memory accesses.
//
// Design: a gather, not the TPU's trick (the TPU kernel computed the full
// [N, P] correlation tile on its matrix unit and selected k entries with
// masks, because TPU gathers are slow). One warp owns one (b, n) and keeps
// every load in flight at once:
// - the K indices arrive in one coalesced load, a lane per index, and are
//   handed round with `__shfl_sync`;
// - the warp is split into 32/L groups of L lanes (L lanes cover one row in
//   16-byte chunks); each lane issues the loads of all its neighbours' row
//   chunks before it uses any of them, so the chain is two memory latencies
//   (indices, then rows), not two per neighbour;
// - each lane ends with one partial dot product per neighbour it touched,
//   and one butterfly over the L lanes of a group (a transposing reduction)
//   leaves each neighbour's full sum on one lane pair; the outputs go out in
//   one coalesced store.
// K is a template parameter: 16 (the tracker's) and 1 have their own
// instances; other K walk the neighbours in chunks of 16. Every sum is taken
// in a fixed order, so the result does not vary from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // (b, n) rows per block, one warp each
constexpr int kChunk = 16;  // neighbours whose loads are in flight together
constexpr unsigned kFull = 0xffffffffu;

// One 16-byte chunk of an fvec row as fp32 registers.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kVec = 4;
  using Raw = float4;
  __device__ static void to_float(const Raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Raw = uint4;
  __device__ static void to_float(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(h[i]);
      f[2 * i] = u.x;
      f[2 * i + 1] = u.y;
    }
  }
};

// The target slice matching one fvec chunk, as the fp32 values of fvec's
// type: read as TF (fvec's type) or read as fp32 and rounded to TF.
template <typename TF, typename TT>
__device__ __forceinline__ void load_target(const TT* p, float* t) {
  constexpr int kVec = Chunk<TF>::kVec;
  if constexpr (sizeof(TF) == sizeof(TT)) {
    Chunk<TF>::to_float(*reinterpret_cast<const typename Chunk<TF>::Raw*>(p), t);
  } else {  // fp32 targets for a bf16 cloud: round here, as a cast would
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      t[4 * q + 0] = __bfloat162float(__float2bfloat16_rn(x.x));
      t[4 * q + 1] = __bfloat162float(__float2bfloat16_rn(x.y));
      t[4 * q + 2] = __bfloat162float(__float2bfloat16_rn(x.z));
      t[4 * q + 3] = __bfloat162float(__float2bfloat16_rn(x.w));
    }
  }
}

// KF: 16 or 1 for a fixed K, 0 for any K in chunks of 16. L: lanes per row.
template <typename TF, typename TT, int L, int KF>
__global__ void __launch_bounds__(kWarps * 32)
corr_kernel(const TF* __restrict__ fvec, const TT* __restrict__ targets,
            const int64_t* __restrict__ idx, float* __restrict__ out,
            int rows, int n, int p, int k, int c) {
  using Raw = typename Chunk<TF>::Raw;
  constexpr int kVec = Chunk<TF>::kVec;  // features per 16-byte chunk
  constexpr int kGroups = 32 / L;        // neighbours loaded side by side
  constexpr int kSpan = KF == 1 ? 1 : kChunk;  // neighbours per chunk
  // Neighbour slots per lane: slot i of group grp is neighbour grp + i * kGroups.
  constexpr int V = kSpan >= kGroups ? kSpan / kGroups : 1;
  constexpr int kShare = L / V;  // lanes that end holding one neighbour's sum
  static_assert(L % V == 0, "the butterfly needs V to divide L");

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * n + i
  if (row >= rows) return;  // uniform across the warp
  const int b = row / n;
  const int sub = lane % L;
  const int grp = lane / L;
  const int nvec = c / kVec;

  const TT* trow = targets + (size_t)row * c;
  const TF* cloud = fvec + (size_t)b * p * c;
  const int64_t* irow = idx + (size_t)row * k;
  float* orow = out + (size_t)row * k;
  const int kk_total = KF ? KF : k;

  for (int k0 = 0; k0 < kk_total; k0 += kSpan) {
    const int left = kk_total - k0;
    // One coalesced load of the chunk's indices, a lane per index; an index
    // past K or outside [0, P) becomes -1.
    int mine = -1;
    if (lane < kSpan && lane < left) {
      const int64_t j = irow[k0 + lane];
      if (j >= 0 && j < p) mine = static_cast<int>(j);
    }
    int j[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int slot = grp + i * kGroups;  // < 32
      const int got = __shfl_sync(kFull, mine, slot);
      j[i] = slot < kSpan ? got : -1;
    }
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int v0 = 0; v0 < nvec; v0 += L) {  // same trip count for every lane
      const int v = v0 + sub;
      if (v < nvec) {
        Raw raw[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {  // every row load issued before any use
          if (j[i] >= 0) raw[i] = reinterpret_cast<const Raw*>(cloud + (size_t)j[i] * c)[v];
        }
        float t[kVec];
        load_target<TF, TT>(trow + (size_t)v * kVec, t);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (j[i] < 0) continue;
          float f[kVec];
          Chunk<TF>::to_float(raw[i], f);
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) s += f[e] * t[e];
          acc[i] += s;
        }
      }
    }
    // Transposing butterfly over the group's L lanes: each step halves the
    // slots a lane holds (the lane with bit s set keeps the upper half), so
    // after log2(V) steps one slot is left, which the remaining steps sum.
    // Lane sub then holds slot sub / kShare.
#pragma unroll
    for (int s = L / 2, width = V; s >= 1; s >>= 1) {
      if (width > 1) {
        const bool upper = (sub & s) != 0;
        const int h = width / 2;
#pragma unroll
        for (int i = 0; i < V / 2; ++i) {
          if (i < h) {
            const float send = upper ? acc[i] : acc[i + h];
            const float keep = upper ? acc[i + h] : acc[i];
            acc[i] = keep + __shfl_xor_sync(kFull, send, s);
          }
        }
        width = h;
      } else {
        acc[0] += __shfl_xor_sync(kFull, acc[0], s);
      }
    }
    const int slot = sub / kShare;
    const int kk = grp + slot * kGroups;
    if (sub % kShare == 0 && kk < kSpan && kk < left) orow[k0 + kk] = acc[0];
  }
}

template <typename TF, typename TT, int L>
cudaError_t launch(const void* fvec, const void* targets, const int64_t* idx, float* out,
                   int b, int n, int p, int k, int c, cudaStream_t stream) {
  const int rows = b * n;
  const int blocks = (rows + kWarps - 1) / kWarps;
  const TF* f = static_cast<const TF*>(fvec);
  const TT* t = static_cast<const TT*>(targets);
  if (k == kChunk) {
    corr_kernel<TF, TT, L, kChunk><<<blocks, kWarps * 32, 0, stream>>>(f, t, idx, out, rows, n, p, k, c);
  } else if (k == 1) {
    corr_kernel<TF, TT, L, 1><<<blocks, kWarps * 32, 0, stream>>>(f, t, idx, out, rows, n, p, k, c);
  } else {
    corr_kernel<TF, TT, L, 0><<<blocks, kWarps * 32, 0, stream>>>(f, t, idx, out, rows, n, p, k, c);
  }
  return cudaGetLastError();
}

template <typename TF, typename TT>
cudaError_t dispatch(const void* fvec, const void* targets, const int64_t* idx, float* out,
                     int b, int n, int p, int k, int c, cudaStream_t s) {
  const int nvec = c / Chunk<TF>::kVec;
  if (nvec <= 2) return launch<TF, TT, 2>(fvec, targets, idx, out, b, n, p, k, c, s);
  if (nvec <= 4) return launch<TF, TT, 4>(fvec, targets, idx, out, b, n, p, k, c, s);
  if (nvec <= 8) return launch<TF, TT, 8>(fvec, targets, idx, out, b, n, p, k, c, s);
  if (nvec <= 16) return launch<TF, TT, 16>(fvec, targets, idx, out, b, n, p, k, c, s);
  return launch<TF, TT, 32>(fvec, targets, idx, out, b, n, p, k, c, s);
}

}  // namespace

// fvec_dtype, targets_dtype: 0 = float32, 1 = bfloat16; targets of fvec's
// type, or fp32 targets with a bf16 fvec. c must be a multiple of 16 bytes'
// worth of fvec elements and every row 16-byte aligned (checked by the Python
// wrapper).
extern "C" int corr_forward(const void* fvec, const void* targets, const int64_t* idx,
                            float* out, int b, int n, int p, int k, int c, int fvec_dtype,
                            int targets_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fvec_dtype == 0 && targets_dtype == 0)
    return dispatch<float, float>(fvec, targets, idx, out, b, n, p, k, c, s);
  if (fvec_dtype == 1 && targets_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(fvec, targets, idx, out, b, n, p, k, c, s);
  if (fvec_dtype == 1 && targets_dtype == 0)
    return dispatch<__nv_bfloat16, float>(fvec, targets, idx, out, b, n, p, k, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
