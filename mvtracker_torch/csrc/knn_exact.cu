// Exact streaming k-nearest-neighbour search with a fixed tie order, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `mvtracker_tpu/ops/knn.py::knn_pallas`
// (`_knn_kernel`), the unpacked streaming top-k that callers reach directly:
// its k min-extractions take, among equal distances, the lowest column
// first. Same outputs as `knn.cu` (for every query the k nearest reference
// points, ascending, as (sqrt(max(d^2, 1e-12)), index); ranks >= N keep the
// fill: distance 1e15, index 0), and besides: among equal d^2 the lower
// index comes first, so the result is that of a stable sort of d^2 and does
// not depend on the schedule. A caller that dedups, or compares two runs
// index by index, needs that; the tracker does not, which is why `knn.cu`
// leaves the tie order open and saves the compares.
//
// What bounds it on the card: B*M*N distance evaluations and top-k compares,
// fp32 instruction throughput.
//
// Design: the shared scan of `knn_common.cuh` (one warp per query, eight
// queries per block, the warp's top-k one entry per lane) with the order
// (d^2, index) in every compare. The TPU kernel needed five vector passes
// per extraction (min, first column holding it, select, gather, mask); here
// the order is one more compare where two distances are equal. d^2 is the
// direct sum of squared differences in fp32, no expansion and no centring.

#include "knn_common.cuh"

namespace {

using namespace knn;

template <bool kOne>
__global__ void __launch_bounds__(kWarps * 32)
knn_exact_kernel(const float* __restrict__ ref, const float* __restrict__ query,
                 float* __restrict__ dist, int64_t* __restrict__ idx, int n, int m, int k) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int b = blockIdx.y;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = q < m;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = query + ((size_t)b * m + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }

  TopK top;
  scan_range<true, kOne>(ref + (size_t)b * n * 3, 0, n, qx, qy, qz, active, sx, sy, sz, top, k);
  if (active) {
    const size_t row = (size_t)b * m + q;
    write_result(top, dist + row * k, idx + row * k, k);
  }
}

}  // namespace

extern "C" int knn_exact_forward(const float* ref, const float* query, float* dist, int64_t* idx,
                                 int b, int n, int m, int k, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) {
    knn_exact_kernel<true><<<grid, kWarps * 32, 0, s>>>(ref, query, dist, idx, n, m, k);
  } else {
    knn_exact_kernel<false><<<grid, kWarps * 32, 0, s>>>(ref, query, dist, idx, n, m, k);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
