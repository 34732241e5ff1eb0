// k-nearest-neighbour search over a large reference cloud for Hopper
// (sm_90a), the reference axis split across thread blocks.
//
// Replaces the TPU kernel `mvtracker_tpu/ops/knn.py::knn_pallas_packed`
// (`_knn_kernel_packed`), which the JAX dispatcher takes for clouds of more
// than 262144 points: there the reference tiles sit on a sequential grid
// axis and the running top-k lives in the revisited output block. Same
// contract as `knn.cu`: for every query of every batch the k nearest
// reference points, ascending, as (sqrt(max(d^2, 1e-12)), index); ranks >= N
// keep the fill (distance 1e15, index 0); tie order is not part of the
// contract.
//
// What bounds it on the card: B*M*N distance evaluations and top-k compares,
// fp32 instruction throughput, as for `knn.cu`. What differs is the shape it
// is for: a large cloud and few queries. The whole-cloud kernels give a
// query one warp that walks the cloud alone, so ceil(M / 8) * B blocks are
// all the parallelism there is; where that is fewer than the card holds at
// once, multiprocessors sit idle while the others walk 280000 points.
//
// Design: two kernels per call. `partial`: grid (query blocks, B, splits);
// block (x, b, s) scans the reference points [s * span, (s + 1) * span) for
// its eight queries with the shared scan of `knn_common.cuh` and writes each
// query's sorted top-k of that span, as raw d^2 and int32 index, into a
// workspace [B, M, splits, k]. `merge`: one warp per query offers its
// splits * k candidates, 32 at a time and in span order, to a fresh top-k
// with the same warp insertion, and writes the result. Where the TPU kernel
// walks the tiles in sequence because its grid axis is sequential, here the
// spans run side by side and meet in the merge.
//
// A span more costs every query a top-k filled from empty (about k
// insertions and their broadcasts), so it pays where the query blocks alone
// leave multiprocessors idle. The wrapper asks `knn_tiled_blocks_per_sm` how
// many blocks of the partial kernel one multiprocessor holds at this k, and cuts the
// cloud into as many spans, each a whole number of tiles, as bring the grid
// to about one such full load of the card.

#include "knn_common.cuh"

namespace {

using namespace knn;

template <bool kOne>
__global__ void __launch_bounds__(kWarps * 32)
knn_tiled_partial(const float* __restrict__ ref, const float* __restrict__ query,
                  float* __restrict__ ws_d, int* __restrict__ ws_i, int n, int m, int k, int span) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int lane = threadIdx.x & 31;
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
  const int begin = split * span;
  scan_range<false, kOne>(ref + (size_t)b * n * 3, begin, min(n, begin + span), qx, qy, qz, active,
                    sx, sy, sz, top, k);
  if (active && lane < k) {
    const size_t slot = (((size_t)b * m + q) * gridDim.z + split) * k + lane;
    ws_d[slot] = top.d;
    ws_i[slot] = top.i;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
knn_tiled_merge(const float* __restrict__ ws_d, const int* __restrict__ ws_i,
                float* __restrict__ dist, int64_t* __restrict__ idx, int rows, int cands, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * m + q
  if (row >= rows) return;  // uniform across the warp

  TopK top;
  const float* cd = ws_d + (size_t)row * cands;
  const int* ci = ws_i + (size_t)row * cands;
  for (int c0 = 0; c0 < cands; c0 += 32) {
    const int c = c0 + lane;
    offer<false>(top, c < cands ? cd[c] : kBig, c < cands ? ci[c] : 0, k);
  }
  write_result(top, dist + (size_t)row * k, idx + (size_t)row * k, k);
}

}  // namespace

// ws_d (float) and ws_i (int32) hold b * m * splits * k entries each; span is
// a multiple of the tile (2048) and splits * span >= n > (splits - 1) * span
// (all computed by the Python wrapper).
extern "C" int knn_tiled_forward(const float* ref, const float* query, float* dist, int64_t* idx,
                                 float* ws_d, int* ws_i, int b, int n, int m, int k, int splits,
                                 int span, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || splits < 1 || splits > 65535 || span < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + kWarps - 1) / kWarps, b, splits);
  if (k == 1) {
    knn_tiled_partial<true><<<grid, kWarps * 32, 0, s>>>(ref, query, ws_d, ws_i, n, m, k, span);
  } else {
    knn_tiled_partial<false><<<grid, kWarps * 32, 0, s>>>(ref, query, ws_d, ws_i, n, m, k, span);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = b * m;
  knn_tiled_merge<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      ws_d, ws_i, dist, idx, rows, splits * k, k);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the partial kernel that one multiprocessor holds at once for
// this k (0 on an error).
extern "C" int knn_tiled_blocks_per_sm(int k) {
  int blocks = 0;
  const cudaError_t err =
      k == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_tiled_partial<true>, kWarps * 32, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_tiled_partial<false>, kWarps * 32, 0);
  return err == cudaSuccess ? blocks : 0;
}

extern "C" const char* mvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
