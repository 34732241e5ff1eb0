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
// An index outside [0, P) adds nothing to either; a row named twice by one
// (b, n) counts twice. fvec and targets are the uncast tensors the forward
// was given: the cloud fp32 or bf16, the targets fp32 (the tracker carries
// its track features in fp32 in both models). All products and sums are
// fp32; d_targets is written in fp32, d_fvec in fvec's type.
//
// What bounds it on the card: memory. The least it must move is the dense
// d_fvec (B*P*C values, almost all zero at the tracker's shapes: 49152
// contributions land on a level-0 cloud of 196608 rows), the gathered rows,
// g, idx, targets and d_targets.
//
// Design: d_fvec is a transpose of the scatter, done tile by tile in shared
// memory, so it never exists in fp32 in device memory and takes no global
// float atomic.
// - A block owns R consecutive rows of one b (a tile), all C channels, as
//   fp32 in shared memory (dynamic shared memory), in `copies` copies. R and
//   the copies are chosen per call by the wrapper
//   (`ops/corr.py::corr_backward_plan`): B * ceil(P / R) blocks fill the card
//   at the small levels, and small tiles get up to 8 copies.
// - It finds the contributions (n, k) whose index falls in its tile by
//   scanning all N*K indices of its b in order (a 32 KB read from L2 at the
//   tracker's shapes), 1024 at a time, compacting the matches in order into a
//   list in shared memory (a block-wide prefix sum).
// - The 8 warps split the list: with k copies, warp w takes the entries j
//   with j % k == w / (8 / k) whose row r has r % (8 / k) == w % (8 / k), and
//   adds g * targets[b, n, :] onto its copy of the row, in list order, its
//   lanes covering the row's 16-byte chunks, with up to 4 contributions'
//   loads in flight. The copies are summed in order at the end. So every
//   cell is summed by one thread in a fixed order, with no atomic on a float:
//   the bits of d_fvec are the same from run to run. The copies are there
//   because the tracker names rows very unequally (at level 3 one cloud point
//   is a neighbour of up to 187 of 256 queries): with one copy, one warp
//   walks a hot row's contributions a few at a time while the others idle.
//   Every contribution reads its target row again from L2 (25 MB a launch at
//   the tracker's shapes, against 1.5 MB of targets). Spreading a row over
//   the block with shared-memory float atomics, or grouping the list by row
//   first, measured slower (`PERF.md`).
// - It writes its R rows once, coalesced, in fvec's type; rows no index names
//   come out as zeros from the same write.
// The other way of finding a tile's contributions, a first pass that buckets
// the (n, k) by tile (a count, a scan and a scatter with integer atomics),
// measured slower at the three small levels and is not kept (`PERF.md`).
//
// d_targets is a gather, the forward's layout: a warp per (b, n), the K
// indices and gradients loaded once, a lane per neighbour, and handed round
// with shuffles; L lanes cover one row in 16-byte chunks, each lane issues
// all its neighbours' row loads before it uses them, and the 32 / L groups'
// fp32 partial sums are combined with shuffles in a fixed order.
//
// One C call launches both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;        // threads of a tile block
constexpr int kTileWarps = kThreads / 32;
// Index entries scanned, and at most listed, per round: a longer list takes
// shared memory that would let a multiprocessor hold more blocks.
constexpr int kList = 1024;
constexpr int kPerThread = kList / kThreads;
constexpr int kInFlight = 4;         // contributions whose loads are in flight together
constexpr int kGatherWarps = 8;      // (b, n) rows per d_targets block
constexpr int kChunk = 16;           // neighbours whose loads are in flight together

// Exclusive prefix sum of one int per thread over the block; returns the
// thread's offset and sets *total. Needs `scratch` of kTileWarps + 1 ints.
__device__ __forceinline__ int block_exclusive_scan(int x, int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kTileWarps ? scratch[lane] : 0;
    int winc = w;
#pragma unroll
    for (int off = 1; off < kTileWarps; off <<= 1) {
      const int y = __shfl_up_sync(kFull, winc, off);
      if (lane >= off) winc += y;
    }
    if (lane < kTileWarps) scratch[lane] = winc - w;
    if (lane == kTileWarps - 1) scratch[kTileWarps] = winc;
  }
  __syncthreads();
  const int offset = scratch[warp] + inc - x;
  *total = scratch[kTileWarps];
  __syncthreads();  // scratch may be reused right after
  return offset;
}

__device__ __forceinline__ void store_row4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ void store_row4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// d_fvec, one tile of `rows` rows of one b per block.
template <typename TF>
__global__ void __launch_bounds__(kThreads)
corr_bwd_tile_kernel(const float* __restrict__ targets, const int64_t* __restrict__ idx,
                     const float* __restrict__ g, TF* __restrict__ d_fvec, int n, int p, int k,
                     int c, int rows, int tiles, int copies) {
  extern __shared__ float4 tile[];  // [copies][rows][c / 4] fp32
  __shared__ int list_e[kList];  // listed entries n * k + k' within b, in scan order
  __shared__ int list_r[kList];  // their rows within the tile
  __shared__ int scan_scratch[kTileWarps + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int groups = kTileWarps >> (31 - __clz(copies));  // warps that split the rows of one copy
  float4* mine = tile + (warp / groups) * rows * (c / 4);  // this warp's copy
  const int b = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * rows;
  const int nrows = min(rows, p - row0);
  const int nc4 = c / 4;
  const int cells = nrows * nc4;
  const int total = n * k;
  const int64_t* ib = idx + (size_t)b * total;
  const float* gb = g + (size_t)b * total;
  const float4* tb = reinterpret_cast<const float4*>(targets + (size_t)b * n * c);

  for (int i = tid; i < copies * rows * nc4; i += kThreads) tile[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // Cells zeroed by one warp are added to, or summed at the end, by another,
  // also when no round below runs.
  __syncthreads();

  for (int e0 = 0; e0 < total; e0 += kList) {
    // Entries e0 + tid * kPerThread + j, in order; keep those in the tile.
    int local[kPerThread];
    int hits = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = e0 + tid * kPerThread + j;
      local[j] = -1;
      if (e < total) {
        const int64_t r = ib[e] - row0;
        if (r >= 0 && r < nrows) {
          local[j] = static_cast<int>(r);
          ++hits;
        }
      }
    }
    int listed;
    int pos = block_exclusive_scan(hits, scan_scratch, &listed);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (local[j] >= 0) {
        list_e[pos] = e0 + tid * kPerThread + j;
        list_r[pos] = local[j];
        ++pos;
      }
    }
    __syncthreads();
    // Warp w adds its share of the list to its copy, in list order: the
    // entries j with j % copies == w / groups whose row r has
    // r % groups == w % groups.
    for (int j0 = 0; j0 < listed; j0 += 32) {
      const int jj = j0 + lane;
      unsigned own = __ballot_sync(
          kFull, jj < listed && jj % copies == warp / groups && list_r[jj] % groups == warp % groups);
      while (own) {  // warp-uniform
        int sel[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          sel[q] = -1;
          if (own) {
            sel[q] = j0 + __ffs(own) - 1;
            own &= own - 1;
          }
        }
        for (int v = lane; v < nc4; v += 32) {
          float4 t[kInFlight];
          float gq[kInFlight];
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {  // g and the target chunks load together
            if (sel[q] < 0) continue;
            const int e = list_e[sel[q]];
            gq[q] = gb[e];
            t[q] = tb[(size_t)(e / k) * nc4 + v];
          }
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            if (sel[q] < 0) continue;
            float4& a = mine[list_r[sel[q]] * nc4 + v];
            a.x += gq[q] * t[q].x;
            a.y += gq[q] * t[q].y;
            a.z += gq[q] * t[q].z;
            a.w += gq[q] * t[q].w;
          }
        }
      }
    }
    __syncthreads();  // the lists are refilled next round; the tile is read below
  }

  // The copies summed in order, written once.
  TF* out = d_fvec + ((size_t)b * p + row0) * c;
  for (int i = tid; i < cells; i += kThreads) {
    float4 sum = tile[i];
    for (int cp = 1; cp < copies; ++cp) {
      const float4 x = tile[cp * rows * nc4 + i];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    store_row4(out + (size_t)i * 4, sum);
  }
}

// d_targets: a warp per (b, n); L lanes per row, 32 / L groups of neighbours.
template <typename TF>
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

template <typename TF, int L>
__global__ void __launch_bounds__(kGatherWarps * 32)
corr_bwd_gather_kernel(const TF* __restrict__ fvec, const int64_t* __restrict__ idx,
                       const float* __restrict__ g, float* __restrict__ d_targets, int rows,
                       int n, int p, int k, int c) {
  using Raw = typename Chunk<TF>::Raw;
  constexpr int kVec = Chunk<TF>::kVec;
  constexpr int kGroups = 32 / L;
  constexpr int V = kChunk >= kGroups ? kChunk / kGroups : 1;  // neighbour slots per lane

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGatherWarps + (threadIdx.x >> 5);  // b * n + i
  if (row >= rows) return;  // uniform across the warp
  const int b = row / n;
  const int sub = lane % L;
  const int grp = lane / L;
  const int nvec = c / kVec;
  const TF* cloud = fvec + (size_t)b * p * c;
  const int64_t* irow = idx + (size_t)row * k;
  const float* grow = g + (size_t)row * k;
  float* drow = d_targets + (size_t)row * c;

  for (int v0 = 0; v0 < nvec; v0 += L) {  // same trip count for every lane
    const int v = v0 + sub;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < k; k0 += kChunk) {
      // The chunk's indices and gradients, a lane per neighbour; an index
      // past K or outside [0, P) becomes -1.
      int mine = -1;
      float gmine = 0.f;
      if (lane < kChunk && k0 + lane < k) {
        const int64_t j = irow[k0 + lane];
        if (j >= 0 && j < p) {
          mine = static_cast<int>(j);
          gmine = grow[k0 + lane];
        }
      }
      int j[V];
      float gk[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int slot = grp + i * kGroups;  // < 32
        const int got = __shfl_sync(kFull, mine, slot);
        gk[i] = __shfl_sync(kFull, gmine, slot);
        j[i] = slot < kChunk && v < nvec ? got : -1;
      }
      Raw raw[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {  // every row load issued before any use
        if (j[i] >= 0) raw[i] = reinterpret_cast<const Raw*>(cloud + (size_t)j[i] * c)[v];
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (j[i] < 0) continue;
        float f[kVec];
        Chunk<TF>::to_float(raw[i], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] += gk[i] * f[e];
      }
    }
    // Sum the groups' partial rows; every lane takes part.
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
    }
    if (grp == 0 && v < nvec) {
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q) {
        reinterpret_cast<float4*>(drow + (size_t)v * kVec)[q] =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      }
    }
  }
}

template <typename TF, int L>
cudaError_t launch_gather(const void* fvec, const int64_t* idx, const float* g, float* d_targets,
                          int b, int n, int p, int k, int c, cudaStream_t s) {
  const int rows = b * n;
  const int blocks = (rows + kGatherWarps - 1) / kGatherWarps;
  corr_bwd_gather_kernel<TF, L><<<blocks, kGatherWarps * 32, 0, s>>>(
      static_cast<const TF*>(fvec), idx, g, d_targets, rows, n, p, k, c);
  return cudaGetLastError();
}

template <typename TF>
cudaError_t gather(const void* fvec, const int64_t* idx, const float* g, float* d_targets, int b,
                   int n, int p, int k, int c, cudaStream_t s) {
  const int nvec = c / Chunk<TF>::kVec;
  if (nvec <= 2) return launch_gather<TF, 2>(fvec, idx, g, d_targets, b, n, p, k, c, s);
  if (nvec <= 4) return launch_gather<TF, 4>(fvec, idx, g, d_targets, b, n, p, k, c, s);
  if (nvec <= 8) return launch_gather<TF, 8>(fvec, idx, g, d_targets, b, n, p, k, c, s);
  if (nvec <= 16) return launch_gather<TF, 16>(fvec, idx, g, d_targets, b, n, p, k, c, s);
  return launch_gather<TF, 32>(fvec, idx, g, d_targets, b, n, p, k, c, s);
}

template <typename TF>
cudaError_t launch_tiles(const float* targets, const int64_t* idx, const float* g, void* d_fvec,
                         int b, int n, int p, int k, int c, int rows, int tiles, int copies,
                         cudaStream_t s) {
  auto kernel = corr_bwd_tile_kernel<TF>;
  // The tile's size is the wrapper's plan; past the default 48 KB a block
  // must be allowed it, and the card refuses what it cannot hold.
  const size_t smem = (size_t)copies * rows * c * sizeof(float);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  kernel<<<b * tiles, kThreads, smem, s>>>(targets, idx, g, static_cast<TF*>(d_fvec), n, p, k, c,
                                          rows, tiles, copies);
  return cudaGetLastError();
}

template <typename TF>
cudaError_t backward(const void* fvec, const float* targets, const int64_t* idx, const float* g,
                     float* d_targets, void* d_fvec, int b, int n, int p, int k, int c, int rows,
                     int tiles, int copies, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (b > 0 && tiles > 0) {
    err = launch_tiles<TF>(targets, idx, g, d_fvec, b, n, p, k, c, rows, tiles, copies, s);
    if (err != cudaSuccess) return err;
  }
  if (b > 0 && n > 0) err = gather<TF>(fvec, idx, g, d_targets, b, n, p, k, c, s);
  return err;
}

}  // namespace

// fvec_dtype: 0 = float32, 1 = bfloat16. c must be a multiple of 16 bytes'
// worth of fvec elements, fvec and targets 16-byte aligned (checked by the
// Python wrapper). The tile plan (`ops/corr.py::corr_backward_plan`, which
// also sets the tile's size limit): `tiles` tiles of `rows` rows cover P,
// each held in `copies` (1, 2, 4 or 8) fp32 copies in shared memory.
extern "C" int corr_backward(const void* fvec, const float* targets, const int64_t* idx,
                             const float* g, float* d_targets, void* d_fvec, int b, int n, int p,
                             int k, int c, int rows, int tiles, int copies, int fvec_dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || (int64_t)rows * tiles < p || (copies != 1 && copies != 2 && copies != 4 && copies != 8) ||
      (int64_t)copies * rows * c * 4 > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fvec_dtype == 0)
    return backward<float>(fvec, targets, idx, g, d_targets, d_fvec, b, n, p, k, c, rows, tiles,
                           copies, s);
  if (fvec_dtype == 1)
    return backward<__nv_bfloat16>(fvec, targets, idx, g, d_targets, d_fvec, b, n, p, k, c, rows,
                                   tiles, copies, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
