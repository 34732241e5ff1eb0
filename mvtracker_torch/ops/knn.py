"""Batched k-nearest-neighbour search, counterpart of `mvtracker_tpu/ops/knn.py`.

`knn(ref, query, k, backend="auto")` returns (dists [B, M, k], idx [B, M, k])
sorted by ascending Euclidean distance, like the JAX package's `knn`.

Three CUDA kernels, one for each TPU kernel of the JAX module (design notes
in the sources; the scan they share is `csrc/knn_common.cuh`), and two plain
PyTorch versions that serve CPU tensors and are the yardstick the kernels
are checked against:

| backend | on CUDA tensors | replaces | on CPU tensors |
|---|---|---|---|
| `fused` | `knn_cuda`, `csrc/knn.cu` | `knn_pallas_fused` | `knn_plain` |
| `tiled` | `knn_tiled_cuda`, `csrc/knn_tiled.cu` | `knn_pallas_packed` | `knn_plain` |
| `exact` | `knn_exact_cuda`, `csrc/knn_exact.cu` | `knn_pallas` | `knn_exact_plain` |

`auto` is the JAX dispatcher's rule: `fused` up to `FUSED_MAX_POINTS`
reference points, `tiled` above. `fused` and `tiled` may break ties in any
order, and callers do not rely on it; `exact` puts the lower index first
among equal distances, so its indices equal a stable sort's.

`knn` takes a plain version only for tensors on the CPU. For CUDA tensors it
launches the kernel or raises.

`knn_sharded` and `knn_sharded_ring` search a cloud split over the ranks of
a process group (the JAX module's two schedules, there inside a
`shard_map`): each rank searches its shard with `knn`, so the shard's size
picks the kernel, and the candidates are merged by the key (distance, global
index). Every rank of the group gets the same bits, which equal a global
search that puts the lower index first among equal distances.

Contract shared by all (the JAX package's `knn_reference`):
- distances are sqrt(max(d^2, 1e-12)) in fp32;
- for k > N, ranks >= N get the distance 1e15 (sqrt of the 1e30 fill) and
  index 0;
- indices are int64.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from mvtracker_torch.ops import _cuda
from mvtracker_torch.parallel import mesh as mesh_lib
from mvtracker_torch.utils.observability import span

_BIG = 1e30
MAX_K = 32  # the kernels keep one top-k entry per lane of a warp
BACKENDS = ("auto", "fused", "tiled", "exact")
# Largest cloud `auto` gives to the fused kernel, the JAX dispatcher's switch
# (there the limit of a cloud resident in on-chip memory). Here: above it one
# warp per query walking the whole cloud alone leaves most of the card idle
# at a tracker's query counts, and the tiled kernel splits the cloud instead.
FUSED_MAX_POINTS = 256 * 1024
TILE = 2048  # reference points per shared-memory tile in the kernels


def _safe_sqrt(d2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def _fill_past_cloud(dists, idx, k):
    """Append the k > N fill ranks (distance 1e15, index 0)."""
    fill = dists.shape[:-1] + (k - dists.shape[-1],)
    dists = torch.cat([dists, torch.full(fill, _BIG**0.5, dtype=dists.dtype, device=dists.device)], -1)
    idx = torch.cat([idx, torch.zeros(fill, dtype=idx.dtype, device=idx.device)], -1)
    return dists, idx


def knn_plain(ref: torch.Tensor, query: torch.Tensor, k: int, max_elems: int = 1 << 24):
    """Plain kNN: [B, N, 3], [B, M, 3] -> ([B, M, k], [B, M, k]).

    Squared distances are direct sums of squared differences in fp32,
    computed for as many queries at a time as keep B * chunk * N under
    `max_elems`, then `torch.topk`.
    """
    ref = ref.float()
    query = query.float()
    b, n, _ = ref.shape
    m = query.shape[1]
    kk = min(k, n)
    chunk = max(1, max_elems // max(b * n, 1))
    dists, idx = [], []
    for s in range(0, m, chunk):
        q = query[:, s : s + chunk]
        d2 = ((q[:, :, None, :] - ref[:, None, :, :]) ** 2).sum(-1)  # [B, c, N]
        v, i = torch.topk(d2, kk, dim=-1, largest=False, sorted=True)
        dists.append(_safe_sqrt(v))
        idx.append(i)
    dists = torch.cat(dists, 1) if dists else query.new_zeros((b, 0, kk))
    idx = torch.cat(idx, 1) if idx else torch.zeros((b, 0, kk), dtype=torch.int64, device=query.device)
    if k > n:
        dists, idx = _fill_past_cloud(dists, idx, k)
    return dists, idx


def knn_exact_plain(ref: torch.Tensor, query: torch.Tensor, k: int, max_elems: int = 1 << 24):
    """Plain exact kNN with ties to the lower index: the first k of a stable
    sort of d^2. d^2 is (dx*dx + dy*dy) + dz*dz in fp32, one rounding per
    operation, the expression the kernels evaluate, so on equal inputs the
    indices agree with `knn_exact_cuda` one for one."""
    ref = ref.float()
    query = query.float()
    b, n, _ = ref.shape
    m = query.shape[1]
    kk = min(k, n)
    chunk = max(1, max_elems // max(b * n, 1))
    rx, ry, rz = (ref[:, None, :, c] for c in range(3))
    dists, idx = [], []
    for s in range(0, m, chunk):
        q = query[:, s : s + chunk]
        dx, dy, dz = (r - q[:, :, None, c] for c, r in enumerate((rx, ry, rz)))
        d2 = (dx * dx + dy * dy) + dz * dz  # [B, c, N]
        v, i = torch.sort(d2, dim=-1, stable=True)
        dists.append(_safe_sqrt(v[..., :kk]))
        idx.append(i[..., :kk])
    dists = torch.cat(dists, 1) if dists else query.new_zeros((b, 0, kk))
    idx = torch.cat(idx, 1) if idx else torch.zeros((b, 0, kk), dtype=torch.int64, device=query.device)
    if k > n:
        dists, idx = _fill_past_cloud(dists, idx, k)
    return dists, idx


def _check_cuda_args(name: str, ref: torch.Tensor, query: torch.Tensor, k: int):
    """The guards the three kernel wrappers share; returns (b, n, m)."""
    if not (ref.is_cuda and query.is_cuda and ref.device == query.device):
        raise ValueError(f"{name} needs ref and query on the same CUDA device")
    if ref.dtype != torch.float32 or query.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {ref.dtype} and {query.dtype}")
    if ref.dim() != 3 or query.dim() != 3 or ref.shape[2] != 3 or query.shape[2] != 3:
        raise ValueError(f"{name} takes [B, N, 3] and [B, M, 3], got {tuple(ref.shape)}, {tuple(query.shape)}")
    if ref.shape[0] != query.shape[0]:
        raise ValueError(f"{name}: ref and query batch sizes differ")
    if not (ref.is_contiguous() and query.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name} supports 1 <= k <= {MAX_K}, got {k}")
    b, n, _ = ref.shape
    m = query.shape[1]
    if n < 1:
        raise ValueError(f"{name} needs a non-empty reference cloud")
    if max(b * n * 3, b * m * k) >= 2**31 or b > 65535:
        raise ValueError(f"{name}: tensor too large for the kernel's indexing")
    return b, n, m


def _empty_result(ref: torch.Tensor, b: int, m: int, k: int):
    """The kernels' outputs: distances [B, M, k] fp32, indices [B, M, k] int64."""
    return (torch.empty((b, m, k), dtype=torch.float32, device=ref.device),
            torch.empty((b, m, k), dtype=torch.int64, device=ref.device))


def knn_cuda(ref: torch.Tensor, query: torch.Tensor, k: int):
    """The CUDA kernel `csrc/knn.cu` on CUDA tensors; same contract as
    `knn_plain`."""
    b, n, m = _check_cuda_args("knn_cuda", ref, query, k)
    dist, idx = _empty_result(ref, b, m, k)
    if b and m:
        _cuda.launch("knn", "knn_forward", ref, query, dist, idx, b, n, m, k)
    return dist, idx


def knn_exact_cuda(ref: torch.Tensor, query: torch.Tensor, k: int):
    """The CUDA kernel `csrc/knn_exact.cu` on CUDA tensors; same contract as
    `knn_exact_plain` (ties to the lower index)."""
    b, n, m = _check_cuda_args("knn_exact_cuda", ref, query, k)
    dist, idx = _empty_result(ref, b, m, k)
    if b and m:
        _cuda.launch("knn_exact", "knn_exact_forward", ref, query, dist, idx, b, n, m, k)
    return dist, idx


def tiled_plan(b: int, n: int, m: int, resident_blocks: int) -> tuple[int, int]:
    """(splits, span) for the tiled kernel: the cloud is cut into `splits`
    spans of `span` points, a whole number of tiles each. The grid has
    ceil(m / 8) * b * splits blocks; `splits` brings it as near as it can to
    `resident_blocks`, the blocks the card holds at once, and is 1 where the
    query blocks alone come to that: a span more costs each query a top-k
    filled from empty, which pays only on multiprocessors otherwise idle."""
    tiles = -(-n // TILE)
    query_blocks = -(-m // 8) * b
    splits = max(1, min(tiles, round(resident_blocks / max(query_blocks, 1))))
    span = -(-tiles // splits) * TILE
    return -(-n // span), span


@functools.lru_cache(maxsize=None)
def tiled_resident_blocks(device_index: int, one: bool) -> int:
    """Blocks of the tiled kernel's first pass that the card holds at once;
    `one` for k = 1, which has its own instance of the kernel."""
    per_sm = _cuda.load("knn_tiled").knn_tiled_blocks_per_sm(1 if one else 2)
    if per_sm < 1:
        raise RuntimeError("knn_tiled_cuda: the occupancy query failed")
    return per_sm * torch.cuda.get_device_properties(device_index).multi_processor_count


def knn_tiled_cuda(ref: torch.Tensor, query: torch.Tensor, k: int):
    """The CUDA kernels `csrc/knn_tiled.cu` on CUDA tensors (a partial top-k
    per span of the cloud, then a merge, launched by one C call); same
    contract as `knn_plain`."""
    b, n, m = _check_cuda_args("knn_tiled_cuda", ref, query, k)
    dist, idx = _empty_result(ref, b, m, k)
    if b == 0 or m == 0:
        return dist, idx
    splits, span = tiled_plan(b, n, m, tiled_resident_blocks(ref.device.index, k == 1))
    ws_d = torch.empty((b, m, splits, k), dtype=torch.float32, device=ref.device)
    ws_i = torch.empty((b, m, splits, k), dtype=torch.int32, device=ref.device)
    _cuda.launch("knn_tiled", "knn_tiled_forward", ref, query, dist, idx, ws_d, ws_i, b, n, m, k, splits, span)
    return dist, idx


def resolve_backend(backend: str, n: int) -> str:
    """The backend `knn` takes for a cloud of n points: `auto` resolved."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown knn backend {backend!r}; one of {BACKENDS}")
    if backend == "auto":
        return "fused" if n <= FUSED_MAX_POINTS else "tiled"
    return backend


def knn(ref: torch.Tensor, query: torch.Tensor, k: int, backend: str = "auto"):
    """Batched kNN dispatch: [B, N, 3], [B, M, 3] -> ([B, M, k], [B, M, k]).
    `backend` picks the kernel for CUDA tensors (`auto`: `fused` up to
    `FUSED_MAX_POINTS` reference points, `tiled` above); CPU tensors take the
    plain version with the same contract. Records the profiler span
    `mvtracker::knn`."""
    backend = resolve_backend(backend, ref.shape[1])
    with span("knn"):
        if ref.is_cuda:
            kernel = {"fused": knn_cuda, "tiled": knn_tiled_cuda, "exact": knn_exact_cuda}[backend]
            return kernel(ref.float().contiguous(), query.float().contiguous(), k)
        if ref.device.type == "cpu" and query.device.type == "cpu":
            return (knn_exact_plain if backend == "exact" else knn_plain)(ref, query, k)
    raise ValueError(f"knn: unsupported devices {ref.device}, {query.device}")


# ---------------------------------------------------------------------------
# kNN over a cloud split across the ranks of a process group
# ---------------------------------------------------------------------------


def _pack(dists: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(distance, index) as one int64 key that sorts as the pair: the fp32
    bits of a distance >= 0 order as the distance, and sit above the index."""
    return (dists.float().contiguous().view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)


def _unpack(keys: torch.Tensor):
    dists = (keys >> 32).to(torch.int32).view(torch.float32)
    return dists, keys & 0xFFFFFFFF


def _merge(keys: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(keys, dim=-1).values[..., :k]


def _global_keys(ref_local, query, k, owner: int, backend: str) -> torch.Tensor:
    """The shard's top-k as keys, its indices offset to the whole cloud's."""
    d, i = knn(ref_local, query, k, backend=backend)
    return _pack(d, i + owner * ref_local.shape[1])


def knn_sharded(ref_local: torch.Tensor, query: torch.Tensor, k: int, group, backend: str = "auto"):
    """kNN when the cloud is split over the ranks of `group`: this rank holds
    shard `rank in group` of equal shards, `ref_local` [B, N/D, 3], and the
    whole query set [B, M, 3]. Each rank's top-k, one all-gather of the D * k
    candidates, then a merge. Returns (dists, global indices) [B, M, k]."""
    keys = _global_keys(ref_local, query, k, dist.get_rank(group), backend)
    return _unpack(_merge(torch.cat(mesh_lib.all_gather(keys, group), dim=-1), k))


def knn_sharded_ring(ref_local: torch.Tensor, query: torch.Tensor, k: int, group, backend: str = "auto"):
    """The same search with the shards passed around the group's ring: at
    each of D steps a rank folds the visiting shard's top-k into its running
    best, then hands the shard to the next rank. One shard crosses a link
    per step instead of D * k candidates per query, the better schedule when
    M * k exceeds N / D. The best starts at distance `_BIG`, index 0."""
    n_ranks, me = dist.get_world_size(group), dist.get_rank(group)
    b, m, _ = query.shape
    best = _pack(torch.full((b, m, k), _BIG, device=query.device), torch.zeros((b, m, k), dtype=torch.int64,
                                                                              device=query.device))
    shard = ref_local
    for step in range(n_ranks):
        owner = (me - step) % n_ranks
        best = _merge(torch.cat([best, _global_keys(shard, query, k, owner, backend)], dim=-1), k)
        if step + 1 < n_ranks:
            shard = mesh_lib.ring_shift(shard, group)
    return _unpack(best)
