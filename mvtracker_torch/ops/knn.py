"""Batched k-nearest-neighbour search, counterpart of `mvtracker_tpu/ops/knn.py`.

`knn(ref, query, k)` returns (dists [B, M, k], idx [B, M, k]) sorted by
ascending Euclidean distance, like the JAX package's `knn`. Ties may be
broken in any order; callers do not rely on tie order.

Two versions of the same function:
- `knn_cuda`, the CUDA kernel `csrc/knn.cu`, which replaces the TPU kernel
  `mvtracker_tpu/ops/knn.py::knn_pallas_fused`. Its design note is in the
  source;
- `knn_plain`, chunked squared differences and `torch.topk`: the CPU path
  and the yardstick the kernel is checked against.

`knn` takes the plain version only for tensors on the CPU. For CUDA tensors
it launches the kernel or raises.

Contract shared by both (the JAX package's `knn_reference`):
- distances are sqrt(max(d^2, 1e-12)) in fp32;
- for k > N, ranks >= N get the distance 1e15 (sqrt of the 1e30 fill) and
  index 0;
- indices are int64.
"""

from __future__ import annotations

import torch

from mvtracker_torch.ops import _cuda

_BIG = 1e30
MAX_K = 32  # largest k the kernel is instantiated for


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


def knn_cuda(ref: torch.Tensor, query: torch.Tensor, k: int):
    """The CUDA kernel `csrc/knn.cu` on CUDA tensors; same contract as
    `knn_plain`. Adds one to `knn_cuda.launches` per kernel launch."""
    if not (ref.is_cuda and query.is_cuda and ref.device == query.device):
        raise ValueError("knn_cuda needs ref and query on the same CUDA device")
    if ref.dtype != torch.float32 or query.dtype != torch.float32:
        raise TypeError(f"knn_cuda takes float32, got {ref.dtype} and {query.dtype}")
    if ref.dim() != 3 or query.dim() != 3 or ref.shape[2] != 3 or query.shape[2] != 3:
        raise ValueError(f"knn_cuda takes [B, N, 3] and [B, M, 3], got {tuple(ref.shape)}, {tuple(query.shape)}")
    if ref.shape[0] != query.shape[0]:
        raise ValueError("knn_cuda: ref and query batch sizes differ")
    if not (ref.is_contiguous() and query.is_contiguous()):
        raise ValueError("knn_cuda takes contiguous tensors")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_cuda supports 1 <= k <= {MAX_K}, got {k}")
    b, n, _ = ref.shape
    m = query.shape[1]
    if n < 1:
        raise ValueError("knn_cuda needs a non-empty reference cloud")
    if max(b * n * 3, b * m * k) >= 2**31 or b > 65535:
        raise ValueError("knn_cuda: tensor too large for the kernel's indexing")
    dist = torch.empty((b, m, k), dtype=torch.float32, device=ref.device)
    idx = torch.empty((b, m, k), dtype=torch.int64, device=ref.device)
    if b == 0 or m == 0:
        return dist, idx
    lib = _cuda.load("knn")
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.knn_forward(ref.data_ptr(), query.data_ptr(), dist.data_ptr(), idx.data_ptr(), b, n, m, k, stream)
    _cuda.check(lib, status, "knn_cuda")
    knn_cuda.launches += 1
    return dist, idx


knn_cuda.launches = 0


def knn(ref: torch.Tensor, query: torch.Tensor, k: int):
    """Batched kNN dispatch: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. [B, N, 3], [B, M, 3] -> ([B, M, k], [B, M, k])."""
    if ref.is_cuda:
        return knn_cuda(ref.float().contiguous(), query.float().contiguous(), k)
    if ref.device.type == "cpu" and query.device.type == "cpu":
        return knn_plain(ref, query, k)
    raise ValueError(f"knn: unsupported devices {ref.device}, {query.device}")
