"""Grouped neighbour correlation (L1), counterpart of `mvtracker_tpu/ops/corr.py`.

Gather the k nearest neighbours' feature vectors from a fused cloud and
correlate them with per-track target features:

    corr[b, m, k, g] = <target[b, m, g, :], fvec[b, idx[b, m, k], g, :]> / sqrt(C / G)

The single-group case, the tracker's configuration, goes through the
`torch.autograd.Function` `CorrSelect`, the counterpart of the JAX
package's `custom_vjp` around `corr_select_pallas`. It takes the uncast
cloud features and targets and casts them to the compute dtype inside (the
fp32 targets of a bf16 call are rounded by the kernel itself, as they load):

- forward: `corr_select`, which is the CUDA kernel `csrc/corr.cu` on CUDA
  tensors (it replaces the forward of
  `mvtracker_tpu/ops/corr_pallas.py::corr_select_pallas`) and
  `corr_select_plain`, a gather and an einsum, on CPU tensors;
- backward: `corr_select_backward`, which is the CUDA kernel
  `csrc/corr_bwd.cu` on CUDA tensors (it replaces `_corr_select_bwd` of the
  same JAX module) and `corr_select_backward_plain` on CPU tensors. It
  works in fp32 on the uncast tensors the forward was given and returns
  each gradient in its tensor's own dtype, as the JAX backward does.

Design notes are in the kernel sources. For CUDA tensors the kernels are
launched or an error is raised; the plain versions serve CPU tensors only.
Neighbour offsets ride along in the `[corr | offset | xyz]` layout of the
JAX package.
"""

from __future__ import annotations

import functools
import math

import torch

from mvtracker_torch.ops import _cuda
from mvtracker_torch.utils.observability import span

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gather_neighbors(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather [B, P, C] values at [B, M, K] indices -> [B, M, K, C]."""
    b, p, c = values.shape
    _, m, k = idx.shape
    offset = torch.arange(b, device=idx.device).view(b, 1, 1) * p
    flat = (idx.long() + offset).reshape(-1)
    return values.reshape(b * p, c).index_select(0, flat).reshape(b, m, k, c)


def grouped_correlation(targets: torch.Tensor, neighbor_fvec: torch.Tensor, groups: int = 1):
    """Channel-grouped dot products [B, M, C] x [B, M, K, C] -> [B, M, K, G],
    scaled by 1/sqrt(C/G)."""
    b, m, c = targets.shape
    k = neighbor_fvec.shape[2]
    tg = targets.reshape(b, m, groups, c // groups).float()
    ng = neighbor_fvec.reshape(b, m, k, groups, c // groups).float()
    corr = torch.einsum("bmgc,bmkgc->bmkg", tg, ng)
    return (corr / math.sqrt(c / groups)).to(targets.dtype)


def corr_select_plain(fvec: torch.Tensor, targets: torch.Tensor, idx: torch.Tensor):
    """Plain version of the kernel: [B, P, C], [B, N, C], [B, N, K] ->
    [B, N, K] fp32 (float64 for float64 inputs), unscaled; an index outside
    [0, P) gives 0. Targets of another dtype than `fvec` are rounded to
    `fvec`'s first, as the kernel does with fp32 targets for a bf16 cloud."""
    p = fvec.shape[1]
    targets = targets.to(fvec.dtype)
    acc = torch.promote_types(torch.float32, fvec.dtype)
    valid = (idx >= 0) & (idx < p)
    rows = gather_neighbors(fvec, torch.where(valid, idx, torch.zeros_like(idx)))
    corr = torch.einsum("bnc,bnkc->bnk", targets.to(acc), rows.to(acc))
    return torch.where(valid, corr, torch.zeros_like(corr))


def corr_select_cuda(fvec: torch.Tensor, targets: torch.Tensor, idx: torch.Tensor):
    """The CUDA kernel `csrc/corr.cu`; same contract as `corr_select_plain`,
    for float32 or bfloat16 of one type, or a bfloat16 fvec with float32
    targets (rounded to bfloat16 in the kernel as they load). The sums run in
    a fixed order: the same inputs give the same bits. Adds one to
    `corr_select_cuda.launches` per kernel launch."""
    if not (fvec.is_cuda and targets.device == fvec.device and idx.device == fvec.device):
        raise ValueError("corr_select_cuda needs fvec, targets and idx on one CUDA device")
    if fvec.dtype not in _DTYPE_CODES or targets.dtype not in (fvec.dtype, torch.float32):
        raise TypeError(
            f"corr_select_cuda takes float32 or bfloat16 of one type, or a bfloat16 fvec with float32 "
            f"targets, got {fvec.dtype}, {targets.dtype}"
        )
    if idx.dtype != torch.int64:
        raise TypeError(f"corr_select_cuda takes int64 indices, got {idx.dtype}")
    if fvec.dim() != 3 or targets.dim() != 3 or idx.dim() != 3:
        raise ValueError("corr_select_cuda takes [B, P, C], [B, N, C], [B, N, K]")
    b, p, c = fvec.shape
    _, n, k = idx.shape
    if targets.shape != (b, n, c) or idx.shape[0] != b:
        raise ValueError(
            f"corr_select_cuda: shapes {tuple(fvec.shape)}, {tuple(targets.shape)}, {tuple(idx.shape)} disagree"
        )
    vec = 16 // fvec.element_size()
    if c % vec:
        raise ValueError(f"corr_select_cuda needs C a multiple of {vec} for {fvec.dtype}, got {c}")
    if not (fvec.is_contiguous() and targets.is_contiguous() and idx.is_contiguous()):
        raise ValueError("corr_select_cuda takes contiguous tensors")
    if fvec.data_ptr() % 16 or targets.data_ptr() % 16:
        raise ValueError("corr_select_cuda needs 16-byte aligned fvec and targets")
    if max(b * n * k, b * n) >= 2**31:
        raise ValueError("corr_select_cuda: tensor too large for the kernel's indexing")
    out = torch.empty((b, n, k), dtype=torch.float32, device=fvec.device)
    if out.numel() == 0:
        return out
    lib = _cuda.load("corr")
    with torch.cuda.device(fvec.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.corr_forward(
            fvec.data_ptr(), targets.data_ptr(), idx.data_ptr(), out.data_ptr(),
            b, n, p, k, c, _DTYPE_CODES[fvec.dtype], _DTYPE_CODES[targets.dtype], stream,
        )
    _cuda.check(lib, status, "corr_select_cuda")
    corr_select_cuda.launches += 1
    return out


corr_select_cuda.launches = 0


def corr_select_backward_plain(fvec: torch.Tensor, targets: torch.Tensor, idx: torch.Tensor, g: torch.Tensor):
    """Plain version of the backward kernel. With corr = `corr_select_plain`
    and g = d loss / d corr [B, N, K]:

        d_targets[b, n] = sum_k g[b, n, k] * fvec[b, idx[b, n, k]]
        d_fvec[b, p]    = sum over (n, k) with idx[b, n, k] == p of g[b, n, k] * targets[b, n]

    computed in fp32 (float64 if an input is float64) from `fvec` and
    `targets` as given; an index outside [0, P) adds nothing. Returns
    (d_fvec in fvec.dtype, d_targets in targets.dtype).
    """
    b, p, c = fvec.shape
    acc = torch.promote_types(torch.float32, torch.promote_types(fvec.dtype, targets.dtype))
    valid = (idx >= 0) & (idx < p)
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    gz = torch.where(valid, g.to(acc), torch.zeros((), dtype=acc, device=g.device))
    rows = gather_neighbors(fvec, safe).to(acc)  # [B, N, K, C]
    d_targets = torch.einsum("bnk,bnkc->bnc", gz, rows).to(targets.dtype)
    updates = gz[..., None] * targets.to(acc)[:, :, None, :]  # [B, N, K, C]
    flat = (safe.long() + torch.arange(b, device=idx.device).view(b, 1, 1) * p).reshape(-1)
    d_fvec = torch.zeros((b * p, c), dtype=acc, device=fvec.device).index_add_(0, flat, updates.reshape(-1, c))
    return d_fvec.reshape(b, p, c).to(fvec.dtype), d_targets


# Shared memory a block of the backward gives its tile of d_fvec rows (fp32,
# all C channels, all copies): the one limit on a tile; `csrc/corr_bwd.cu`
# allows each launch the size its plan asks for.
CORR_BWD_TILE_BYTES = 64 * 1024
# Tile blocks wanted per multiprocessor where the cloud is small: a block's
# time is a chain of memory latencies, so several share each multiprocessor.
CORR_BWD_BLOCKS_PER_SM = 4


def corr_backward_copies(rows: int, c: int) -> int:
    """fp32 copies of a tile of `rows` rows that the backward's block keeps,
    the most of 1, 2, 4, 8 that fit `CORR_BWD_TILE_BYTES`: with k copies,
    k warps share a row, each summing every k-th contribution, and the
    copies are summed at the end. Small tiles, where few rows take most
    contributions, get 8."""
    copies = 8
    while copies > 1 and copies * rows * c * 4 > CORR_BWD_TILE_BYTES:
        copies //= 2
    return copies


def corr_backward_plan(b: int, p: int, c: int, sms: int) -> tuple[int, int, int]:
    """(rows, tiles, copies) for the backward's d_fvec pass: each of `b` clouds
    of `p` rows is cut into `tiles` tiles of `rows` rows, one block each. A
    tile holds at most `CORR_BWD_TILE_BYTES` of fp32 rows; within that, tiles
    are made small enough that b * tiles reaches `CORR_BWD_BLOCKS_PER_SM`
    blocks on each of the card's `sms` multiprocessors, so that small clouds
    fill the card too. `copies` from `corr_backward_copies`."""
    cap = max(1, CORR_BWD_TILE_BYTES // (4 * c))
    want = -(-CORR_BWD_BLOCKS_PER_SM * sms // max(b, 1))
    rows = max(1, min(cap, -(-p // want)))
    return rows, -(-p // rows), corr_backward_copies(rows, c)


@functools.lru_cache(maxsize=None)
def _multiprocessors(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def corr_select_backward_cuda(fvec: torch.Tensor, targets: torch.Tensor, idx: torch.Tensor, g: torch.Tensor):
    """The CUDA kernels `csrc/corr_bwd.cu`, launched by one C call; same
    contract as `corr_select_backward_plain`, for a float32 or bfloat16 fvec
    and float32 targets (the tracker's track features are fp32 in both
    models). Adds one to `corr_select_backward_cuda.launches` per call that
    launches them.

    `d_fvec` is summed tile by tile in shared memory and written once in
    fvec's dtype; both gradients are summed in a fixed order, so the same
    inputs give the same bits.
    """
    if not (fvec.is_cuda and all(t.device == fvec.device for t in (targets, idx, g))):
        raise ValueError("corr_select_backward_cuda needs fvec, targets, idx and g on one CUDA device")
    if fvec.dtype not in _DTYPE_CODES or targets.dtype != torch.float32:
        raise TypeError(
            f"corr_select_backward_cuda takes a float32 or bfloat16 fvec and float32 targets, "
            f"got {fvec.dtype}, {targets.dtype}"
        )
    if idx.dtype != torch.int64 or g.dtype != torch.float32:
        raise TypeError(f"corr_select_backward_cuda takes int64 idx and float32 g, got {idx.dtype}, {g.dtype}")
    if fvec.dim() != 3 or targets.dim() != 3 or idx.dim() != 3:
        raise ValueError("corr_select_backward_cuda takes [B, P, C], [B, N, C], [B, N, K], [B, N, K]")
    b, p, c = fvec.shape
    _, n, k = idx.shape
    if targets.shape != (b, n, c) or idx.shape[0] != b or g.shape != idx.shape:
        raise ValueError(
            f"corr_select_backward_cuda: shapes {tuple(fvec.shape)}, {tuple(targets.shape)}, "
            f"{tuple(idx.shape)}, {tuple(g.shape)} disagree"
        )
    vec = 16 // fvec.element_size()
    if c % vec:
        raise ValueError(f"corr_select_backward_cuda needs C a multiple of {vec} for {fvec.dtype} fvec, got {c}")
    if not all(t.is_contiguous() for t in (fvec, targets, idx, g)):
        raise ValueError("corr_select_backward_cuda takes contiguous tensors")
    if fvec.data_ptr() % 16 or targets.data_ptr() % 16:
        raise ValueError("corr_select_backward_cuda needs 16-byte aligned fvec and targets")
    if max(b * n * k, b * n) >= 2**31:
        raise ValueError("corr_select_backward_cuda: tensor too large for the kernel's indexing")
    d_fvec = torch.empty_like(fvec)
    d_targets = torch.empty_like(targets)
    if d_fvec.numel() == 0 and d_targets.numel() == 0:
        return d_fvec, d_targets
    rows, tiles, copies = corr_backward_plan(b, p, c, _multiprocessors(fvec.device.index))
    lib = _cuda.load("corr_bwd")
    with torch.cuda.device(fvec.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.corr_backward(
            fvec.data_ptr(), targets.data_ptr(), idx.data_ptr(), g.data_ptr(), d_targets.data_ptr(),
            d_fvec.data_ptr(), b, n, p, k, c, rows, tiles, copies, _DTYPE_CODES[fvec.dtype], stream,
        )
    _cuda.check(lib, status, "corr_select_backward_cuda")
    corr_select_backward_cuda.launches += 1
    return d_fvec, d_targets


corr_select_backward_cuda.launches = 0


def corr_select(fvec: torch.Tensor, targets: torch.Tensor, idx: torch.Tensor):
    """Correlations <targets[b, n], fvec[b, idx[b, n, k]]> -> [B, N, K] fp32,
    unscaled: the CUDA kernel for CUDA tensors, the plain version for CPU.
    Records the profiler span `mvtracker::corr`."""
    with span("corr"):
        if fvec.is_cuda:
            return corr_select_cuda(fvec, targets, idx)
        if fvec.device.type == "cpu":
            return corr_select_plain(fvec, targets, idx)
    raise ValueError(f"corr_select: unsupported device {fvec.device}")


def corr_select_backward(fvec: torch.Tensor, targets: torch.Tensor, idx: torch.Tensor, g: torch.Tensor):
    """Gradients of `corr_select` -> (d_fvec, d_targets): the CUDA kernel for
    CUDA tensors, the plain version for CPU."""
    if fvec.is_cuda:
        return corr_select_backward_cuda(fvec, targets, idx, g)
    if fvec.device.type == "cpu":
        return corr_select_backward_plain(fvec, targets, idx, g)
    raise ValueError(f"corr_select_backward: unsupported device {fvec.device}")


class CorrSelect(torch.autograd.Function):
    """`corr_select` with its hand-written backward, the counterpart of the
    JAX package's `custom_vjp` on `corr_select_pallas`.

    Takes the uncast `cloud_fvec` [B, P, C], `targets` [B, N, C], int64
    `idx` [B, N, K] and the compute dtype (None = float32). The forward
    casts both to the compute dtype and correlates (fp32 targets go to
    `corr_select` as they are, which rounds them to the cloud's dtype: no
    separate cast); the uncast tensors are what is saved. The backward works
    on them in fp32 and returns `d_fvec` in `cloud_fvec.dtype` and
    `d_targets` in `targets.dtype`, so a cast to bf16 rounds the forward's
    operands only, never the gradients' factors.
    """

    @staticmethod
    def forward(ctx, cloud_fvec, targets, idx, compute_dtype=None):
        dt = torch.float32 if compute_dtype is None else compute_dtype
        cloud_fvec, targets, idx = cloud_fvec.contiguous(), targets.contiguous(), idx.contiguous()
        ctx.save_for_backward(cloud_fvec, targets, idx)
        if targets.dtype != torch.float32:
            targets = targets.to(dt)
        return corr_select(cloud_fvec.to(dt), targets, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        cloud_fvec, targets, idx = ctx.saved_tensors
        d_fvec, d_targets = corr_select_backward(cloud_fvec, targets, idx, g.float().contiguous())
        return d_fvec, d_targets, None, None


def corr_sample(
    cloud_xyz: torch.Tensor,  # [B, P, 3]
    cloud_fvec: torch.Tensor,  # [B, P, C]
    targets: torch.Tensor,  # [B, M, C]
    coords_xyz: torch.Tensor,  # [B, M, 3]
    neighbor_idx: torch.Tensor,  # [B, M, K]
    groups: int = 1,
    add_neighbor_offset: bool = True,
    add_neighbor_xyz: bool = False,
    compute_dtype=None,  # torch.bfloat16 streams features in bf16
) -> torch.Tensor:
    """Correlation features per track point -> [B, M, K, F], laid out per
    neighbour as [corr (G) | offset (3)? | xyz (3)?].

    With one group the features go through `CorrSelect`, which casts them to
    `compute_dtype` (fp32 when None) itself, then the 1/sqrt(C) scale; with
    more groups through the gather and `grouped_correlation`.
    """
    if groups == 1:
        c = cloud_fvec.shape[-1]
        corr = CorrSelect.apply(cloud_fvec, targets, neighbor_idx.long(), compute_dtype)
        out = (corr[..., None] / math.sqrt(c)).to(targets.dtype)
    else:
        out = grouped_correlation(targets, gather_neighbors(cloud_fvec, neighbor_idx), groups)
    if add_neighbor_offset or add_neighbor_xyz:
        neighbor_xyz = gather_neighbors(cloud_xyz, neighbor_idx)
        if add_neighbor_offset:
            offset = neighbor_xyz - coords_xyz[:, :, None, :]
            out = torch.cat([out, offset.to(out.dtype)], dim=-1)
        if add_neighbor_xyz:
            out = torch.cat([out, neighbor_xyz.to(out.dtype)], dim=-1)
    return out
