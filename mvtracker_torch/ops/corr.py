"""Grouped neighbour correlation (L1), counterpart of `mvtracker_tpu/ops/corr.py`.

Gather the k nearest neighbours' feature vectors from a fused cloud and
correlate them with per-track target features:

    corr[b, m, k, g] = <target[b, m, g, :], fvec[b, idx[b, m, k], g, :]> / sqrt(C / G)

The single-group case, the tracker's configuration, goes through
`corr_select`: the CUDA kernel `csrc/corr.cu` on CUDA tensors (it replaces
the forward of `mvtracker_tpu/ops/corr_pallas.py::corr_select_pallas`;
design note in the source) and `corr_select_plain`, a gather and an einsum,
on CPU tensors. Neighbour offsets ride along in the `[corr | offset | xyz]`
layout of the JAX package.
"""

from __future__ import annotations

import math

import torch

from mvtracker_torch.ops import _cuda

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
    [B, N, K] fp32, unscaled; an index outside [0, P) gives 0."""
    p = fvec.shape[1]
    valid = (idx >= 0) & (idx < p)
    rows = gather_neighbors(fvec, torch.where(valid, idx, torch.zeros_like(idx)))
    corr = torch.einsum("bnc,bnkc->bnk", targets.float(), rows.float())
    return torch.where(valid, corr, torch.zeros_like(corr))


def corr_select_cuda(fvec: torch.Tensor, targets: torch.Tensor, idx: torch.Tensor):
    """The CUDA kernel `csrc/corr.cu`; same contract as `corr_select_plain`.
    Adds one to `corr_select_cuda.launches` per kernel launch."""
    if not (fvec.is_cuda and targets.device == fvec.device and idx.device == fvec.device):
        raise ValueError("corr_select_cuda needs fvec, targets and idx on one CUDA device")
    if fvec.dtype not in _DTYPE_CODES or targets.dtype != fvec.dtype:
        raise TypeError(
            f"corr_select_cuda takes float32 or bfloat16 of one type, got {fvec.dtype}, {targets.dtype}"
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
            b, n, p, k, c, _DTYPE_CODES[fvec.dtype], stream,
        )
    _cuda.check(lib, status, "corr_select_cuda")
    corr_select_cuda.launches += 1
    return out


corr_select_cuda.launches = 0


def corr_select(fvec: torch.Tensor, targets: torch.Tensor, idx: torch.Tensor):
    """Correlations <targets[b, n], fvec[b, idx[b, n, k]]> -> [B, N, K] fp32,
    unscaled: the CUDA kernel for CUDA tensors, the plain version for CPU."""
    if fvec.is_cuda:
        return corr_select_cuda(fvec, targets, idx)
    if fvec.device.type == "cpu":
        return corr_select_plain(fvec, targets, idx)
    raise ValueError(f"corr_select: unsupported device {fvec.device}")


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

    With one group the features go through `corr_select` in `compute_dtype`
    (fp32 when None), then the 1/sqrt(C) scale; with more groups through
    the gather and `grouped_correlation`.
    """
    if groups == 1:
        dt = torch.float32 if compute_dtype is None else compute_dtype
        c = cloud_fvec.shape[-1]
        corr = corr_select(
            cloud_fvec.to(dt).contiguous(), targets.to(dt).contiguous(), neighbor_idx.long().contiguous()
        )
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
