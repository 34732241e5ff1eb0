"""Sin/cos embeddings (L0), counterpart of `mvtracker_tpu/utils/embeddings.py`.

Two frequency conventions, as in the JAX package:
- `sincos_1d` family: omega_i = 1 / 10000^(2i/D), output [sin | cos];
- `coord_embedding_3d`: div_term_i = 2i * 1000 / C, sin and cos interleaved
  per channel, raw coordinates appended.
"""

from __future__ import annotations

import torch


def sincos_1d(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    """[...] positions (flattened to [M]) -> [M, embed_dim] = [sin | cos]."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / torch.pow(10000.0, omega / (embed_dim / 2.0))
    out = pos.reshape(-1).float()[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_3d(embed_dim: int, grid_xyz: torch.Tensor) -> torch.Tensor:
    """[..., 3] coords -> [..., embed_dim]; each axis gets embed_dim/3."""
    if embed_dim % 3:
        raise ValueError(f"embed_dim must be a multiple of 3, got {embed_dim}")
    d = embed_dim // 3
    emb = torch.cat([sincos_1d(d, grid_xyz[..., i]) for i in range(3)], dim=-1)
    return emb.reshape(*grid_xyz.shape[:-1], embed_dim)


def _interleaved_sincos(v: torch.Tensor, c: int) -> torch.Tensor:
    """[..., 1] coords -> [..., C]: even channels sin, odd channels cos."""
    div_term = torch.arange(0, c, 2, dtype=torch.float32, device=v.device) * (1000.0 / c)
    arg = v * div_term
    return torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1).reshape(*v.shape[:-1], c)


def coord_embedding_3d(xyz: torch.Tensor, c: int, cat_coords: bool = True) -> torch.Tensor:
    """Flow embedding [..., 3] -> [..., 3*C (+3)], coordinates appended."""
    pe = torch.cat([_interleaved_sincos(xyz[..., i : i + 1], c) for i in range(3)], dim=-1)
    if cat_coords:
        pe = torch.cat([pe, xyz], dim=-1)
    return pe
