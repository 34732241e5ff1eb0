"""Sin/cos embeddings (L0), counterpart of `mvtracker_tpu/utils/embeddings.py`.

Two frequency conventions, as in the JAX package:
- `sincos_1d` family: omega_i = 1 / 10000^(2i/D), output [sin | cos];
- `coord_embedding_{2,3,4}d`: div_term_i = 2i * 1000 / C, sin and cos
  interleaved per channel, raw coordinates prepended in 2D and appended in
  3D and 4D (the reference's quirk, kept);
- `fourier_embedding`: sin and cos of x times frequencies spaced
  logarithmically (or linearly) between 1 and 2^max_freq_log2.
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


def sincos_2d(embed_dim: int, grid_xy: torch.Tensor) -> torch.Tensor:
    """[..., 2] coords -> [..., embed_dim]; each axis gets embed_dim/2."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    emb = torch.cat([sincos_1d(embed_dim // 2, grid_xy[..., i]) for i in range(2)], dim=-1)
    return emb.reshape(*grid_xy.shape[:-1], embed_dim)


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


def coord_embedding_2d(xy: torch.Tensor, c: int, cat_coords: bool = True) -> torch.Tensor:
    """[..., 2] -> [..., (2 +) 2*C], coordinates prepended."""
    pe = torch.cat([_interleaved_sincos(xy[..., i : i + 1], c) for i in range(2)], dim=-1)
    if cat_coords:
        pe = torch.cat([xy, pe], dim=-1)
    return pe


def coord_embedding_3d(xyz: torch.Tensor, c: int, cat_coords: bool = True) -> torch.Tensor:
    """Flow embedding [..., 3] -> [..., 3*C (+3)], coordinates appended."""
    pe = torch.cat([_interleaved_sincos(xyz[..., i : i + 1], c) for i in range(3)], dim=-1)
    if cat_coords:
        pe = torch.cat([pe, xyz], dim=-1)
    return pe


def coord_embedding_4d(xyzw: torch.Tensor, c: int, cat_coords: bool = True) -> torch.Tensor:
    """[..., 4] -> [..., 4*C (+4)], coordinates appended."""
    pe = torch.cat([_interleaved_sincos(xyzw[..., i : i + 1], c) for i in range(4)], dim=-1)
    if cat_coords:
        pe = torch.cat([pe, xyzw], dim=-1)
    return pe


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """fp32 `num` points from `start` to `stop` as `jnp.linspace` computes
    them (start * (1 - s) + stop * s, s = i / (num - 1), the end exact);
    `torch.linspace` rounds otherwise."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    step = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step, torch.tensor([stop], dtype=torch.float32)])


def fourier_embedding(
    x: torch.Tensor,
    n_freqs: int,
    max_freq_log2: float,
    include_input: bool = True,
    log_sampling: bool = True,
    rescale: float = 1.0,
) -> torch.Tensor:
    """[..., D] -> [..., (D +) 2*n_freqs*D]: x / rescale first, then sin and
    cos of x times each frequency in turn."""
    if log_sampling:
        freqs = 2.0 ** _linspace(0.0, max_freq_log2, n_freqs)
    else:
        freqs = _linspace(2.0**0.0, 2.0**max_freq_log2, n_freqs)
    out = [x / rescale] if include_input else []
    for f in freqs.tolist():
        out += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(out, dim=-1)
