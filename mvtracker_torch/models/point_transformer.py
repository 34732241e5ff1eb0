"""Serialized point-cloud transformer (L2), counterpart of
`mvtracker_tpu/models/point_transformer.py`: the PTv3-like backbone that
refines the level-0 fused cloud's features (`use_point_transformer`).

Per block:
1. quantize each cloud's xyz to a 1024^3 grid over its own bounding box and
   compute Morton (z-order) keys, in xyz order in even blocks and zxy order
   in odd ones;
2. sort the points by key, stably (ties, points of one voxel, keep their
   cloud order, as `jnp.argsort` does);
3. pre-LN attention and MLP over contiguous groups of `group_size` sorted
   points; odd blocks roll the sequence by half a group first. The last
   group is zero-padded and its padding rows are masked from the keys;
4. scatter the features back to the cloud's order.

The module runs on a batch of clouds [B, P, 3], [B, P, C] (the JAX module
runs one cloud under `vmap`). Layers are the update transformer's
`Attention` and `Mlp` and its parameter-free LayerNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvtracker_torch.models.layers import Linear, layer_norm_noaffine
from mvtracker_torch.models.updateformer import Attention, Mlp

ORDERS = ((0, 1, 2), (2, 0, 1))  # Morton interleave orders, by block parity


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 `v` so that two zero bits follow each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_code(xyz: torch.Tensor, bits: int = 10, order=(0, 1, 2)) -> torch.Tensor:
    """Z-order keys (int32) of points [..., P, 3], each cloud normalized to
    the unit cube by its own bounds; `order` names the axis of each
    interleave slot."""
    lo = xyz.detach().amin(dim=-2, keepdim=True)
    hi = xyz.detach().amax(dim=-2, keepdim=True)
    q = ((xyz - lo) / torch.clamp(hi - lo, min=1e-6) * (2**bits - 1)).to(torch.int32)
    a, b, c = (_spread_bits(q[..., axis]) for axis in order)
    return a | (b << 1) | (c << 2)


class SerializedAttentionBlock(nn.Module):
    """Pre-LN attention and MLP over contiguous groups of a sorted sequence."""

    def __init__(self, dim, num_heads=4, group_size=128, shift=False, dtype=None, device=None):
        super().__init__()
        self.group_size = group_size
        self.shift = shift
        self.attn = Attention(dim, num_heads=num_heads, dim_head=max(dim // num_heads, 16), dtype=dtype, device=device)
        self.mlp = Mlp(dim, dim * 4, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, P, C], sorted
        b, p, c = x.shape
        g = self.group_size
        if self.shift:
            x = torch.roll(x, g // 2, dims=1)
        pad = (-p) % g
        groups = F.pad(x, (0, 0, 0, pad)).reshape(-1, g, c)  # [B * P/G, G, C]
        key_mask = None
        if pad:
            # The zero rows padded after the roll must not act as keys.
            key_mask = (torch.arange(p + pad, device=x.device) < p).reshape(-1, g).repeat(b, 1)
        groups = groups + self.attn(layer_norm_noaffine(groups), key_mask=key_mask)
        groups = groups + self.mlp(layer_norm_noaffine(groups))
        out = groups.reshape(b, p + pad, c)[:, :p]
        if self.shift:
            out = torch.roll(out, -(g // 2), dims=1)
        return out


class SerializedPointTransformer(nn.Module):
    """Refines per-point features of fused clouds: xyz [B, P, 3], feats
    [B, P, C] -> [B, P, C], a residual on the input features in their dtype."""

    def __init__(self, in_dim, dim=128, depth=4, num_heads=4, group_size=128, dtype=None, device=None):
        super().__init__()
        self.proj_in = Linear(in_dim, dim, dtype=dtype, device=device)
        self.blocks = nn.ModuleList(
            SerializedAttentionBlock(dim, num_heads, group_size, shift=bool(d % 2), dtype=dtype, device=device)
            for d in range(depth)
        )
        self.proj_out = Linear(dim, in_dim, dtype=dtype, device=device)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        x = self.proj_in(feats)
        for d, block in enumerate(self.blocks):
            perm = torch.argsort(morton_code(xyz, order=ORDERS[d % 2]), dim=-1, stable=True)
            inv = torch.argsort(perm, dim=-1)
            xs = block(torch.gather(x, 1, perm[..., None].expand(-1, -1, x.shape[-1])))
            x = torch.gather(xs, 1, inv[..., None].expand(-1, -1, xs.shape[-1]))
        return (feats + self.proj_out(x)).to(feats.dtype)
