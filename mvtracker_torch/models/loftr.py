"""LoFTR-style local feature transformer (L2), counterpart of
`mvtracker_tpu/models/loftr.py`.

The update transformer's support memory (`support_memory_tokens`) runs
this between the track tokens and a learned bank of memory tokens. Two
attention forms, chosen by `attention=`:

- "full": softmax attention, the default, as the reference runs it. The
  logits are taken to fp32 for the softmax and masked pairs get float32's
  lowest value;
- "linear": the elu(x) + 1 kernelised attention, O(L D^2) instead of
  O(L^2 D), with the reference's divide-by-S guard against overflow.

Both are written as einsum and softmax, as the JAX module is, so that the
two sum alike. A layer is bias-free q/k/v/merge projections, a LayerNorm on
the message, a feed-forward over [x, message] (2d -> 2d -> d, bias-free,
ReLU), a second LayerNorm and a residual add. State-dict names are the
reference's (`layers.{i}.q_proj`, `layers.{i}.mlp.0`, ...).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mvtracker_torch.models.layers import LayerNorm, Linear


def linear_attention(q, k, v, q_mask=None, kv_mask=None, eps: float = 1e-6):
    """Kernelised attention: q [B, L, H, D], k and v [B, S, H, D], masks
    [B, L] and [B, S] bool -> [B, L, H, D]."""
    q = F.elu(q) + 1.0
    k = F.elu(k) + 1.0
    if q_mask is not None:
        q = q * q_mask[:, :, None, None]
    if kv_mask is not None:
        k = k * kv_mask[:, :, None, None]
        v = v * kv_mask[:, :, None, None]
    s_len = v.shape[1]
    v = v / s_len
    kv = torch.einsum("bshd,bshv->bhdv", k, v)
    z = 1.0 / (torch.einsum("blhd,bhd->blh", q, k.sum(dim=1)) + eps)
    return torch.einsum("blhd,bhdv->blhv", q, kv) * z[..., None] * s_len


def full_attention(q, k, v, q_mask=None, kv_mask=None):
    """Softmax attention, fp32 softmax: q [B, L, H, D], k and v [B, S, H, D]
    -> [B, L, H, D]. Pairs whose key (or, with a key mask, query) is masked
    get float32's lowest logit."""
    sim = torch.einsum("blhd,bshd->bhls", q, k) * q.shape[-1] ** -0.5
    sim = sim.float()
    if kv_mask is not None:
        mask = kv_mask[:, None, None, :]
        if q_mask is not None:
            mask = mask & q_mask[:, None, :, None]
        sim = sim.masked_fill(~mask, torch.finfo(torch.float32).min)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.einsum("bhls,bshd->blhd", attn, v)


class LoFTRLayer(nn.Module):
    """One self- or cross-attention encoder layer."""

    def __init__(self, d_model: int, nhead: int, attention: str = "full", device=None):
        super().__init__()
        if attention not in ("full", "linear"):
            raise ValueError(f"attention must be 'full' or 'linear', got {attention!r}")
        self.nhead, self.attention = nhead, attention
        self.q_proj = Linear(d_model, d_model, bias=False, device=device)
        self.k_proj = Linear(d_model, d_model, bias=False, device=device)
        self.v_proj = Linear(d_model, d_model, bias=False, device=device)
        self.merge = Linear(d_model, d_model, bias=False, device=device)
        self.mlp = nn.Sequential(
            Linear(2 * d_model, 2 * d_model, bias=False, device=device),
            nn.ReLU(),
            Linear(2 * d_model, d_model, bias=False, device=device),
        )
        self.norm1 = LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x, source, x_mask=None, source_mask=None):
        b, _, d_model = x.shape
        q = self.q_proj(x).reshape(b, -1, self.nhead, d_model // self.nhead)
        k = self.k_proj(source).reshape(b, -1, self.nhead, d_model // self.nhead)
        v = self.v_proj(source).reshape(b, -1, self.nhead, d_model // self.nhead)
        attend = linear_attention if self.attention == "linear" else full_attention
        message = attend(q, k, v, x_mask, source_mask).reshape(b, -1, d_model)
        message = self.norm1(self.merge(message))
        message = self.norm2(self.mlp(torch.cat([x, message], dim=-1)))
        return x + message


class LocalFeatureTransformer(nn.Module):
    """Alternating self/cross layers over two token sets feat0 [B, L, C] and
    feat1 [B, S, C]. A "self" layer updates each set against itself with the
    same weights; a "cross" layer updates feat0 against feat1, then feat1
    against the updated feat0 (the reference's order)."""

    def __init__(
        self,
        d_model: int,
        nhead: int = 4,
        layer_names: Sequence[str] = ("self", "cross", "self", "cross", "self", "cross"),
        attention: str = "full",
        device=None,
    ):
        super().__init__()
        for name in layer_names:
            if name not in ("self", "cross"):
                raise KeyError(f"unknown layer name {name!r}")
        self.layer_names = tuple(layer_names)
        self.layers = nn.ModuleList([LoFTRLayer(d_model, nhead, attention, device=device) for _ in layer_names])

    def forward(self, feat0, feat1, mask0: Optional[torch.Tensor] = None, mask1: Optional[torch.Tensor] = None):
        for layer, name in zip(self.layers, self.layer_names):
            if name == "self":
                feat0 = layer(feat0, feat0, mask0, mask0)
                feat1 = layer(feat1, feat1, mask1, mask1)
            else:
                feat0 = layer(feat0, feat1, mask0, mask1)
                feat1 = layer(feat1, feat0, mask1, mask0)
        return feat0, feat1
