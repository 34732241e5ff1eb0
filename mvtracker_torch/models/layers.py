"""Dense and convolution layers that compute in a chosen dtype.

They mirror flax's `nn.Dense(dtype=...)` and `nn.Conv(dtype=...)`: the
parameters stay fp32, and with `dtype=torch.bfloat16` the input, weight and
bias are cast to bf16 for the product (fp32 accumulation on the card) and
the output is bf16. With `dtype=None` the layer runs in the parameters'
dtype, fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, bias=True, dtype=None, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, dtype=None, device=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def layer_norm_noaffine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without parameters over the last axis, statistics in fp32,
    result in the input dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """Affine LayerNorm; statistics in fp32, result in `dtype` (input
    dtype when None), as flax's `nn.LayerNorm(dtype=...)`."""

    def __init__(self, dim, eps=1e-5, dtype=None, device=None):
        super().__init__(dim, eps=eps, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype or x.dtype)
