"""Convolutional feature encoder (L2), counterpart of `mvtracker_tpu/models/encoder.py`.

Stride-2 7x7 stem, four residual stages at (64, 96, 128, 128) channels with
strides (1, 2, 2, 2), every stage resized (bilinear, align_corners=True) to
H/stride and concatenated, then a 3x3 conv to 2*out and a 1x1 conv to out.
Instance norm without parameters after every conv. The port runs NCHW; the
JAX package runs NHWC. Module names follow the reference state dict
(`fnet.layerX.Y.conv1`, ...).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mvtracker_torch.models.layers import Conv2d


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the spatial axes of NCHW, no parameters.

    Moments E[x] and E[x^2] in fp32, the variance clamped at 0 (the one-pass
    form can cancel slightly negative), result in the input dtype.
    """
    xf = x.float()
    m1 = xf.mean(dim=(2, 3), keepdim=True)
    m2 = (xf * xf).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    return ((xf - m1) * torch.rsqrt(var + eps)).to(x.dtype)


def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Dense 1D align-corners linear interpolation matrix [n_out, n_in]."""
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    w = np.zeros((n_out, n_in), np.float32)
    if n_out == 1:
        w[0, 0] = 1.0
        return w
    pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = pos - lo
    w[np.arange(n_out), lo] += 1.0 - frac
    w[np.arange(n_out), hi] += frac
    return w


def bilinear_resize_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NCHW with align_corners=True, as two dense
    interpolation products (one per spatial axis), like the JAX package."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    wh = torch.from_numpy(_interp_matrix(out_h, h)).to(device=x.device, dtype=x.dtype)
    ww = torch.from_numpy(_interp_matrix(out_w, w)).to(device=x.device, dtype=x.dtype)
    x = torch.einsum("oh,bchw->bcow", wh, x)
    return torch.einsum("ow,bchw->bcho", ww, x)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with instance norm, optional strided 1x1 shortcut."""

    def __init__(self, in_planes, planes, stride=1, dtype=None, device=None):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1, dtype=dtype, device=device)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, dtype=dtype, device=device)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            # A Sequential so the weight is named `downsample.0`, as in the
            # reference (whose Sequential also holds the parameter-free norm).
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride, dtype=dtype, device=device)
            )

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Multi-scale CNN encoder: [B, 3, H, W] -> [B, output_dim, H/stride, W/stride] fp32."""

    def __init__(self, output_dim=128, stride=4, dtype=None, device=None):
        super().__init__()
        self.stride = stride
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, **kw)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, 1, **kw), ResidualBlock(64, 64, 1, **kw))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2, **kw), ResidualBlock(96, 96, 1, **kw))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, 2, **kw), ResidualBlock(128, 128, 1, **kw))
        self.layer4 = nn.Sequential(ResidualBlock(128, 128, 2, **kw), ResidualBlock(128, 128, 1, **kw))
        self.conv2 = Conv2d(64 + 96 + 128 + 128, output_dim * 2, 3, padding=1, **kw)
        self.conv3 = Conv2d(output_dim * 2, output_dim, 1, **kw)

    def forward(self, x):
        h, w = x.shape[-2:]
        out_h, out_w = h // self.stride, w // self.stride
        x = F.relu(instance_norm(self.conv1(x)))
        a = self.layer1(x)
        b = self.layer2(a)
        c = self.layer3(b)
        d = self.layer4(c)
        feats = torch.cat([bilinear_resize_align_corners(t, out_h, out_w) for t in (a, b, c, d)], dim=1)
        feats = F.relu(instance_norm(self.conv2(feats)))
        return self.conv3(feats).float()
