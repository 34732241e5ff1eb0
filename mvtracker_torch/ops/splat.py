"""Softmax splatting (L1), counterpart of `mvtracker_tpu/ops/splat.py`.

A bilinear scatter-add: each point deposits its value times a weight on the
four cells around its continuous (x, y), and the canvas is normalised by
the deposited weights. `softsplat` warps an image through a flow field that
way; `splat_points` scatters a point set's features onto a plane (the
triplane construction of `models/spatracker.py`).

The scatter is `index_put_(accumulate=True)` on the flattened canvas, which
autograd differentiates (its backward is a gather). Each cell sums its
deposits in another order on the card than on the CPU, which adds in point
order; on an H100 two runs gave the same bits, the same as under
`torch.use_deterministic_algorithms` (`PERF.md`). Like the JAX module,
a non-finite position deposits nothing and a corner outside the canvas
deposits nothing.
"""

from __future__ import annotations

import torch


def _bilinear_scatter(values, weights, x, y, height: int, width: int):
    """Scatter-add values * weights bilinearly into a canvas.

    values [B, P, C], weights [B, P], x and y [B, P] continuous targets ->
    (accumulated values [B, H, W, C], accumulated weights [B, H, W])."""
    b, p, c = values.shape
    finite = torch.isfinite(x) & torch.isfinite(y)
    # A non-finite point moves to -2, whose four corners all lie outside.
    x = torch.where(finite, x, torch.full_like(x, -2.0))
    y = torch.where(finite, y, torch.full_like(y, -2.0))
    x0, y0 = torch.floor(x), torch.floor(y)
    acc = values.new_zeros(b * height * width, c)
    acc_w = values.new_zeros(b * height * width)
    base = (torch.arange(b, device=values.device) * (height * width))[:, None]
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cx, cy = x0 + dx, y0 + dy
        w_tot = (1 - torch.abs(x - cx)) * (1 - torch.abs(y - cy)) * weights
        in_bounds = finite & (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
        w_tot = torch.where(in_bounds, w_tot, torch.zeros_like(w_tot))
        # Clamped before the cast (torch wraps where JAX saturates): a corner
        # outside the canvas adds its zero deposit to an edge cell, so the
        # shapes stay fixed and nothing waits for the device.
        xi = cx.clamp(0, width - 1).long()
        yi = cy.clamp(0, height - 1).long()
        flat = (base + yi * width + xi).reshape(-1)
        acc = acc.index_put((flat,), (values * w_tot[..., None]).reshape(-1, c), accumulate=True)
        acc_w = acc_w.index_put((flat,), w_tot.reshape(-1), accumulate=True)
    return acc.reshape(b, height, width, c), acc_w.reshape(b, height, width)


def softsplat(ten_in, ten_flow, ten_metric=None, mode: str = "soft", eps: float = 1e-7):
    """Splat an image [B, H, W, C] through a flow [B, H, W, 2] (dx, dy).

    mode "sum" adds, "avg" normalises by the deposited weight, "soft"
    weights each source pixel by exp(metric [B, H, W]) and normalises."""
    b, h, w, c = ten_in.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, device=ten_in.device), torch.arange(w, device=ten_in.device), indexing="ij"
    )
    tx = (xs[None] + ten_flow[..., 0]).reshape(b, h * w)
    ty = (ys[None] + ten_flow[..., 1]).reshape(b, h * w)
    values = ten_in.reshape(b, h * w, c)
    if mode in ("sum", "avg"):
        weights = torch.ones(b, h * w, dtype=ten_in.dtype, device=ten_in.device)
    elif mode == "soft":
        if ten_metric is None:
            raise ValueError("softsplat mode 'soft' needs ten_metric")
        weights = torch.exp(ten_metric).reshape(b, h * w)
    else:
        raise ValueError(f"unknown softsplat mode: {mode}")
    acc, acc_w = _bilinear_scatter(values, weights, tx, ty, h, w)
    if mode == "sum":
        return acc
    return acc / (acc_w[..., None] + eps)


def splat_points(points_xy, features, metric, height: int, width: int, eps: float = 1e-7):
    """Softmax-splat points [B, P, 2] (continuous plane coords) with
    features [B, P, C] and weight logits metric [B, P] onto a [B, H, W, C]
    plane."""
    acc, acc_w = _bilinear_scatter(
        features, torch.exp(metric), points_xy[..., 0], points_xy[..., 1], height, width
    )
    return acc / (acc_w[..., None] + eps)
