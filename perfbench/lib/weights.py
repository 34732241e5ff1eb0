"""Seeded weights for a model's state dict, made on its device in one draw.

Every entry gets a rule by its name and shape (the rules of the
configuration file's `init`):
- biases 0; norm weights 1 (their biases 0);
- `virual_tracks` (the update transformer's virtual tracks) N(0, 1);
- the last layer of the flow head N(0, (flow_head_gain / sqrt(fan_in))^2),
  so that a refinement step moves a track by a fraction of a cloud cell;
- every other dense or convolution weight N(0, 1 / fan_in) (LeCun normal).

One `torch.randn` call on a seeded generator of the device draws the whole
parameter vector, which is then cut into the entries and scaled. The same
seed gives the same weights on the same device.
"""

from __future__ import annotations

import math

import torch


def rule(name: str, shape: tuple, flow_head_gain: float) -> tuple[str, float]:
    """(kind, std) of one entry: kind "zero", "one" or "normal"."""
    if name.endswith(".bias"):
        return "zero", 0.0
    if "norm" in name.rsplit(".", 2)[-2]:  # the module that owns the leaf
        return "one", 0.0
    if name.endswith("virual_tracks"):
        return "normal", 1.0
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    if name.endswith("flow_head.4.weight"):
        std *= flow_head_gain
    return "normal", std


def seeded_state(shapes: dict, seed: int, device, flow_head_gain: float) -> dict:
    """{name: float32 tensor} for {name: shape}, drawn in one call."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        kind, std = rule(name, tuple(shape), flow_head_gain)
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    return out
