"""Weights for the port.

- `params_from_flax(params)`: the JAX package's MVTracker params (nested
  dicts of numpy arrays, with or without the outer "params" key) -> a
  state dict for `mvtracker_torch.models.mvtracker.MVTracker`. The port's
  module names are the reference torch model's, so the JAX package's own
  `convert_reference_state_dict` maps the result straight back.
  The mapping is a fixed re-layout, so it carries any tree of that
  structure: a gradient tree, or AdamW's `mu` and `nu`.
- `opt_state_from_optax(opt_state)`: the optax state of the JAX package's
  optimizer -> the state of `mvtracker_torch.training.step.Optimizer`.
- `random_state_dict(model, seed)`: seeded numpy weights with the
  distributions flax initializes the JAX model with, for runs that need a
  model but no checkpoint.

Layouts: flax Conv (kh, kw, I, O) -> (O, I, kh, kw); flax Dense (I, O) ->
(O, I); LayerNorm scale/bias -> weight/bias.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _conv(p, name):
    out = {f"{name}.weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])
    return out


def _dense(p, name):
    out = {f"{name}.weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])
    return out


def _norm(p, name):
    return {f"{name}.weight": np.asarray(p["scale"]), f"{name}.bias": np.asarray(p["bias"])}


def _attn_block(p, name):
    key = "attn" if "attn" in p else "cross_attn"
    out = {}
    for lin in ("to_q", "to_kv", "to_out"):
        out.update(_dense(p[key][lin], f"{name}.{key}.{lin}"))
    out.update(_dense(p["mlp"]["fc1"], f"{name}.mlp.fc1"))
    out.update(_dense(p["mlp"]["fc2"], f"{name}.mlp.fc2"))
    if "norm_context" in p:
        out.update(_norm(p["norm_context"], f"{name}.norm_context"))
    return out


def _unstack(tree, i):
    """Slice depth i out of a stacked (axis 0) parameter tree."""
    return {k: _unstack(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in tree.items()}


def _space_blocks(layer, i):
    out = _attn_block(layer["sv2p"], f"updateformer.space_virtual2point_blocks.{i}")
    out.update(_attn_block(layer["svirt"], f"updateformer.space_virtual_blocks.{i}"))
    out.update(_attn_block(layer["sp2v"], f"updateformer.space_point2virtual_blocks.{i}"))
    return out


def params_from_flax(params) -> dict[str, torch.Tensor]:
    """Flax MVTracker params -> the port's state dict (fp32 tensors on the CPU)."""
    p = params.get("params", params)
    sd = {}
    fnet = p["fnet"]
    for name in ("conv1", "conv2", "conv3"):
        sd.update(_conv(fnet[name], f"fnet.{name}"))
    for layer in range(1, 5):
        for j in range(2):
            blk = fnet[f"layer{layer}_{j}"]
            prefix = f"fnet.layer{layer}.{j}"
            sd.update(_conv(blk["conv1"], f"{prefix}.conv1"))
            sd.update(_conv(blk["conv2"], f"{prefix}.conv2"))
            if "downsample" in blk:
                sd.update(_conv(blk["downsample"], f"{prefix}.downsample.0"))

    uf = p["updateformer"]
    sd.update(_dense(uf["input_transform"], "updateformer.input_transform"))
    sd["updateformer.virual_tracks"] = np.asarray(uf["virtual_tracks"])
    if "layers" in uf:  # 1:1 interleave, depth stacked on axis 0
        depth = np.asarray(uf["layers"]["time"]["mlp"]["fc1"]["kernel"]).shape[0]
        for i in range(depth):
            layer = _unstack(uf["layers"], i)
            sd.update(_attn_block(layer["time"], f"updateformer.time_blocks.{i}"))
            sd.update(_space_blocks(layer, i))
    else:
        i = 0
        while f"time_{i}" in uf:
            sd.update(_attn_block(uf[f"time_{i}"], f"updateformer.time_blocks.{i}"))
            i += 1
        j = 0
        while f"sv2p_{j}" in uf:
            sd.update(_space_blocks({k: uf[f"{k}_{j}"] for k in ("sv2p", "svirt", "sp2v")}, j))
            j += 1
    for fi, ti in ((0, 0), (1, 2), (2, 4)):
        sd.update(_dense(uf[f"flow_head_{fi}"], f"updateformer.flow_head.{ti}"))

    sd.update(_norm(p["ffeats_norm"], "ffeats_norm"))
    sd.update(_dense(p["ffeats_updater"], "ffeats_updater.0"))
    sd.update(_dense(p["vis_predictor"], "vis_predictor.0"))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def opt_state_from_optax(opt_state) -> dict:
    """The optax state of `mvtracker_tpu.training.step.make_optimizer` (a
    nested tuple whose AdamW part has `count`, `mu` and `nu`; arrays as
    numpy) -> {"count", "mu", "nu"} with `mu` and `nu` under the port's
    parameter names."""

    def find(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                hit = find(child)
                if hit is not None:
                    return hit
        return None

    adam = find(opt_state)
    if adam is None:
        raise ValueError("opt_state_from_optax: no Adam state (count, mu, nu) in the given optimizer state")
    return {"count": int(adam.count), "mu": params_from_flax(adam.mu), "nu": params_from_flax(adam.nu)}


def _truncated_normal(rng, shape, std):
    # flax's truncated_normal(stddev) draws within 2 std and rescales so the
    # result has standard deviation `std`.
    x = rng.standard_normal(shape)
    while True:
        bad = np.abs(x) > 2.0
        if not bad.any():
            break
        x[bad] = rng.standard_normal(int(bad.sum()))
    return x * (std / 0.87962566103423978)


def random_state_dict(model: nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Seeded numpy weights for every tensor of `model.state_dict()`, drawn
    from the distributions flax initializes the JAX MVTracker with:
    convs kaiming-normal (fan out), attention and MLP denses xavier-uniform,
    the flow head truncated-normal (std 0.001), other denses lecun-normal,
    virtual tracks standard normal, norms one/zero, biases zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("virual_tracks"):
            w = rng.standard_normal(shape)
        elif name.endswith(".bias"):
            w = np.zeros(shape)
        elif "norm" in name.rsplit(".", 2)[-2]:
            w = np.ones(shape)
        elif len(shape) == 4:
            fan_out = shape[0] * shape[2] * shape[3]
            w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_out)
        elif "flow_head" in name:
            w = _truncated_normal(rng, shape, 0.001)
        elif name.startswith("updateformer."):
            limit = np.sqrt(6.0 / (shape[0] + shape[1]))
            w = rng.uniform(-limit, limit, size=shape)
        else:
            w = _truncated_normal(rng, shape, 1.0 / np.sqrt(shape[1]))
        out[name] = torch.from_numpy(w.astype(np.float32))
    return out
