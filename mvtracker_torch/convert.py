"""Weights for the port.

- `load_flax_msgpack(path)`: read a params file that flax's
  `serialization.msgpack_serialize` wrote (the release artifact,
  `release/mvtracker_medium_synth.msgpack`) into nested dicts of numpy
  arrays, with a msgpack decoder of its own: neither `msgpack` nor `flax`
  is needed. bf16 leaves come back as fp32, widened exactly.
- `read_flax_params(path)`: such a file as the port's state dict, with the
  leaves no parameter reads; `load_release(path, model)`: that file into
  `model`, strictly: any leaf missing, extra or of another shape raises and
  is named.
- `params_from_flax(params)`: the JAX package's MVTracker params (nested
  dicts of numpy arrays, with or without the outer "params" key) -> a
  state dict for `mvtracker_torch.models.mvtracker.MVTracker`, or for the
  variants that share its tree (`MultiViewSpaTracker`, `CoTracker2D`; the
  update transformer's LoFTR memory `gnn` and `support_memory` too). The port's
  module names are the reference torch model's, so the JAX package's own
  `convert_reference_state_dict` maps the result straight back.
  The mapping is a fixed re-layout, so it carries any tree of that
  structure: a gradient tree, or AdamW's `mu` and `nu`.
- `updateformer_from_flax(params)`, `point_transformer_from_flax(params)`:
  the same for the update transformer alone, and for the point
  transformer alone (`params_from_flax` maps it inside a tracker's tree,
  under "cloud_backbone").
- `opt_state_from_optax(opt_state)`: the optax state of the JAX package's
  optimizer -> the state of `mvtracker_torch.training.step.Optimizer`.
- `random_state_dict(model, seed)`: seeded numpy weights with the
  distributions flax initializes the JAX model with, for runs that need a
  model but no checkpoint (the VGGT's by `models/vggt.py::init_rule`).
- `vggt_params_from_flax(params)`: the JAX package's VGGT params -> a state
  dict for `mvtracker_torch.models.vggt.VGGT`, whose names are the
  reference's (facebook/VGGT-1B); `load_vggt_checkpoint(path)`: a
  downloaded VGGT torch checkpoint as that state dict, the keys the model
  has no part for (the track head) left out, as JAX's converter does.

Layouts: flax Conv (kh, kw, I, O) -> (O, I, kh, kw); flax Dense (I, O) ->
(O, I); LayerNorm scale/bias -> weight/bias; flax ConvTranspose (kh, kw, I,
O) -> (I, O, kh, kw) with the taps flipped in both spatial axes.
"""

from __future__ import annotations

import logging
import re
import struct

import numpy as np
import torch
from torch import nn

# ---------------------------------------------------------------------------
# msgpack, as far as flax's params files use it
# ---------------------------------------------------------------------------

_EXT_NDARRAY = 1  # flax's ext code for an ndarray: packed (shape, dtype name, C-order bytes)
_FIXED = {  # format byte -> (struct code of the big-endian value, its size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    """msgpack decoder over one buffer. Strings decode to `str` (or stay
    `bytes` with `raw=True`, as flax decodes an ndarray's header), binary
    data is sliced from a memoryview without copying, and ext type 1 becomes
    a numpy array."""

    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated data at byte {self.pos} (need {n} more)")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def _uint(self, size: int) -> int:
        return struct.unpack(_LENGTH[size], self._take(size))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        payload = self._take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(
                f"msgpack: ext type {code} (flax uses 2 for a complex scalar and 3 for a numpy scalar) "
                "is not supported; a params file holds arrays only"
            )
        return _ndarray_from_ext(payload)

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return self._array(b & 0x0F)
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            code, size = _FIXED[b]
            return struct.unpack(code, self._take(size))[0]
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return self._take(self._uint(1 << (b - 0xC4)))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            return self._ext(self._uint(1 << (b - 0xC7)))
        if 0xD4 <= b <= 0xD8:  # fixext 1..16
            return self._ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return self._str(self._uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):  # array 16/32
            return self._array(self._uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self._uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: unknown format byte 0x{b:02x} at byte {self.pos - 1}")


def _ndarray_from_ext(payload: memoryview) -> np.ndarray:
    """flax's ndarray ext payload -> a numpy array that owns its memory.
    bfloat16 (not a numpy dtype) is read as uint16 and widened to fp32 by
    a 16-bit shift, which is exact."""
    reader = _Reader(payload, raw=True)
    shape, dtype_name, buffer = reader.read()
    if reader.pos != len(payload):
        raise ValueError("msgpack: trailing bytes in an ndarray ext payload")
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape).copy()


def _reject_chunked(tree, path=""):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError(f"{path or 'the file'}: chunked arrays (leaves over 1 GiB) are not supported")
        for key, value in tree.items():
            _reject_chunked(value, f"{path}/{key}")


def load_flax_msgpack(path: str) -> dict:
    """A flax msgpack params file -> nested dicts of numpy arrays (bf16
    leaves as fp32), the tree `flax.serialization.msgpack_restore` gives."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} bytes after the msgpack object")
    _reject_chunked(tree)
    return tree


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


def _space_blocks(layer, i, prefix="updateformer."):
    out = _attn_block(layer["sv2p"], f"{prefix}space_virtual2point_blocks.{i}")
    out.update(_attn_block(layer["svirt"], f"{prefix}space_virtual_blocks.{i}"))
    out.update(_attn_block(layer["sp2v"], f"{prefix}space_point2virtual_blocks.{i}"))
    return out


def _updateformer(uf, prefix):
    sd = _dense(uf["input_transform"], f"{prefix}input_transform")
    sd[f"{prefix}virual_tracks"] = np.asarray(uf["virtual_tracks"])
    # 1:1 interleave, depth stacked on axis 0 (`migrate_updateformer_layout`
    # brings older files to this layout)
    depth = np.asarray(uf["layers"]["time"]["mlp"]["fc1"]["kernel"]).shape[0]
    for i in range(depth):
        layer = _unstack(uf["layers"], i)
        sd.update(_attn_block(layer["time"], f"{prefix}time_blocks.{i}"))
        sd.update(_space_blocks(layer, i, prefix))
    for fi, ti in ((0, 0), (1, 2), (2, 4)):
        sd.update(_dense(uf[f"flow_head_{fi}"], f"{prefix}flow_head.{ti}"))
    if "support_memory" in uf:
        sd[f"{prefix}support_memory"] = np.asarray(uf["support_memory"])
        sd.update(_loftr(uf["gnn"], f"{prefix}gnn."))
    return sd


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

    sd.update(_updateformer(p["updateformer"], "updateformer."))
    sd.update(_norm(p["ffeats_norm"], "ffeats_norm"))
    sd.update(_dense(p["ffeats_updater"], "ffeats_updater.0"))
    if "vis_hidden" in p:
        sd.update(_dense(p["vis_hidden"], "vis_hidden"))
    sd.update(_dense(p["vis_predictor"], "vis_predictor.0"))
    if "cloud_backbone" in p:
        sd.update(_point_transformer(p["cloud_backbone"], "cloud_backbone."))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _loftr(p, prefix):
    """flax LocalFeatureTransformer params (layer_{i}/{q_proj, k_proj, v_proj,
    merge, mlp_0, mlp_1, norm1, norm2}) -> the reference's names."""
    sd = {}
    i = 0
    while f"layer_{i}" in p:
        layer, name = p[f"layer_{i}"], f"{prefix}layers.{i}"
        for lin in ("q_proj", "k_proj", "v_proj", "merge"):
            sd.update(_dense(layer[lin], f"{name}.{lin}"))
        sd.update(_dense(layer["mlp_0"], f"{name}.mlp.0"))
        sd.update(_dense(layer["mlp_1"], f"{name}.mlp.2"))
        sd.update(_norm(layer["norm1"], f"{name}.norm1"))
        sd.update(_norm(layer["norm2"], f"{name}.norm2"))
        i += 1
    return sd


def _point_transformer(p, prefix):
    sd = _dense(p["proj_in"], f"{prefix}proj_in")
    d = 0
    while f"block_{d}" in p:
        sd.update(_attn_block(p[f"block_{d}"], f"{prefix}blocks.{d}"))
        d += 1
    sd.update(_dense(p["proj_out"], f"{prefix}proj_out"))
    return sd


def updateformer_from_flax(params) -> dict[str, torch.Tensor]:
    """The JAX package's `EfficientUpdateFormer` params (its support memory
    too) -> a state dict for `mvtracker_torch.models.updateformer.EfficientUpdateFormer`."""
    sd = _updateformer(params.get("params", params), "")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def point_transformer_from_flax(params) -> dict[str, torch.Tensor]:
    """The JAX package's `SerializedPointTransformer` params -> a state dict
    for `mvtracker_torch.models.point_transformer.SerializedPointTransformer`."""
    sd = _point_transformer(params.get("params", params), "")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


class _Recorder(dict):
    """A params tree that records the path of every leaf read from it, so
    that `load_release` can name the leaves `params_from_flax` left unread."""

    def __init__(self, tree, seen, path=""):
        super().__init__(tree)
        self._seen, self._path = seen, path

    def _wrap(self, key, value):
        path = f"{self._path}/{key}" if self._path else str(key)
        if isinstance(value, dict):
            return _Recorder(value, self._seen, path)
        self._seen.add(path)
        return value

    def __getitem__(self, key):
        return self._wrap(key, super().__getitem__(key))

    def get(self, key, default=None):
        return self[key] if key in self else default

    def items(self):
        return [(k, self._wrap(k, v)) for k, v in super().items()]


def _leaf_paths(tree, path=""):
    for key, value in tree.items():
        sub = f"{path}/{key}" if path else str(key)
        if isinstance(value, dict):
            yield from _leaf_paths(value, sub)
        else:
            yield sub


def migrate_updateformer_layout(tree: dict) -> dict:
    """Stack a flax file's unrolled update-transformer blocks (time_i,
    sv2p_i, svirt_i, sp2v_i, from before the JAX package scanned its
    layers) into the scanned "layers" layout that `params_from_flax` reads;
    other trees are returned as they are."""
    uf = tree.get("params", tree).get("updateformer")
    if not isinstance(uf, dict) or "layers" in uf or "time_0" not in uf:
        return tree
    depth = len([k for k in uf if k.startswith("time_")])

    def stack(trees):
        return {
            k: stack([t[k] for t in trees]) if isinstance(v, dict) else np.stack([np.asarray(t[k]) for t in trees])
            for k, v in trees[0].items()
        }

    uf["layers"] = stack([{name: uf.pop(f"{name}_{i}") for name in ("time", "sv2p", "svirt", "sp2v")}
                          for i in range(depth)])
    logging.info("warm-start: migrated %d unrolled updateformer blocks to the scanned layout", depth)
    return tree


def read_flax_params(path: str) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A flax msgpack params file -> (the port's state dict, the paths of the
    file's leaves that no parameter reads), the update-transformer layout
    migrated first. A tree that lacks a part of the layout raises
    ValueError."""
    tree = migrate_updateformer_layout(load_flax_msgpack(path))
    seen: set = set()
    try:
        sd = params_from_flax(_Recorder(tree, seen))
    except KeyError as e:
        raise ValueError(f"{path}: the params tree lacks {e} that the model's layout needs") from None
    return sd, sorted(set(_leaf_paths(tree)) - seen)


def load_release(path: str, model: nn.Module) -> nn.Module:
    """Load a flax msgpack params file into `model` strictly, with the
    meaning of the JAX package's `Trainer.warm_start(strict=True)`: a leaf of
    the file the model has no place for, a parameter the file does not
    give, or a shape that differs raises ValueError naming them, so a model
    built with other options than the file's never runs on half its
    weights. Values are cast to the model's parameter dtype. Returns
    `model`."""
    sd, unread = read_flax_params(path)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    wrong = sorted(
        f"{k} {tuple(sd[k].shape)} vs the model's {tuple(want[k].shape)}"
        for k in set(sd) & set(want)
        if sd[k].shape != want[k].shape
    )
    if unread or missing or extra or wrong:
        raise ValueError(
            f"strict load of {path}: the model's options do not match the file; "
            f"file leaves with no counterpart {unread + extra}, parameters the file lacks {missing}, "
            f"shapes that differ {wrong}"
        )
    model.load_state_dict({k: v.to(want[k].dtype) for k, v in sd.items()}, strict=True)
    return model


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
    convs kaiming-normal (fan out), attention and MLP denses (the update
    transformer's, its LoFTR memory's and the point transformer's)
    xavier-uniform, the flow head truncated-normal (std 0.001), other denses
    lecun-normal, virtual tracks standard normal, the support-memory bank
    0.1, norms one/zero, biases zero. For a `VGGT`, the JAX VGGT's (by
    `models/vggt.py::init_rule`): denses and convs lecun-normal, LayerScale
    at its init value, camera and register tokens normal with std 1e-6, the
    DINOv2 positional embedding std 0.02."""
    from mvtracker_torch.models.vggt import VGGT, init_rule

    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if isinstance(model, VGGT):
            kind, value = init_rule(name, shape, model.cfg)
            if kind == "const":
                w = np.full(shape, value)
            elif kind == "normal":
                w = rng.standard_normal(shape) * value
            else:
                w = _truncated_normal(rng, shape, value)
        elif name.endswith("virual_tracks"):
            w = rng.standard_normal(shape)
        elif name.endswith("support_memory"):
            w = np.full(shape, 0.1)
        elif name.endswith(".bias"):
            w = np.zeros(shape)
        elif "norm" in name.rsplit(".", 2)[-2]:
            w = np.ones(shape)
        elif len(shape) == 4:
            fan_out = shape[0] * shape[2] * shape[3]
            w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_out)
        elif "flow_head" in name:
            w = _truncated_normal(rng, shape, 0.001)
        elif name.startswith(("updateformer.", "cloud_backbone.blocks.")):
            limit = np.sqrt(6.0 / (shape[0] + shape[1]))
            w = rng.uniform(-limit, limit, size=shape)
        else:
            w = _truncated_normal(rng, shape, 1.0 / np.sqrt(shape[1]))
        out[name] = torch.from_numpy(w.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# VGGT
# ---------------------------------------------------------------------------


def _deconv(p, name):
    """flax ConvTranspose -> torch ConvTranspose2d: flax's transposed
    convolution is a fractionally strided correlation, torch's the gradient
    of one, so the taps land mirrored."""
    w = np.asarray(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    return {f"{name}.weight": np.ascontiguousarray(w), f"{name}.bias": np.asarray(p["bias"])}


def _vggt_block(p, name):
    sd = {**_norm(p["norm1"], f"{name}.norm1"), **_norm(p["norm2"], f"{name}.norm2"),
          f"{name}.ls1.gamma": np.asarray(p["ls1"]), f"{name}.ls2.gamma": np.asarray(p["ls2"])}
    sd.update(_dense(p["attn"]["qkv"], f"{name}.attn.qkv"))
    sd.update(_dense(p["attn"]["proj"], f"{name}.attn.proj"))
    for qk in ("q_norm", "k_norm"):
        if qk in p["attn"]:
            sd.update(_norm(p["attn"][qk], f"{name}.attn.{qk}"))
    sd.update(_dense(p["mlp_fc1"], f"{name}.mlp.fc1"))
    sd.update(_dense(p["mlp_fc2"], f"{name}.mlp.fc2"))
    return sd


def _dpt_head(p, name):
    sd = _norm(p["norm"], f"{name}.norm")
    for li in range(4):
        sd.update(_conv(p[f"project_{li}"], f"{name}.projects.{li}"))
        sd.update(_conv(p[f"scratch_{li}"], f"{name}.scratch.layer{li + 1}_rn"))
    sd.update(_deconv(p["resize_0"], f"{name}.resize_layers.0"))
    sd.update(_deconv(p["resize_1"], f"{name}.resize_layers.1"))
    sd.update(_conv(p["resize_3"], f"{name}.resize_layers.3"))
    for li in range(1, 5):
        blk, ref = p[f"refine{li}"], f"{name}.scratch.refinenet{li}"
        for unit in ("res1", "res2"):
            if f"{unit}_conv1" in blk:
                for conv in ("conv1", "conv2"):
                    sd.update(_conv(blk[f"{unit}_{conv}"], f"{ref}.resConfUnit{unit[-1]}.{conv}"))
        sd.update(_conv(blk["out_conv"], f"{ref}.out_conv"))
    sd.update(_conv(p["out_conv1"], f"{name}.scratch.output_conv1"))
    sd.update(_conv(p["out_conv2a"], f"{name}.scratch.output_conv2.0"))
    sd.update(_conv(p["out_conv2b"], f"{name}.scratch.output_conv2.2"))
    return sd


def _numbered(tree, prefix):
    """The keys `<prefix><i>` of `tree`, in the order of i."""
    keys = [k for k in tree if k.startswith(prefix) and k[len(prefix):].isdigit()]
    return sorted(keys, key=lambda k: int(k[len(prefix):]))


def vggt_params_from_flax(params) -> dict[str, torch.Tensor]:
    """The JAX package's VGGT params (with or without the outer "params"
    key) -> the port's VGGT state dict (fp32 tensors on the CPU)."""
    p = params.get("params", params)
    agg = p["aggregator"]
    sd = {"aggregator.camera_token": np.asarray(agg["camera_token"])[None],
          "aggregator.register_token": np.asarray(agg["register_token"])[None]}
    for i, key in enumerate(_numbered(agg, "frame_")):
        sd.update(_vggt_block(agg[key], f"aggregator.frame_blocks.{i}"))
        sd.update(_vggt_block(agg[f"global_{i}"], f"aggregator.global_blocks.{i}"))
    if "patch_vit" in agg:
        vit = agg["patch_vit"]
        sd.update(_conv(vit["proj"], "aggregator.patch_embed.patch_embed.proj"))
        for leaf in ("cls_token", "pos_embed", "register_tokens"):
            sd[f"aggregator.patch_embed.{leaf}"] = np.asarray(vit[leaf])
        sd.update(_norm(vit["norm"], "aggregator.patch_embed.norm"))
        for i, key in enumerate(_numbered(vit, "block_")):
            sd.update(_vggt_block(vit[key], f"aggregator.patch_embed.blocks.{i}"))
    else:
        sd.update(_conv(agg["patch_embed"], "aggregator.patch_embed.proj"))

    cam = p["camera_head"]
    sd.update(_norm(cam["token_norm"], "camera_head.token_norm"))
    sd.update(_norm(cam["trunk_norm"], "camera_head.trunk_norm"))
    sd["camera_head.empty_pose_tokens"] = np.asarray(cam["empty_pose_tokens"])
    sd.update(_dense(cam["embed_pose"], "camera_head.embed_pose"))
    sd.update(_dense(cam["pose_modulation"], "camera_head.poseLN_modulation.1"))
    sd.update(_dense(cam["pose_branch_fc1"], "camera_head.pose_branch.fc1"))
    sd.update(_dense(cam["pose_branch_fc2"], "camera_head.pose_branch.fc2"))
    for i, key in enumerate(_numbered(cam, "trunk_")):
        sd.update(_vggt_block(cam[key], f"camera_head.trunk.{i}"))
    sd.update(_dpt_head(p["depth_head"], "depth_head"))
    sd.update(_dpt_head(p["point_head"], "point_head"))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


# Keys of a VGGT-1B checkpoint the model has no part for: the track head,
# and DINOv2's mask token (a pretraining leftover, unused at inference).
_VGGT_SKIPPED = ("track_head.", "aggregator.patch_embed.mask_token")


def load_vggt_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A VGGT torch checkpoint (.pt/.pth/.bin, the facebook/VGGT-1B layout)
    -> the port's VGGT state dict: DINOv2's chunked block names
    (`blocks.<chunk>.<i>.`) flattened, the skipped keys dropped. Load it
    with `VGGT(VGGTConfig()).load_state_dict(sd)`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt and not any(k.startswith("aggregator") for k in ckpt):
        ckpt = ckpt["model"]
    sd = {}
    for k, v in ckpt.items():
        if k.startswith(_VGGT_SKIPPED):
            continue
        sd[re.sub(r"(patch_embed\.blocks)\.\d+\.(\d+)\.", r"\1.\2.", k)] = v.float()
    return sd
