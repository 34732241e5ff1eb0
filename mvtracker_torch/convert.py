"""Weights for the port.

- `load_flax_msgpack(path)`: read a params file that flax's
  `serialization.msgpack_serialize` wrote (the release artifact,
  `release/mvtracker_medium_synth.msgpack`) into nested dicts of numpy
  arrays, with a msgpack decoder of its own: neither `msgpack` nor `flax`
  is needed. bf16 leaves come back as fp32, widened exactly.
- `flax_msgpack_bytes(tree)`, `save_flax_msgpack(tree, path)`: the inverse,
  an encoder of its own that writes the bytes flax writes for a tree of
  numpy arrays or torch tensors (bf16 and fp16 kept): keys sorted as
  `msgpack_serialize` sorts them, or with `sort_keys=False` in the tree's
  order, as `to_bytes` keeps it. A leaf over 1 GiB, which flax would split
  into chunks, raises.
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
- `convert_reference_state_dict(sd)`, `load_reference_checkpoint(path)`,
  `convert_vggt_state_dict(sd)`: the other way, a reference (or port) state
  dict -> the flax tree the JAX package's functions of those names give.
  Each mapping is one layout function (`_mvtracker`, `_vggt`) that a
  `_Walk` reads in either direction, so the two ways share one table.
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


# flax's MAX_CHUNK_SIZE: flax writes a leaf of more bytes as a map of chunks,
# which `load_flax_msgpack` refuses, so the encoder refuses it too.
MAX_LEAF_BYTES = 2**30
_EXT_NPSCALAR = 3  # flax's ext code for a numpy scalar: packed like an ndarray of shape ()
_TORCH_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
    torch.bool: "bool",
}


def _head(n: int, fix: int, fix_max: int, codes: tuple) -> bytes:
    """The header of a str, bin, array, map or ext of length `n`: the fixed
    form up to `fix_max` (when the type has one), else the smallest of the
    8-, 16- and 32-bit length forms `codes` allows."""
    if n <= fix_max:
        return bytes([fix | n])
    for code, fmt in zip(codes, (">B", ">H", ">I")[3 - len(codes):]):
        if n <= (1 << (8 * struct.calcsize(fmt))) - 1:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: a length of {n} does not fit 32 bits")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v >= 0 else (
        (0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for code, fmt in forms:
        try:
            return bytes([code]) + struct.pack(fmt, v)
        except struct.error:
            continue
    raise OverflowError(f"msgpack: {v} does not fit 64 bits")


def _array_parts(x):
    """(shape, dtype name, C-order bytes, byte count) of a numpy array or a
    torch tensor; the bytes are made only when asked for."""
    if torch.is_tensor(x):
        if x.dtype not in _TORCH_DTYPE_NAMES:
            raise TypeError(f"msgpack: no flax dtype name for a {x.dtype} tensor")
        nbytes = x.numel() * x.element_size()

        def data():
            t = x.detach().cpu().contiguous()
            return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()

        return tuple(x.shape), _TORCH_DTYPE_NAMES[x.dtype], data, nbytes
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise TypeError("msgpack: object and structured dtypes have no flax encoding")
    return x.shape, x.dtype.name, lambda: x.tobytes("C"), x.size * x.dtype.itemsize


def _pack(obj, sort_keys: bool, path: str = ""):
    """Yield the msgpack bytes of `obj` as flax writes them: `msgpack.packb(
    ..., use_bin_type=True)`, arrays as ext type 1 (numpy scalars 3) whose
    payload is the packed (shape, dtype name, C-order bytes)."""
    if isinstance(obj, dict):
        items = sorted(obj.items()) if sort_keys else obj.items()
        yield _head(len(obj), 0x80, 15, (0xDE, 0xDF))
        for key, value in items:
            yield from _pack(key, sort_keys)
            yield from _pack(value, sort_keys, f"{path}/{key}")
    elif torch.is_tensor(obj) or isinstance(obj, (np.ndarray, np.generic)):
        code = _EXT_NPSCALAR if isinstance(obj, np.generic) else _EXT_NDARRAY
        shape, name, data, nbytes = _array_parts(np.asarray(obj) if code == _EXT_NPSCALAR else obj)
        if nbytes > MAX_LEAF_BYTES:
            raise ValueError(f"{path or 'the leaf'}: {nbytes} bytes; flax writes a leaf over {MAX_LEAF_BYTES} bytes as "
                             "chunks, which this encoder and load_flax_msgpack do not support")
        payload = b"".join(_pack([list(shape), name, data()], sort_keys))
        yield _head(len(payload), 0, -1, (0xC7, 0xC8, 0xC9)) if len(payload) not in (1, 2, 4, 8, 16) else bytes(
            [0xD4 + len(payload).bit_length() - 1])
        yield struct.pack(">b", code)
        yield payload
    elif obj is None:
        yield b"\xc0"
    elif isinstance(obj, bool):
        yield b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        yield _int(obj)
    elif isinstance(obj, float):
        yield b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        yield _head(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        yield raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        yield _head(len(obj), 0, -1, (0xC4, 0xC5, 0xC6))
        yield bytes(obj)
    elif isinstance(obj, (list, tuple)):
        yield _head(len(obj), 0x90, 15, (0xDC, 0xDD))
        for value in obj:
            yield from _pack(value, sort_keys, path)
    else:
        raise TypeError(f"msgpack: {path or 'the tree'}: cannot encode a {type(obj).__name__}")


def flax_msgpack_bytes(tree, sort_keys: bool = True) -> bytes:
    """The bytes flax writes for a params tree (nested dicts whose leaves are
    numpy arrays or torch tensors; bf16 and fp16 tensors keep their dtype
    and raw 2-byte words). With `sort_keys` those of
    `flax.serialization.msgpack_serialize` (which passes the tree through
    `jax.tree_util`, so every dict's keys come out sorted); without, those
    of `flax.serialization.to_bytes`, which keeps each dict's insertion
    order. A leaf over 1 GiB raises, naming it (flax would chunk it)."""
    return b"".join(_pack(tree, sort_keys))


def save_flax_msgpack(tree, path: str, sort_keys: bool = True) -> int:
    """Write `flax_msgpack_bytes(tree, sort_keys)` to `path`, piece by piece
    (the whole file is never held twice); returns the bytes written. Nothing
    is written when a leaf is refused."""
    pieces = list(_pack(tree, sort_keys))
    with open(path, "wb") as f:
        for piece in pieces:
            f.write(piece)
    return sum(len(p) for p in pieces)


# ---------------------------------------------------------------------------
# The parameter layout, one table read in both directions
# ---------------------------------------------------------------------------

# A flax leaf -> the port's tensor, and back.
_TO_PORT = {
    "plain": lambda a: a,
    "conv": lambda a: a.transpose(3, 2, 0, 1),  # (kh, kw, I, O) -> (O, I, kh, kw)
    "dense": lambda a: a.T,  # (I, O) -> (O, I)
    # flax's transposed convolution is a fractionally strided correlation,
    # torch's the gradient of one, so the taps land mirrored.
    "deconv": lambda a: np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1)),  # -> (I, O, kh, kw)
    "batch": lambda a: a[None],  # VGGT's camera and register tokens carry a batch axis in torch
}
_TO_FLAX = {
    "plain": lambda a: a,
    "conv": lambda a: a.transpose(2, 3, 1, 0),
    "dense": lambda a: a.T,
    "deconv": lambda a: np.ascontiguousarray(a.transpose(2, 3, 0, 1)[::-1, ::-1]),
    "batch": lambda a: a[0],
}


def _to_numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


class _Slices(dict):
    """Depth index -> one block's leaf, stacked on axis 0 when the walk ends."""


class _Walk:
    """One pass over a model's parameter layout. Built with `tree` (the JAX
    package's params, nested dicts) it reads that tree and fills `out` with
    the port's state dict; built with `sd` (a state dict, of tensors or
    arrays) it reads that and fills `out` with the flax tree. The layout
    functions below name every parameter once, by its flax path and its port
    name, so the two directions cannot drift apart."""

    def __init__(self, tree=None, sd=None):
        self.to_port = tree is not None
        self.src = tree if self.to_port else sd
        self.out = {}
        self.read = set()  # "/"-joined flax paths of the leaves read (towards the port)

    def _node(self, path):
        node = self.src
        for key in path:
            if not isinstance(node, dict) or key not in node:
                return None
            node = node[key]
        return node

    def has(self, path, name) -> bool:
        """Whether the source holds the part at flax `path`, or port key `name`."""
        return self._node(path) is not None if self.to_port else name in self.src

    def count(self, path_of, name_of) -> int:
        """How many consecutive blocks i = 0, 1, ... the source holds."""
        i = 0
        while self.has(path_of(i), name_of(i)):
            i += 1
        return i

    def depth(self, path, name_of) -> int:
        """A stacked part's depth: axis 0 of the flax leaf at `path`, or the
        consecutive blocks `name_of(i)` of the state dict."""
        if self.to_port:
            node = self._node(path)
            if node is None:
                raise KeyError("/".join(path))
            return np.shape(node)[0]
        return self.count(lambda i: path, name_of)

    def leaf(self, path, name, kind="plain", index=None):
        """One parameter: flax `path` (slice `index` of a stacked leaf) <-> port `name`."""
        if self.to_port:
            value = self._node(path)
            if value is None:
                raise KeyError("/".join(path))
            self.read.add("/".join(path))
            value = np.asarray(value)
            self.out[name] = _TO_PORT[kind](value if index is None else value[index])
            return
        value = _TO_FLAX[kind](_to_numpy(self.src[name]))
        node = self.out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if index is None:
            node[path[-1]] = value
        else:
            node.setdefault(path[-1], _Slices())[index] = value

    def result(self) -> dict:
        def finish(node):
            if isinstance(node, _Slices):
                return np.stack([node[i] for i in range(len(node))])
            if isinstance(node, dict):
                return {k: finish(v) for k, v in node.items()}
            return node

        return finish(self.out)


def _to_port(params, layout) -> tuple[dict[str, torch.Tensor], set]:
    """Flax params (with or without the outer "params" key) through `layout`
    -> (the port's state dict as fp32 tensors, the flax paths read)."""
    walk = _Walk(tree=params)
    layout(walk, ("params",) if "params" in params else ())
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in walk.out.items()}, walk.read


def _to_flax(sd, layout) -> dict:
    """A state dict through `layout` -> the flax params tree (numpy leaves, the
    state dict's dtypes, bf16 widened to fp32), under "params"."""
    walk = _Walk(sd=sd)
    layout(walk, ("params",))
    return walk.result()


def _conv(m, f, name):
    m.leaf(f + ("kernel",), f"{name}.weight", "conv")
    if m.has(f + ("bias",), f"{name}.bias"):
        m.leaf(f + ("bias",), f"{name}.bias")


def _dense(m, f, name, index=None):
    m.leaf(f + ("kernel",), f"{name}.weight", "dense", index)
    if m.has(f + ("bias",), f"{name}.bias"):
        m.leaf(f + ("bias",), f"{name}.bias", index=index)


def _norm(m, f, name, index=None):
    m.leaf(f + ("scale",), f"{name}.weight", index=index)
    m.leaf(f + ("bias",), f"{name}.bias", index=index)


def _attn_block(m, f, name, cross=False, index=None):
    attn = "cross_attn" if cross else "attn"
    for lin in ("to_q", "to_kv", "to_out"):
        _dense(m, f + (attn, lin), f"{name}.{attn}.{lin}", index)
    _dense(m, f + ("mlp", "fc1"), f"{name}.mlp.fc1", index)
    _dense(m, f + ("mlp", "fc2"), f"{name}.mlp.fc2", index)
    if cross:
        _norm(m, f + ("norm_context",), f"{name}.norm_context", index)


def _updateformer(m, f, prefix):
    _dense(m, f + ("input_transform",), f"{prefix}input_transform")
    m.leaf(f + ("virtual_tracks",), f"{prefix}virual_tracks")  # sic: the reference's name
    # 1:1 interleave, depth stacked on axis 0 (`migrate_updateformer_layout`
    # brings older files to this layout).
    layers = f + ("layers",)
    depth = m.depth(layers + ("time", "mlp", "fc1", "kernel"), lambda i: f"{prefix}time_blocks.{i}.mlp.fc1.weight")
    if not m.to_port:
        space = m.count(lambda i: None, lambda i: f"{prefix}space_virtual_blocks.{i}.mlp.fc1.weight")
        if space != depth:
            raise ValueError(f"time depth {depth} and space depth {space} differ; the port's layout stacks them 1:1")
    for i in range(depth):
        _attn_block(m, layers + ("time",), f"{prefix}time_blocks.{i}", index=i)
        _attn_block(m, layers + ("sv2p",), f"{prefix}space_virtual2point_blocks.{i}", cross=True, index=i)
        _attn_block(m, layers + ("svirt",), f"{prefix}space_virtual_blocks.{i}", index=i)
        _attn_block(m, layers + ("sp2v",), f"{prefix}space_point2virtual_blocks.{i}", cross=True, index=i)
    for fi, ti in ((0, 0), (1, 2), (2, 4)):
        _dense(m, f + (f"flow_head_{fi}",), f"{prefix}flow_head.{ti}")
    if m.has(f + ("support_memory",), f"{prefix}support_memory"):
        m.leaf(f + ("support_memory",), f"{prefix}support_memory")
        _loftr_layout(m, f + ("gnn",), f"{prefix}gnn.")


def _loftr_layout(m, f, prefix):
    """flax LocalFeatureTransformer params (layer_{i}/{q_proj, k_proj, v_proj,
    merge, mlp_0, mlp_1, norm1, norm2}) <-> the reference's names."""
    for i in range(m.count(lambda i: f + (f"layer_{i}",), lambda i: f"{prefix}layers.{i}.q_proj.weight")):
        layer, name = f + (f"layer_{i}",), f"{prefix}layers.{i}"
        for lin in ("q_proj", "k_proj", "v_proj", "merge"):
            _dense(m, layer + (lin,), f"{name}.{lin}")
        _dense(m, layer + ("mlp_0",), f"{name}.mlp.0")
        _dense(m, layer + ("mlp_1",), f"{name}.mlp.2")
        _norm(m, layer + ("norm1",), f"{name}.norm1")
        _norm(m, layer + ("norm2",), f"{name}.norm2")


def _point_transformer(m, f, prefix):
    _dense(m, f + ("proj_in",), f"{prefix}proj_in")
    for d in range(m.count(lambda d: f + (f"block_{d}",), lambda d: f"{prefix}blocks.{d}.attn.to_q.weight")):
        _attn_block(m, f + (f"block_{d}",), f"{prefix}blocks.{d}")
    _dense(m, f + ("proj_out",), f"{prefix}proj_out")


def _mvtracker(m, f):
    """MVTracker, in the insertion order of the JAX package's
    `convert_reference_state_dict` (which `flax.serialization.to_bytes` keeps)."""
    fnet = f + ("fnet",)
    for name in ("conv1", "conv2", "conv3"):
        _conv(m, fnet + (name,), f"fnet.{name}")
    for layer in range(1, 5):
        for j in range(2):
            blk, prefix = fnet + (f"layer{layer}_{j}",), f"fnet.layer{layer}.{j}"
            _conv(m, blk + ("conv1",), f"{prefix}.conv1")
            _conv(m, blk + ("conv2",), f"{prefix}.conv2")
            if m.has(blk + ("downsample",), f"{prefix}.downsample.0.weight"):
                _conv(m, blk + ("downsample",), f"{prefix}.downsample.0")
    _updateformer(m, f + ("updateformer",), "updateformer.")
    _norm(m, f + ("ffeats_norm",), "ffeats_norm")
    _dense(m, f + ("ffeats_updater",), "ffeats_updater.0")
    if m.has(f + ("vis_hidden",), "vis_hidden.weight"):
        _dense(m, f + ("vis_hidden",), "vis_hidden")
    _dense(m, f + ("vis_predictor",), "vis_predictor.0")
    if m.has(f + ("cloud_backbone",), "cloud_backbone.proj_in.weight"):
        _point_transformer(m, f + ("cloud_backbone",), "cloud_backbone.")


def params_from_flax(params) -> dict[str, torch.Tensor]:
    """Flax MVTracker params -> the port's state dict (fp32 tensors on the CPU)."""
    return _to_port(params, _mvtracker)[0]


def convert_reference_state_dict(sd) -> dict:
    """A state dict of the reference torch MVTracker or of the port's (tensors
    or arrays) -> the JAX package's params tree {"params": ...} of numpy
    arrays, as `mvtracker_tpu.convert.convert_reference_state_dict` gives it:
    the inverse of `params_from_flax`, with the update transformer's depth
    read from the keys and its blocks stacked on axis 0. Keys of no
    parameter (a training checkpoint's extras) are not read."""
    return _to_flax(sd, _mvtracker)


def load_reference_checkpoint(path: str) -> dict:
    """A reference `.pth` (or a port checkpoint) -> `convert_reference_state_dict`
    of it. A training checkpoint that nests the model under "model" is
    unwrapped; the file is read with `torch.load(weights_only=True)`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt and not any(str(k).startswith("fnet") for k in ckpt):
        ckpt = ckpt["model"]
    return convert_reference_state_dict(ckpt)


def _loftr(params, prefix) -> dict[str, np.ndarray]:
    """The JAX package's LocalFeatureTransformer params -> the port's names."""
    walk = _Walk(tree=params)
    _loftr_layout(walk, (), prefix)
    return walk.out


def updateformer_from_flax(params) -> dict[str, torch.Tensor]:
    """The JAX package's `EfficientUpdateFormer` params (its support memory
    too) -> a state dict for `mvtracker_torch.models.updateformer.EfficientUpdateFormer`."""
    return _to_port(params, lambda m, f: _updateformer(m, f, ""))[0]


def point_transformer_from_flax(params) -> dict[str, torch.Tensor]:
    """The JAX package's `SerializedPointTransformer` params -> a state dict
    for `mvtracker_torch.models.point_transformer.SerializedPointTransformer`."""
    return _to_port(params, lambda m, f: _point_transformer(m, f, ""))[0]


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
    try:
        sd, read = _to_port(tree, _mvtracker)
    except KeyError as e:
        raise ValueError(f"{path}: the params tree lacks {e} that the model's layout needs") from None
    return sd, sorted(set(_leaf_paths(tree)) - read)


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


def _vggt_block(m, f, name):
    """In the JAX converter's order: norm1, attn (qkv, proj, the q/k norms of
    the aggregator's blocks), ls1, norm2, the MLP, ls2."""
    _norm(m, f + ("norm1",), f"{name}.norm1")
    _dense(m, f + ("attn", "qkv"), f"{name}.attn.qkv")
    _dense(m, f + ("attn", "proj"), f"{name}.attn.proj")
    for qk in ("q_norm", "k_norm"):
        if m.has(f + ("attn", qk), f"{name}.attn.{qk}.weight"):
            _norm(m, f + ("attn", qk), f"{name}.attn.{qk}")
    m.leaf(f + ("ls1",), f"{name}.ls1.gamma")
    _norm(m, f + ("norm2",), f"{name}.norm2")
    _dense(m, f + ("mlp_fc1",), f"{name}.mlp.fc1")
    _dense(m, f + ("mlp_fc2",), f"{name}.mlp.fc2")
    m.leaf(f + ("ls2",), f"{name}.ls2.gamma")


def _deconv(m, f, name):
    m.leaf(f + ("kernel",), f"{name}.weight", "deconv")
    if m.has(f + ("bias",), f"{name}.bias"):
        m.leaf(f + ("bias",), f"{name}.bias")


def _dpt_head(m, f, name):
    _norm(m, f + ("norm",), f"{name}.norm")
    for li in range(4):
        _conv(m, f + (f"project_{li}",), f"{name}.projects.{li}")
        _conv(m, f + (f"scratch_{li}",), f"{name}.scratch.layer{li + 1}_rn")
    _deconv(m, f + ("resize_0",), f"{name}.resize_layers.0")
    _deconv(m, f + ("resize_1",), f"{name}.resize_layers.1")
    _conv(m, f + ("resize_3",), f"{name}.resize_layers.3")
    for li in range(1, 5):
        blk, ref = f + (f"refine{li}",), f"{name}.scratch.refinenet{li}"
        for unit in ("res1", "res2"):
            if m.has(blk + (f"{unit}_conv1",), f"{ref}.resConfUnit{unit[-1]}.conv1.weight"):
                for conv in ("conv1", "conv2"):
                    _conv(m, blk + (f"{unit}_{conv}",), f"{ref}.resConfUnit{unit[-1]}.{conv}")
        _conv(m, blk + ("out_conv",), f"{ref}.out_conv")
    _conv(m, f + ("out_conv1",), f"{name}.scratch.output_conv1")
    _conv(m, f + ("out_conv2a",), f"{name}.scratch.output_conv2.0")
    _conv(m, f + ("out_conv2b",), f"{name}.scratch.output_conv2.2")


def _vggt(m, f):
    agg = f + ("aggregator",)
    m.leaf(agg + ("camera_token",), "aggregator.camera_token", "batch")
    m.leaf(agg + ("register_token",), "aggregator.register_token", "batch")
    for i in range(m.count(lambda i: agg + (f"frame_{i}",), lambda i: f"aggregator.frame_blocks.{i}.norm1.weight")):
        _vggt_block(m, agg + (f"frame_{i}",), f"aggregator.frame_blocks.{i}")
        _vggt_block(m, agg + (f"global_{i}",), f"aggregator.global_blocks.{i}")
    vit = agg + ("patch_vit",)
    if m.has(vit, "aggregator.patch_embed.patch_embed.proj.weight"):
        _conv(m, vit + ("proj",), "aggregator.patch_embed.patch_embed.proj")
        for leaf in ("cls_token", "pos_embed", "register_tokens"):
            m.leaf(vit + (leaf,), f"aggregator.patch_embed.{leaf}")
        _norm(m, vit + ("norm",), "aggregator.patch_embed.norm")
        blocks = m.count(lambda i: vit + (f"block_{i}",), lambda i: f"aggregator.patch_embed.blocks.{i}.norm1.weight")
        for i in range(blocks):
            _vggt_block(m, vit + (f"block_{i}",), f"aggregator.patch_embed.blocks.{i}")
    else:  # the conv patchify variant
        _conv(m, agg + ("patch_embed",), "aggregator.patch_embed.proj")

    cam = f + ("camera_head",)
    _norm(m, cam + ("token_norm",), "camera_head.token_norm")
    _norm(m, cam + ("trunk_norm",), "camera_head.trunk_norm")
    m.leaf(cam + ("empty_pose_tokens",), "camera_head.empty_pose_tokens")
    _dense(m, cam + ("embed_pose",), "camera_head.embed_pose")
    _dense(m, cam + ("pose_modulation",), "camera_head.poseLN_modulation.1")  # Sequential(SiLU, Linear)
    _dense(m, cam + ("pose_branch_fc1",), "camera_head.pose_branch.fc1")
    _dense(m, cam + ("pose_branch_fc2",), "camera_head.pose_branch.fc2")
    for i in range(m.count(lambda i: cam + (f"trunk_{i}",), lambda i: f"camera_head.trunk.{i}.norm1.weight")):
        _vggt_block(m, cam + (f"trunk_{i}",), f"camera_head.trunk.{i}")
    _dpt_head(m, f + ("depth_head",), "depth_head")
    _dpt_head(m, f + ("point_head",), "point_head")


def vggt_params_from_flax(params) -> dict[str, torch.Tensor]:
    """The JAX package's VGGT params (with or without the outer "params"
    key) -> the port's VGGT state dict (fp32 tensors on the CPU)."""
    return _to_port(params, _vggt)[0]


def _flatten_dino_chunks(key: str) -> str:
    """DINOv2's chunked block names (`blocks.<chunk>.<i>.`) -> flat (`blocks.<i>.`)."""
    return re.sub(r"(patch_embed\.blocks)\.\d+\.(\d+)\.", r"\1.\2.", key)


def convert_vggt_state_dict(sd) -> dict:
    """A VGGT state dict (facebook/VGGT-1B layout, or the port's) -> the JAX
    package's VGGT params {"params": ...} of numpy arrays, as
    `mvtracker_tpu.convert.convert_vggt_state_dict` gives it: the inverse of
    `vggt_params_from_flax`, DINOv2's chunked block names flattened first,
    the parts JAX has no place for (`track_head.*`, the mask token, the
    ResNet mean and std buffers) not read."""
    return _to_flax({_flatten_dino_chunks(k): v for k, v in sd.items()}, _vggt)


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
        sd[_flatten_dino_chunks(k)] = v.float()
    return sd
