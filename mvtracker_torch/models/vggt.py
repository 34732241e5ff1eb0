"""VGGT (Visual Geometry Grounded Transformer), counterpart of
`mvtracker_tpu/models/vggt.py`: a feed-forward depth and camera estimator for
scenes without calibrated depth (facebook/VGGT-1B at the defaults).

* Aggregator: each frame patchified (a DINOv2 ViT-L/14 with registers, or a
  single conv), one camera token and R register tokens prepended (one value
  for frame 0, another for every later frame), then `depth` rounds of a
  frame block (attention within each frame) and a global block (attention
  across all frames), both with 2D rotary embeddings, LayerScale and
  QK-norm. Each round's two outputs, concatenated, are an intermediate.
* Camera head: iterative refinement of the camera token with AdaLN
  modulation from the previous pose encoding (absT, quaR, FoV).
* DPT heads: four intermediates projected, reassembled to four scales,
  fused coarse to fine, then depth (or world points) and confidence at full
  resolution.

The modules keep the reference's parameter names (those JAX
`convert.py::convert_vggt_state_dict` reads), so a downloaded VGGT-1B state
dict loads through `load_state_dict` (`convert.load_vggt_checkpoint`). The
numerics follow the JAX model: LayerNorm eps 1e-6, the tanh GELU, resizes
with `jax.image.resize`'s rules (half-pixel centres, antialiased when
shrinking; Keys cubic with a = -0.5 for the positional embedding),
attention with an fp32 softmax (`F.scaled_dot_product_attention`, which
keeps the [N, N] scores off the device memory on the GPU).

One departure: the JAX fusion pyramid upsamples each level 2x and fails to
add it to an odd-sized finer level (a patch grid of 37 at 518 pixels). This
one resizes each fused level to the size of the next, as the reference
(`dpt_head.py::scratch_forward`) does; at even grids that is the same 2x.

Where the JAX model, and so this one, computes otherwise than the published
VGGT (which matters once a released checkpoint is loaded; seeded weights
see no difference in kind): the tanh GELU where VGGT has the exact one;
LayerNorm eps 1e-6 in the frame, global and camera blocks where VGGT has
1e-5; the DINOv2 positional embedding resized by `jax.image.resize`'s cubic
rule where DINOv2 calls `F.interpolate(bicubic)` with its 0.1 offset; the
DPT fusion resizes with half-pixel centres where VGGT aligns corners, and no
DPT UV positional embedding; the pose encoding's quaternion read scalar
first (w, x, y, z) where VGGT writes it scalar last.

`aligned_depth` runs a VGGT with the camera and depth heads only
(`point_head=False`) as the depth stage of `MVTracker(depth_estimator=...)`
(the reference's `--depth_estimator vggt_aligned`): one VGGT sequence a
timestep over the V views, each view's depth scaled into the rig's world by the Umeyama sim3
from VGGT's camera centres to the rig's (`utils/geometry.py::umeyama_sim3`).
Where it may part from the reference's `vggt_aligned`:
- the frames are resized on the device by `jax.image.resize`'s cubic rule
  and clamped to [0, 1], where VGGT's own preprocessing
  (`load_and_preprocess_images`, mode "crop") resizes with PIL's bicubic
  and rounds to 8 bits; the size is that mode's: 518 columns and the rows
  that keep the aspect, rounded to a multiple of 14 (294 for 288x512); a
  frame taller than wide is refused rather than centre-cropped;
- the depth comes back to the clip's size by the antialiased linear rule;
- no confidence mask: every pixel keeps its estimated depth;
- the sim3 is solved by Horn's quaternion method in float64 on the device
  (the optimum of the reference's SVD, with no host round trip), and only
  its scale is used: the depth is unprojected through the rig's own
  cameras, as sensor depth is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mvtracker_torch.device import resolve_device
from mvtracker_torch.ops.gsplat import quat_to_rotmat
from mvtracker_torch.utils import geometry as geo
from mvtracker_torch.utils.observability import span

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)
_LN_EPS = 1e-6  # flax LayerNorm's default


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    """Defaults: VGGT-1B."""

    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    rope_freq: float = 100.0
    init_values: float = 0.01  # LayerScale
    camera_trunk_depth: int = 4
    camera_iterations: int = 4
    dpt_features: int = 256
    dpt_out_channels: tuple = (256, 512, 1024, 1024)
    # "dinov2": the DINOv2 ViT front end of VGGT-1B; "conv": one conv patchify.
    patch_embed: str = "dinov2"
    vit_depth: int = 24
    vit_num_heads: int = 16
    vit_init_values: float = 1.0

    @property
    def intermediate_layer_idx(self) -> tuple:
        """Aggregator layers feeding the DPT heads."""
        if self.depth >= 24:
            return (4, 11, 17, 23)
        q = max(self.depth // 4, 1)
        return (q - 1, 2 * q - 1, 3 * q - 1, self.depth - 1)


def config_from_widths(widths: dict) -> VGGTConfig:
    """A `VGGTConfig` from a configuration file's widths (lists as tuples);
    a key it does not have raises."""
    return VGGTConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in widths.items()})


def tiny_config(**over) -> VGGTConfig:
    """A CPU-testable instance with the same topology (the JAX package's)."""
    base = dict(
        img_size=56, patch_size=14, embed_dim=64, depth=4, num_heads=4,
        num_register_tokens=2, camera_trunk_depth=2, dpt_features=32,
        dpt_out_channels=(32, 48, 64, 64),
        patch_embed="conv", vit_depth=2, vit_num_heads=4,
    )
    base.update(over)
    return VGGTConfig(**base)


# -- Resizes with jax.image.resize's rules -------------------------------------


def _linear_kernel(x):
    return torch.clamp(1.0 - x, min=0.0)


def _keys_cubic_kernel(x):  # a = -0.5
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int, method: str, device=None) -> torch.Tensor:
    """[in, out] weights of one axis of `jax.image.resize(..., method)`
    (antialiased: the kernel widens by in/out when shrinking), in fp32."""
    kernel = {"linear": _linear_kernel, "cubic": _keys_cubic_kernel}[method]
    inv_scale = 1.0 / (out_size / in_size)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    w = kernel(x / max(inv_scale, 1.0))
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_2d(x: torch.Tensor, out_hw: tuple[int, int], method: str, channels_last: bool = False) -> torch.Tensor:
    """`jax.image.resize` over the two spatial axes of [N, C, H, W] (or
    [N, H, W, C] with `channels_last`); an axis whose size stays is left as
    it is."""
    h_axis = 1 if channels_last else 2
    for axis, out in zip((h_axis, h_axis + 1), out_hw):
        if x.shape[axis] == out:
            continue
        w = resize_weights(x.shape[axis], out, method, x.device).to(x.dtype)
        x = torch.tensordot(x.movedim(axis, -1), w, dims=1).movedim(-1, axis)
    return x


# -- 2D rotary position embedding -------------------------------------------------


def _rope_1d(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """x [B, H, N, D], pos [B, N] -> rotated features."""
    d = x.shape[-1]
    exponents = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    inv_freq = 1.0 / (base**exponents)
    angles = pos[..., None].to(torch.float32) * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return (x * cos + torch.cat([-x2, x1], dim=-1) * sin).to(x.dtype)


def apply_rope_2d(x: torch.Tensor, positions: torch.Tensor, base: float) -> torch.Tensor:
    """x [B, H, N, D] (D % 4 == 0), positions [B, N, 2] (y, x): the first
    half of the features rotates with y, the second with x."""
    d = x.shape[-1]
    return torch.cat([_rope_1d(x[..., : d // 2], positions[..., 0], base),
                      _rope_1d(x[..., d // 2 :], positions[..., 1], base)], dim=-1)


# -- Transformer block: pre-LN, optional QK-norm, LayerScale -----------------------


def _layer_norm(dim, affine=True):
    return nn.LayerNorm(dim, eps=_LN_EPS, elementwise_affine=affine)


class VGGTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, rope_freq: float = 100.0, qk_norm: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.rope_freq = rope_freq
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm = _layer_norm(head_dim) if qk_norm else nn.Identity()
        self.k_norm = _layer_norm(head_dim) if qk_norm else nn.Identity()
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, pos: torch.Tensor | None = None) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads).permute(2, 0, 3, 1, 4)
        q, k, v = self.q_norm(qkv[0]), self.k_norm(qkv[1]), qkv[2]  # [B, H, N, D]
        if pos is not None and self.rope_freq > 0:
            q = apply_rope_2d(q, pos, self.rope_freq)
            k = apply_rope_2d(k, pos, self.rope_freq)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class VGGTBlock(nn.Module):
    """The aggregator's blocks have QK-norm and RoPE; the DINOv2 front end's
    and the camera trunk's have neither (rope_freq < 0)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, init_values=0.01, rope_freq=100.0, qk_norm=True):
        super().__init__()
        self.norm1 = _layer_norm(dim)
        self.attn = VGGTAttention(dim, num_heads, rope_freq, qk_norm)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = _layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x, pos=None):
        x = x + self.ls1(self.attn(self.norm1(x), pos))
        return x + self.ls2(self.mlp(self.norm2(x)))


# -- Patch embeds ---------------------------------------------------------------


class PatchEmbed(nn.Module):
    """One conv patchify (the reference's patch_embed="conv")."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)

    def forward(self, x):  # [B, 3, H, W] -> [B, P, C]
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoPatchEmbed(nn.Module):
    """The DINOv2 ViT front end returning the normalized patch tokens: conv
    patchify, cls token, the positional embedding (stored at the training
    grid, cubic-resized to another), register tokens, `vit_depth` blocks,
    a final LayerNorm."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        grid = cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, c))
        self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, c))
        self.blocks = nn.ModuleList(
            VGGTBlock(c, cfg.vit_num_heads, cfg.mlp_ratio, cfg.vit_init_values, rope_freq=-1.0, qk_norm=False)
            for _ in range(cfg.vit_depth))
        self.norm = _layer_norm(c)

    def forward(self, x):  # [B, 3, H, W] -> [B, P, C]
        cfg = self.cfg
        b, _, h, w = x.shape
        c = cfg.embed_dim
        hp, wp = h // cfg.patch_size, w // cfg.patch_size
        patches = self.patch_embed(x)
        grid = cfg.img_size // cfg.patch_size
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (hp, wp) != (grid, grid):
            pos_patch = resize_2d(pos_patch.reshape(1, grid, grid, c), (hp, wp), "cubic",
                                  channels_last=True).reshape(1, hp * wp, c)
        tokens = torch.cat([self.cls_token.expand(b, 1, c), patches], dim=1)
        tokens = tokens + torch.cat([pos_cls, pos_patch], dim=1)
        tokens = torch.cat([tokens[:, :1], self.register_tokens.expand(b, -1, c), tokens[:, 1:]], dim=1)
        for blk in self.blocks:
            tokens = blk(tokens)
        return self.norm(tokens)[:, 1 + cfg.num_register_tokens:]


# -- Aggregator -------------------------------------------------------------------


class Aggregator(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        self.patch_embed = DinoPatchEmbed(cfg) if cfg.patch_embed == "dinov2" else PatchEmbed(cfg)
        # Index 0 for frame 0, index 1 for every later frame.
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, c))
        self.register_token = nn.Parameter(torch.zeros(1, 2, cfg.num_register_tokens, c))
        self.frame_blocks = nn.ModuleList(
            VGGTBlock(c, cfg.num_heads, cfg.mlp_ratio, cfg.init_values, cfg.rope_freq) for _ in range(cfg.depth))
        self.global_blocks = nn.ModuleList(
            VGGTBlock(c, cfg.num_heads, cfg.mlp_ratio, cfg.init_values, cfg.rope_freq) for _ in range(cfg.depth))
        self.register_buffer("_resnet_mean", torch.tensor(_RESNET_MEAN).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("_resnet_std", torch.tensor(_RESNET_STD).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, images: torch.Tensor, keep=None) -> tuple[list, int]:
        """images [B, S, H, W, 3] in [0, 1] -> (intermediates [B, S, P, 2C]
        for every round, index of the first patch token). With `keep` (round
        indices) the other rounds' entries are None and never stored."""
        cfg = self.cfg
        b, s, h, w, _ = images.shape
        c = cfg.embed_dim
        x = images.reshape(b * s, h, w, 3).permute(0, 3, 1, 2)
        x = (x - self._resnet_mean) / self._resnet_std
        hp, wp = h // cfg.patch_size, w // cfg.patch_size
        with span("vggt_patch_embed"):
            patches = self.patch_embed(x)

        sel = torch.clamp(torch.arange(s, device=images.device), max=1)  # 0, 1, 1, ...
        special = torch.cat([self.camera_token[0, sel], self.register_token[0, sel]], dim=1)  # [S, 1+R, C]
        tokens = torch.cat([special.repeat(b, 1, 1).to(patches.dtype), patches], dim=1)
        patch_start = 1 + cfg.num_register_tokens
        p = tokens.shape[1]

        # RoPE positions: (y+1, x+1) for patches, 0 for the special tokens.
        ys, xs = torch.meshgrid(torch.arange(hp, device=images.device), torch.arange(wp, device=images.device),
                                indexing="ij")
        pos_patch = torch.stack([ys, xs], -1).reshape(1, hp * wp, 2) + 1
        pos = torch.cat([torch.zeros(1, patch_start, 2, dtype=pos_patch.dtype, device=images.device), pos_patch], 1)
        pos_frame = pos.repeat(b * s, 1, 1)
        pos_global = pos.repeat(b, s, 1)

        outputs = []
        with span("vggt_rounds"):
            for i, (frame_blk, global_blk) in enumerate(zip(self.frame_blocks, self.global_blocks)):
                tokens = frame_blk(tokens, pos_frame)
                frame_inter = tokens.reshape(b, s, p, c)
                tokens = global_blk(tokens.reshape(b, s * p, c), pos_global).reshape(b * s, p, c)
                kept = keep is None or i in keep
                outputs.append(torch.cat([frame_inter, tokens.reshape(b, s, p, c)], dim=-1) if kept else None)
        return outputs, patch_start


# -- Camera head -------------------------------------------------------------------


class CameraHead(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        dim = 2 * cfg.embed_dim
        self.token_norm = _layer_norm(dim)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = nn.Linear(9, dim)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, 3 * dim))
        self.adaln_norm = _layer_norm(dim, affine=False)
        self.trunk = nn.ModuleList(
            VGGTBlock(dim, cfg.num_heads, cfg.mlp_ratio, cfg.init_values, rope_freq=-1.0, qk_norm=False)
            for _ in range(cfg.camera_trunk_depth))
        self.trunk_norm = _layer_norm(dim)
        self.pose_branch = Mlp(dim, dim // 2, 9)

    def forward(self, aggregated: list[torch.Tensor]) -> list[torch.Tensor]:
        """-> pose encodings [B, S, 9], one per refinement iteration."""
        tokens = self.token_norm(aggregated[-1][:, :, 0])  # the camera token
        b, s, _ = tokens.shape
        preds, pred = [], None
        for _ in range(self.cfg.camera_iterations):
            # A copy, not a view: a module's input that is a view of a parameter made
            # under no_grad breaks FlopCounterMode's module tracking.
            inp = self.empty_pose_tokens.repeat(b, s, 1) if pred is None else pred.detach()
            shift, scale, gate = self.poseLN_modulation(self.embed_pose(inp)).chunk(3, dim=-1)
            modulated = gate * (self.adaln_norm(tokens) * (1 + scale) + shift) + tokens
            for blk in self.trunk:
                modulated = blk(modulated)
            delta = self.pose_branch(self.trunk_norm(modulated)).float()  # accumulated in fp32 under autocast
            pred = delta if pred is None else pred + delta
            # FoV through a ReLU; translation and quaternion linear.
            preds.append(torch.cat([pred[..., :7], F.relu(pred[..., 7:])], dim=-1))
        return preds


def pose_encoding_to_extri_intri(pose_enc: torch.Tensor, image_size_hw: tuple[int, int]):
    """[..., 9] (absT, quaR wxyz, FoV h w) -> extrinsics [..., 3, 4],
    intrinsics [..., 3, 3] with the principal point at the image centre."""
    t = pose_enc[..., :3]
    r = quat_to_rotmat(pose_enc[..., 3:7])
    fov_h, fov_w = pose_enc[..., 7], pose_enc[..., 8]
    extr = torch.cat([r, t[..., None]], dim=-1)
    h, w = image_size_hw
    fy = (h / 2.0) / torch.tan(torch.clamp(fov_h / 2.0, min=1e-3))
    fx = (w / 2.0) / torch.tan(torch.clamp(fov_w / 2.0, min=1e-3))
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    intr = torch.stack(
        [
            torch.stack([fx, zeros, torch.full_like(fx, w / 2.0)], -1),
            torch.stack([zeros, fy, torch.full_like(fy, h / 2.0)], -1),
            torch.stack([zeros, zeros, ones], -1),
        ],
        dim=-2,
    )
    return extr, intr


# -- DPT head ---------------------------------------------------------------------------


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _FusionBlock(nn.Module):
    def __init__(self, features: int, has_residual: bool = True):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features) if has_residual else None
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, residual=None, size=None):
        """Fuse, then bilinear-resize to `size` (2x where None)."""
        if self.resConfUnit1 is not None and residual is not None:
            x = x + self.resConfUnit1(residual)
        x = self.resConfUnit2(x)
        size = size or (2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(resize_2d(x, size, "linear"))


class _Scratch(nn.Module):
    def __init__(self, cfg: VGGTConfig, output_dim: int):
        super().__init__()
        f = cfg.dpt_features
        for i, oc in enumerate(cfg.dpt_out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(oc, f, 3, padding=1, bias=False))
        self.refinenet1 = _FusionBlock(f)
        self.refinenet2 = _FusionBlock(f)
        self.refinenet3 = _FusionBlock(f)
        self.refinenet4 = _FusionBlock(f, has_residual=False)
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, output_dim, 1))


class DPTHead(nn.Module):
    def __init__(self, cfg: VGGTConfig, output_dim: int = 2, activation: str = "exp", conf_activation: str = "expp1"):
        super().__init__()
        self.cfg = cfg
        self.activation = activation
        self.conf_activation = conf_activation
        dim_in = 2 * cfg.embed_dim
        oc = cfg.dpt_out_channels
        self.norm = _layer_norm(dim_in)  # one LayerNorm over all four taps
        self.projects = nn.ModuleList(nn.Conv2d(dim_in, o, 1) for o in oc)
        # Reassembly to the pyramid's scales: 4x and 2x deconvs, identity,
        # a stride-2 conv.
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = _Scratch(cfg, output_dim)

    def forward(self, aggregated, images, patch_start_idx):
        cfg = self.cfg
        b, s, h, w, _ = images.shape
        hp, wp = h // cfg.patch_size, w // cfg.patch_size
        sc = self.scratch
        feats = []
        for li, layer in enumerate(cfg.intermediate_layer_idx):
            t = self.norm(aggregated[layer][:, :, patch_start_idx:])  # [B, S, P, 2C]
            t = t.reshape(b * s, hp, wp, -1).permute(0, 3, 1, 2)
            t = self.resize_layers[li](self.projects[li](t))
            feats.append(getattr(sc, f"layer{li + 1}_rn")(t))

        x = sc.refinenet4(feats[3], size=feats[2].shape[2:])
        x = sc.refinenet3(x, feats[2], size=feats[1].shape[2:])
        x = sc.refinenet2(x, feats[1], size=feats[0].shape[2:])
        x = sc.refinenet1(x, feats[0])
        x = resize_2d(sc.output_conv1(x), (h, w), "linear")
        x = sc.output_conv2(x).permute(0, 2, 3, 1).float()  # [B*S, H, W, output_dim]; activated in fp32

        value, conf = x[..., :-1], x[..., -1]
        if self.activation == "exp":
            value = torch.exp(torch.clamp(value, -10.0, 10.0))
        elif self.activation == "inv_log":
            value = torch.sign(value) * torch.expm1(torch.clamp(torch.abs(value), max=10.0))
        if self.conf_activation == "expp1":
            conf = 1.0 + torch.exp(torch.clamp(conf, -10.0, 10.0))
        return value.reshape(b, s, h, w, -1), conf.reshape(b, s, h, w)


# -- The model ----------------------------------------------------------------------


class VGGT(nn.Module):
    """Aggregator with the camera, depth and point heads (the reference's
    track head is not part of it); `point_head=False` leaves the point head
    out (its checkpoint keys too: `convert.load_vggt_checkpoint`)."""

    def __init__(self, cfg: VGGTConfig = VGGTConfig(), device="cuda", point_head: bool = True):
        super().__init__()
        self.cfg = cfg
        with resolve_device(device):  # built where it runs: VGGT-1B is 1.2e9 parameters
            self.aggregator = Aggregator(cfg)
            self.camera_head = CameraHead(cfg)
            self.depth_head = DPTHead(cfg, output_dim=2, activation="exp")
            self.point_head = DPTHead(cfg, output_dim=4, activation="inv_log") if point_head else None

    @property
    def device(self) -> torch.device:
        return self.aggregator.camera_token.device

    def forward(self, images: torch.Tensor) -> dict:
        """images [B, S, H, W, 3] in [0, 1] -> predictions. Of the
        aggregator's rounds only those the heads read are kept: the DPT taps
        and the last."""
        h, w = images.shape[2:4]
        keep = set(self.cfg.intermediate_layer_idx) | {self.cfg.depth - 1}
        aggregated, patch_start = self.aggregator(images, keep=keep)
        with span("vggt_camera"):
            pose_enc_list = self.camera_head(aggregated)
        with span("vggt_depth_head"):
            depth, depth_conf = self.depth_head(aggregated, images, patch_start)
        extr, intr = pose_encoding_to_extri_intri(pose_enc_list[-1], (h, w))
        out = {
            "pose_enc": pose_enc_list[-1],
            "pose_enc_list": pose_enc_list,
            "extrinsics": extr,
            "intrinsics": intr,
            "depth": depth,
            "depth_conf": depth_conf,
        }
        if self.point_head is not None:
            world_points, point_conf = self.point_head(aggregated, images, patch_start)
            out.update(world_points=world_points[..., :3], world_points_conf=point_conf)
        return out


def input_size(h: int, w: int, cfg: VGGTConfig) -> tuple[int, int]:
    """VGGT's input size for an H x W frame, by its own preprocessing's
    "crop" rule: `img_size` columns and the rows that keep the aspect,
    rounded to a multiple of the patch size."""
    rows = round(h * cfg.img_size / w / cfg.patch_size) * cfg.patch_size
    if rows > cfg.img_size:
        raise ValueError(f"a {h}x{w} frame is taller than wide: VGGT's preprocessing would crop it; not supported")
    return rows, cfg.img_size


def aligned_depth(model: VGGT, rgbs: torch.Tensor, extrs: torch.Tensor, dtype=None) -> torch.Tensor:
    """The `vggt_aligned` depth stage of `MVTracker(depth_estimator=...)`
    (the module docstring says where it may part from the reference's):
    rgbs [V, T, H, W, 3] in 0..255 and the rig's world->camera extrs
    [V, T, 3, 4] on the device -> depth [V, T, H, W] in the rig's world
    units, fp32. `model` runs T sequences of the V views, under autocast to
    `dtype` where one is given; the resizes and the alignment run fp32, the
    Umeyama solve float64."""
    v, t, h, w, _ = rgbs.shape
    size = input_size(h, w, model.cfg)
    with span("depth_align"):
        frames = rgbs.transpose(0, 1).reshape(t * v, h, w, 3) / 255.0
        frames = resize_2d(frames, size, "cubic", channels_last=True).clamp(0.0, 1.0).reshape(t, v, *size, 3)
    amp = contextlib.nullcontext() if dtype is None else torch.autocast(rgbs.device.type, dtype=dtype)
    with amp:
        pred = model(frames)
    depth, extr = pred["depth"][..., 0], pred["extrinsics"]  # [T, V, h', w'], [T, V, 3, 4]
    with span("depth_align"):
        scale, _, _ = geo.umeyama_sim3(geo.camera_centers(extr.float()), geo.camera_centers(extrs.transpose(0, 1)))
        depth = depth * scale.to(depth.dtype)[:, None, None, None]
        depth = resize_2d(depth.reshape(t * v, 1, *size), (h, w), "linear").reshape(t, v, h, w)
    return depth.transpose(0, 1)


def init_rule(name: str, shape: tuple, cfg: VGGTConfig) -> tuple[str, float]:
    """How flax initializes the JAX model's counterpart of parameter `name`:
    ("const", value), ("normal", std) or ("truncated_normal", std; flax's
    lecun normal: within 2 std, rescaled)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "gamma":  # LayerScale
        return "const", cfg.vit_init_values if ".patch_embed.blocks." in name else cfg.init_values
    if name in ("aggregator.camera_token", "aggregator.register_token"):
        return "normal", 1e-6
    if name.endswith("patch_embed.pos_embed"):
        return "normal", 0.02
    if leaf in ("cls_token", "register_tokens", "empty_pose_tokens", "bias"):
        return "const", 0.0
    if len(shape) == 1:  # LayerNorm scale
        return "const", 1.0
    if len(shape) == 2:  # Linear [O, I]
        fan_in = shape[1]
    elif ".resize_layers.0." in name or ".resize_layers.1." in name:  # ConvTranspose2d [I, O, kh, kw]
        fan_in = shape[0] * shape[2] * shape[3]
    else:  # Conv2d [O, I, kh, kw]
        fan_in = shape[1] * shape[2] * shape[3]
    return "truncated_normal", 1.0 / math.sqrt(fan_in)


_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


@torch.no_grad()
def init_weights_(model: VGGT, seed: int) -> VGGT:
    """Fill every parameter by `init_rule` from a `torch.Generator` seeded
    with `seed` on the model's device (fast for VGGT-1B on the GPU; the
    draws differ from `convert.random_state_dict`'s numpy ones)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    for name, p in model.named_parameters():
        kind, value = init_rule(name, tuple(p.shape), model.cfg)
        if kind == "const":
            p.fill_(value)
        elif kind == "normal":
            p.normal_(0.0, value, generator=gen)
        else:  # inverse CDF of uniform draws within [-2, 2] std
            p.uniform_(lo, hi, generator=gen)
            p.mul_(2).sub_(1).erfinv_().mul_(math.sqrt(2) * value / _TRUNC_STD)
    return model


def estimate_depth_and_poses(model: VGGT, images: np.ndarray):
    """images [S, H, W, 3] in [0, 1] -> (depth [S, H, W], conf [S, H, W],
    extrinsics [S, 3, 4], intrinsics [S, 3, 3]) as numpy, run on the
    model's device."""
    with torch.no_grad():
        out = model(torch.from_numpy(np.asarray(images, np.float32)).to(model.device)[None])
    return (out["depth"][0, ..., 0].cpu().numpy(), out["depth_conf"][0].cpu().numpy(),
            out["extrinsics"][0].cpu().numpy(), out["intrinsics"][0].cpu().numpy())
