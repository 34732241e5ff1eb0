"""Plain PyTorch reference of the flagship tracker behind a VGGT depth stage
(the reference's `--depth_estimator vggt_aligned`), written from VGGT's
published description (Wang et al., arXiv 2503.11651) and its state-dict
layout, for the configuration `mvtracker-flagship-vggt1b`.

It imports nothing of the program under test. Everything runs in float32
with TF32 off (the caller sets `torch.backends`), one timestep at a time,
as straightforward code:
- each timestep's V frames resized to VGGT's input (518 columns, the rows
  that keep the aspect rounded to a multiple of 14) by the resize rule of
  `jax.image.resize` (half-pixel centres, Keys cubic a = -0.5, antialiased
  when shrinking), clamped to [0, 1];
- DINOv2 with registers: the patchify convolution, the class token, the
  positional embedding resized by the same cubic rule to the patch grid,
  the register tokens, the blocks, the last norm;
- the aggregator's rounds: a frame block (attention inside each frame) and
  a global block (attention across the V frames), both with 2D RoPE on the
  patches' (y + 1, x + 1) (0 for the camera and register tokens), QK-norm
  and LayerScale; frame 0 takes the first camera and register tokens, the
  others the second; attention as an explicit softmax(Q K^T / sqrt(d)) V;
- the camera head: the last round's camera token, normed, refined by the
  AdaLN-modulated trunk over its iterations; translation, a unit quaternion
  read (w, x, y, z) and a field of view;
- the DPT depth head on the four taps: a norm, projections, reassembly by
  4x and 2x transposed convolutions, identity and a stride-2 convolution,
  the coarse-to-fine fusion with linear resizes to the next level's size,
  the output convolutions around a linear resize to the input size, exp of
  the first channel clamped to [-10, 10];
- the alignment: each timestep's Umeyama sim3 from VGGT's camera centres
  (-R^T t) onto the rig's, by an SVD with the reflection fix, in float64
  (the precision the program solves it in); the depth times that scale,
  resized back to the clip's size by the linear rule;
- then the tracker of `reference/mvtracker.py` on that depth.

Where the program's VGGT computes otherwise than the published model (its
docstring lists each: the tanh GELU, LayerNorm eps 1e-6, the resize rules,
no DPT UV embedding, the quaternion's order), this reference computes what
the program states, since it decides whether the program's answers are
right, not whether its model is the published one.

`lowp` rounds where the configuration computes in bf16 (the program runs
VGGT under bf16 autocast): the operands and outputs of VGGT's dense layers,
convolutions, resizes inside the model and attention products (Q, K, V, the
probabilities and the output), and the DPT's sums of two such outputs. The
residual stream, the norms, RoPE, the softmax, the camera head's
accumulated pose, the activations of the depth, the input and output
resizes and the alignment stay fp32 (float64 for the solve), as there. The
tracker takes `lowp` as its own reference does.

Layouts as `reference/mvtracker.py`; `forward(..., depth_source=
"vggt_aligned")` ignores the given depth, which may be empty.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F


def _tracker_reference():
    """The tracker's reference, `mvtracker.py` beside this file, loaded by its
    path as the harness loads a reference (a reference imports nothing of
    the benchmark's package)."""
    spec = importlib.util.spec_from_file_location("perfbench_reference_mvtracker_tracker",
                                                  Path(__file__).with_name("mvtracker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TrackerRef = _tracker_reference().Ref

# The VGGT widths this reference computes; any other key is refused.
# `init_values` and `vit_init_values` only set an initial LayerScale, which
# the state dict overrides.
VGGT_WIDTHS = frozenset({"img_size", "patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio",
                         "num_register_tokens", "rope_freq", "init_values", "camera_trunk_depth",
                         "camera_iterations", "dpt_features", "dpt_out_channels", "patch_embed", "vit_depth",
                         "vit_num_heads", "vit_init_values"})
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
EPS = 1e-6


def _ident(x):
    return x


def cubic(x):
    """Keys' cubic kernel with a = -0.5 at |x|."""
    x = x.abs()
    near = (1.5 * x - 2.5) * x * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))


def tent(x):
    return (1.0 - x.abs()).clamp_min(0.0)


def resize_matrix(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """[n_out, n_in]: output sample i at input position (i + 0.5) n_in / n_out
    - 0.5, the kernel widened by n_in / n_out when shrinking, each row
    normalized (a row of negligible sum and a sample outside the input are
    zero)."""
    step = n_in / n_out
    width = max(step, 1.0)
    at = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * step - 0.5
    src = torch.arange(n_in, dtype=torch.float64, device=device)
    w = kernel((at[:, None] - src[None, :]) / width)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps, w / total, torch.zeros_like(w))
    inside = (at >= -0.5) & (at <= n_in - 0.5)
    return (w * inside[:, None]).float()


def resize(x, size, kernel, q=_ident):
    """x [N, C, H, W] -> [N, C, size]; an axis that keeps its size is left."""
    h, w = size
    if x.shape[-2] != h:
        x = q(torch.einsum("oh,nchw->ncow", q(resize_matrix(x.shape[-2], h, kernel, x.device)), q(x)))
    if x.shape[-1] != w:
        x = q(torch.einsum("ow,nchw->ncho", q(resize_matrix(x.shape[-1], w, kernel, x.device)), q(x)))
    return x


def layernorm(x, weight=None, bias=None):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    y = (x - m) / torch.sqrt(v + EPS)
    return y if weight is None else y * weight + bias


def rope(x, pos, base):
    """x [B, H, N, D]; the first half of the features turns with pos[..., 0]
    (y), the second with pos[..., 1] (x); within each half, feature j pairs
    with j + D/4 at frequency base^(-2j / (D/2))."""
    out = []
    for half, p in zip(x.chunk(2, -1), (pos[..., 0], pos[..., 1])):
        d = half.shape[-1]
        freq = base ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
        ang = p.float()[:, None, :, None] * freq  # [B, 1, N, d/2]
        cos, sin = ang.cos(), ang.sin()
        a, b = half[..., : d // 2], half[..., d // 2:]
        out.append(torch.cat([a * cos - b * sin, b * cos + a * sin], -1))
    return torch.cat(out, -1)


def rotation_from_quaternion(q):
    """(w, x, y, z), normalized -> [..., 3, 3]."""
    w, x, y, z = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def umeyama_scale(src, dst):
    """Umeyama's s of the sim3 dst ~ s R src + t, src and dst [N, 3], by an
    SVD of the cross-covariance with the reflection fix, in float64."""
    src, dst = src.double(), dst.double()
    a, b = src - src.mean(0), dst - dst.mean(0)
    cov = b.T @ a / src.shape[0]
    u, d, vt = torch.linalg.svd(cov)
    sign = torch.ones(3, dtype=torch.float64, device=src.device)
    if torch.linalg.det(u) * torch.linalg.det(vt) < 0:
        sign[2] = -1.0
    return float((d * sign).sum() / ((a * a).sum() / src.shape[0]))


class VGGTRef:
    """VGGT's aggregator, camera head and depth head for one sequence."""

    def __init__(self, cfg: dict, w: dict, q):
        unknown = sorted(set(cfg) - VGGT_WIDTHS)
        if unknown:
            raise ValueError(f"the reference does not compute the VGGT widths {unknown}")
        if cfg.get("patch_embed", "dinov2") != "dinov2":
            raise ValueError(f"the reference computes the DINOv2 front end only, not {cfg['patch_embed']!r}")
        self.c = {"img_size": 518, "patch_size": 14, "embed_dim": 1024, "depth": 24, "num_heads": 16,
                  "mlp_ratio": 4.0, "num_register_tokens": 4, "rope_freq": 100.0, "camera_trunk_depth": 4,
                  "camera_iterations": 4, "dpt_features": 256, "vit_depth": 24, "vit_num_heads": 16}
        self.c.update({k: v for k, v in cfg.items() if k in self.c})
        self.w, self.q = w, q

    def p(self, name):
        return self.w["depth_estimator." + name]

    def linear(self, name, x):
        return self.q(F.linear(self.q(x), self.q(self.p(name + ".weight")), self.q(self.p(name + ".bias"))))

    def conv(self, name, x, stride=1, padding=0, transpose=False):
        bias = self.w.get("depth_estimator." + name + ".bias")
        op = F.conv_transpose2d if transpose else F.conv2d
        return self.q(op(self.q(x), self.q(self.p(name + ".weight")), None if bias is None else self.q(bias),
                         stride=stride, padding=padding))

    def norm(self, name, x):
        return layernorm(x, self.p(name + ".weight"), self.p(name + ".bias"))

    def attention(self, name, x, heads, pos, qk_norm):
        b, n, c = x.shape
        d = c // heads
        qkv = self.linear(name + ".qkv", x).reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if qk_norm:
            q, k = self.norm(name + ".q_norm", q), self.norm(name + ".k_norm", k)
        if pos is not None and self.c["rope_freq"] > 0:
            q, k = rope(q, pos, self.c["rope_freq"]), rope(k, pos, self.c["rope_freq"])
        att = torch.softmax(self.q(q) @ self.q(k).transpose(-1, -2) / math.sqrt(d), -1)
        out = self.q(self.q(att) @ self.q(v))
        return self.linear(name + ".proj", out.transpose(1, 2).reshape(b, n, c))

    def block(self, name, x, heads, pos=None, qk_norm=True):
        x = x + self.p(name + ".ls1.gamma") * self.attention(name + ".attn", self.norm(name + ".norm1", x), heads,
                                                             pos, qk_norm)
        h = self.q(F.gelu(self.linear(name + ".mlp.fc1", self.norm(name + ".norm2", x)), approximate="tanh"))
        return x + self.p(name + ".ls2.gamma") * self.linear(name + ".mlp.fc2", h)

    def dino(self, x):
        """[S, 3, H, W] normalized -> patch tokens [S, P, C]."""
        c, ps = self.c["embed_dim"], self.c["patch_size"]
        pre = "aggregator.patch_embed."
        s, _, h, w = x.shape
        hp, wp = h // ps, w // ps
        patches = self.conv(pre + "patch_embed.proj", x, stride=ps).flatten(2).transpose(1, 2)
        grid = self.c["img_size"] // ps
        pos = self.p(pre + "pos_embed")
        pos_patch = pos[:, 1:].reshape(1, grid, grid, c).permute(0, 3, 1, 2)
        pos_patch = resize(pos_patch, (hp, wp), cubic, self.q).permute(0, 2, 3, 1).reshape(1, hp * wp, c)
        tok = torch.cat([self.p(pre + "cls_token").expand(s, 1, c), patches], 1)
        tok = tok + torch.cat([pos[:, :1], pos_patch], 1)
        reg = self.p(pre + "register_tokens").expand(s, -1, c)
        tok = torch.cat([tok[:, :1], reg, tok[:, 1:]], 1)
        for i in range(self.c["vit_depth"]):
            tok = self.block(f"{pre}blocks.{i}", tok, self.c["vit_num_heads"], qk_norm=False)
        return self.norm(pre + "norm", tok)[:, 1 + self.c["num_register_tokens"]:]

    def taps(self):
        depth = self.c["depth"]
        if depth >= 24:
            return (4, 11, 17, 23)
        k = max(depth // 4, 1)
        return (k - 1, 2 * k - 1, 3 * k - 1, depth - 1)

    def aggregate(self, images):
        """[S, H, W, 3] in [0, 1] -> ({round: [S, P, 2C]} for the taps and the
        last round, index of the first patch token)."""
        s, h, w, _ = images.shape
        c, ps, r = self.c["embed_dim"], self.c["patch_size"], self.c["num_register_tokens"]
        mean = torch.tensor(MEAN, device=images.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=images.device).view(1, 3, 1, 1)
        patches = self.dino((images.permute(0, 3, 1, 2) - mean) / std)
        which = [0] + [1] * (s - 1)
        special = torch.cat([self.p("aggregator.camera_token")[0, which],
                             self.p("aggregator.register_token")[0, which]], 1)  # [S, 1 + R, C]
        tok = torch.cat([special, patches], 1)
        n = tok.shape[1]
        hp, wp = h // ps, w // ps
        ys, xs = torch.meshgrid(torch.arange(hp, device=images.device), torch.arange(wp, device=images.device),
                                indexing="ij")
        pos = torch.cat([torch.zeros(1 + r, 2, dtype=torch.long, device=images.device),
                         torch.stack([ys.reshape(-1), xs.reshape(-1)], -1) + 1])  # [P, 2]
        keep = set(self.taps()) | {self.c["depth"] - 1}
        out = {}
        for i in range(self.c["depth"]):
            tok = self.block(f"aggregator.frame_blocks.{i}", tok, self.c["num_heads"], pos[None].expand(s, n, 2))
            framewise = tok
            tok = self.block(f"aggregator.global_blocks.{i}", tok.reshape(1, s * n, c), self.c["num_heads"],
                             pos.repeat(s, 1)[None]).reshape(s, n, c)
            if i in keep:
                out[i] = torch.cat([framewise, tok], -1)
        return out, 1 + r

    def camera(self, last):
        """The last round [S, P, 2C] -> world->camera extrinsics [S, 3, 4]."""
        tok = self.norm("camera_head.token_norm", last[:, 0])
        s, dim = tok.shape
        pred = None
        for _ in range(self.c["camera_iterations"]):
            inp = self.p("camera_head.empty_pose_tokens")[0].expand(s, 9) if pred is None else pred
            mod = self.linear("camera_head.poseLN_modulation.1", F.silu(self.linear("camera_head.embed_pose", inp)))
            shift, scale, gate = mod.chunk(3, -1)
            x = gate * (layernorm(tok) * (1 + scale) + shift) + tok
            for j in range(self.c["camera_trunk_depth"]):
                x = self.block(f"camera_head.trunk.{j}", x[None], self.c["num_heads"], qk_norm=False)[0]
            x = self.norm("camera_head.trunk_norm", x)
            h = self.q(F.gelu(self.linear("camera_head.pose_branch.fc1", x), approximate="tanh"))
            delta = self.linear("camera_head.pose_branch.fc2", h)
            pred = delta if pred is None else pred + delta
        rot = rotation_from_quaternion(pred[:, 3:7])
        return torch.cat([rot, pred[:, :3, None]], -1)

    def fuse(self, name, x, residual, size):
        def unit(u, y):
            y2 = self.conv(f"{name}.{u}.conv2", F.relu(self.conv(f"{name}.{u}.conv1", F.relu(y), padding=1)),
                           padding=1)
            return self.q(y + y2)

        if residual is not None:
            x = self.q(x + unit("resConfUnit1", residual))
        x = unit("resConfUnit2", x)
        size = size or (2 * x.shape[-2], 2 * x.shape[-1])
        return self.conv(f"{name}.out_conv", resize(x, size, tent, self.q))

    def depth(self, taps, start, h, w):
        """-> depth [S, H, W] from the four taps."""
        ps = self.c["patch_size"]
        hp, wp = h // ps, w // ps
        feats = []
        for li, layer in enumerate(self.taps()):
            t = self.norm("depth_head.norm", taps[layer][:, start:])
            t = t.reshape(t.shape[0], hp, wp, -1).permute(0, 3, 1, 2)
            t = self.conv(f"depth_head.projects.{li}", t)
            if li == 0:
                t = self.conv("depth_head.resize_layers.0", t, stride=4, transpose=True)
            elif li == 1:
                t = self.conv("depth_head.resize_layers.1", t, stride=2, transpose=True)
            elif li == 3:
                t = self.conv("depth_head.resize_layers.3", t, stride=2, padding=1)
            feats.append(self.conv(f"depth_head.scratch.layer{li + 1}_rn", t, padding=1))
        pre = "depth_head.scratch."
        x = self.fuse(pre + "refinenet4", feats[3], None, feats[2].shape[-2:])
        x = self.fuse(pre + "refinenet3", x, feats[2], feats[1].shape[-2:])
        x = self.fuse(pre + "refinenet2", x, feats[1], feats[0].shape[-2:])
        x = self.fuse(pre + "refinenet1", x, feats[0], None)
        x = resize(self.conv(pre + "output_conv1", x, padding=1), (h, w), tent, self.q)
        x = self.conv(pre + "output_conv2.2", F.relu(self.conv(pre + "output_conv2.0", x, padding=1)))
        return torch.exp(x[:, 0].clamp(-10.0, 10.0))


class Ref:
    """The reference for the configuration's widths (the tracker's, plus
    `depth_estimator`: VGGT's) and one state dict."""

    def __init__(self, cfg: dict, state: dict, lowp=None, frame_block: int = 8):
        cfg = dict(cfg)
        vggt_cfg = cfg.pop("depth_estimator", None)
        self.tracker = TrackerRef(cfg, state, lowp=lowp, frame_block=frame_block)
        self.vggt = None if vggt_cfg is None else VGGTRef(vggt_cfg, self.tracker.w, lowp or _ident)

    def input_size(self, h, w):
        c = self.vggt.c
        rows = round(h * c["img_size"] / w / c["patch_size"]) * c["patch_size"]
        if rows > c["img_size"]:
            raise ValueError(f"a {h}x{w} frame would be cropped by VGGT's preprocessing; not computed")
        return rows, c["img_size"]

    @torch.no_grad()
    def estimate_depth(self, rgbs, extrs):
        """rgbs [V, T, H, W, 3] in 0..255, extrs [V, T, 3, 4] -> [V, T, H, W]."""
        v, t, h, w, _ = rgbs.shape
        size = self.input_size(h, w)
        out = torch.empty(v, t, h, w, device=rgbs.device)
        for ti in range(t):
            frames = resize(rgbs[:, ti].float().permute(0, 3, 1, 2) / 255.0, size, cubic).clamp(0.0, 1.0)
            taps, start = self.vggt.aggregate(frames.permute(0, 2, 3, 1))
            est = self.vggt.camera(taps[self.vggt.c["depth"] - 1])
            centres_est = -torch.einsum("vij,vi->vj", est[:, :, :3], est[:, :, 3])
            centres_rig = -torch.einsum("vij,vi->vj", extrs[:, ti, :, :3].float(), extrs[:, ti, :, 3].float())
            depth = self.vggt.depth(taps, start, *size) * umeyama_scale(centres_est, centres_rig)
            out[:, ti] = resize(depth[:, None], (h, w), tent)[:, 0]
        return out

    @torch.no_grad()
    def forward(self, rgbs, depths, queries, intrs, extrs, iters, depth_source=None):
        if depth_source is not None:
            if depth_source != "vggt_aligned":
                raise ValueError(f"the reference computes depth_source 'vggt_aligned' only, not {depth_source!r}")
            if self.vggt is None:
                raise ValueError("depth_source 'vggt_aligned' needs the configuration's depth_estimator")
            depths = self.estimate_depth(rgbs, extrs)
        return self.tracker.forward(rgbs, depths, queries, intrs, extrs, iters)
