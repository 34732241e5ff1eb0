"""Differentiable 3D gaussian splatting, counterpart of
`mvtracker_tpu/ops/gsplat.py`, in plain PyTorch.

The JAX renderer keeps every shape static, and so does this one:

1. project all N gaussians once (EWA splatting: the perspective Jacobian
   applied to the 3D covariance, plus a 0.3 px low-pass);
2. sort them by camera depth (stable `argsort`), invalid or culled ones at
   depth +inf, so they sink to the back with opacity 0;
3. composite front to back over fixed chunks of gaussians, carrying each
   pixel's transmittance; within a chunk an exclusive cumulative product of
   (1 - alpha) keeps the exact compositing order.

Each chunk runs under `torch.utils.checkpoint` (non-reentrant), as the JAX
chunk body runs under `jax.checkpoint`: the backward keeps only the carries
between chunks and recomputes one chunk's [chunk, H*W] tensors at a time,
so its memory is O(H*W*chunk) and not O(H*W*N). No Pallas kernel stands
behind the JAX renderer (the compositor is a `lax.scan` of dense
elementwise ops), so none stands behind this one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# Alpha below this contributes nothing (the CUDA rasterizers' 1/255 cutoff);
# alpha is clamped below 1 first, for a stable cumulative product.
_ALPHA_EPS = 1.0 / 255.0
_ALPHA_MAX = 0.999


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at 0 is 1, as `jnp.abs` differentiates (torch's
    `abs` gives 0 there). The losses of the splatting baselines take |a - b|
    of tensors that start equal, where the choice moves parameters."""
    return torch.where(x >= 0, x, -x)


def pick(x: torch.Tensor, i: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """`x` at the index held by the 0-dim tensor `i` along `dim`, by
    `index_select` (indexing with a 0-dim tensor reads it to the host)."""
    return x.index_select(dim, i.reshape(1)).squeeze(dim)


def _unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-8)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalize wxyz quaternion(s) [..., 4] -> rotation matrix [..., 3, 3]."""
    q = _unit(q)
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def cont6d_to_rotmat(c: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation [..., 6] -> [..., 3, 3] (Gram-Schmidt on two
    column vectors)."""
    a1, a2 = c[..., :3], c[..., 3:]
    b1 = _unit(a1)
    a2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = _unit(a2)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_cont6d(r: torch.Tensor) -> torch.Tensor:
    """Inverse of `cont6d_to_rotmat` (the first two columns)."""
    return torch.cat([r[..., :, 0], r[..., :, 1]], dim=-1)


def build_cov3d(log_scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Per-gaussian world covariance R S S^T R^T; scales are exp(log_scales)."""
    r = quat_to_rotmat(quats)
    rs = r * torch.exp(log_scales)[..., None, :]
    return rs @ rs.transpose(-1, -2)


class ProjectedGaussians(NamedTuple):
    """Screen-space gaussians, ready for rasterization."""

    means2d: torch.Tensor  # [N, 2] pixel coords
    conic: torch.Tensor  # [N, 3] upper triangle of the inverse 2D covariance (a, b, c)
    depths: torch.Tensor  # [N] camera z (+inf if invalid)
    opacities: torch.Tensor  # [N] in [0, 1], zeroed if invalid
    radii: torch.Tensor  # [N] 3-sigma screen radius in px (0 if invalid)


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    intr: torch.Tensor,
    w2c: torch.Tensor,
    img_wh: tuple[int, int],
    near: float = 0.01,
    far: float = 1e4,
) -> ProjectedGaussians:
    """EWA-project 3D gaussians into a pinhole camera.

    means3d [N,3], cov3d [N,3,3], opacities [N], intr [3,3], w2c [3,4] or [4,4].
    """
    w, h = img_wh
    rot, tr = w2c[:3, :3], w2c[:3, 3]
    p_cam = means3d @ rot.T + tr
    z = p_cam[..., 2]
    fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]

    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    means2d = torch.stack([fx * p_cam[..., 0] / z_safe + cx, fy * p_cam[..., 1] / z_safe + cy], dim=-1)

    # J W Sigma W^T J^T with the perspective Jacobian J; the tangent terms
    # clamped to 1.3 times the half field of view, as the CUDA rasterizers do.
    x, y = p_cam[..., 0], p_cam[..., 1]
    lim_x = 1.3 * (0.5 * w / fx)
    lim_y = 1.3 * (0.5 * h / fy)
    tx = torch.minimum(torch.maximum(x / z_safe, -lim_x), lim_x) * z_safe
    ty = torch.minimum(torch.maximum(y / z_safe, -lim_y), lim_y) * z_safe
    zero = torch.zeros_like(z_safe)
    j = torch.stack(
        [
            torch.stack([fx / z_safe, zero, -fx * tx / (z_safe * z_safe)], -1),
            torch.stack([zero, fy / z_safe, -fy * ty / (z_safe * z_safe)], -1),
        ],
        dim=-2,
    )  # [N, 2, 3]
    jw = j @ rot
    cov2d = jw @ cov3d @ jw.transpose(-1, -2)
    cov2d = cov2d + 0.3 * torch.eye(2, dtype=cov2d.dtype, device=cov2d.device)

    a, b, c = cov2d[..., 0, 0], cov2d[..., 0, 1], cov2d[..., 1, 1]
    det = a * c - b * b
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radii = torch.ceil(3.0 * torch.sqrt(lam_max))

    on_screen = (
        (means2d[..., 0] > -radii)
        & (means2d[..., 0] < w + radii)
        & (means2d[..., 1] > -radii)
        & (means2d[..., 1] < h + radii)
    )
    valid = (z > near) & (z < far) & (det > 0) & on_screen
    return ProjectedGaussians(
        means2d=means2d,
        conic=conic,
        depths=torch.where(valid, z, torch.full_like(z, float("inf"))),
        opacities=torch.where(valid, opacities, torch.zeros_like(opacities)),
        radii=torch.where(valid, radii, torch.zeros_like(radii)),
    )


def _composite_chunk(px, py, trans, acc_attr, acc_depth, m2d, con, dep, opa, att):
    """One chunk of the front-to-back composite: the carries (transmittance
    [HW], attribute [HW, A] and depth [HW, 1] sums) after `chunk` more
    depth-sorted gaussians."""
    dx = px[None, :] - m2d[:, 0:1]  # [chunk, HW]
    dy = py[None, :] - m2d[:, 1:2]
    power = -0.5 * (con[:, 0:1] * dx * dx + con[:, 2:3] * dy * dy) - con[:, 1:2] * dx * dy
    alpha = opa[:, None] * torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(alpha, 0.0, _ALPHA_MAX)
    alpha = torch.where(alpha < _ALPHA_EPS, torch.zeros_like(alpha), alpha)
    cum = torch.cumprod(1.0 - alpha, dim=0)
    excl = torch.cat([torch.ones_like(cum[:1]), cum[:-1]], dim=0)  # exclusive: in-chunk order
    wgt = alpha * excl * trans[None, :]
    acc_attr = acc_attr + wgt.T @ att
    dep_finite = torch.where(torch.isfinite(dep), dep, torch.zeros_like(dep))
    acc_depth = acc_depth + wgt.T @ dep_finite[:, None]
    return trans * cum[-1], acc_attr, acc_depth


def _composite_chunked(means2d, conic, depths, opacities, attrs, img_wh, chunk):
    """Front-to-back compositing of depth-sorted gaussians over the pixel
    grid. attrs [N, A]. Returns (attribute image [H*W, A], alpha [H*W],
    expected depth [H*W])."""
    w, h = img_wh
    n = means2d.shape[0]
    pad = (-n) % chunk
    if pad:
        means2d = F.pad(means2d, (0, 0, 0, pad))
        conic = F.pad(conic, (0, 0, 0, pad))
        depths = F.pad(depths, (0, pad), value=float("inf"))
        opacities = F.pad(opacities, (0, pad))
        attrs = F.pad(attrs, (0, 0, 0, pad))
    dtype, device = means2d.dtype, means2d.device
    # Pixel centres at integer coordinates (the repo's convention).
    py, px = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    px = px.reshape(-1).to(dtype)
    py = py.reshape(-1).to(dtype)
    hw = h * w
    trans = torch.ones(hw, dtype=dtype, device=device)
    acc_attr = torch.zeros(hw, attrs.shape[-1], dtype=dtype, device=device)
    acc_depth = torch.zeros(hw, 1, dtype=dtype, device=device)
    recompute = torch.is_grad_enabled() and any(
        t.requires_grad for t in (means2d, conic, depths, opacities, attrs))
    for s in range(0, n + pad, chunk):
        args = (px, py, trans, acc_attr, acc_depth, means2d[s : s + chunk], conic[s : s + chunk],
                depths[s : s + chunk], opacities[s : s + chunk], attrs[s : s + chunk])
        if recompute:
            trans, acc_attr, acc_depth = checkpoint(_composite_chunk, *args, use_reentrant=False,
                                                    preserve_rng_state=False)
        else:
            trans, acc_attr, acc_depth = _composite_chunk(*args)
    return acc_attr, 1.0 - trans, acc_depth[:, 0]


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # [H, W, A]
    alpha: torch.Tensor  # [H, W]
    depth: torch.Tensor  # [H, W] alpha-weighted expected depth
    radii: torch.Tensor  # [N] screen radii (0 for culled): densification statistics
    means2d: torch.Tensor  # [N, 2] projected centres


def render_gaussians(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    log_scales: torch.Tensor,
    logit_opacities: torch.Tensor,
    colors: torch.Tensor,
    intr: torch.Tensor,
    w2c: torch.Tensor,
    img_wh: tuple[int, int],
    bg: torch.Tensor | None = None,
    chunk: int = 512,
    means2d_offset: torch.Tensor | None = None,
) -> RenderOutput:
    """Render N gaussians into one pinhole view; colors [N, A] for any A.

    Differentiable in every gaussian parameter. Pass a zeros [N, 2]
    `means2d_offset` that requires grad to read the screen-space centre
    gradients, the densification statistic.
    """
    w, h = img_wh
    cov3d = build_cov3d(log_scales, quats)
    opac = torch.sigmoid(logit_opacities.reshape(-1))
    proj = project_gaussians(means3d, cov3d, opac, intr, w2c, (w, h))
    means2d = proj.means2d
    if means2d_offset is not None:
        means2d = means2d + means2d_offset

    order = torch.argsort(proj.depths, stable=True)
    attr = colors.to(means3d.dtype)
    acc, alpha, depth = _composite_chunked(
        means2d[order], proj.conic[order], proj.depths[order], proj.opacities[order], attr[order], (w, h), chunk)
    if bg is not None:
        acc = acc + (1.0 - alpha)[:, None] * bg[None, :]
    return RenderOutput(
        rgb=acc.reshape(h, w, -1),
        alpha=alpha.reshape(h, w),
        depth=depth.reshape(h, w),
        radii=proj.radii,
        means2d=proj.means2d,
    )


def render_reference(means3d, quats, log_scales, logit_opacities, colors, intr, w2c, img_wh, bg=None):
    """The unchunked renderer (one chunk of all N gaussians): O(H*W*N)
    memory, the same result as `render_gaussians`."""
    return render_gaussians(means3d, quats, log_scales, logit_opacities, colors, intr, w2c, img_wh, bg=bg,
                            chunk=max(1, means3d.shape[0]))


def ssim(img0: torch.Tensor, img1: torch.Tensor, window: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] image pair (gaussian window, valid
    convolutions)."""
    half = window // 2
    coords = torch.arange(window, dtype=img0.dtype, device=img0.device) - half
    g = torch.exp(-(coords**2) / (2 * sigma**2))
    g = g / g.sum()
    kh = g.reshape(1, 1, window, 1)
    kw = g.reshape(1, 1, 1, window)

    def blur(x):  # separable, per channel
        x = x.permute(2, 0, 1)[:, None]  # [C, 1, H, W]
        x = F.conv2d(F.conv2d(x, kh), kw)
        return x[:, 0].permute(1, 2, 0)

    c1, c2 = 0.01**2, 0.03**2
    mu0, mu1 = blur(img0), blur(img1)
    var0 = blur(img0 * img0) - mu0 * mu0
    var1 = blur(img1 * img1) - mu1 * mu1
    cov = blur(img0 * img1) - mu0 * mu1
    num = (2 * mu0 * mu1 + c1) * (2 * cov + c2)
    den = (mu0 * mu0 + mu1 * mu1 + c1) * (var0 + var1 + c2)
    return torch.mean(num / den)


def gaussian_influence(
    points: torch.Tensor,
    means3d: torch.Tensor,
    quats: torch.Tensor,
    log_scales: torch.Tensor,
    logit_opacities: torch.Tensor,
) -> torch.Tensor:
    """Opacity-weighted density of each gaussian at each query point,
    `sigmoid(o) * exp(-1/2 (x-mu)^T Sigma^-1 (x-mu))` -> [M, N], solved in
    the gaussian's own frame (Sigma^-1 = R S^-2 R^T)."""
    r = quat_to_rotmat(quats)  # [N, 3, 3]
    inv_s = torch.exp(-log_scales)  # [N, 3]
    diff = points[:, None, :] - means3d[None, :, :]  # [M, N, 3]
    local = torch.einsum("nij,mni->mnj", r, diff)
    maha = torch.sum((local * inv_s[None]) ** 2, dim=-1)
    return torch.sigmoid(logit_opacities.reshape(-1))[None, :] * torch.exp(-0.5 * maha)
