"""Camera geometry (L0), counterpart of `mvtracker_tpu/utils/geometry.py`.

Conventions are the JAX package's:
- intrinsics ``K``: [..., 3, 3]; the centre of the top-left pixel is (0, 0);
- extrinsics ``E``: [..., 3, 4] world->camera;
- a depth map sampled with stride ``s`` places cell (i, j) at pixel
  ``((j + 0.5) * s - 0.5, (i + 0.5) * s - 0.5)``.

Matrix inverses run in float32 whatever the input dtype.
"""

from __future__ import annotations

import torch


def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """Append a constant 1 to the last axis. [..., D] -> [..., D+1]."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def from_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """Drop the last (homogeneous) coordinate. [..., D+1] -> [..., D]."""
    return x[..., :-1]


def extrinsics_square(extrs: torch.Tensor) -> torch.Tensor:
    """Pad [..., 3, 4] world->camera extrinsics to a square [..., 4, 4]."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=extrs.dtype, device=extrs.device)
    bottom = bottom.expand(*extrs.shape[:-2], 1, 4)
    return torch.cat([extrs, bottom], dim=-2)


def invert_intrinsics(intrs: torch.Tensor) -> torch.Tensor:
    """Invert [..., 3, 3] intrinsics in float32, cast back to the input dtype."""
    return torch.linalg.inv(intrs.float()).to(intrs.dtype)


def invert_extrinsics(extrs: torch.Tensor) -> torch.Tensor:
    """Invert [..., 3, 4] world->camera extrinsics to [..., 4, 4] camera->world."""
    return torch.linalg.inv(extrinsics_square(extrs).float()).to(extrs.dtype)


def pixel_grid(height: int, width: int, stride: int, device=None) -> torch.Tensor:
    """Pixel-centre coordinates of a strided sampling grid, xy order: [H, W, 2]."""
    ys = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) * stride - 0.5
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) * stride - 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2, stride-2 average pool over the last two axes of [..., H, W]."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def nearest_downsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x downsample over the last two axes (even indices)."""
    return x[..., ::2, ::2]


def nearest_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest downsample over the last two axes by an integer factor:
    output[i] = input[i * factor], as `F.interpolate(scale_factor=1/factor,
    mode="nearest")`."""
    return x[..., ::factor, ::factor]


def unproject_depth_to_world(
    depths: torch.Tensor,  # [*B, H, W]
    intrs_inv: torch.Tensor,  # [*B, 3, 3]
    extrs_inv: torch.Tensor,  # [*B, 4, 4]
    stride: int,
) -> torch.Tensor:
    """Unproject a (strided) depth map to world xyz per pixel: [*B, H, W, 3]."""
    h, w = depths.shape[-2:]
    grid_h = to_homogeneous(pixel_grid(h, w, stride, depths.device).to(depths.dtype))
    cam = torch.einsum("...ij,hwj->...hwi", intrs_inv, grid_h)
    cam = cam * depths[..., None]
    world_h = torch.einsum("...ij,...hwj->...hwi", extrs_inv, to_homogeneous(cam))
    return world_h[..., :3]


def init_pointcloud_from_rgbd(
    fmaps: torch.Tensor,  # [B, V, S, H, W, C] channels-last
    depths: torch.Tensor,  # [B, V, S, H, W]
    intrs: torch.Tensor,  # [B, V, S, 3, 3]
    extrs: torch.Tensor,  # [B, V, S, 3, 4]
    stride: int = 4,
    level: int = 0,
    return_validity_mask: bool = False,
):
    """Fuse per-view feature maps and depths into one world-space feature
    cloud per (batch, frame) at pyramid `level`.

    Features are 2x2 average-pooled and depths nearest-downsampled `level`
    times. Returns xyz [B*S, V*H'*W', 3] and fvec [B*S, V*H'*W', C], flattened
    as (B, S) across clouds and (V, H, W) within one, like the JAX package.
    With `return_validity_mask` also valid [B*S, V*H'*W'] bool, true where
    the (downsampled) depth is positive.
    """
    b, v, s, h, w, c = fmaps.shape
    if depths.shape != (b, v, s, h, w):
        raise ValueError(f"depths {tuple(depths.shape)} do not match fmaps {tuple(fmaps.shape)}")
    for _ in range(level):
        fmaps = fmaps.reshape(b, v, s, h // 2, 2, w // 2, 2, c).mean(dim=(4, 6))
        depths = nearest_downsample_2x(depths)
        h, w = h // 2, w // 2
    world = unproject_depth_to_world(
        depths, invert_intrinsics(intrs), invert_extrinsics(extrs), stride * 2**level
    )
    xyz = world.permute(0, 2, 1, 3, 4, 5).reshape(b * s, v * h * w, 3)
    fvec = fmaps.permute(0, 2, 1, 3, 4, 5).reshape(b * s, v * h * w, c)
    if return_validity_mask:
        return xyz, fvec, (depths > 0).permute(0, 2, 1, 3, 4).reshape(b * s, v * h * w)
    return xyz, fvec


def world_to_pixel_xy_and_camera_z(world_xyz: torch.Tensor, intrs: torch.Tensor, extrs: torch.Tensor):
    """Project world points [*B, N, 3] into cameras with intrs [*B, 3, 3]
    and extrs [*B, 3, 4] -> (pixel_xy [*B, N, 2], camera_z [*B, N, 1])."""
    camera_xyz = torch.einsum("...ij,...nj->...ni", extrs, to_homogeneous(world_xyz))
    camera_z = camera_xyz[..., -1:]
    pixel_h = torch.einsum("...ij,...nj->...ni", intrs, camera_xyz)
    return pixel_h[..., :2] / pixel_h[..., -1:], camera_z


def pixel_xy_and_camera_z_to_world(
    pixel_xy: torch.Tensor,  # [*B, N, 2]
    camera_z: torch.Tensor,  # [*B, N, 1]
    intrs_inv: torch.Tensor,  # [*B, 3, 3]
    extrs_inv: torch.Tensor,  # [*B, 4, 4]
) -> torch.Tensor:
    """Lift pixel coordinates and camera-space depth back to world xyz [*B, N, 3]."""
    camera_xyz = torch.einsum("...ij,...nj->...ni", intrs_inv, to_homogeneous(pixel_xy)) * camera_z
    world_h = torch.einsum("...ij,...nj->...ni", extrs_inv, to_homogeneous(camera_xyz))
    return world_h[..., :3]


def reprojection_roundtrip_dev(world_xyz: torch.Tensor, intrs: torch.Tensor, extrs: torch.Tensor) -> torch.Tensor:
    """Largest |world -> (pixel xy, camera z) -> world| deviation over all
    views, a scalar: the runtime guard on the projection algebra.

    world_xyz [*B, N, 3]; intrs [V, *B, 3, 3] and extrs [V, *B, 3, 4] carry a
    leading view axis. Points with |camera z| <= 1e-3 are left out (the
    round trip divides and multiplies by z); 0 when every point is.
    """
    pix, z = world_to_pixel_xy_and_camera_z(world_xyz[None], intrs, extrs)
    back = pixel_xy_and_camera_z_to_world(pix, z, invert_intrinsics(intrs), invert_extrinsics(extrs))
    dev = (back - world_xyz[None]).abs().amax(dim=-1)
    ok = z[..., 0].abs() > 1e-3
    return torch.where(ok, dev, torch.zeros_like(dev)).max()


def get_points_on_a_grid(size: int, extent: tuple, center: tuple | None = None, device=None) -> torch.Tensor:
    """Uniform grid of size * size pixel positions over an image of `extent`
    (H, W) with a margin of W/64, as reference `model_utils.py:361-417`:
    [1, size^2, 2] in (x, y) order. size 1 gives the image centre."""
    if size == 1:
        return torch.tensor([[[extent[1] / 2, extent[0] / 2]]], dtype=torch.float32, device=device)
    if center is None:
        center = (extent[0] / 2, extent[1] / 2)
    margin = extent[1] / 64
    range_y = (margin - extent[0] / 2 + center[0], extent[0] / 2 + center[0] - margin)
    range_x = (margin - extent[1] / 2 + center[1], extent[1] / 2 + center[1] - margin)
    grid_y, grid_x = torch.meshgrid(
        torch.linspace(*range_y, size, device=device),
        torch.linspace(*range_x, size, device=device),
        indexing="ij",
    )
    return torch.stack([grid_x, grid_y], dim=-1).reshape(1, -1, 2)


def bilinear_sample2d(im: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample channels-last maps im [B, H, W, C] at continuous
    pixel locations x, y [B, N] -> [B, N, C]. The four corner indices are
    clamped into the map; the weights are not."""
    b, h, w, c = im.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    # float -> int32 saturates in the JAX package; clamp before the cast so a
    # far-out coordinate cannot wrap.
    x0i = x0.clamp(0, w - 1).long()
    x1i = (x0 + 1).clamp(0, w - 1).long()
    y0i = y0.clamp(0, h - 1).long()
    y1i = (y0 + 1).clamp(0, h - 1).long()
    flat = im.reshape(b, h * w, c)

    def gather(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx)[..., None].expand(-1, -1, c))

    return (
        gather(y0i, x0i) * (1 - wx) * (1 - wy)
        + gather(y0i, x1i) * wx * (1 - wy)
        + gather(y1i, x0i) * (1 - wx) * wy
        + gather(y1i, x1i) * wx * wy
    )


def reduce_masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None, keepdim: bool = False, eps: float = 1e-6):
    """Mean of `x` over the entries where `mask` is nonzero:
    sum(x * mask) / (sum(mask) + eps)."""
    mask = mask.to(x.dtype)
    prod = x * mask
    if dim is None:
        return prod.sum() / (mask.sum() + eps)
    return prod.sum(dim=dim, keepdim=keepdim) / (mask.sum(dim=dim, keepdim=keepdim) + eps)


def camera_centers(extrs: torch.Tensor) -> torch.Tensor:
    """World positions [..., 3] of the cameras of world->camera extrinsics
    [..., 3, 4] with a rotation block: -R^T t."""
    return -torch.einsum("...ij,...i->...j", extrs[..., :3], extrs[..., 3])


def umeyama_sim3(src: torch.Tensor, dst: torch.Tensor):
    """The sim3 (s [B], R [B, 3, 3], t [B, 3]) minimizing |dst - (s R src + t)|
    over point sets src, dst [B, N, 3], batched and on their device, in
    float64 (Umeyama 1991; `datasets/datapoint.py::align_umeyama` gives the
    same by an SVD on the host).

    The rotation is Horn's: the unit quaternion of the largest eigenvalue of
    the 4x4 symmetric matrix built from the cross-covariance M, a proper
    rotation whatever the reflection SVD's sign fix guards against. The
    eigenvector is found without a host round trip (a linear-algebra solver
    would check its status on the host): (N + |N|_F I), which has the same
    eigenvectors and no negative eigenvalue, is squared 24 times (its power
    2^24) with renormalization, and the column of the result with the largest
    diagonal entry is taken. That eigenvalue is trace(R^T M), Umeyama's
    trace(D S), so the scale is it over the source's summed squared
    deviation. Degenerate sets (fewer than three distinct non-collinear
    points) have no unique rotation, here as with the SVD."""
    src, dst = src.double(), dst.double()
    mu_s, mu_d = src.mean(-2), dst.mean(-2)
    a, b = src - mu_s[..., None, :], dst - mu_d[..., None, :]
    m = torch.einsum("...ni,...nj->...ij", b, a)  # sum_n b_n a_n^T
    sxx, sxy, sxz = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    syx, syy, syz = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    szx, szy, szz = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    # Horn's N for R a = b (quaternion w, x, y, z): q^T N q = trace(R(q)^T M).
    n = torch.stack([
        torch.stack([sxx + syy + szz, szy - syz, sxz - szx, syx - sxy], -1),
        torch.stack([szy - syz, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([sxz - szx, sxy + syx, syy - sxx - szz, syz + szy], -1),
        torch.stack([syx - sxy, szx + sxz, syz + szy, szz - sxx - syy], -1),
    ], -2)
    eye = torch.eye(4, dtype=n.dtype, device=n.device)
    p = n + torch.linalg.matrix_norm(n)[..., None, None].clamp_min(1e-300) * eye
    for _ in range(24):
        p = p @ p
        p = p / torch.linalg.matrix_norm(p)[..., None, None].clamp_min(1e-300)
    col = torch.diagonal(p, dim1=-2, dim2=-1).argmax(-1)
    q = torch.take_along_dim(p, col[..., None, None], dim=-1)[..., 0]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ], -2)
    trace = torch.einsum("...ij,...ij->...", r, m)  # the largest eigenvalue of N
    scale = trace / (a * a).sum((-2, -1))
    t = mu_d - scale[..., None] * torch.einsum("...ij,...j->...i", r, mu_s)
    return scale, r, t
