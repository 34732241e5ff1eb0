"""Canonical batch schema + scene-space transforms (L4).

Numpy re-design of the reference's `mvtracker/datasets/utils.py:22-434`
(`Datapoint`, `collate_fn`, `transform_scene`, `add_camera_noise`,
`aug_depth`, `align_umeyama`). The data pipeline is host-side and
accelerator-free: numpy in, device tensors out at the train-step boundary.

A copy of `mvtracker_tpu/datasets/datapoint.py` (the port imports nothing
of that package). Layout, as there:
- video is channels-last [V, T, H, W, 3]; depth is [V, T, H, W];
- a batch is a plain dict of stacked numpy arrays with a leading scene
  axis; the train step moves it to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Datapoint:
    """One scene. Mirrors reference `datasets/utils.py:22-55` field-for-field
    (minus torch-specific extras), channels-last."""

    video: np.ndarray  # [V, T, H, W, 3] uint8/float
    videodepth: np.ndarray  # [V, T, H, W] float
    intrs: np.ndarray  # [V, T, 3, 3]
    extrs: np.ndarray  # [V, T, 3, 4]
    # Per-view 2D tracks: pixel xy + camera z (reference `trajectory`).
    trajectory: Optional[np.ndarray] = None  # [V, T, N, 3]
    visibility: Optional[np.ndarray] = None  # [V, T, N] bool
    trajectory_3d: Optional[np.ndarray] = None  # [T, N, 3] world
    query_points_3d: Optional[np.ndarray] = None  # [N, 4] (t, xyz)
    valid: Optional[np.ndarray] = None  # [T, N] bool
    segmentation: Optional[np.ndarray] = None  # [V, T, H, W]
    videodepthconf: Optional[np.ndarray] = None  # [V, T, H, W]
    seq_name: str = ""
    track_upscaling_factor: float = 1.0
    novel_video: Optional[np.ndarray] = None
    novel_intrs: Optional[np.ndarray] = None
    novel_extrs: Optional[np.ndarray] = None


def collate(datapoints: list[Datapoint]) -> dict[str, np.ndarray]:
    """Stack scenes into the batch dict consumed by the train step.

    Mirrors reference `collate_fn` (`datasets/utils.py:57-141`) minus torch.
    """
    def stack(attr):
        vals = [getattr(d, attr) for d in datapoints]
        if any(v is None for v in vals):
            return None
        return np.stack(vals)

    batch = {
        "rgbs": stack("video").astype(np.float32),
        "depths": stack("videodepth").astype(np.float32),
        "intrs": stack("intrs").astype(np.float32),
        "extrs": stack("extrs").astype(np.float32),
    }
    for name, attr in (
        ("query_points", "query_points_3d"),
        ("traj_gt", "trajectory_3d"),
        ("valid", "valid"),
    ):
        v = stack(attr)
        if v is not None:
            batch[name] = v.astype(np.float32)
    vis = stack("visibility")
    if vis is not None:
        batch["vis_gt"] = vis.any(axis=1).astype(np.float32)  # any-view [B, T, N]
    batch["track_upscaling_factor"] = np.asarray(
        [d.track_upscaling_factor for d in datapoints], np.float32
    )
    return batch


def transform_scene(
    scale: float,
    rotation: np.ndarray,  # [3, 3]
    translation: np.ndarray,  # [3]
    depth: Optional[np.ndarray] = None,  # [V, T, H, W]
    extrs: Optional[np.ndarray] = None,  # [V, T, 3, 4]
    query_points: Optional[np.ndarray] = None,  # [N, 4]
    traj3d_world: Optional[np.ndarray] = None,  # [T, N, 3]
    traj2d_w_z: Optional[np.ndarray] = None,  # [V, T, N, 3]
):
    """Apply X' = t + R @ (s * X) to a whole scene.

    Mirrors reference `transform_scene` (`datasets/utils.py:210-302`):
    depth and camera-z scale by s; extrinsics get translation scaled then a
    right-multiplication by the inverse rigid transform; world-space points
    scale-then-rigid.
    """
    assert np.allclose(rotation @ rotation.T, np.eye(3), atol=1e-3)
    rt = np.eye(4)
    rt[:3, :3] = rotation
    rt[:3, 3] = translation
    rt_inv = np.linalg.inv(rt)

    depth_t = depth * scale if depth is not None else None

    extrs_t = None
    if extrs is not None:
        v, t = extrs.shape[:2]
        sq = np.tile(np.eye(4), (v, t, 1, 1))
        sq[:, :, :3, :3] = extrs[:, :, :3, :3]
        sq[:, :, :3, 3] = extrs[:, :, :3, 3] * scale
        extrs_t = np.einsum("vtki,ij->vtkj", sq, rt_inv)[:, :, :3, :].astype(extrs.dtype)

    qp_t = None
    if query_points is not None:
        xyz = query_points[:, 1:4] * scale
        xyz_h = np.concatenate([xyz, np.ones_like(xyz[:, :1])], -1)
        xyz_t = (rt @ xyz_h.T).T[:, :3]
        qp_t = np.concatenate([query_points[:, :1], xyz_t], -1).astype(query_points.dtype)

    traj3d_t = None
    if traj3d_world is not None:
        xyz = traj3d_world * scale
        xyz_h = np.concatenate([xyz, np.ones_like(xyz[..., :1])], -1)
        traj3d_t = np.einsum("ij,tnj->tni", rt, xyz_h)[..., :3].astype(traj3d_world.dtype)

    traj2d_t = None
    if traj2d_w_z is not None:
        traj2d_t = traj2d_w_z.copy()
        traj2d_t[..., 2] *= scale

    return depth_t, extrs_t, qp_t, traj3d_t, traj2d_t


def add_camera_noise(intrs, extrs, noise_std_intr=0.01, noise_std_extr=0.001, rng=None):
    """Gaussian parameter noise; mirrors reference `datasets/utils.py:304-330`."""
    rng = rng or np.random.default_rng()
    return (
        intrs + rng.normal(0, noise_std_intr, size=intrs.shape),
        extrs + rng.normal(0, noise_std_extr, size=extrs.shape),
    )


def _bilinear_upsample_ac(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """align_corners=True bilinear upsample of [..., h, w] (numpy)."""
    *lead, h, w = x.shape
    def mat(no, ni):
        if ni == 1:
            return np.ones((no, 1), np.float32)
        pos = np.arange(no) * (ni - 1) / (no - 1)
        lo = np.floor(pos).astype(int)
        hi = np.minimum(lo + 1, ni - 1)
        frac = pos - lo
        m = np.zeros((no, ni), np.float32)
        m[np.arange(no), lo] += 1 - frac
        m[np.arange(no), hi] += frac
        return m
    x = np.einsum("oh,...hw->...ow", mat(out_h, h), x)
    x = np.einsum("ow,...hw->...ho", mat(out_w, w), x)
    return x


def _gaussian_blur(x: np.ndarray, kernel: int = 7, sigma: float = 2.0) -> np.ndarray:
    """Separable gaussian blur over the last two axes (reflect padding,
    matching torchvision's gaussian_blur)."""
    r = kernel // 2
    g = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    g /= g.sum()
    xp = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(r, r), (0, 0)], mode="reflect")
    x = sum(g[i] * xp[..., i : i + x.shape[-2], :] for i in range(kernel))
    xp = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, 0), (r, r)], mode="reflect")
    x = sum(g[i] * xp[..., :, i : i + x.shape[-1]] for i in range(kernel))
    return x


def aug_depth(
    depth: np.ndarray,  # [V, T, H, W]
    grid=(8, 8),
    scale=(0.7, 1.3),
    shift=(-0.1, 0.1),
    gn_kernel=7,
    gn_sigma=2.0,
    rng=None,
) -> np.ndarray:
    """Patch-wise depth scale/shift corruption + blur; mirrors reference
    `aug_depth` (`datasets/utils.py:332-360`). Zero (invalid) depth stays 0."""
    rng = rng or np.random.default_rng()
    v, t, h, w = depth.shape
    msk = depth != 0
    gh, gw = grid
    scale_map = rng.uniform(scale[0], scale[1], size=(v, t, gh, gw)).astype(np.float32)
    shift_map = rng.uniform(shift[0], shift[1], size=(v, t, gh, gw)).astype(np.float32)
    scale_map = _bilinear_upsample_ac(scale_map, h, w)
    shift_map = _bilinear_upsample_ac(shift_map, h, w)
    out = depth.copy()
    mean_valid = depth[msk].mean() if msk.any() else 0.0
    out[msk] = depth[msk] * scale_map[msk] + shift_map[msk] * mean_valid
    # Native C++/OpenMP blur when available (numpy fallback inside);
    # imported lazily — native's own fallback imports this module.
    from mvtracker_torch import native as _native

    out = _native.gaussian_blur(out, gn_kernel, gn_sigma)
    out[~msk] = 0
    return out


def align_umeyama(model: np.ndarray, data: np.ndarray, known_scale=False):
    """Sim3 alignment (s, R, t) minimizing |model - (s R data + t)|.

    Mirrors reference `align_umeyama` (`datasets/utils.py:362-395`).
    """
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mz = model - mu_m
    dz = data - mu_d
    n = model.shape[0]
    c = (mz.T @ dz) / n
    sigma2 = (dz * dz).sum() / n
    u, d, vt = np.linalg.svd(c)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt.T) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    s = 1.0 if known_scale else np.trace(np.diag(d) @ s_mat) / sigma2
    t = mu_m - s * r @ mu_d
    return s, r, t
