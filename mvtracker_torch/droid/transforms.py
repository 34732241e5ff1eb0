"""Rigid-transform helpers for the DROID robot-data factory, counterpart
of `mvtracker_tpu/droid/transforms.py`.

Mirrors the reference's `conversions/droid/utils/transforms.py` math:
6-DoF pose vectors <-> homogeneous matrices and batched world->pixel
projections. Pure numpy (host-side preprocessing), vectorized over frames
where the reference loops.
"""

from __future__ import annotations

import numpy as np


def euler_xyz_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """Intrinsic xyz Euler angles [..., 3] -> rotation matrices [..., 3, 3].

    Matches `scipy.spatial.transform.Rotation.from_euler('xyz', ...)` as
    used by the reference (`transforms.py:27-31`).
    """
    rpy = np.asarray(rpy, np.float64)
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    # R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (intrinsic xyz == extrinsic zyx).
    r = np.empty(rpy.shape[:-1] + (3, 3))
    r[..., 0, 0] = cy * cp
    r[..., 0, 1] = cy * sp * sr - sy * cr
    r[..., 0, 2] = cy * sp * cr + sy * sr
    r[..., 1, 0] = sy * cp
    r[..., 1, 1] = sy * sp * sr + cy * cr
    r[..., 1, 2] = sy * sp * cr - cy * sr
    r[..., 2, 0] = -sp
    r[..., 2, 1] = cp * sr
    r[..., 2, 2] = cp * cr
    return r


def rotvec_to_matrix(rv: np.ndarray) -> np.ndarray:
    """Rodrigues: rotation vector [3] -> matrix [3, 3]."""
    rv = np.asarray(rv, np.float64)
    theta = np.linalg.norm(rv)
    if theta < 1e-12:
        return np.eye(3)
    k = rv / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def pose6_to_T(p: np.ndarray) -> np.ndarray:
    """[x, y, z, roll, pitch, yaw] -> 4x4 (reference `transforms.py:17-31`)."""
    p = np.asarray(p, np.float64)
    t = np.eye(4)
    t[:3, 3] = p[:3]
    t[:3, :3] = euler_xyz_to_matrix(p[3:6])
    return t


def pose6_to_T_batch(p: np.ndarray) -> np.ndarray:
    """[T, 6] -> [T, 4, 4], vectorized."""
    p = np.asarray(p, np.float64)
    out = np.tile(np.eye(4), (len(p), 1, 1))
    out[:, :3, 3] = p[:, :3]
    out[:, :3, :3] = euler_xyz_to_matrix(p[:, 3:6])
    return out


def rvec_tvec_to_matrix(val) -> np.ndarray:
    """[tx, ty, tz, rx, ry, rz] (translation + euler) -> 4x4
    (reference `transforms.py:34-50`)."""
    val = np.asarray(val, np.float64)
    t = np.eye(4)
    t[:3, 3] = val[:3]
    t[:3, :3] = euler_xyz_to_matrix(val[3:6])
    return t


def project_tracks_to_2d(
    tracks_3d: np.ndarray,  # [T, N, 3] world
    k: np.ndarray,  # [3, 3]
    world_t_cam: np.ndarray,  # [4, 4] static or [T, 4, 4] per-frame cam->world
    width: int,
    height: int,
    min_depth: float = 0.01,
    clip_to_bounds: bool = False,
) -> np.ndarray:
    """Project 3D world tracks into a camera; invalid projections are NaN.

    Mirrors reference `transforms.py:279-322` (note: calibration provides
    cam->world poses; projection uses the inverse), vectorized over frames.
    Returns [T, N, 2].
    """
    t_frames, n, _ = tracks_3d.shape
    if world_t_cam.ndim == 2:
        world_t_cam = np.broadcast_to(world_t_cam, (t_frames, 4, 4))
    cam_t_world = np.linalg.inv(world_t_cam)

    pts_h = np.concatenate([tracks_3d, np.ones((t_frames, n, 1))], axis=-1)
    cam_pts = np.einsum("tij,tnj->tni", cam_t_world[:, :3, :], pts_h)
    z = cam_pts[..., 2]
    pix_h = np.einsum("ij,tnj->tni", k, cam_pts)
    with np.errstate(divide="ignore", invalid="ignore"):
        pix = pix_h[..., :2] / pix_h[..., 2:]

    invalid = z < min_depth
    if clip_to_bounds:
        invalid |= (
            (pix[..., 0] < 0) | (pix[..., 0] >= width)
            | (pix[..., 1] < 0) | (pix[..., 1] >= height)
        )
    pix = pix.astype(np.float32)
    pix[invalid] = np.nan
    return pix


def estimate_zed_intrinsics(width: int, height: int) -> np.ndarray:
    """Approximate ZED-2 intrinsics from video dimensions.

    Mirrors reference `render_tracks_from_mp4.py:567-596`
    (`estimate_zed_intrinsics`): the render path falls back to a typical
    ZED-2 focal (fx ~ 0.42 * width, ~110 deg HFOV class, square pixels,
    principal point at the image center) when an episode's
    `intrinsics.json` is missing — good enough for visualization overlays,
    not for metric work.
    """
    fx = 0.42 * width
    return np.array(
        [[fx, 0.0, width / 2.0], [0.0, fx, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float64,
    )
