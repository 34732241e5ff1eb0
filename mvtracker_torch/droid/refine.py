"""Wrist-camera ICP/z-offset refinement for processed DROID episodes,
counterpart of `mvtracker_tpu/droid/refine.py`.

The DROID factory's camera refinement stage (reference
`conversions/droid/utils/optimization.py:428-601`,
`optimize_wrist_camera_icp_z_only`): the wrist ZED's depth carries a
per-rig forward bias, so its cloud floats off the externally observed
surfaces. The reference samples ~10 frames, builds a gripper-excluded
wrist cloud + a fused external-camera cloud per frame, searches the wrist
z offset in +/- 5 cm, and applies the winner along the camera's viewing
axis to every per-frame wrist pose.

Here the episode IO (depth videos, extrinsics.npz, metadata.json) feeds
the batched search of `ops/icp.py` on `device` (its kNN is the K1 kernel
on the GPU); clouds are voxel-downsampled host-side like the reference
(`voxel_size=0.01`, `optimization.py:268-272`).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from mvtracker_torch.ops import icp as icp_ops

# Reference depth gates (`optimize_wrist_camera_icp_z_only`,
# `optimization.py:506-510` / `conversions/droid/config.yaml:17-21`).
MIN_DEPTH_WRIST_ICP = 0.15  # excludes the gripper in front of the lens
WRIST_MAX_DEPTH = 0.75
EXT_MIN_DEPTH = 0.1
EXT_MAX_DEPTH = 1.5


def voxel_downsample(points: np.ndarray, voxel: float = 0.01) -> np.ndarray:
    """Mean point per occupied voxel (Open3D `voxel_down_sample` stand-in)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(
        keys, axis=0, return_inverse=True, return_counts=True
    )
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(np.float32)


def _unproject_camera_frame(depth: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Depth map [H, W] -> camera-frame xyz [H*W, 3] (zero-depth dropped)."""
    h, w = depth.shape
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    z = depth.reshape(-1)
    x = ((u.reshape(-1) - k[0, 2]) / k[0, 0]) * z
    y = ((v.reshape(-1) - k[1, 2]) / k[1, 1]) * z
    pts = np.stack([x, y, z], axis=1)
    return pts[z > 0]


def collect_refinement_frames(
    dp,
    cam_ids: list[str],
    wrist_serial: str,
    n_frames: int = 6,
    voxel: float = 0.01,
    max_points: int = 4000,
    rng: Optional[np.random.Generator] = None,
    wrist_depth_range: tuple[float, float] = (MIN_DEPTH_WRIST_ICP, WRIST_MAX_DEPTH),
    ext_depth_range: tuple[float, float] = (EXT_MIN_DEPTH, EXT_MAX_DEPTH),
) -> list[dict]:
    """Build the multi-frame optimization input from a loaded episode
    Datapoint (reference frame collection, `optimization.py:520-576`)."""
    rng = rng or np.random.default_rng(0)
    if wrist_serial not in cam_ids:
        return []
    wi = cam_ids.index(wrist_serial)
    v, t = dp.videodepth.shape[:2]
    frames = []
    for ti in np.linspace(0, t - 1, min(n_frames, t), dtype=int):
        local = _unproject_camera_frame(dp.videodepth[wi, ti], dp.intrs[wi, ti])
        local = local[
            (local[:, 2] > wrist_depth_range[0]) & (local[:, 2] < wrist_depth_range[1])
        ]
        local = voxel_downsample(local, voxel)
        ext_pts = []
        for vi in range(v):
            if vi == wi:
                continue
            pts = _unproject_camera_frame(dp.videodepth[vi, ti], dp.intrs[vi, ti])
            pts = pts[(pts[:, 2] > ext_depth_range[0]) & (pts[:, 2] < ext_depth_range[1])]
            # world = R^T (x_cam - t) for world->cam extrinsics [3, 4].
            r = dp.extrs[vi, ti, :, :3]
            tt = dp.extrs[vi, ti, :, 3]
            ext_pts.append((pts - tt) @ r)
        if not ext_pts:
            continue
        ext = voxel_downsample(np.concatenate(ext_pts, axis=0), voxel)
        if len(local) < 100 or len(ext) < 100:
            continue
        if len(local) > max_points:
            local = local[rng.permutation(len(local))[:max_points]]
        if len(ext) > max_points * 2:
            ext = ext[rng.permutation(len(ext))[: max_points * 2]]
        r = dp.extrs[wi, ti, :, :3]
        tt = dp.extrs[wi, ti, :, 3]
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = r.T
        c2w[:3, 3] = -r.T @ tt
        frames.append(
            {
                "wrist_points_local": local.astype(np.float32),
                "wrist_cam_to_world": c2w,
                "external_points_world": ext.astype(np.float32),
            }
        )
    return frames


def refine_episode_wrist_z(
    episode_dir: str,
    n_frames: int = 6,
    z_range: tuple[float, float] = (-0.05, 0.05),
    voxel: float = 0.01,
    max_corr_dist: float = 0.05,
    write: bool = False,
    max_episode_frames: Optional[int] = None,
    wrist_depth_range: tuple[float, float] = (MIN_DEPTH_WRIST_ICP, WRIST_MAX_DEPTH),
    ext_depth_range: tuple[float, float] = (EXT_MIN_DEPTH, EXT_MAX_DEPTH),
    device="cuda",
) -> dict:
    """Full-episode wrist z-offset refinement; the search runs on `device`.

    With `write=True`, applies the offset to the per-frame wrist poses in
    `extrinsics.npz` (translation shifted along each pose's viewing axis,
    reference `apply_z_offset_to_wrist_transforms`) and records the offset
    in `quality.json`.
    """
    from mvtracker_torch.datasets.droid import episode_camera_ids, load_droid_episode

    with open(os.path.join(episode_dir, "metadata.json")) as f:
        meta = json.load(f)
    wrist_serial = str(meta.get("wrist_cam_serial", ""))
    dp = load_droid_episode(episode_dir, max_frames=max_episode_frames)
    cam_ids = episode_camera_ids(episode_dir)[: dp.videodepth.shape[0]]

    frames = collect_refinement_frames(
        dp, cam_ids, wrist_serial, n_frames=n_frames, voxel=voxel,
        wrist_depth_range=wrist_depth_range, ext_depth_range=ext_depth_range,
    )
    if not frames:
        return {"status": "no_wrist_or_external", "episode": episode_dir}

    z, fitness = icp_ops.optimize_wrist_z_offset_multi_frame(
        frames, z_range=z_range, max_corr_dist=max_corr_dist, device=device
    )
    out = {
        "status": "ok",
        "episode": episode_dir,
        "wrist_z_offset_m": z,
        "fitness": fitness,
        "frames_used": len(frames),
    }
    if write:
        extr_path = os.path.join(episode_dir, "extrinsics.npz")
        data = dict(np.load(extr_path))
        if "wrist" in data:
            poses = np.asarray(data["wrist"])  # [T, 4, 4] cam->world
            poses = poses.copy()
            # Shift along each pose's viewing axis (third rotation column),
            # the reference's `apply_z_offset_to_wrist_transforms`.
            poses[:, :3, 3] += z * poses[:, :3, 2]
            data["wrist"] = poses
            np.savez_compressed(extr_path, **data)
        q_path = os.path.join(episode_dir, "quality.json")
        quality = {}
        if os.path.exists(q_path):
            with open(q_path) as f:
                quality = json.load(f)
        quality["wrist_z_offset_m"] = z
        quality["wrist_z_offset_fitness"] = fitness
        with open(q_path, "w") as f:
            json.dump(quality, f, indent=2)
    return out
