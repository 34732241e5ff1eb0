"""DROID visual-QA loop: fused-cloud reprojection + episode validation renders,
counterpart of `mvtracker_tpu/droid/reproject.py`.

Re-designs the reference factory's visual validation pair
(`conversions/droid/reproject_depth_into_videos.py` and
`conversions/droid/training_data/render_episode_validation.py`): per frame,
fuse every camera's RGB-D into one world-space colored cloud (with the
per-camera depth clamps of `conversions/droid/config.yaml:16-21`), z-buffer
render it back into each camera, and write per-camera reprojection videos,
FFV1 16-bit depth videos, and track-overlay validation videos. This is the
factory's "does the calibration + depth + tracks actually cohere" check.

All host-side numpy (the factory's render stage is CPU territory); the
z-buffer is a vectorized sort+scatter rather than the reference's Python
loop, and the gap fill is a neighborhood min-depth dilation. Depth videos
go out through the port's FFV1 writer (`droid/depth_video.py`), overlays
through `viz/mp4.save_video`.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np

# Per-camera depth clamps, meters (reference `conversions/droid/config.yaml:16-21`).
DEPTH_CLAMPS = {
    "wrist": (0.01, 0.75),
    "external": (0.1, 1.5),
}


def render_pointcloud_to_view(
    points_world: np.ndarray,  # [P, 3]
    colors: np.ndarray,  # [P, 3] uint8/float
    intr: np.ndarray,  # [3, 3]
    extr_w2c: np.ndarray,  # [3, 4] world->camera
    height: int,
    width: int,
    min_depth: float = 0.01,
    splat_size: int = 3,
) -> tuple[np.ndarray, np.ndarray]:
    """Z-buffered point rendering; returns (rgb [H,W,3] uint8, depth [H,W]).

    Equivalent of the reference's `render_dense_pointcloud_fast`
    (`reproject_depth_into_videos.py:123-221`): project, keep the closest
    point per pixel, fill small gaps. The closest-wins rule is realized by
    scattering in DESCENDING depth order (later writes win in numpy
    fancy-index assignment).
    """
    rgb = np.zeros((height, width, 3), np.uint8)
    dep = np.zeros((height, width), np.float32)
    if len(points_world) == 0:
        return rgb, dep

    cam = points_world @ extr_w2c[:, :3].T + extr_w2c[:, 3]
    z = cam[:, 2]
    ok = z > min_depth
    cam, z, colors = cam[ok], z[ok], np.asarray(colors)[ok]
    if len(cam) == 0:
        return rgb, dep
    # Round (not truncate): a point that projects to 31.9999 belongs to
    # pixel 32; truncation would systematically shift the render.
    u = np.round(cam[:, 0] * intr[0, 0] / z + intr[0, 2]).astype(np.int32)
    v = np.round(cam[:, 1] * intr[1, 1] / z + intr[1, 2]).astype(np.int32)
    ok = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    u, v, z, colors = u[ok], v[ok], z[ok], colors[ok]
    if len(u) == 0:
        return rgb, dep

    order = np.argsort(-z)  # farthest first; closest scatters last and wins
    u, v, z, colors = u[order], v[order], z[order], colors[order]
    zbuf = np.full((height, width), np.inf, np.float32)
    zbuf[v, u] = z
    rgb[v, u] = np.clip(colors, 0, 255).astype(np.uint8)

    # Gap fill: a few min-depth neighborhood passes (the reference dilates
    # with a splat kernel; here empty pixels take the closest neighbor
    # within the splat radius).
    r = max(splat_size // 2, 0)
    if r > 0:
        filled_z = zbuf.copy()
        filled_rgb = rgb.copy()
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dx == 0 and dy == 0:
                    continue
                sz = np.roll(np.roll(zbuf, dy, axis=0), dx, axis=1)
                sc = np.roll(np.roll(rgb, dy, axis=0), dx, axis=1)
                take = sz < filled_z  # closest neighbor within the radius
                filled_z = np.where(take, sz, filled_z)
                filled_rgb = np.where(take[..., None], sc, filled_rgb)
        # Only fill pixels that were empty; keep direct hits exact.
        empty0 = zbuf == np.inf
        zbuf = np.where(empty0, filled_z, zbuf)
        rgb = np.where(empty0[..., None], filled_rgb, rgb)

    dep = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
    return rgb, dep


def fuse_frame_cloud(
    rgbs: np.ndarray,  # [V, H, W, 3]
    depths: np.ndarray,  # [V, H, W]
    intrs: np.ndarray,  # [V, 3, 3]
    extrs_w2c: np.ndarray,  # [V, 3, 4]
    clamps,  # list of (min, max) per view
    stride: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Unproject every view's clamped depth into one world cloud.

    Mirrors the fusion of `generate_pointcloud_from_droid.py` with the
    per-camera clamps of `config.yaml:16-21`. Returns (points [P,3],
    colors [P,3]).
    """
    pts_all, col_all = [], []
    for vi in range(rgbs.shape[0]):
        d = depths[vi, ::stride, ::stride]
        c = rgbs[vi, ::stride, ::stride]
        k = intrs[vi].astype(np.float64)  # full-res pixels; grid scaled below
        h, w = d.shape
        lo, hi = clamps[vi]
        ys, xs = np.mgrid[0:h, 0:w]
        xs = xs * stride + (stride - 1) / 2.0
        ys = ys * stride + (stride - 1) / 2.0
        ok = (d > lo) & (d < hi)
        if not ok.any():
            continue
        zs = d[ok]
        x = (xs[ok] - k[0, 2]) / k[0, 0] * zs
        y = (ys[ok] - k[1, 2]) / k[1, 1] * zs
        cam = np.stack([x, y, zs], axis=-1)
        r = extrs_w2c[vi, :, :3]
        t = extrs_w2c[vi, :, 3]
        world = (cam - t) @ r  # R^T (cam - t)
        pts_all.append(world)
        col_all.append(c[ok])
    if not pts_all:
        return np.zeros((0, 3)), np.zeros((0, 3))
    return np.concatenate(pts_all), np.concatenate(col_all)


def _camera_clamps(cam_ids, wrist_serial: str):
    return [
        DEPTH_CLAMPS["wrist" if str(c) == str(wrist_serial) else "external"]
        for c in cam_ids
    ]


def reproject_episode(
    episode_dir: str,
    out_dir: str,
    max_frames: Optional[int] = None,
    stride: int = 2,
    splat_size: int = 3,
    write_depth_video: bool = True,
    overlay_tracks: bool = False,
    fps: float = 30.0,
) -> dict:
    """Fused-cloud reprojection for a processed episode.

    Writes, per camera: `<cam>_reprojected.mp4` (fused cloud rendered back
    into that camera) and `<cam>_depth_reprojected.mkv` (FFV1 16-bit depth
    of the render). With `overlay_tracks`, also `<cam>_validation.mp4` with
    the episode's gripper tracks drawn on the reprojection — the
    `render_episode_validation.py` role.

    Returns {camera: {paths...}}.
    """
    from mvtracker_torch.datasets.droid import episode_camera_ids, load_droid_episode
    from mvtracker_torch.droid.depth_video import FFV1DepthVideoWriter
    from mvtracker_torch.viz.mp4 import render_tracks_on_video, save_video

    dp = load_droid_episode(episode_dir, max_frames=max_frames)
    v, t, h, w = dp.videodepth.shape
    with open(os.path.join(episode_dir, "metadata.json")) as f:
        meta = json.load(f)
    wrist = str(meta.get("wrist_cam_serial", ""))
    cam_ids = episode_camera_ids(episode_dir) or [str(i) for i in range(v)]
    clamps = _camera_clamps(cam_ids[:v], wrist)

    os.makedirs(out_dir, exist_ok=True)
    renders = np.zeros((v, t, h, w, 3), np.uint8)
    rdepths = np.zeros((v, t, h, w), np.float32)
    for ti in range(t):
        pts, cols = fuse_frame_cloud(
            dp.video[:, ti], dp.videodepth[:, ti], dp.intrs[:, ti],
            dp.extrs[:, ti], clamps, stride=stride,
        )
        for vi in range(v):
            rgb, dep = render_pointcloud_to_view(
                pts, cols, dp.intrs[vi, ti], dp.extrs[vi, ti], h, w,
                min_depth=clamps[vi][0], splat_size=splat_size,
            )
            renders[vi, ti] = rgb
            rdepths[vi, ti] = dep

    out: dict = {}
    tracks_2d = None
    if overlay_tracks and dp.trajectory is not None:
        tracks_2d = dp.trajectory  # [V, T, N, 3]
    for vi in range(v):
        cam = cam_ids[vi] if vi < len(cam_ids) else str(vi)
        entry = {}
        mp4_path = os.path.join(out_dir, f"{cam}_reprojected.mp4")
        entry["rgb"] = save_video(renders[vi], mp4_path, fps=fps)
        if write_depth_video:
            mkv_path = os.path.join(out_dir, f"{cam}_depth_reprojected.mkv")
            writer = FFV1DepthVideoWriter(mkv_path, w, h, fps=fps)
            for ti in range(t):
                writer.write_frame(rdepths[vi, ti])
            writer.close()
            writer.save_metadata()
            entry["depth"] = mkv_path
        if tracks_2d is not None:
            frames = render_tracks_on_video(
                renders[vi], np.nan_to_num(tracks_2d[vi][..., :2], nan=-1e4)
            )
            val_path = os.path.join(out_dir, f"{cam}_validation.mp4")
            entry["validation"] = save_video(frames, val_path, fps=fps)
        out[cam] = entry
        logging.info("reprojected camera %s -> %s", cam, entry)
    return out
