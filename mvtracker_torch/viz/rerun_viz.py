"""Rerun.io visualization, import-gated; counterpart of
`mvtracker_tpu/viz/rerun_viz.py`.

Re-design of reference `mvtracker/utils/visualizer_rerun.py`: logs fused
RGB point clouds per frame, camera frusta, and predicted/GT track strips to
a .rrd recording. rerun-sdk is an optional dependency — all entry points
raise a clear error if it is missing (it is not baked into this image).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _require_rerun():
    try:
        import rerun as rr  # noqa

        return rr
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "rerun-sdk is not installed; install it to use rerun visualization "
            "(the mp4 visualizer `mvtracker_torch.viz.mp4` has no extra deps)"
        ) from e


def log_pointclouds(
    rrd_path: str,
    video: np.ndarray,  # [V, T, H, W, 3]
    depths: np.ndarray,  # [V, T, H, W]
    intrs: np.ndarray,
    extrs: np.ndarray,
    stride: int = 4,
    fps: float = 12.0,
    max_depth: Optional[float] = None,
):
    """Log per-frame fused RGB clouds (reference `visualizer_rerun.py:91-200`)."""
    import torch

    from mvtracker_torch.utils import geometry as geo

    rr = _require_rerun()
    rr.init("mvtracker_torch", recording_id="viz")

    v, t, h, w, _ = video.shape
    for ti in range(t):
        rr.set_time_seconds("frame", ti / fps)
        pts_all, col_all = [], []
        for vi in range(v):
            # [::stride] + pixel_grid places the ray at (j+0.5)*stride-0.5
            # while the depth sample sits at pixel j*stride — a deliberate
            # match of the MODEL's (reference-mirroring) fused-cloud
            # convention (`model_utils.py:444,463` does exactly this), so
            # these clouds diagnose what the tracker actually sees.
            d = depths[vi, ti, ::stride, ::stride]
            world = geo.unproject_depth_to_world(
                torch.from_numpy(np.asarray(d, np.float32))[None],
                geo.invert_intrinsics(torch.from_numpy(np.asarray(intrs[vi, ti], np.float32)))[None],
                geo.invert_extrinsics(torch.from_numpy(np.asarray(extrs[vi, ti], np.float32)))[None],
                stride,
            )[0].numpy()
            cols = video[vi, ti, ::stride, ::stride].reshape(-1, 3)
            valid = (d > 0).reshape(-1)
            if max_depth is not None:
                valid &= (d < max_depth).reshape(-1)
            pts_all.append(world.reshape(-1, 3)[valid])
            col_all.append(cols[valid])
        rr.log(
            "world/cloud",
            rr.Points3D(np.concatenate(pts_all), colors=np.concatenate(col_all).astype(np.uint8)),
        )
    rr.save(rrd_path)


def log_tracks(
    rrd_path: str,
    traj: np.ndarray,  # [T, N, 3]
    visibility: Optional[np.ndarray] = None,  # [T, N]
    gt_traj: Optional[np.ndarray] = None,
    fps: float = 12.0,
):
    """Log track strips with per-track rainbow colors (reference
    `visualizer_rerun.py:444-618`)."""
    from mvtracker_torch.viz.mp4 import rainbow_colors

    rr = _require_rerun()
    rr.init("mvtracker_torch_tracks", recording_id="tracks")
    t, n, _ = traj.shape
    colors = rainbow_colors(n)
    for ti in range(t):
        rr.set_time_seconds("frame", ti / fps)
        rr.log("world/tracks", rr.Points3D(traj[ti], colors=colors, radii=0.02))
        if ti > 0:
            strips = np.stack([traj[max(0, ti - 8) : ti + 1, i] for i in range(n)])
            rr.log("world/strips", rr.LineStrips3D(strips, colors=colors))
        if gt_traj is not None:
            rr.log("world/gt", rr.Points3D(gt_traj[ti], colors=[128, 128, 128], radii=0.015))
    rr.save(rrd_path)
