"""Misc utilities, counterpart of `mvtracker_tpu/utils/misc.py`, in numpy:
farthest-point sampling, trajectory error statistics, and the depth z-test
visibility the splatting baselines' track exports share.
"""

from __future__ import annotations

import numpy as np


def farthest_point_sampling(points: np.ndarray, n_samples: int, seed: int = 0) -> np.ndarray:
    """Greedy farthest-point subset of [N, D] points; returns indices
    [n_samples]. The first index is drawn from `np.random.default_rng(seed)`."""
    n = len(points)
    if n_samples >= n:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    chosen = np.empty(n_samples, np.int64)
    chosen[0] = rng.integers(n)
    dists = np.linalg.norm(points - points[chosen[0]], axis=-1)
    for i in range(1, n_samples):
        chosen[i] = int(np.argmax(dists))
        dists = np.minimum(dists, np.linalg.norm(points - points[chosen[i]], axis=-1))
    return chosen


def trajectory_errors(
    pred: np.ndarray,  # [T, N, D]
    gt: np.ndarray,  # [T, N, D]
    visibility: np.ndarray | None = None,  # [T, N]
) -> dict[str, float]:
    """Median and mean per-point trajectory errors, over the visible points
    where `visibility` is given."""
    d = np.linalg.norm(pred - gt, axis=-1)
    if visibility is not None:
        d = np.where(visibility, d, np.nan)
    return {
        "median_error": float(np.nanmedian(d)),
        "mean_error": float(np.nanmean(d)),
    }


def depth_ztest_visibility(
    tracks: np.ndarray,  # [T, N, 3] world
    depths: np.ndarray,  # [V, T, H, W]
    intrs: np.ndarray,  # [V, 3, 3]
    extrs: np.ndarray,  # [V, 3, 4] world->cam
    vis_threshold: float = 0.02,
) -> np.ndarray:
    """Per-frame visibility by depth z-test, OR-ed over views -> [T, N] bool.

    A point is visible in a view when it projects in front of the camera and
    sits within `vis_threshold` behind the depth at its pixel (one-sided:
    `0 <= z - d <= vis_threshold`, so floaters in front of the surface are
    not visible). The pixel is the projection clipped to the image, then
    `nan_to_num`, then truncated to int.
    """
    t_total, n = tracks.shape[:2]
    vis = np.zeros((t_total, n), bool)
    for vi in range(depths.shape[0]):
        k_mat, e = intrs[vi], extrs[vi]
        p_cam = tracks @ e[:3, :3].T + e[:3, 3]
        z = p_cam[..., 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            x = np.clip((p_cam[..., 0] * k_mat[0, 0]) / z + k_mat[0, 2], 0, depths.shape[3] - 1)
            y = np.clip((p_cam[..., 1] * k_mat[1, 1]) / z + k_mat[1, 2], 0, depths.shape[2] - 1)
        xi, yi = np.nan_to_num(x).astype(int), np.nan_to_num(y).astype(int)
        d = depths[vi, np.arange(t_total)[:, None], yi, xi]
        diff = z - d
        vis |= (z > 0) & (diff >= 0) & (diff <= vis_threshold) & (d > 0)
    return vis
