"""Monocular 2D trackers lifted to the multi-view 3D API (L3), counterpart
of `mvtracker_tpu/models/monocular.py`.

`MonocularToMultiViewAdapter` turns any 2D point tracker into a scene-level
3D tracker:

1. each 3D query goes to the view where a depth z-test at its own frame
   agrees best (`pick_best_view`);
2. the 2D tracker tracks each view's queries through that view's video;
3. the 2D tracks are lifted back to world space through the view's depth
   (bilinear) and cameras.

The 2D tracker is any callable

    tracker_2d(rgbs [T, H, W, 3] in 0..255, queries [M, 3] (t, x, y))
        -> (tracks [T, M, 2], visibility [T, M])

given tensors on the adapter's device; it may answer with tensors or numpy
arrays. `SimpleNNTracker2D` is the in-repo one (normalised
cross-correlation template matching); `models/cotracker2d.py` and
`models/hub_baselines.py` give the others.

The adapter's loop over views runs on the host, as the JAX module's does
(`jit_compatible = False`: the predictor hands it host arrays); the
selection, the 2D tracking and the lift run on the adapter's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mvtracker_torch.device import resolve_device
from mvtracker_torch.utils import geometry as geo


def sample_frames(maps: torch.Tensor, frame: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of scalar maps [B, H, W] at (x, y), each point on its
    own map `frame` (all [M]) -> [M]. The arithmetic of
    `geometry.bilinear_sample2d` (corner indices clamped into the map, a NaN
    coordinate reads corner 0 as the JAX package's cast does)."""
    b, h, w = maps.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0, y0 = torch.nan_to_num(x0), torch.nan_to_num(y0)
    x0i, x1i = x0.clamp(0, w - 1).long(), (x0 + 1).clamp(0, w - 1).long()
    y0i, y1i = y0.clamp(0, h - 1).long(), (y0 + 1).clamp(0, h - 1).long()
    flat = maps.reshape(-1)
    base = frame.long() * (h * w)

    def gather(yy, xx):
        return flat[base + yy * w + xx]

    return (
        gather(y0i, x0i) * (1 - wx) * (1 - wy)
        + gather(y0i, x1i) * wx * (1 - wy)
        + gather(y1i, x0i) * (1 - wx) * wy
        + gather(y1i, x1i) * wx * wy
    )


def pick_best_view(query_points, depths, intrs, extrs):
    """The view each query is most clearly seen in, and its pixel there.

    query_points [N, 4] (t, x, y, z), depths [V, T, H, W], intrs [V, T, 3, 3],
    extrs [V, T, 3, 4] -> (view [N] int64, pixel_xy [N, 2]). Each view
    projects the query at its own frame; a view where it lands outside the
    image, behind the camera or on a zero depth is out; of the others the one
    with the least |z - depth| / z wins, the first on a tie. A query no view
    sees goes to view 0."""
    v, t, h, w = depths.shape
    n = query_points.shape[0]
    qt = query_points[:, 0].long()
    qxyz = query_points[:, 1:]
    pix, z = geo.world_to_pixel_xy_and_camera_z(qxyz[None, :, None, :].expand(v, n, 1, 3), intrs[:, qt], extrs[:, qt])
    pix, z = pix[:, :, 0], z[:, :, 0, 0]  # [V, N, 2], [V, N]
    frame = (torch.arange(v, device=depths.device)[:, None] * t + qt[None]).reshape(-1)
    d_at = sample_frames(depths.reshape(v * t, h, w), frame, pix[..., 0].reshape(-1), pix[..., 1].reshape(-1))
    d_at = d_at.reshape(v, n)
    in_bounds = (pix[..., 0] >= 0) & (pix[..., 0] < w) & (pix[..., 1] >= 0) & (pix[..., 1] < h) & (z > 0)
    err = torch.abs(z - d_at) / torch.clamp(z, min=1e-6)
    err = torch.where(in_bounds & (d_at > 0), err, torch.full_like(err, float("inf")))
    best = torch.argmin(err, dim=0)
    best = torch.where(torch.isinf(err.min(dim=0).values), torch.zeros_like(best), best)
    return best, pix[best, torch.arange(n, device=pix.device)]


def _on(x, dev) -> torch.Tensor:
    return (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))).to(dev, torch.float32)


class MonocularToMultiViewAdapter:
    """A 2D tracker as a scene-level 3D tracker: called like a tracker, with
    rgbs [V, T, H, W, 3], depths [V, T, H, W], query_points [N, 4], intrs
    [V, T, 3, 3], extrs [V, T, 3, 4] (host arrays or tensors) -> {"traj"
    [T, N, 3], "vis" [T, N], "occluded" [T, N]} on `device`."""

    jit_compatible = False  # host-side orchestration: the predictor passes host arrays

    def __init__(self, tracker_2d: Callable, visibility_threshold: float = 0.5, device="cuda"):
        self.tracker_2d = tracker_2d
        self.visibility_threshold = visibility_threshold
        self.device = resolve_device(device)

    def __call__(self, rgbs, depths, query_points, intrs, extrs, **kwargs) -> dict:
        dev = self.device
        rgbs, depths, query_points, intrs, extrs = (_on(a, dev) for a in (rgbs, depths, query_points, intrs, extrs))
        v, t = rgbs.shape[:2]
        n = query_points.shape[0]
        qt = query_points[:, 0].long()
        view_idx, pix = pick_best_view(query_points, depths, intrs, extrs)
        traj = torch.zeros(t, n, 3, device=dev)
        vis = torch.zeros(t, n, device=dev)
        views = view_idx.cpu().numpy()
        for vi in range(v):
            sel = torch.from_numpy(np.nonzero(views == vi)[0]).to(dev)
            if len(sel) == 0:
                continue
            queries_2d = torch.cat([qt[sel, None].float(), pix[sel]], dim=1)  # (t, x, y)
            tracks_2d, vis_2d = self.tracker_2d(rgbs[vi], queries_2d)
            tracks_2d, vis_2d = _on(tracks_2d, dev), _on(vis_2d, dev)  # [T, M, 2], [T, M]
            z = geo.bilinear_sample2d(depths[vi][..., None], tracks_2d[..., 0], tracks_2d[..., 1])
            world = geo.pixel_xy_and_camera_z_to_world(
                tracks_2d, z, geo.invert_intrinsics(intrs[vi]), geo.invert_extrinsics(extrs[vi])
            )
            traj[:, sel] = world
            vis[:, sel] = vis_2d
        return {"traj": traj, "vis": vis, "occluded": vis < self.visibility_threshold}


class SimpleNNTracker2D:
    """Normalised cross-correlation template tracking of image patches.

    Each query's `patch` x `patch` grey template (at its rounded, clamped
    start pixel) is searched frame by frame within `search` pixels of its
    last position (the box clamped so the patch stays inside the image);
    the best score wins, the first in raster order on a tie, and becomes the
    next frame's template. A track is visible where its score exceeds 0.5.
    Before and at its start frame a track holds the query's own position,
    visible.

    The JAX module loops over queries, frames and candidates in Python; here
    every frame's search runs for all queries at once on the tensors'
    device, with the same clamps, scores and tie rule. The scores are
    float32 as there; `dtype=torch.float64` computes them in float64 (a
    control of how far rounding alone moves the tracks: on a flat template
    the winner is decided by the rounding of its mean)."""

    def __init__(self, patch: int = 7, search: int = 12, dtype=torch.float32):
        self.patch = patch
        self.search = search
        self.dtype = dtype

    def __call__(self, rgbs, queries):
        dev = rgbs.device if torch.is_tensor(rgbs) else torch.device("cpu")
        gray = (_on(rgbs, dev).to(self.dtype) / 255.0).mean(dim=-1)  # [T, H, W]
        queries = _on(queries, dev)
        t, h, w = gray.shape
        m = queries.shape[0]
        p, s = self.patch, self.search
        r = p // 2
        t0 = queries[:, 0].long()
        x, y = queries[:, 1], queries[:, 2]
        cx = torch.round(x).long().clamp(r, w - r - 1)
        cy = torch.round(y).long().clamp(r, h - r - 1)

        win = torch.arange(-r, r + 1, device=dev)
        win_dy, win_dx = torch.meshgrid(win, win, indexing="ij")
        win_off = (win_dy * w + win_dx).reshape(-1)  # [p*p], raster order
        box = torch.arange(-s, s + 1, device=dev)
        box_dy, box_dx = [a.reshape(-1) for a in torch.meshgrid(box, box, indexing="ij")]  # raster order

        def windows(frame, yy, xx):
            """gray[frame] windows centred at (yy, xx) [M, K] -> [M, K, p*p]."""
            centre = frame[:, None] * (h * w) + yy * w + xx
            return gray.reshape(-1)[centre[..., None] + win_off]

        template = windows(t0.clamp(0, t - 1), cy[:, None], cx[:, None])[:, 0]  # [M, p*p]
        tracks = torch.stack([x, y], dim=-1)[None].repeat(t, 1, 1)
        vis = torch.ones(t, m, device=dev)
        for ti in range(1, t):
            live = t0 < ti
            yy, xx = cy[:, None] + box_dy, cx[:, None] + box_dx  # [M, (2s+1)^2]
            inside = (yy >= r) & (yy <= h - r - 1) & (xx >= r) & (xx <= w - r - 1)
            cand = windows(torch.full_like(t0, ti), yy.clamp(r, h - r - 1), xx.clamp(r, w - r - 1))
            tz = template - template.mean(dim=-1, keepdim=True)
            tn = torch.linalg.vector_norm(tz, dim=-1) + 1e-6
            wz = cand - cand.mean(dim=-1, keepdim=True)
            score = (tz[:, None] * wz).sum(dim=-1) / (tn[:, None] * (torch.linalg.vector_norm(wz, dim=-1) + 1e-6))
            score = torch.where(inside, score, torch.full_like(score, -float("inf")))
            best = torch.argmax(score, dim=-1)  # the first maximum
            best_score = score.gather(1, best[:, None])[:, 0]
            bx, by = xx.gather(1, best[:, None])[:, 0], yy.gather(1, best[:, None])[:, 0]
            cx, cy = torch.where(live, bx, cx), torch.where(live, by, cy)
            tracks[ti] = torch.where(live[:, None], torch.stack([cx, cy], dim=-1).float(), tracks[ti])
            vis[ti] = torch.where(live, (best_score > 0.5).float(), vis[ti])
            template = torch.where(live[:, None], windows(torch.full_like(t0, ti), cy[:, None], cx[:, None])[:, 0],
                                   template)
        return tracks, vis
