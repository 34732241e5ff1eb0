"""Evaluation predictor (L5), counterpart of
`mvtracker_tpu/evaluation/predictor.py`: the inference-time wrapper around
a tracker.

- optional nearest resize of rgb and depth to `interp_shape`, with the
  intrinsics rescaled (reference `evaluation_predictor_3dpt.py:71-87`);
- support points: a pixel grid per view (optionally at several frames)
  unprojected through the depth map into world space (reference :101-120),
  plus uniformly sampled random support points (:147-189);
- queries and support points run through the model together; only the
  original queries' tracks are returned; visibility is thresholded.

Inputs arrive as host arrays and move to the predictor's device once per
call; every step after that stays on the device. The model's weights live
in the model (the JAX predictor takes them as a separate `params`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mvtracker_torch.device import resolve_device
from mvtracker_torch.utils import geometry as geo


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize over the last two axes of [..., H, W]: source index
    floor(i * H_in / H_out) in integers, the pixel PyTorch's 'nearest'
    interpolation means (its float scale can round to another pixel)."""
    h, w = x.shape[-2], x.shape[-1]
    ri = torch.arange(out_h, device=x.device) * h // out_h
    ci = torch.arange(out_w, device=x.device) * w // out_w
    return x[..., ri[:, None], ci[None, :]]


def build_support_grid_points(depths, intrs, extrs, grid_size: int, n_grids_per_view: int = 1) -> torch.Tensor:
    """grid_size^2 pixels per view unprojected through the depth map, at
    `n_grids_per_view` evenly spaced frames (reference
    `evaluation_predictor_3dpt.py:101-120`). depths [V, T, H, W], intrs
    [V, T, 3, 3], extrs [V, T, 3, 4] -> [frames * V * grid_size^2, 4] (t, xyz)."""
    v, t, h, w = depths.shape
    pix = geo.get_points_on_a_grid(grid_size, (h, w), device=depths.device)[0]  # [G, 2]
    intrs_inv = geo.invert_intrinsics(intrs)
    extrs_inv = geo.invert_extrinsics(extrs)
    pts = []
    for ti in range(0, t, max(1, t // n_grids_per_view)):
        for vi in range(v):
            z = geo.bilinear_sample2d(depths[vi, ti][None, :, :, None], pix[None, :, 0], pix[None, :, 1])[0]  # [G, 1]
            world = geo.pixel_xy_and_camera_z_to_world(
                pix[None], z[None], intrs_inv[vi, ti][None], extrs_inv[vi, ti][None]
            )[0]
            pts.append(torch.cat([torch.full_like(world[:, :1], float(ti)), world], dim=1))
    return torch.cat(pts, dim=0)


def draw_uniform_support_samples(num_points: int, t: int, h: int, w: int, generator: torch.Generator, device=None):
    """Random sample positions for `build_uniform_support_points`: frame
    indices ts [num_points] (int64, uniform in [0, t)) and pixel positions
    xs, ys [num_points] uniform in [0, w - 1) and [0, h - 1)."""
    ts = torch.randint(0, t, (num_points,), generator=generator, device=device)
    xs = torch.rand(num_points, generator=generator, device=device) * (w - 1.0)
    ys = torch.rand(num_points, generator=generator, device=device) * (h - 1.0)
    return ts, xs, ys


def build_uniform_support_points(depths, intrs, extrs, ts, xs, ys) -> torch.Tensor:
    """The samples (ts, xs, ys) unprojected in every view through that view's
    depth, bilinearly sampled at frame ts (reference
    `evaluation_predictor_3dpt.py:147-189`) -> [num_points * V, 4] (t, xyz)."""
    v = depths.shape[0]
    intrs_inv = geo.invert_intrinsics(intrs)
    extrs_inv = geo.invert_extrinsics(extrs)
    pix = torch.stack([xs, ys], dim=-1)  # [P, 2]
    pts = []
    for vi in range(v):
        z = geo.bilinear_sample2d(depths[vi].permute(1, 2, 0)[None], xs[None], ys[None])[0]  # [P, T]
        z_t = torch.gather(z, 1, ts[:, None])  # [P, 1]
        world = geo.pixel_xy_and_camera_z_to_world(
            pix[:, None, :], z_t[:, :, None], intrs_inv[vi].index_select(0, ts), extrs_inv[vi].index_select(0, ts)
        )[:, 0]
        pts.append(torch.cat([ts[:, None].float(), world], dim=1))
    return torch.cat(pts, dim=0)


class EvaluationPredictor:
    """Wraps a tracker for evaluation: an `MVTracker` (or any `nn.Module`
    with its call signature and an `iters` argument), or a plain callable
    with the scene-level interface (CopyCat, cached predictions). A callable
    with `jit_compatible = False` is host-side: it gets and gives numpy.

    The mode is chosen per call as the JAX predictor chooses it: single
    point, chunked (when `chunk_frames` is set and the video is longer), or
    one forward of the queries and support points. Every mode resizes,
    rescales the intrinsics and builds the support points on the device.

    `device` defaults to the model's device for an `nn.Module`, else to
    "cuda"; a device other than the model's raises.
    """

    def __init__(
        self,
        model,
        interp_shape: Optional[tuple[int, int]] = (384, 512),
        visibility_threshold: float = 0.5,
        grid_size: int = 5,
        n_grids_per_view: int = 1,
        num_uniformly_sampled_pts: int = 0,
        n_iters: int = 6,
        single_point: bool = False,
        local_grid_size: int = 8,
        local_extent: int = 50,
        consume_model_stats: bool = False,
        chunk_frames: Optional[int] = None,
        device=None,
    ):
        if consume_model_stats:
            raise NotImplementedError("consume_model_stats needs MVTracker(collect_stats=True), which is not ported yet")
        self.model = model
        self.interp_shape = interp_shape
        self.visibility_threshold = visibility_threshold
        self.grid_size = grid_size
        self.n_grids_per_view = n_grids_per_view
        self.num_uniformly_sampled_pts = num_uniformly_sampled_pts
        self.n_iters = n_iters
        self.single_point = single_point
        self.local_grid_size = local_grid_size
        self.local_extent = local_extent
        # Temporal chunking for long videos (reference demo, `demo.py:694-880`):
        # segments of `chunk_frames` frames overlapping by one frame; None (or
        # any value < 2) disables.
        self.chunk_frames = int(chunk_frames) if chunk_frames and int(chunk_frames) >= 2 else None
        model_device = next(model.parameters()).device if isinstance(model, nn.Module) else None
        if device is None:
            device = model_device if model_device is not None else "cuda"
        self.device = resolve_device(device)
        if model_device is not None and model_device.type != self.device.type:
            raise ValueError(f"the model lies on {model_device}, the predictor was asked for {self.device}")

    # ------------------------------------------------------------------

    def _to_device(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.asarray(x, dtype=np.float32))
        return x.to(self.device, torch.float32)

    def _as_tensor(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def _forward(self, rgbs, depths, queries, intrs, extrs):
        """One model run -> (traj [T, N, 3], vis [T, N]) on the device."""
        model = self.model
        if isinstance(model, nn.Module):
            out = model(rgbs, depths, queries, intrs, extrs, iters=self.n_iters)
        elif getattr(model, "jit_compatible", True):
            out = model(rgbs, depths, queries, intrs, extrs)
        else:  # host-side baselines take and give numpy
            out = model(*(x.cpu().numpy() for x in (rgbs, depths, queries, intrs, extrs)))
        return self._as_tensor(out["traj"]), self._as_tensor(out["vis"])

    def _resize(self, rgbs, depths, intrs):
        """Nearest resize to `interp_shape` with the intrinsics rescaled."""
        if self.interp_shape is None:
            return rgbs, depths, intrs
        h_raw, w_raw = rgbs.shape[2:4]
        h, w = self.interp_shape
        rgbs = nearest_resize(rgbs.permute(0, 1, 4, 2, 3), h, w).permute(0, 1, 3, 4, 2)
        depths = nearest_resize(depths, h, w)
        scale = torch.tensor([[w / w_raw, 0, 0], [0, h / h_raw, 0], [0, 0, 1]], dtype=intrs.dtype, device=intrs.device)
        return rgbs, depths, torch.einsum("ij,vtjk->vtik", scale, intrs)

    def _support(self, depths, intrs, extrs, generator) -> list:
        support = []
        if self.grid_size > 0:
            support.append(build_support_grid_points(depths, intrs, extrs, self.grid_size, self.n_grids_per_view))
        if self.num_uniformly_sampled_pts > 0:
            v, t, h, w = depths.shape
            samples = draw_uniform_support_samples(self.num_uniformly_sampled_pts, t, h, w, generator, depths.device)
            support.append(build_uniform_support_points(depths, intrs, extrs, *samples))
        return support

    def __call__(self, rgbs, depths, query_points, intrs, extrs, generator: Optional[torch.Generator] = None):
        """rgbs [V, T, H, W, 3] in 0..255, depths [V, T, H, W], query_points
        [N, 4] (t, x, y, z), intrs [V, T, 3, 3], extrs [V, T, 3, 4], as host
        arrays or tensors -> {"traj" [T, N, 3], "vis" [T, N], "occluded"
        [T, N]} on the device. `generator` draws the uniform support points
        (default: seeded with 0 on every call)."""
        rgbs, depths, query_points, intrs, extrs = map(self._to_device, (rgbs, depths, query_points, intrs, extrs))
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        t = rgbs.shape[1]
        n = query_points.shape[0]
        chunked = self.chunk_frames is not None and t > self.chunk_frames

        rgbs, depths, intrs = self._resize(rgbs, depths, intrs)
        support = self._support(depths, intrs, extrs, generator)
        if self.single_point:
            traj, vis = self._forward_single_point(rgbs, depths, query_points, intrs, extrs, support)
        else:
            queries = torch.cat([query_points] + support, dim=0)
            forward = self._forward_chunked if chunked else self._forward
            traj, vis = forward(rgbs, depths, queries, intrs, extrs)
            traj, vis = traj[:, :n], vis[:, :n]
        return {"traj": traj, "vis": vis, "occluded": vis < self.visibility_threshold}

    def _forward_chunked(self, rgbs, depths, queries, intrs, extrs):
        """Track a long video in segments of `chunk_frames` frames that share
        one boundary frame (the JAX predictor's `_forward_chunked`). A track
        already started re-enters the next segment as a query at relative
        t=0, placed at its predicted position on the shared frame; tracks
        starting inside the segment use their own query; tracks starting
        later get the start time chunk + S, past every window of the
        segment, so the model keeps them out of attention, and their rows
        are masked out of the stitched result. The last segment is
        edge-padded to the full length and its padding dropped."""
        t = rgbs.shape[1]
        chunk = self.chunk_frames
        qt = queries[:, 0].long().cpu().numpy()  # host control flow: segment assembly
        qxyz = queries[:, 1:]
        inert_t = chunk + int(getattr(self.model, "sliding_window_len", chunk))

        def seg_frames(x, t0, length):
            sl = x[:, t0 : t0 + length]
            if length < chunk:
                sl = torch.cat([sl, x[:, t0 + length - 1 : t0 + length].expand(-1, chunk - length, *x.shape[2:])], dim=1)
            return sl

        def host_mask(mask):
            return torch.from_numpy(mask).to(queries.device)

        cur_xyz = qxyz
        traj_parts, vis_parts = [], []
        t0 = 0
        while True:
            length = min(chunk, t - t0)
            started = qt < t0
            inside = (qt >= t0) & (qt < t0 + chunk)
            rel_t = np.where(started, 0, np.where(inside, qt - t0, inert_t))
            seg_xyz = torch.where(host_mask(started)[:, None], cur_xyz, qxyz)
            seg_queries = torch.cat([torch.from_numpy(rel_t).to(queries)[:, None], seg_xyz], dim=1)
            traj_s, vis_s = self._forward(
                *(seg_frames(x, t0, length) for x in (rgbs, depths)), seg_queries,
                *(seg_frames(x, t0, length) for x in (intrs, extrs)),
            )
            offset = 0 if t0 == 0 else 1  # the shared frame came with the previous segment
            traj_parts.append(traj_s[offset:length])
            vis_parts.append(vis_s[offset:length])
            cur_xyz = torch.where(host_mask(qt < t0 + length)[:, None], traj_s[length - 1], cur_xyz)
            if t0 + length >= t:
                break
            t0 += chunk - 1
        traj = torch.cat(traj_parts, dim=0)
        vis = torch.cat(vis_parts, dim=0)
        # Re-mask with the true start times.
        alive = torch.arange(t, device=queries.device)[:, None] >= host_mask(qt)[None, :]
        return torch.where(alive[..., None], traj, torch.zeros_like(traj)), torch.where(alive, vis, torch.zeros_like(vis))

    def _local_grid_points(self, depths, intrs, extrs, query):
        """A local_grid_size^2 pixel grid of local_extent pixels around the
        query's projection in every view at its query frame, clipped to the
        image and unprojected through the depth (reference
        `evaluation_predictor_3dpt.py:191-339`) -> [V * G^2, 4]."""
        v, t, h, w = depths.shape
        g = self.local_grid_size
        qt = int(query[0])
        qxyz = query[1:]
        intrs_inv = geo.invert_intrinsics(intrs)
        extrs_inv = geo.invert_extrinsics(extrs)
        half = self.local_extent / 2
        lin = torch.linspace(-half, half, g, device=depths.device)
        hi = torch.tensor([w - 1.0, h - 1.0], device=depths.device)
        pts = []
        for vi in range(v):
            pix, _ = geo.world_to_pixel_xy_and_camera_z(qxyz[None, None, :], intrs[vi, qt][None], extrs[vi, qt][None])
            gx, gy = torch.meshgrid(pix[0, 0, 0] + lin, pix[0, 0, 1] + lin, indexing="xy")
            grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
            grid = torch.minimum(torch.clamp(grid, min=0.0), hi)
            z = geo.bilinear_sample2d(depths[vi, qt][None, :, :, None], grid[None, :, 0], grid[None, :, 1])[0]
            world = geo.pixel_xy_and_camera_z_to_world(
                grid[None], z[None], intrs_inv[vi, qt][None], extrs_inv[vi, qt][None]
            )[0]
            pts.append(torch.cat([query[:1].expand(world.shape[0], 1), world], dim=1))
        return torch.cat(pts, dim=0)

    def _forward_single_point(self, rgbs, depths, query_points, intrs, extrs, support):
        """One model run per query, with a local support grid around it."""
        trajs, viss = [], []
        for i in range(query_points.shape[0]):
            q = query_points[i]
            local = self._local_grid_points(depths, intrs, extrs, q)
            queries = torch.cat([q[None], local] + support, dim=0)
            traj, vis = self._forward(rgbs, depths, queries, intrs, extrs)
            trajs.append(traj[:, 0])
            viss.append(vis[:, 0])
        return torch.stack(trajs, dim=1), torch.stack(viss, dim=1)
