"""Generic unlabeled multi-view scenes, counterpart of
`mvtracker_tpu/datasets/generic_scene.py`.

Per-view RGB and depth directories with camera parameters and no ground
truth tracks; evaluation queries come from depth
(`evaluation/query_sampling.py`). Layout:

    scene_dir/
      cameras.npz            {intrinsics [V,3,3] or [V,T,3,3],
                              extrinsics [V,3,4] or [V,T,3,4]}
      view_<i>/rgb/*.png     (or .npy)
      view_<i>/depth/*.npy   float metres, or 16-bit PNG in millimetres
      view_<i>/depth_conf/*.npy   optional confidence

View directories sort by their number (view_10 after view_9). Frames are
read with the port's own `datasets/image_io.py` (PNG and float TIFF; JPEG
only where imageio is installed, which the GPU host lacks) and `.npy` with
numpy. `estimate_scene_normalization` puts the ground near z=0 at unit-ish
scale; `align_estimated_cameras_to_gt` maps estimated cameras (VGGT's, say)
into the ground truth's world.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from mvtracker_torch.datasets.datapoint import Datapoint, align_umeyama, transform_scene
from mvtracker_torch.datasets.image_io import read_image
from mvtracker_torch.utils import geometry as geo


def unproject_view(depth: np.ndarray, intr: np.ndarray, extr: np.ndarray, stride: int) -> np.ndarray:
    """One strided depth map [H', W'] (taken at every `stride`-th pixel) ->
    world points [H', W', 3], on the CPU."""
    world = geo.unproject_depth_to_world(
        torch.from_numpy(np.ascontiguousarray(depth, np.float32))[None],
        geo.invert_intrinsics(torch.from_numpy(np.asarray(intr, np.float32)))[None],
        geo.invert_extrinsics(torch.from_numpy(np.asarray(extr, np.float32)))[None],
        stride,
    )
    return world[0].numpy()


def estimate_scene_normalization(
    depths: np.ndarray,  # [V, T, H, W]
    intrs: np.ndarray,  # [V, T, 3, 3]
    extrs: np.ndarray,  # [V, T, 3, 4]
    stride: int = 8,
    ground_percentile: float = 5.0,
) -> tuple[float, np.ndarray, np.ndarray]:
    """(scale, R, t) that put the ground (the `ground_percentile` of z over
    frame 0's points) near z=0 and the 90th percentile of the spread at 1;
    gravity is taken as -z."""
    pts = []
    for vi in range(depths.shape[0]):
        d = depths[vi, 0, ::stride, ::stride]
        pts.append(unproject_view(d, intrs[vi, 0], extrs[vi, 0], stride)[d > 0])
    pts = np.concatenate(pts, axis=0)
    if len(pts) == 0:
        return 1.0, np.eye(3), np.zeros(3)
    ground_z = np.percentile(pts[:, 2], ground_percentile)
    center = np.median(pts, axis=0)
    spread = np.percentile(np.linalg.norm(pts - center, axis=1), 90)
    scale = 1.0 / max(spread, 1e-6)
    translation = -np.array([center[0], center[1], ground_z]) * scale
    return float(scale), np.eye(3), translation


def _load_frames(path: str) -> np.ndarray:
    files = sorted(f for f in os.listdir(path) if f.lower().endswith((".png", ".jpg", ".jpeg", ".npy")))
    frames = []
    for f in files:
        p = os.path.join(path, f)
        if f.endswith(".npy"):
            frames.append(np.load(p))
        else:
            arr = read_image(p)
            if arr.dtype == np.uint16:  # millimetre depth PNG
                arr = arr.astype(np.float32) / 1000.0
            frames.append(arr)
    return np.stack(frames)


class GenericSceneDataset:
    def __init__(
        self,
        data_root: str,
        view_subset: Optional[list[int]] = None,
        normalize_scene: bool = False,
        max_frames: Optional[int] = None,
    ):
        self.data_root = data_root
        self.view_subset = view_subset
        self.normalize_scene = normalize_scene
        self.max_frames = max_frames
        self.seq_names = sorted(
            d for d in os.listdir(data_root)
            if os.path.isdir(os.path.join(data_root, d)) and os.path.exists(os.path.join(data_root, d, "cameras.npz"))
        )

    def __len__(self):
        return len(self.seq_names)

    def __getitem__(self, index: int) -> Datapoint:
        path = os.path.join(self.data_root, self.seq_names[index])
        cams = np.load(os.path.join(path, "cameras.npz"))
        intrs = cams["intrinsics"].astype(np.float32)
        extrs = cams["extrinsics"].astype(np.float32)
        view_dirs = sorted((d for d in os.listdir(path) if d.startswith("view_")), key=lambda s: int(s.split("_")[-1]))
        views = self.view_subset or list(range(len(view_dirs)))

        rgbs, depths, confs = [], [], []
        for v in views:
            vp = os.path.join(path, view_dirs[v])
            rgbs.append(_load_frames(os.path.join(vp, "rgb"))[..., :3].astype(np.float32))
            depths.append(_load_frames(os.path.join(vp, "depth")).astype(np.float32))
            cp = os.path.join(vp, "depth_conf")
            confs.append(_load_frames(cp).astype(np.float32) if os.path.isdir(cp) else None)

        video = np.stack(rgbs)
        depth = np.stack(depths)
        if depth.ndim == 5:
            depth = depth[..., 0]
        t = video.shape[1]
        if self.max_frames and t > self.max_frames:
            t = self.max_frames
            video, depth = video[:, :t], depth[:, :t]
        if intrs.ndim == 3:
            intrs = np.repeat(intrs[:, None], t, axis=1)
        if extrs.ndim == 3:
            extrs = np.repeat(extrs[:, None], t, axis=1)
        intrs = intrs[views][:, :t]
        extrs = extrs[views][:, :t]
        conf = np.stack([c[:t] for c in confs]) if all(c is not None for c in confs) else None

        if self.normalize_scene:
            s, r, tr = estimate_scene_normalization(depth, intrs, extrs)
            depth, extrs, _, _, _ = transform_scene(s, r, tr, depth=depth, extrs=extrs)

        return Datapoint(video=video, videodepth=depth, videodepthconf=conf, intrs=intrs, extrs=extrs,
                         seq_name=self.seq_names[index])


def align_estimated_cameras_to_gt(
    est_extrs: np.ndarray,  # [V, 3, 4] estimated world->cam
    gt_extrs: np.ndarray,  # [V, 3, 4] ground truth world->cam
) -> tuple[float, np.ndarray, np.ndarray]:
    """Umeyama sim3 between the camera centres: (s, R, t) mapping the
    estimated world into the ground truth's."""
    def centers(extrs):
        return -np.einsum("vij,vi->vj", extrs[:, :, :3], extrs[:, :, 3])  # -R^T t

    return align_umeyama(centers(gt_extrs), centers(est_extrs))
