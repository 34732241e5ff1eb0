"""TAP-Vid 2D benchmark (L4), counterpart of `mvtracker_tpu/datasets/tapvid.py`.

Loads TAP-Vid pickles (DAVIS and the others), samples queries in "first"
or "strided" mode, and presents each video as a one-view scene of the 3D
API: identity camera, depth from precomputed per-video `.npy` files under
`depth_root` or unit depth, tracks lifted through that depth.

Frames stored as encoded bytes are decoded by `datasets/image_io.py`: PNG
natively, JPEG only where imageio imports.
"""

from __future__ import annotations

import os
import pickle
from typing import Mapping, Optional

import numpy as np

from mvtracker_torch.datasets.datapoint import Datapoint
from mvtracker_torch.datasets.image_io import decode_image


def sample_queries_first(target_occluded, target_points, frames) -> Mapping[str, np.ndarray]:
    """Queries at each track's first visible frame, as [t, x, y]; tracks
    never visible are dropped. target_occluded [N, T] bool, target_points
    [N, T, 2], frames [T, H, W, 3]."""
    valid = np.sum(~target_occluded, axis=1) > 0
    target_points = target_points[valid]
    target_occluded = target_occluded[valid]
    queries = []
    for i in range(target_points.shape[0]):
        index = np.where(~target_occluded[i])[0][0]
        x, y = target_points[i, index]
        queries.append([index, x, y])
    return {
        "video": frames[None],
        "query_points": np.asarray(queries, np.float32)[None],
        "target_points": target_points[None],
        "occluded": target_occluded[None],
    }


def sample_queries_strided(target_occluded, target_points, frames, query_stride: int = 5) -> Mapping[str, np.ndarray]:
    """A query for every track visible at every `query_stride`-th frame, as
    [t, y, x] (the reference's order in this mode, kept)."""
    tracks, occs, queries, trackgroups = [], [], [], []
    trackgroup = np.arange(target_occluded.shape[0])
    for i in range(0, target_occluded.shape[1], query_stride):
        mask = ~target_occluded[:, i]
        query = np.stack(
            [i * np.ones(target_occluded.shape[0]), target_points[:, i, 1], target_points[:, i, 0]], axis=-1
        )
        queries.append(query[mask])
        tracks.append(target_points[mask])
        occs.append(target_occluded[mask])
        trackgroups.append(trackgroup[mask])
    return {
        "video": frames[None],
        "query_points": np.concatenate(queries)[None].astype(np.float32),
        "target_points": np.concatenate(tracks)[None],
        "occluded": np.concatenate(occs)[None],
        "trackgroup": np.concatenate(trackgroups)[None],
    }


class TapVidDataset:
    """A TAP-Vid pickle (a dict or a list of {video [T, H, W, 3] uint8 or a
    list of encoded frames, points [N, T, 2] in [0, 1], occluded [N, T]})."""

    def __init__(self, pickle_path: str, query_mode: str = "first", depth_root: Optional[str] = None):
        self.query_mode = query_mode
        self.depth_root = depth_root
        with open(pickle_path, "rb") as f:
            data = pickle.load(f)
        if isinstance(data, dict):
            self.names = sorted(data.keys())
            self.data = data
        else:
            self.names = [str(i) for i in range(len(data))]
            self.data = {str(i): d for i, d in enumerate(data)}

    def __len__(self):
        return len(self.names)

    @staticmethod
    def _decode_video(video) -> np.ndarray:
        if isinstance(video, np.ndarray) and video.ndim == 4:
            return video
        return np.stack([decode_image(bytes(frame), f"frame {i}") for i, frame in enumerate(video)])

    def __getitem__(self, index: int) -> Datapoint:
        name = self.names[index]
        d = self.data[name]
        video = self._decode_video(d["video"]).astype(np.float32)  # [T, H, W, 3]
        t, h, w, _ = video.shape
        points = np.asarray(d["points"], np.float32)
        occluded = np.asarray(d["occluded"], bool)
        pix = points * np.asarray([w, h], np.float32)[None, None]

        if self.query_mode == "first":
            sample = sample_queries_first(occluded, pix, video)
        else:
            sample = sample_queries_strided(occluded, pix, video)
        tracks_2d = sample["target_points"][0].transpose(1, 0, 2)  # [T, N, 2]
        occ = sample["occluded"][0].T  # [T, N]
        queries = sample["query_points"][0]  # [N, 3]
        n = queries.shape[0]

        if self.depth_root is not None:
            depth = np.load(os.path.join(self.depth_root, f"{name}.npy")).astype(np.float32)
        else:
            depth = np.ones((t, h, w), np.float32)

        # Identity camera: world == camera, pixel-space 3D (K = I).
        intrs = np.tile(np.eye(3, dtype=np.float32), (1, t, 1, 1))
        extrs = np.tile(np.eye(4, dtype=np.float32)[:3], (1, t, 1, 1))
        ti = np.arange(t)[:, None]
        xi = np.clip(np.round(tracks_2d[..., 0]).astype(int), 0, w - 1)
        yi = np.clip(np.round(tracks_2d[..., 1]).astype(int), 0, h - 1)
        zz = depth[ti, yi, xi]
        traj3d = np.concatenate([tracks_2d * zz[..., None], zz[..., None]], axis=-1)

        qt = queries[:, 0]
        qxy = queries[:, 1:3] if self.query_mode == "first" else queries[:, [2, 1]]  # strided: [t, y, x]
        qz = depth[
            qt.astype(int),
            np.clip(np.round(qxy[:, 1]).astype(int), 0, h - 1),
            np.clip(np.round(qxy[:, 0]).astype(int), 0, w - 1),
        ]
        query3d = np.concatenate([qt[:, None], qxy * qz[:, None], qz[:, None]], axis=1).astype(np.float32)

        return Datapoint(
            video=video[None],
            videodepth=depth[None],
            intrs=intrs,
            extrs=extrs,
            trajectory=np.concatenate([tracks_2d, zz[..., None]], -1)[None],
            visibility=(~occ)[None],
            trajectory_3d=traj3d.astype(np.float32),
            query_points_3d=query3d,
            valid=np.ones((t, n), bool),
            seq_name=f"tapvid_{name}",
        )
