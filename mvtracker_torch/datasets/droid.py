"""DROID robot episodes as multi-view Datapoints, counterpart of
`mvtracker_tpu/datasets/droid.py`.

Bridges the DROID data factory's on-disk artifacts (produced by
`droid/pipeline.process_episode` + the recording extraction stage; same
layout as the reference's `conversions/droid/training_data/` outputs) to
the tracker's canonical `Datapoint`, so DROID episodes feed BOTH the
evaluator (BASELINE config 3: full-episode tracking) and the trainer
(BASELINE config 4: training on a DROID subset) through the exact same
code path as Kubric/Panoptic/DexYCB.

Episode directory layout:

    episode/
      tracks.npz              tracks_3d [T, N, 3] (meters, robot base frame),
                              tracks_2d_{cam} [T, N, 2] (NaN = invalid)
      extrinsics.npz          external_{cam} [4, 4] cam->world (static),
                              wrist [T, 4, 4] per-frame cam->world
      metadata.json           camera_intrinsics: {cam: {K, width, height}},
                              wrist_cam_serial
      quality.json
      recordings/{cam}/       depth.mkv (FFV1 16-bit, `droid/depth_video.py`)
                              or depth.npz (key "depth", [T, H, W] float m);
                              rgb.npz (key "rgb", [T, H, W, 3] uint8) or a
                              directory of rgb_*.png frames

The reference reads these artifacts in `render_tracks_from_mp4.py:
1158-1347` (metadata + videos) and trains on HF-uploaded episodes; here the
same artifacts become Datapoints directly.

RGB frames load from rgb.npz, else rgb_*.png (the port's PNG reader,
`datasets/image_io.py`), else rgb.mp4 (through imageio only, which raises
naming the file where imageio is absent, as on the GPU host); depth from
depth.mkv (the port's FFV1 codec, `droid/depth_video.py`), else depth.npz.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from mvtracker_torch.datasets import image_io
from mvtracker_torch.datasets.datapoint import Datapoint


def _load_rgb(cam_dir: str, t: int) -> Optional[np.ndarray]:
    npz_path = os.path.join(cam_dir, "rgb.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            return np.asarray(z["rgb"][:t])
    pngs = sorted(
        f for f in os.listdir(cam_dir) if f.startswith("rgb_") and f.endswith(".png")
    ) if os.path.isdir(cam_dir) else []
    if pngs:
        return np.stack([image_io.read_image(os.path.join(cam_dir, f)) for f in pngs[:t]])
    mp4 = os.path.join(cam_dir, "rgb.mp4")
    if os.path.exists(mp4):
        return image_io.read_video(mp4)[:t]
    return None


def _load_depth(cam_dir: str, t: int) -> Optional[np.ndarray]:
    mkv = os.path.join(cam_dir, "depth.mkv")
    if os.path.exists(mkv):
        from mvtracker_torch.droid.depth_video import read_depth_video

        return read_depth_video(mkv, max_frames=t)
    npz_path = os.path.join(cam_dir, "depth.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            return np.asarray(z["depth"][:t])
    return None


def episode_camera_ids(episode_dir: str) -> list[str]:
    """Camera ids of an episode in the same order `load_droid_episode`
    stacks them as views (cameras with a pose, intrinsics, and an RGB+depth
    recording)."""
    with open(os.path.join(episode_dir, "metadata.json")) as f:
        meta = json.load(f)
    cam_intrs = meta.get("camera_intrinsics", {})
    wrist_serial = str(meta.get("wrist_cam_serial", ""))
    extr_z = np.load(os.path.join(episode_dir, "extrinsics.npz"))
    ids = []
    for key in extr_z.files:
        if key.startswith("external_"):
            ids.append(key[len("external_"):])
        elif key == "wrist" and wrist_serial:
            ids.append(wrist_serial)
    rec_root = os.path.join(episode_dir, "recordings")
    out = []
    for cid in sorted(c for c in ids if c in cam_intrs):
        cam_dir = os.path.join(rec_root, cid)
        has_rgb = (
            os.path.exists(os.path.join(cam_dir, "rgb.npz"))
            or os.path.exists(os.path.join(cam_dir, "rgb.mp4"))
            or (
                os.path.isdir(cam_dir)
                and any(f.startswith("rgb_") and f.endswith(".png") for f in os.listdir(cam_dir))
            )
        )
        has_depth = os.path.exists(os.path.join(cam_dir, "depth.mkv")) or os.path.exists(
            os.path.join(cam_dir, "depth.npz")
        )
        if has_rgb and has_depth:
            out.append(cid)
    return out


def load_droid_episode(
    episode_dir: str,
    max_frames: Optional[int] = None,
    cams: Optional[list[str]] = None,
) -> Datapoint:
    """One episode directory -> Datapoint (views = cameras with recordings)."""
    with open(os.path.join(episode_dir, "metadata.json")) as f:
        meta = json.load(f)
    cam_intrs = meta.get("camera_intrinsics", {})
    wrist_serial = str(meta.get("wrist_cam_serial", ""))

    tracks = np.load(os.path.join(episode_dir, "tracks.npz"))
    extr_z = np.load(os.path.join(episode_dir, "extrinsics.npz"))
    tracks_3d = np.asarray(tracks["tracks_3d"], np.float32)  # [T, N, 3]
    t_total = tracks_3d.shape[0]
    t = t_total if max_frames is None else min(max_frames, t_total)
    tracks_3d = tracks_3d[:t]

    # cam -> [T, 4, 4] cam->world pose
    poses: dict[str, np.ndarray] = {}
    for key in extr_z.files:
        if key.startswith("external_"):
            cid = key[len("external_"):]
            poses[cid] = np.broadcast_to(np.asarray(extr_z[key]), (t, 4, 4))
        elif key == "wrist" and wrist_serial:
            poses[wrist_serial] = np.asarray(extr_z[key])[:t]

    rec_root = os.path.join(episode_dir, "recordings")
    cam_ids = cams or sorted(c for c in poses if c in cam_intrs)

    videos, depths, intrs_l, extrs_l, traj2d_l, vis_l = [], [], [], [], [], []
    for cid in cam_ids:
        cam_dir = os.path.join(rec_root, cid)
        rgb = _load_rgb(cam_dir, t)
        dep = _load_depth(cam_dir, t)
        if rgb is None or dep is None:
            continue
        info = cam_intrs[cid]
        k = np.asarray(info["K"], np.float32)
        pose = poses[cid].astype(np.float64)  # cam->world
        w2c = np.linalg.inv(pose)[:, :3, :]  # [T, 3, 4] world->cam

        videos.append(rgb[:t].astype(np.float32))
        depths.append(dep[:t].astype(np.float32))
        intrs_l.append(np.broadcast_to(k, (t, 3, 3)))
        extrs_l.append(w2c.astype(np.float32))

        # Per-view 2D tracks (pixel xy + camera z), reference Datapoint
        # `trajectory` convention.
        key2d = f"tracks_2d_{cid}"
        pts_h = np.concatenate([tracks_3d, np.ones((t, tracks_3d.shape[1], 1))], -1)
        cam_z = np.einsum("tij,tnj->tni", w2c, pts_h)[..., 2].astype(np.float32)
        if key2d in tracks.files:
            xy = np.asarray(tracks[key2d], np.float32)[:t]
        else:
            from mvtracker_torch.droid.transforms import project_tracks_to_2d

            xy = project_tracks_to_2d(
                tracks_3d, k, poses[cid], info["width"], info["height"]
            ).astype(np.float32)
        vis = np.isfinite(xy).all(-1) & (cam_z > 0.01)
        traj2d_l.append(np.concatenate([np.nan_to_num(xy), cam_z[..., None]], -1))
        vis_l.append(vis)

    if not videos:
        raise FileNotFoundError(f"no camera recordings under {rec_root}")

    n = tracks_3d.shape[1]
    query = np.concatenate(
        [np.zeros((n, 1), np.float32), tracks_3d[0]], axis=1
    )  # gripper tracks exist from frame 0
    return Datapoint(
        video=np.stack(videos),
        videodepth=np.stack(depths),
        intrs=np.stack(intrs_l).astype(np.float32),
        extrs=np.stack(extrs_l),
        trajectory=np.stack(traj2d_l),
        visibility=np.stack(vis_l),
        trajectory_3d=tracks_3d,
        query_points_3d=query,
        valid=np.ones((t, n), bool),
        seq_name=os.path.basename(os.path.normpath(episode_dir)),
        track_upscaling_factor=1.0,  # DROID is metric (meters)
    )


class DroidEpisodeDataset:
    """All processed episodes under a root directory, as Datapoints.

    Compatible with the evaluator loop and (via `datasets/loader.py`) the
    trainer — BASELINE configs 3 and 4.
    """

    def __init__(
        self,
        root: str,
        max_frames: Optional[int] = None,
        cams: Optional[list[str]] = None,
    ):
        self.root = root
        self.max_frames = max_frames
        self.cams = cams
        self.episodes = sorted(
            os.path.join(root, d)
            for d in os.listdir(root)
            if os.path.exists(os.path.join(root, d, "tracks.npz"))
        )
        if not self.episodes:
            raise FileNotFoundError(f"no processed episodes (tracks.npz) under {root}")

    def __len__(self) -> int:
        return len(self.episodes)

    def __getitem__(self, i: int) -> Datapoint:
        return load_droid_episode(
            self.episodes[i], max_frames=self.max_frames, cams=self.cams
        )


def scale_datapoint_world(dp: Datapoint, scale: float) -> Datapoint:
    """Similarity-scale a metric Datapoint's world by `scale` in place-free
    form: depths, camera translations, camera-z, 3D tracks, and queries are
    multiplied; pixels, intrinsics, and rotations are untouched (the image
    content of a scaled world is identical).

    This is how metric DROID episodes are brought into a checkpoint's
    trained world scale for BOTH training (`DroidTrainDataset`) and eval
    (`scripts/eval_droid_track_error.py` inverts predictions by the same
    factor).
    """
    import dataclasses

    extrs = dp.extrs.copy()
    extrs[..., 3] *= scale
    traj = dp.trajectory.copy() if dp.trajectory is not None else None
    if traj is not None:
        traj[..., 2] *= scale  # camera z; pixel xy unchanged
    query = dp.query_points_3d.copy()
    query[:, 1:4] *= scale
    return dataclasses.replace(
        dp,
        videodepth=dp.videodepth * scale,
        extrs=extrs,
        trajectory=traj,
        trajectory_3d=dp.trajectory_3d * scale,
        query_points_3d=query,
    )


class DroidTrainDataset(DroidEpisodeDataset):
    """DROID episodes as TRAINING Datapoints (BASELINE config 4).

    Wraps `DroidEpisodeDataset` with the world-scale similarity adapter so
    a checkpoint trained on the synthetic domain (median depth ~4 units)
    can be fine-tuned on metric tabletop episodes without re-learning
    scale from scratch: `world_scale="auto"` rescales each episode to a
    target median depth of 4.0 (per-episode factor, matching the eval
    adapter in `scripts/eval_droid_track_error.py`).
    """

    def __init__(
        self,
        root: str,
        max_frames: Optional[int] = None,
        cams: Optional[list[str]] = None,
        world_scale: float | str = "auto",
        target_median_depth: float = 4.0,
    ):
        super().__init__(root, max_frames=max_frames, cams=cams)
        self.world_scale = world_scale
        self.target_median_depth = target_median_depth

    def __getitem__(self, i: int) -> Datapoint:
        dp = super().__getitem__(i)
        if self.world_scale == "auto":
            med = float(np.median(dp.videodepth[dp.videodepth > 0]))
            s = self.target_median_depth / med
        else:
            s = float(self.world_scale)
        return scale_datapoint_world(dp, s) if s != 1.0 else dp
