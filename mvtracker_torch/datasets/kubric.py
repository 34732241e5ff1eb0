"""Kubric multi-view dataset loader (L4).

Reads the reference's on-disk Kubric scene format
(`mvtracker/datasets/kubric_multiview_dataset.py:1114-1258`):

    scene_dir/
      tracks_3d.npz                 {tracks_3d: [T, N, 3]}
      tracks_segmentation_ids.npz   {tracks_segmentation_ids: [N]}
      cameras.npz                   {camera_positions, lookat_positions} (v3)
      views.npz                     {views} (v2, lookat = 0)
      view_<i>/
        rgba_00000.png ...          RGBA frames
        depth_00000.tiff ...        euclidean depth (float tiff)
        tracks_2d.npz               {tracks_2d: [T, N, 2], occlusion: [T, N]}
        metadata.json               camera K (normalized), per-frame
                                    positions + quaternions, resolution,
                                    sensor_width, focal_length

Conversions mirror the reference exactly:
- camera-to-world built from quaternion + position, inverted to
  world->camera (reference :1196-1208);
- intrinsics denormalized by diag(w, h, 1) and BOTH K and E flipped by
  diag(1, -1, -1) (Kubric's -y/-z camera convention, reference :1212-1213);
- euclidean depth converted to z-depth via the per-pixel rescaling factor
  (reference `depth_from_euclidean_to_z`, :1258-1275);
- depths > 1000 zeroed as invalid (reference :1234-1241).

Counterpart of `mvtracker_tpu/datasets/kubric.py`, the same arrays and the
same track-sampling draws; frames are read with the port's own
`datasets/image_io.py` (RGBA PNG, float32 TIFF) in place of imageio.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Optional

import numpy as np

from mvtracker_torch.datasets.datapoint import Datapoint
from mvtracker_torch.datasets.image_io import read_image


def quaternion_to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """[..., 4] (w, x, y, z) -> [..., 3, 3]. Matches kornia's convention
    used by the reference loader (reference :1199)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = np.empty(q.shape[:-1] + (3, 3), q.dtype)
    r[..., 0, 0] = 1 - 2 * (y * y + z * z)
    r[..., 0, 1] = 2 * (x * y - w * z)
    r[..., 0, 2] = 2 * (x * z + w * y)
    r[..., 1, 0] = 2 * (x * y + w * z)
    r[..., 1, 1] = 1 - 2 * (x * x + z * z)
    r[..., 1, 2] = 2 * (y * z - w * x)
    r[..., 2, 0] = 2 * (x * z - w * y)
    r[..., 2, 1] = 2 * (y * z + w * x)
    r[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return r


def depth_euclidean_to_z(
    depth: np.ndarray,  # [T, H, W]
    sensor_width: float,
    focal_length: float,
) -> np.ndarray:
    """Euclidean (ray-length) depth -> camera-z depth.

    Mirrors reference `depth_from_euclidean_to_z`
    (`kubric_multiview_dataset.py:1258-1275`).
    """
    t, h, w = depth.shape
    sensor_height = sensor_width / w * h
    px = (np.arange(-w / 2, w / 2, dtype=np.float32) + 0.5) / w * sensor_width
    py = (np.arange(-h / 2, h / 2, dtype=np.float32) + 0.5) / h * sensor_height
    gx, gy = np.meshgrid(px, py, indexing="xy")
    rescale = np.sqrt(1 + (gx**2 + gy**2) / focal_length**2)
    return depth / rescale[None]


def load_scene(
    scene_path: str,
    sanity_check_projection: bool = True,
) -> dict:
    """Load a raw Kubric scene directory into numpy arrays."""
    tracks_3d = np.load(os.path.join(scene_path, "tracks_3d.npz"))["tracks_3d"]
    seg_path = os.path.join(scene_path, "tracks_segmentation_ids.npz")
    tracks_seg = (
        np.load(seg_path)["tracks_segmentation_ids"] if os.path.exists(seg_path) else None
    )
    n_frames, n_tracks = tracks_3d.shape[:2]

    view_dirs = sorted(
        (d for d in os.listdir(scene_path) if d.startswith("view_")),
        key=lambda s: int(s.split("_")[-1]),
    )

    videos, depths, intrs_all, extrs_all = [], [], [], []
    tracks_2d_all, occ_all = [], []
    for vd in view_dirs:
        vp = os.path.join(scene_path, vd)
        frame_files = sorted(os.listdir(vp))
        rgbs = [read_image(os.path.join(vp, f)) for f in frame_files if f.startswith("rgba_")]
        dep = [read_image(os.path.join(vp, f)) for f in frame_files if f.startswith("depth_")]
        assert len(rgbs) == n_frames and len(dep) == n_frames
        rgb = np.stack(rgbs)[..., :3].astype(np.float32)  # [T, H, W, 3]
        depth = np.stack(dep).astype(np.float32)
        if depth.ndim == 4:
            depth = depth[..., 0]

        with open(os.path.join(vp, "metadata.json")) as f:
            meta = json.load(f)
        k_norm = np.asarray(meta["camera"]["K"], np.float64)
        positions = np.asarray(meta["camera"]["positions"], np.float64)
        quaternions = np.asarray(meta["camera"]["quaternions"], np.float64)
        rot = quaternion_to_rotation_matrix(quaternions)  # cam->world rotation

        extr_inv = np.tile(np.eye(4), (n_frames, 1, 1))
        extr_inv[:, :3, :3] = rot
        extr_inv[:, :3, 3] = positions
        extrs = np.linalg.inv(extr_inv)[:, :3, :]  # world->cam [T, 3, 4]

        w_res, h_res = meta["metadata"]["resolution"]
        intr = np.diag([w_res, h_res, 1.0]) @ k_norm @ np.diag([1.0, -1.0, -1.0])
        extrs = np.einsum("ij,tjk->tik", np.diag([1.0, -1.0, -1.0]), extrs)
        intrs = np.tile(intr[None], (n_frames, 1, 1))

        t2d = np.load(os.path.join(vp, "tracks_2d.npz"))
        tracks_2d = t2d["tracks_2d"]
        occlusion = t2d["occlusion"]

        if sanity_check_projection:
            p = np.concatenate([tracks_3d[0, 0], [1.0]])
            proj = intr @ extrs[0] @ p
            proj = proj[:2] / proj[2]
            assert np.allclose(proj, tracks_2d[0, 0], atol=1e-2), (
                f"projection sanity check failed for {vp}: {proj} vs {tracks_2d[0, 0]}"
            )

        depth = depth_euclidean_to_z(
            depth, meta["camera"]["sensor_width"], meta["camera"]["focal_length"]
        )
        depth[depth > 1000] = 0  # invalid-depth convention (reference :1234-1241)

        videos.append(rgb)
        depths.append(depth)
        intrs_all.append(intrs.astype(np.float32))
        extrs_all.append(extrs.astype(np.float32))
        tracks_2d_all.append(tracks_2d)
        occ_all.append(occlusion)

    return {
        "video": np.stack(videos),  # [V, T, H, W, 3]
        "videodepth": np.stack(depths),  # [V, T, H, W]
        "intrs": np.stack(intrs_all),  # [V, T, 3, 3]
        "extrs": np.stack(extrs_all),  # [V, T, 3, 4]
        "tracks_3d": tracks_3d.astype(np.float32),  # [T, N, 3]
        "tracks_2d": np.stack(tracks_2d_all).astype(np.float32),  # [V, T, N, 2]
        "occlusion": np.stack(occ_all),  # [V, T, N]
        "tracks_segmentation_ids": tracks_seg,
    }


class KubricMultiViewDataset:
    """Scene-per-item dataset over a directory of Kubric scenes.

    Track sampling mirrors the reference's `_getitem_helper` core
    (dynamic/static ratio sampling, `kubric_multiview_dataset.py:470-1113`,
    simplified: no photometric/crop augs yet — those are applied by the
    augmentation pipeline).
    """

    def __init__(
        self,
        root: str,
        view_subset: Optional[list[int]] = None,
        num_tracks: int = 256,
        seed: int = 0,
        max_frames: Optional[int] = None,
        sanity_check_projection: bool = False,
        depth_noise_cm: float = 0.0,
        dynamic_ratio: float | None = None,
        view_sample_count: int | None = None,
        depth_source: str = "gt",  # gt | duster | duster_cleaned
        novel_view_subset: Optional[list[int]] = None,
        single_scene: bool = False,
        mode_2d: bool = False,
        split: Optional[str] = None,  # None | "training" | "overfit"
    ):
        # Split resolution (reference `kubric_multiview_dataset.py:160-164`:
        # '-training'/'-overfit-on-training' switch data_root to the train/
        # subdirectory). Flat layouts without a train/ subdir fall back to
        # the root itself with a warning — silently reading the eval scenes
        # as training data is exactly the leak this guards against.
        if split in ("training", "overfit"):
            train_dir = os.path.join(root, "train")
            if os.path.isdir(train_dir):
                root = train_dir
            else:
                logging.warning(
                    "kubric split=%r requested but %s has no train/ subdir; "
                    "using the flat root (train/eval scene sets coincide!)",
                    split, root,
                )
        self.root = root
        self.scenes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        if single_scene:
            self.scenes = self.scenes[:1]
        self.novel_view_subset = novel_view_subset
        self.mode_2d = mode_2d
        self.split = split
        self.view_subset = view_subset
        self.num_tracks = num_tracks
        self.seed = seed
        self.max_frames = max_frames
        self.sanity_check_projection = sanity_check_projection
        self.depth_noise_cm = depth_noise_cm
        self.dynamic_ratio = dynamic_ratio
        self.view_sample_count = view_sample_count
        self.depth_source = depth_source

    @staticmethod
    def from_name(dataset_name: str, dataset_root: str) -> "KubricMultiViewDataset":
        """Name-grammar factory; mirrors the reference's mini-DSL
        (`kubric_multiview_dataset.py:30-204`), e.g.
        'kubric-multiview-v3-views0_1_2_3-noise2cm'. Depth-source variants
        (-duster...) require the corresponding precomputed artifacts."""
        rest = dataset_name
        views = None
        m = re.search(r"-views((?:\d+_?)+)", rest)
        if m:
            views = list(map(int, m.group(1).rstrip("_").split("_")))
        novel_views = None
        m = re.search(r"-novelviews((?:\d+_?)+)", rest)
        if m:
            novel_views = list(map(int, m.group(1).rstrip("_").split("_")))
        noise = 0.0
        m = re.search(r"-noise([\d.]+)cm", rest)
        if m:
            noise = float(m.group(1))
        depth_source = "gt"
        m = re.search(r"-duster(?:(?:\d+_?)+)?(cleaned)?", rest)
        if m:
            depth_source = "duster_cleaned" if m.group(1) else "duster"
        split = None
        if "-overfit-on-training" in rest:
            split = "overfit"
        elif "-training" in rest:
            split = "training"
        # '-cached' freezes track sampling for bit-reproducible evals
        # (reference kubric_multiview_dataset.py:130-134); sampling here is
        # already deterministic per (seed, idx), so both map to seed 0.
        seed = 0
        return KubricMultiViewDataset(
            dataset_root, view_subset=views, seed=seed, depth_noise_cm=noise,
            depth_source=depth_source, novel_view_subset=novel_views,
            single_scene="-single" in rest, mode_2d="-2dpt" in rest,
            split=split,
        )

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, idx: int) -> Datapoint:
        raw = load_scene(
            os.path.join(self.root, self.scenes[idx]),
            sanity_check_projection=self.sanity_check_projection,
        )
        rng = np.random.default_rng(self.seed * 100_003 + idx)

        video = raw["video"]
        depth = raw["videodepth"]
        intrs, extrs = raw["intrs"], raw["extrs"]
        tracks_3d = raw["tracks_3d"]
        occ = raw["occlusion"]

        # Original on-disk view ids, tracked through every subsetting stage
        # (estimated-depth files live in view_{ORIGINAL}/ directories).
        orig_views = list(range(video.shape[0]))

        novel = None
        if self.novel_view_subset is not None:
            # Reference '-novelviews…' variant: held-out views are removed
            # from the inputs and attached as novel-view supervision targets
            # (`kubric_multiview_dataset.py` novel-view tensors).
            nv = [v for v in self.novel_view_subset if v < video.shape[0]]
            novel = (video[nv].copy(), intrs[nv].copy(), extrs[nv].copy())
            if self.view_subset is None and self.view_sample_count is None:
                keep = [v for v in range(video.shape[0]) if v not in nv]
                video, depth = video[keep], depth[keep]
                intrs, extrs = intrs[keep], extrs[keep]
                occ = occ[keep]
                raw["tracks_2d"] = raw["tracks_2d"][keep]
                orig_views = [orig_views[v] for v in keep]

        if self.view_subset is not None:
            view_sel = list(self.view_subset)
        elif self.view_sample_count is not None:
            # Variable-view augmentation: random view subset per sample
            # (reference `kubric_multiview_dataset.py:514-545`).
            view_sel = sorted(
                rng.choice(video.shape[0], size=min(self.view_sample_count, video.shape[0]), replace=False)
            )
        else:
            view_sel = None
        if view_sel is not None:
            video = video[view_sel]
            depth = depth[view_sel]
            intrs = intrs[view_sel]
            extrs = extrs[view_sel]
            occ = occ[view_sel]
            raw["tracks_2d"] = raw["tracks_2d"][view_sel]
            orig_views = [orig_views[v] for v in view_sel]

        t = video.shape[1]
        if self.max_frames is not None and t > self.max_frames:
            t = self.max_frames
            video, depth = video[:, :t], depth[:, :t]
            intrs, extrs = intrs[:, :t], extrs[:, :t]
            tracks_3d, occ = tracks_3d[:t], occ[:, :t]
            raw["tracks_2d"] = raw["tracks_2d"][:, :t]

        if self.depth_source != "gt":
            # Estimated-depth variants (reference '-duster...' names,
            # `kubric_multiview_dataset.py:496-512`): read precomputed
            # per-view depth stacks when present.
            dirname = {
                "duster": "duster_depth",
                "duster_cleaned": "duster_depth_cleaned",
            }[self.depth_source]
            scene_path = os.path.join(self.root, self.scenes[idx])
            alt = []
            for vi in range(depth.shape[0]):
                # Index by ORIGINAL view id: after '-views.../-novelviews...'
                # subsetting, row vi is on-disk view orig_views[vi] — using
                # vi here paired view_0/view_1 depth with view 2/3 RGB.
                dpath = os.path.join(
                    scene_path, f"view_{orig_views[vi]}", dirname + ".npy"
                )
                if not os.path.exists(dpath):
                    raise FileNotFoundError(
                        f"{self.depth_source} depth missing: {dpath}"
                    )
                alt.append(np.load(dpath).astype(np.float32)[: depth.shape[1]])
            depth = np.stack(alt)

        if self.depth_noise_cm > 0:
            # Additive gaussian depth noise (reference '-noise{x}cm' variant).
            noise = rng.normal(0, self.depth_noise_cm / 100.0, size=depth.shape)
            depth = np.where(depth > 0, depth + noise.astype(depth.dtype), depth)

        visibility = ~occ  # [V, T, N]
        vis_any = visibility.any(axis=0)

        # Sample tracks that are visible somewhere, biased toward dynamic
        # tracks (reference samples by dynamic/very-dynamic ratios,
        # `kubric_multiview_dataset.py:470-1113`).
        candidates = np.where(vis_any.any(axis=0))[0]
        if self.dynamic_ratio is not None and len(candidates) > 0:
            movement = np.linalg.norm(
                np.diff(tracks_3d[:, candidates], axis=0), axis=-1
            ).sum(axis=0)
            dynamic = candidates[movement > 0.1]
            static = candidates[movement <= 0.1]
            n_dyn = min(int(round(self.num_tracks * self.dynamic_ratio)), len(dynamic))
            n_stat = min(self.num_tracks - n_dyn, len(static))
            n_dyn = min(self.num_tracks - n_stat, len(dynamic))  # backfill
            chosen = np.concatenate(
                [
                    rng.choice(dynamic, size=n_dyn, replace=False) if n_dyn else [],
                    rng.choice(static, size=n_stat, replace=False) if n_stat else [],
                ]
            ).astype(np.int64)
            n_sample = len(chosen)
        else:
            n_sample = min(self.num_tracks, len(candidates))
            chosen = rng.choice(candidates, size=n_sample, replace=False)
        if 0 < n_sample < self.num_tracks:
            # Scarce scenes: top up by resampling WITH replacement so every
            # datapoint carries exactly num_tracks tracks — ragged N breaks
            # np.stack in collate() for batch_size > 1.
            extra = rng.choice(chosen, size=self.num_tracks - n_sample, replace=True)
            chosen = np.concatenate([chosen, extra])
            n_sample = self.num_tracks

        tracks_3d = tracks_3d[:, chosen]
        visibility = visibility[:, :, chosen]
        vis_any = vis_any[:, chosen]
        tracks_2d = raw["tracks_2d"][:, :, chosen]

        first_vis = np.argmax(vis_any, axis=0)
        query = np.concatenate(
            [
                first_vis[:, None].astype(np.float32),
                tracks_3d[first_vis, np.arange(n_sample)],
            ],
            axis=1,
        )

        # Per-view trajectory with camera z (pixel xy + z).
        z = np.einsum(
            "vtij,tnj->vtni",
            extrs,
            np.concatenate([tracks_3d, np.ones_like(tracks_3d[..., :1])], -1),
        )[..., 2:]
        traj2d_wz = np.concatenate([tracks_2d, z], axis=-1)

        return Datapoint(
            video=video,
            videodepth=depth,
            intrs=intrs,
            extrs=extrs,
            trajectory=traj2d_wz,
            visibility=visibility,
            trajectory_3d=tracks_3d,
            query_points_3d=query,
            valid=np.ones((t, n_sample), bool),
            seq_name=self.scenes[idx],
            novel_video=novel[0][:, :t] if novel is not None else None,
            novel_intrs=novel[1][:, :t] if novel is not None else None,
            novel_extrs=novel[2][:, :t] if novel is not None else None,
        )
