"""Real-world multi-view evaluation datasets (L4): Panoptic Studio, DexYCB.

Disk-format-faithful loaders for the reference's evaluation sets:

- Panoptic Studio (`panoptic_studio_multiview_dataset.py:19-459`):
    scene_dir/
      tapvid3d_annotations.npz   {trajectories [T,N,3],
                                  trajectories_pixelspace [V,T,N,2or3],
                                  per_view_visibilities [V,T,N],
                                  query_points_3d [N,4],
                                  extrinsics [V,T,3,4] or [V,3,4],
                                  intrinsics [V,T,3,3] or [V,3,3]}
      ims/<view>/<frame>.jpg
      dynamic3dgs_depth/depths_{v:02d}.npy   [T, H, W]

- DexYCB (`dexycb_multiview_dataset.py:20-661`):
    scene_dir/
      tracks_3d.npz              3D tracks + visibility annotations
      view_<i>/rgb/*.jpg, view_<i>/depth/*.png (16-bit mm),
      view_<i>/intrinsics_extrinsics.npz {K, extr or similar}

Both expose the `from_name` view-subset grammar of the reference
(e.g. "panoptic-multiview-views27_16_14_8").

Counterpart of `mvtracker_tpu/datasets/real_world.py`, the same arrays and
the same track-subsampling draws; images are read with the port's own
`datasets/image_io.py` (PNG; JPEG only through imageio where it is
installed).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from mvtracker_torch.datasets.datapoint import Datapoint
from mvtracker_torch.datasets.image_io import read_image


def _broadcast_cams(arr: np.ndarray, t: int) -> np.ndarray:
    """[V, 3, x] -> [V, T, 3, x]; passthrough if already per-frame."""
    if arr.ndim == 3:
        return np.repeat(arr[:, None], t, axis=1)
    return arr


def _load_image_dir(path: str) -> np.ndarray:
    files = sorted(
        f for f in os.listdir(path) if f.lower().endswith((".jpg", ".png", ".jpeg"))
    )
    return np.stack([read_image(os.path.join(path, f))[..., :3] for f in files])


class PanopticStudioMultiViewDataset:
    """Panoptic dome eval set; mirrors reference
    `panoptic_studio_multiview_dataset.py:100-459`."""

    def __init__(
        self,
        data_root: str,
        views_to_return: Optional[list[int]] = None,
        traj_per_sample: int = 512,
        seed: Optional[int] = 0,
        max_videos: Optional[int] = None,
    ):
        self.data_root = data_root
        self.views_to_return = views_to_return
        self.traj_per_sample = traj_per_sample
        self.seed = seed
        seqs = sorted(
            f
            for f in os.listdir(data_root)
            if os.path.isdir(os.path.join(data_root, f))
            and not f.startswith((".", "_"))
            and os.path.exists(os.path.join(data_root, f, "tapvid3d_annotations.npz"))
        )
        self.seq_names = seqs[:max_videos] if max_videos else seqs

    @staticmethod
    def from_name(dataset_name: str, dataset_root: str) -> "PanopticStudioMultiViewDataset":
        """Parse the reference's name grammar, e.g.
        'panoptic-multiview-views27_16_14_8' (reference :21-99)."""
        rest = dataset_name.replace("panoptic-multiview", "", 1)
        views = None
        m = re.search(r"-views((?:\d+_?)+)", rest)
        if m:
            views = list(map(int, m.group(1).rstrip("_").split("_")))
        return PanopticStudioMultiViewDataset(
            os.path.join(dataset_root, "panoptic-multiview"), views_to_return=views
        )

    def __len__(self):
        return len(self.seq_names)

    def __getitem__(self, index: int) -> Datapoint:
        rng = np.random.default_rng(None if self.seed is None else self.seed + index)
        path = os.path.join(self.data_root, self.seq_names[index])
        ann = np.load(os.path.join(path, "tapvid3d_annotations.npz"))
        traj3d = ann["trajectories"].astype(np.float32)  # [T, N, 3]
        traj2d = ann["trajectories_pixelspace"].astype(np.float32)
        visibility = ann["per_view_visibilities"].astype(bool)  # [V, T, N]
        query = ann["query_points_3d"].astype(np.float32)
        t, n = traj3d.shape[:2]
        extrs = _broadcast_cams(ann["extrinsics"].astype(np.float32), t)
        intrs = _broadcast_cams(ann["intrinsics"].astype(np.float32), t)

        ims_path = os.path.join(path, "ims")
        all_views = sorted(os.listdir(ims_path), key=int)
        # `views` are CAMERA IDS (dir names / annotation rows), not
        # positions: a dome scene exposing cameras 1/7/14/20 has no ims/0,
        # so the default must be the ids actually present, not range(V).
        views = self.views_to_return or [int(d) for d in all_views]

        rgbs, depths = [], []
        for v in views:
            rgbs.append(_load_image_dir(os.path.join(ims_path, str(v))))
            depths.append(
                np.load(os.path.join(path, "dynamic3dgs_depth", f"depths_{v:02d}.npy"))
            )
        video = np.stack(rgbs).astype(np.float32)
        depth = np.stack(depths).astype(np.float32)

        intrs = intrs[views]
        extrs = extrs[views]
        visibility = visibility[views]
        if traj2d.ndim == 4:
            traj2d = traj2d[views]

        # Track subsampling (visible-somewhere), reference :300-403 analog.
        vis_any = visibility.any(axis=(0, 1))
        candidates = np.where(vis_any)[0]
        n_keep = min(self.traj_per_sample, len(candidates))
        keep = np.sort(rng.choice(candidates, size=n_keep, replace=False))

        return Datapoint(
            video=video,
            videodepth=depth,
            intrs=intrs,
            extrs=extrs,
            trajectory=traj2d[:, :, keep] if traj2d.ndim == 4 else None,
            visibility=visibility[:, :, keep],
            trajectory_3d=traj3d[:, keep],
            query_points_3d=query[keep],
            valid=np.ones((t, n_keep), bool),
            seq_name=self.seq_names[index],
        )


class DexYCBMultiViewDataset:
    """DexYCB hand-object eval set; mirrors reference
    `dexycb_multiview_dataset.py:20-661` (8 fixed cameras, 16-bit mm PNG
    depth, per-view intrinsics_extrinsics.npz)."""

    DEPTH_SCALE = 1000.0  # 16-bit PNG depth is millimeters

    def __init__(
        self,
        data_root: str,
        views_to_return: Optional[list[int]] = None,
        traj_per_sample: int = 512,
        seed: Optional[int] = 0,
        max_videos: Optional[int] = None,
    ):
        self.data_root = data_root
        self.views_to_return = views_to_return
        self.traj_per_sample = traj_per_sample
        self.seed = seed
        seqs = sorted(
            f
            for f in os.listdir(data_root)
            if os.path.isdir(os.path.join(data_root, f))
            and os.path.exists(os.path.join(data_root, f, "tracks_3d.npz"))
        )
        self.seq_names = seqs[:max_videos] if max_videos else seqs

    @staticmethod
    def from_name(dataset_name: str, dataset_root: str) -> "DexYCBMultiViewDataset":
        rest = dataset_name.replace("dexycb-multiview", "", 1)
        views = None
        m = re.search(r"-views((?:\d+_?)+)", rest)
        if m:
            views = list(map(int, m.group(1).rstrip("_").split("_")))
        return DexYCBMultiViewDataset(
            os.path.join(dataset_root, "dex-ycb-multiview"), views_to_return=views
        )

    def __len__(self):
        return len(self.seq_names)

    def __getitem__(self, index: int) -> Datapoint:
        rng = np.random.default_rng(None if self.seed is None else self.seed + index)
        path = os.path.join(self.data_root, self.seq_names[index])

        tracks = np.load(os.path.join(path, "tracks_3d.npz"), allow_pickle=True)
        traj3d = tracks["tracks_3d"].astype(np.float32)  # [T, N, 3]
        t, n = traj3d.shape[:2]

        view_dirs = sorted(
            d for d in os.listdir(path) if d.startswith("view_")
        )
        views = self.views_to_return or list(range(len(view_dirs)))

        rgbs, depths, intrs_l, extrs_l = [], [], [], []
        for v in views:
            vp = os.path.join(path, view_dirs[v])
            rgbs.append(_load_image_dir(os.path.join(vp, "rgb")))
            dfiles = sorted(os.listdir(os.path.join(vp, "depth")))
            dep = np.stack(
                [read_image(os.path.join(vp, "depth", f)) for f in dfiles]
            ).astype(np.float32) / self.DEPTH_SCALE
            depths.append(dep)
            params = np.load(os.path.join(vp, "intrinsics_extrinsics.npz"))
            intr = params["K"] if "K" in params else params["intrinsics"]
            extr = params["extr"] if "extr" in params else params["extrinsics"]
            intrs_l.append(_broadcast_cams(intr[None].astype(np.float32), t)[0])
            extrs_l.append(_broadcast_cams(extr[None].astype(np.float32), t)[0])

        video = np.stack(rgbs).astype(np.float32)
        depth = np.stack(depths)
        intrs = np.stack(intrs_l)
        extrs = np.stack(extrs_l)

        visibility = (
            tracks["per_view_visibilities"][views].astype(bool)
            if "per_view_visibilities" in tracks
            else np.ones((len(views), t, n), bool)
        )
        if "query_points_3d" in tracks:
            query = tracks["query_points_3d"].astype(np.float32)
        else:
            vis_any = visibility.any(axis=0)
            t0 = np.argmax(vis_any, axis=0)
            query = np.concatenate(
                [t0[:, None].astype(np.float32), traj3d[t0, np.arange(n)]], axis=1
            )

        vis_any = visibility.any(axis=(0, 1))
        candidates = np.where(vis_any)[0]
        n_keep = min(self.traj_per_sample, len(candidates))
        keep = np.sort(rng.choice(candidates, size=n_keep, replace=False))

        return Datapoint(
            video=video,
            videodepth=depth,
            intrs=intrs,
            extrs=extrs,
            visibility=visibility[:, :, keep],
            trajectory_3d=traj3d[:, keep],
            query_points_3d=query[keep],
            valid=np.ones((t, n_keep), bool),
            seq_name=self.seq_names[index],
        )


def dataset_from_name(dataset_name: str, dataset_root: str):
    """Dataset-name mini-DSL dispatch (reference SURVEY §5: `from_name`
    factories in each dataset module)."""
    if dataset_name.startswith("panoptic-multiview"):
        return PanopticStudioMultiViewDataset.from_name(dataset_name, dataset_root)
    if dataset_name.startswith("dexycb-multiview"):
        return DexYCBMultiViewDataset.from_name(dataset_name, dataset_root)
    if dataset_name.startswith("kubric-multiview"):
        from mvtracker_torch.datasets.kubric import KubricMultiViewDataset

        return KubricMultiViewDataset.from_name(
            dataset_name, os.path.join(dataset_root, "kubric-multiview")
        )
    raise ValueError(f"unknown dataset name: {dataset_name}")
