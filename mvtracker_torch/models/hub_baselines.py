"""Hub-downloaded 2D trackers (the reference's monocular zoo), counterpart
of `mvtracker_tpu/models/hub_baselines.py`.

`CoTrackerOfflineWrapper` and `CoTrackerOnlineWrapper` load a
facebookresearch/co-tracker predictor from torch.hub and expose it in the
2D-tracker contract of `MonocularToMultiViewAdapter`

    tracker(rgbs [T, H, W, 3] 0..255, queries [M, 3] (t, x, y))
        -> (tracks [T, M, 2] pixel xy, vis [T, M] in [0, 1])

with the model and its inputs on `device` (the adapter's) and tensors out.
The loader is injectable (tests pass a factory for a mock predictor); the
default reads torch.hub's cache and refuses, without touching the network,
a repository that is not cached there.

The other reference wrappers (SpaTrackerV2, LocoTrack, SceneTracker, DELTA,
TAPIP3D) need a vendored third-party repository; `load_monocular_hub_tracker`
reserves their names and says what is missing.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from mvtracker_torch.device import resolve_device


def _default_hub_loader(repo: str, model_name: str):
    # torch.hub.load fetches from GitHub when the checkout is not cached;
    # refuse instead, so that building a preset never waits on a network.
    hub_dir = torch.hub.get_dir()
    prefix = repo.replace("/", "_")
    cached = os.path.isdir(hub_dir) and any(d.startswith(prefix) for d in os.listdir(hub_dir))
    if not cached:
        raise RuntimeError(
            f"torch.hub checkout for {repo} not cached under {hub_dir} and this environment has no network egress; "
            "pre-populate the hub cache to enable this baseline"
        )
    return torch.hub.load(repo, model_name)


def _load(hub_loader, model_name: str, device: torch.device):
    model = (hub_loader or _default_hub_loader)("facebookresearch/co-tracker", model_name)
    return model.to(device) if isinstance(model, torch.nn.Module) else model


def _inputs(rgbs, queries, device):
    """[T, H, W, 3] frames and [M, 3] queries -> video [1, T, 3, H, W] and
    queries [1, M, 3], fp32 on `device`."""
    rgbs, queries = (
        (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))).to(device, torch.float32) for x in (rgbs, queries)
    )
    return rgbs.permute(0, 3, 1, 2)[None], queries[None]


class CoTrackerOfflineWrapper:
    """The co-tracker offline predictor: one forward over the whole video
    with a support grid of `grid_size`^2 points, whose tracks (appended
    after the queries') are dropped."""

    def __init__(self, model_name: str = "cotracker3_offline", grid_size: int = 10,
                 hub_loader: Optional[Callable] = None, device="cuda"):
        self.device = resolve_device(device)
        self.grid_size = grid_size
        self.model = _load(hub_loader, model_name, self.device)

    def __call__(self, rgbs, queries):
        video, q = _inputs(rgbs, queries, self.device)
        with torch.no_grad():
            tracks, vis = self.model(video=video, queries=q, grid_size=self.grid_size)
        m = q.shape[1]
        return tracks[0, :, :m], vis[0, :, :m].float()


class CoTrackerOnlineWrapper:
    """The co-tracker online predictor: primed with the queries
    (`is_first_step`), then advanced over chunks of twice its step, one step
    apart."""

    def __init__(self, model_name: str = "cotracker3_online", grid_size: int = 10,
                 hub_loader: Optional[Callable] = None, device="cuda"):
        self.device = resolve_device(device)
        self.grid_size = grid_size
        self.model = _load(hub_loader, model_name, self.device)

    def __call__(self, rgbs, queries):
        video, q = _inputs(rgbs, queries, self.device)
        t = video.shape[1]
        step = int(getattr(self.model, "step", 4))
        with torch.no_grad():
            self.model(video_chunk=video, queries=q, grid_size=self.grid_size, is_first_step=True)
            tracks = vis = None
            for ti in range(0, max(t - step, 1), step):
                tracks, vis = self.model(video_chunk=video[:, ti : ti + step * 2])
        m = q.shape[1]
        return tracks[0, :, :m], vis[0, :, :m].float()


_HUB_WRAPPERS = {
    "cotracker3_offline": (CoTrackerOfflineWrapper, "cotracker3_offline"),
    "cotracker3_online": (CoTrackerOnlineWrapper, "cotracker3_online"),
    "cotracker2_offline": (CoTrackerOfflineWrapper, "cotracker2"),
    "cotracker2_online": (CoTrackerOnlineWrapper, "cotracker2_online"),
}

# Wrappers that also need a vendored third-party repository on disk.
_NEEDS_VENDORED_REPO = {
    "spatialtrackerv2": "SpaTrackerV2 (github.com/henry123-boy/SpaTrackerV2)",
    "locotrack": "LocoTrack (github.com/cvlab-kaist/locotrack)",
    "scenetracker": "SceneTracker (github.com/wwsource/SceneTracker)",
    "delta": "DELTA (github.com/snap-research/DELTA_densetrack3d)",
    "tapip3d": "TAPIP3D (github.com/zbww/tapip3d)",
}


def load_monocular_hub_tracker(name: str, grid_size: int = 10, hub_loader: Optional[Callable] = None,
                               device="cuda"):
    """The 2D tracker a reference baseline name stands for, on `device`.
    Raises, saying what is missing, when it cannot be built here; the config
    layer decides what to do then."""
    if name in _HUB_WRAPPERS:
        cls, model_name = _HUB_WRAPPERS[name]
        return cls(model_name=model_name, grid_size=grid_size, hub_loader=hub_loader, device=device)
    if name in _NEEDS_VENDORED_REPO:
        raise NotImplementedError(
            f"{name} needs the vendored repo {_NEEDS_VENDORED_REPO[name]} plus its released checkpoint; wrap its "
            "predictor in the tracker_2d contract (see CoTrackerOfflineWrapper) once the code is on disk."
        )
    raise KeyError(f"unknown hub baseline: {name}")
