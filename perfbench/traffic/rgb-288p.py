"""Traffic `rgb-288p`: a calibrated RGB rig with no depth sensor.

The clips of `lib/scene.py::make_clip` (4 views x 24 frames x 288x512, 512
queries lifted from the rendered depth at times over the clip's first
half), with their depth replaced by an empty [V, T, 0, 0]: the rig has no
depth sensor, so the program cannot read one and tracks on its own estimate
(`MVTracker.forward(..., depth_source="vggt_aligned")`).

Sources of the shapes: 4 views as the reference's 4-view Panoptic
evaluation and EgoExo4D's four or more stationary exocentric GoPros
(Grauman et al., CVPR 2024); 16:9 frames at VGGT's published input width,
512 columns so that each of the flagship's 4 levels halves (288 rows: 72,
36, 18, 9); 24 frames as `bench_torch.py`'s headline clip; 512 queries as
`PanopticStudioMultiViewDataset`'s `traj_per_sample`.
"""

from __future__ import annotations

import torch

from perfbench.lib import scene

TRAFFIC = {
    "entry": "forward",
    "options": {"iters": 4, "depth_source": "vggt_aligned"},
    "why": "MVTracker.forward behind VGGT-1B on a calibrated 4-camera RGB rig: 4 views x 24 frames x 288x512, "
           "512 queries over the first half, no depth given, one request in flight",
    "views": 4,
    "frames": 24,
    "height": 288,
    "width": 512,
    "queries": 512,
    "query_times": "first_half",
    "pool": 2,
    "warmup_requests": 2,
    "profiled_requests": 2,
}


def make_clip(seed: int, index: int, traffic: dict, device) -> dict:
    """Clip `index` of the pool: `scene.generate`'s clip of the mix's shapes,
    its depth emptied."""
    clip = scene.generate(seed, index, traffic, device)
    v, t = clip["rgbs"].shape[:2]
    return dict(clip, depths=torch.zeros(v, t, 0, 0))
