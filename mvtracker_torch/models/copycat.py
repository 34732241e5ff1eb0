"""CopyCat: the no-motion baseline (L3), counterpart of
`mvtracker_tpu/models/copycat.py`.

Mirrors reference `mvtracker/models/core/copycat.py:5-39`: every frame
gets the query position, fully visible. It is the evaluator's API contract
in miniature and checks the harness independently of any learned model.
"""

from __future__ import annotations

import numpy as np
import torch


class CopyCat:
    """Numpy callable with the scene-level tracker interface; touches no
    device."""

    jit_compatible = False  # host-side: the predictor hands it numpy arrays

    def __call__(self, rgbs, depths, query_points, intrs, extrs, **kwargs) -> dict:
        t = rgbs.shape[1]
        n = query_points.shape[0]
        q = np.asarray(query_points)
        traj = np.broadcast_to(q[None, :, 1:], (t, n, 3))
        vis = np.ones((t, n), np.float32)
        return {"traj": traj, "vis": vis, "occluded": vis < 0.5}


class CopyCatPredictor:
    """CopyCat with the `EvaluationPredictor` contract: torch tensors on the
    inputs' device (host numpy inputs give CPU tensors)."""

    def __call__(self, rgbs, depths, query_points, intrs, extrs, **kwargs) -> dict:
        q = torch.as_tensor(query_points)
        t = rgbs.shape[1]
        n = q.shape[0]
        traj = q[None, :, 1:].expand(t, n, 3).float()
        vis = torch.ones((t, n), dtype=torch.float32, device=q.device)
        return {"traj": traj, "vis": vis, "occluded": vis < 0.5}
