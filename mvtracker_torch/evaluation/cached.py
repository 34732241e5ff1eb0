"""Cached-prediction predictor (L5), counterpart of
`mvtracker_tpu/evaluation/cached.py`, in numpy.

The reference evaluates offline per-scene optimization baselines
(Dynamic3DGS, Shape-of-Motion) by reading precomputed `*_tracks.npz`
prediction files instead of running a model
(`mvtracker/evaluation/evaluator_3dpt.py:497-514`). Drop npz files with
keys {traj [T, N, 3], vis [T, N]} (or the reference's {tracks,
visibilities}) into a directory, one per sequence name.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class CachedPredictionPredictor:
    """Looks up `<cache_dir>/<seq_name>_tracks.npz` per sequence."""

    def __init__(self, cache_dir: str, visibility_threshold: float = 0.5):
        self.cache_dir = cache_dir
        self.visibility_threshold = visibility_threshold
        self._current_seq: Optional[str] = None

    def set_sequence(self, seq_name: str):
        self._current_seq = seq_name

    def __call__(self, rgbs, depths, query_points, intrs, extrs, **kwargs):
        if self._current_seq is None:
            raise RuntimeError("call set_sequence(seq_name) first")
        path = os.path.join(self.cache_dir, f"{self._current_seq}_tracks.npz")
        data = np.load(path)
        traj = data["traj"] if "traj" in data else data["tracks"]
        vis = data["vis"] if "vis" in data else data["visibilities"]
        t = rgbs.shape[1]
        n = query_points.shape[0]
        if traj.shape != (t, n, 3):
            raise ValueError(f"cached traj shape {traj.shape} != {(t, n, 3)}")
        vis = vis.astype(np.float32)
        return {
            "traj": traj.astype(np.float32),
            "vis": vis,
            "occluded": vis < self.visibility_threshold,
        }
