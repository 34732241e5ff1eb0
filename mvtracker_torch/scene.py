"""Synthetic multi-view RGB-D scenes for driving the tracker.

A copy of the scene maker the JAX package's entry points and benchmark use
(`__graft_entry__.py::_make_scene`): random colours, depths in [1, 4],
V cameras on a circle looking at the origin from distance 3, and N queries
with start frames in [0, T/2) (the first at frame 0). Same generator, same
draws, so a seed gives the same scene in both packages.
"""

from __future__ import annotations

import numpy as np


def make_scene(rng: np.random.Generator, v: int, t: int, h: int, w: int, n: int, dtype=np.float32):
    """Return numpy (rgbs [V,T,H,W,3], depths [V,T,H,W], query [N,4],
    intrs [V,T,3,3], extrs [V,T,3,4])."""
    rgbs = rng.uniform(0, 255, size=(v, t, h, w, 3)).astype(dtype)
    depths = rng.uniform(1.0, 4.0, size=(v, t, h, w)).astype(dtype)
    intrs = np.zeros((v, t, 3, 3), dtype)
    intrs[..., 0, 0] = w * 0.8
    intrs[..., 1, 1] = w * 0.8
    intrs[..., 0, 2] = w / 2
    intrs[..., 1, 2] = h / 2
    intrs[..., 2, 2] = 1.0
    extrs = np.zeros((v, t, 3, 4), dtype)
    for vi in range(v):
        theta = 2 * np.pi * vi / max(v, 1)
        c, s = np.cos(theta), np.sin(theta)
        extrs[vi, :, :, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype)
        extrs[vi, :, :, 3] = np.array([0, 0, 3.0], dtype)
    qt = rng.integers(0, max(t // 2, 1), size=(n,)).astype(dtype)
    qt[0] = 0
    qxyz = rng.normal(size=(n, 3)).astype(dtype) * 0.5
    query = np.concatenate([qt[:, None], qxyz], axis=1)
    return rgbs, depths, query, intrs, extrs
