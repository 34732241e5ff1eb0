"""Query sampling for unlabeled scenes, counterpart of
`mvtracker_tpu/evaluation/query_sampling.py`.

On scenes with no ground-truth tracks, evaluation queries come from depth:
the depth pixels of chosen frames unprojected to the world, cropped to a
vertical cylinder, then subsampled uniformly or spread by k-means. The
uniform draw is JAX's (`np.random.default_rng(seed)`); the k-means is the
port's own numpy (k-means++ seeding, then Lloyd's iterations), since
scikit-learn is absent on the GPU host.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np

from mvtracker_torch.datasets.generic_scene import unproject_view


@dataclasses.dataclass
class SamplingSpec:
    """One sampling round: (frame, zmin, zmax, radius, count, method)."""

    frame: int = 0
    zmin: float = -np.inf
    zmax: float = np.inf
    radius: float = np.inf
    count: int = 256
    method: str = ""  # "" = uniform subsample, "kmeans"
    center_xy: tuple[float, float] = (0.0, 0.0)


def _sq_dists(pts: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """[N, k] squared distances, by |p|^2 - 2 p.c + |c|^2 in float64."""
    d2 = (pts * pts).sum(1)[:, None] - 2.0 * pts @ centers.T + (centers * centers).sum(1)[None]
    return np.maximum(d2, 0.0)


def _kmeans_plus_plus(pts: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Greedy k-means++: each new centre is the best of 2 + log(k) draws
    with probability proportional to the squared distance."""
    n = len(pts)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, pts.shape[1]))
    centers[0] = pts[rng.integers(n)]
    closest = _sq_dists(pts, centers[:1])[:, 0]
    for c in range(1, k):
        cand = np.searchsorted(np.cumsum(closest), rng.random(trials) * closest.sum())
        cand = np.clip(cand, 0, n - 1)
        cand_d2 = np.minimum(closest[None], _sq_dists(pts, pts[cand]).T)  # [trials, N]
        best = int(np.argmin(cand_d2.sum(1)))
        centers[c] = pts[cand[best]]
        closest = cand_d2[best]
    return centers


def kmeans(pts: np.ndarray, k: int, seed: int = 0, max_iter: int = 300, tol: float = 1e-4):
    """k-means of [N, D] points -> (centres [k, D], inertia): k-means++
    seeding from `np.random.default_rng(seed)`, then Lloyd's iterations
    until the centres move by less than `tol` times the mean variance of
    the data (squared); an emptied cluster keeps its centre."""
    x = np.asarray(pts, np.float64)
    centers = _kmeans_plus_plus(x, k, np.random.default_rng(seed))
    stop = tol * np.mean(np.var(x, axis=0))
    for _ in range(max_iter):
        labels = np.argmin(_sq_dists(x, centers), axis=1)
        counts = np.bincount(labels, minlength=k)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, x)
        new = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1)[:, None], centers)
        shift = ((new - centers) ** 2).sum()
        centers = new
        if shift <= stop:
            break
    d2 = _sq_dists(x, centers)
    return centers, float(d2[np.arange(len(x)), np.argmin(d2, axis=1)].sum())


def kmeans_sample(pts: np.ndarray, count: int, seed: int = 0) -> np.ndarray:
    """`count` k-means centres of [N, 3] points (the points themselves when
    there are no more than `count`)."""
    if len(pts) <= count:
        return pts
    t0 = time.time()
    centers, _ = kmeans(pts, count, seed)
    logging.info("k-means (k=%d, N=%d) in %.2fs", count, len(pts), time.time() - t0)
    return centers.astype(pts.dtype)


def sample_queries_from_depth(
    depths: np.ndarray,  # [V, T, H, W]
    intrs: np.ndarray,  # [V, T, 3, 3]
    extrs: np.ndarray,  # [V, T, 3, 4]
    specs: list[SamplingSpec],
    depth_conf: Optional[np.ndarray] = None,  # [V, T, H, W]
    conf_threshold: float = 0.0,
    stride: int = 4,
    seed: int = 0,
) -> np.ndarray:
    """Evaluation queries [(t, x, y, z)] from (confident) depth, one round
    per spec: every `stride`-th pixel of the spec's frame in every view,
    unprojected, cropped to the cylinder around `center_xy`, then subsampled
    uniformly or by k-means. Returns [sum of counts, 4] float32."""
    rng = np.random.default_rng(seed)
    out = []
    for spec in specs:
        t = spec.frame
        pts_all = []
        for vi in range(depths.shape[0]):
            d = depths[vi, t, ::stride, ::stride]
            valid = d > 0
            if depth_conf is not None:
                valid &= depth_conf[vi, t, ::stride, ::stride] > conf_threshold
            pts_all.append(unproject_view(d, intrs[vi, t], extrs[vi, t], stride)[valid])
        pts = np.concatenate(pts_all, axis=0)

        x = pts[:, 0] - spec.center_xy[0]
        y = pts[:, 1] - spec.center_xy[1]
        z = pts[:, 2]
        pts = pts[(x**2 + y**2 < spec.radius**2) & (z >= spec.zmin) & (z <= spec.zmax)]
        if len(pts) == 0:
            continue
        if spec.method == "kmeans":
            chosen = kmeans_sample(pts, spec.count, seed)
        else:
            chosen = pts[rng.choice(len(pts), size=min(spec.count, len(pts)), replace=False)]
        out.append(np.concatenate([np.full((len(chosen), 1), float(t), chosen.dtype), chosen], axis=1))
    if not out:
        return np.zeros((0, 4), np.float32)
    return np.concatenate(out, axis=0).astype(np.float32)
