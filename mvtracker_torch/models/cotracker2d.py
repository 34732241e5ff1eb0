"""Compact learned monocular 2D tracker (L3), counterpart of
`mvtracker_tpu/models/cotracker2d.py`.

The CoTracker2 recipe as a variant of the MVTracker base class: an
average-pooled pyramid of the single view's feature maps as the context, a
bilinear (2r+1)^2 patch correlation around each track's pixel at every
level, the level-0 feature at the query pixel as the track feature. The
track state is (x, y, z) with z supervised to 0, so the base class's window
chaining, masking, refinement and losses apply unchanged. Depths, intrinsics
and extrinsics are taken and ignored. No kNN and no correlation kernel runs
on this path.

`LearnedTracker2D` wraps a `CoTracker2D` in the 2D-tracker contract of
`MonocularToMultiViewAdapter` (`models/monocular.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.models.spatracker import patch_correlation, patch_offsets, pool_channels_last
from mvtracker_torch.utils import geometry as geo


class CoTracker2D(MVTracker):
    """Monocular 2D tracker; takes V=1 inputs. `corr_patch_radius` is the
    patch radius at every pyramid level."""

    def __init__(self, corr_patch_radius: int = 3, **kwargs):
        self.corr_patch_radius = corr_patch_radius  # read by `updateformer_input_dim`
        super().__init__(**kwargs)

    @property
    def updateformer_input_dim(self) -> int:
        """[flow embedding | L levels x (2r+1)^2 | track features | mask, vis]."""
        patch = (2 * self.corr_patch_radius + 1) ** 2
        return (self.flow_embed_dim + 1) * 3 + self.corr_n_levels * patch + self.fmaps_dim + 2

    def _build_context(self, fmaps, depths_strided, intrs, extrs):
        """{"pyramid_{l}": [T, h/2^l, w/2^l, C]} of the one view."""
        v = fmaps.shape[0]
        if v != 1:
            raise ValueError(f"CoTracker2D is monocular; got V={v}")
        level = fmaps[0]
        context = {"pyramid_0": level}
        for lvl in range(1, self.corr_n_levels):
            level = pool_channels_last(level)
            context[f"pyramid_{lvl}"] = level
        return context

    def _feat_init(self, context, query_t, query_xyz):
        """The level-0 feature at the query pixel on its start frame (clamped
        into the video). Returns [N, C]."""
        fmap0 = context["pyramid_0"]
        t, n = fmap0.shape[0], query_xyz.shape[0]
        xy = query_xyz[:, :2] / self.stride
        feats = geo.bilinear_sample2d(fmap0, xy[None, :, 0].expand(t, n), xy[None, :, 1].expand(t, n))
        qt = query_t.clamp(0, t - 1)
        return feats[qt, torch.arange(n, device=feats.device)]

    def _corr_knn(self, context_w, coords):
        return None  # no kNN stage: `corr_knn_reuse` changes nothing

    def _corr_features(self, context_w, coords, ffeats, knn_cache=None, stats=None):
        """Patch correlation around (x, y) at every level: [S, N, L * (2r+1)^2].
        Under compute_dtype="bfloat16" the products run in bf16."""
        offsets = patch_offsets(self.corr_patch_radius, coords.device)
        out = []
        for lvl in range(self.corr_n_levels):
            centers = coords[..., :2] / (self.stride * 2.0**lvl)
            out.append(patch_correlation(context_w[f"pyramid_{lvl}"], centers, offsets, ffeats, self.dtype))
        return torch.cat(out, dim=-1)


class LearnedTracker2D:
    """A `CoTracker2D` as a 2D tracker for `MonocularToMultiViewAdapter`:
    (rgbs [T, H, W, 3] in 0..255, queries [M, 3] (t, x, y)) -> (tracks
    [T, M, 2], visibility [T, M]), tensors on the model's device. The model
    runs with no autograd graph; identity cameras and zero depths fill its
    unused inputs."""

    def __init__(self, model: CoTracker2D, n_iters: int = 4):
        self.model = model
        self.n_iters = n_iters

    @property
    def device(self) -> torch.device:
        return self.model.device

    def __call__(self, rgbs, queries):
        dev = self.device
        rgbs, queries = (
            (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))).to(dev, torch.float32) for x in (rgbs, queries)
        )
        t = rgbs.shape[0]
        q4 = torch.cat([queries, queries.new_zeros(queries.shape[0], 1)], dim=1)  # (t, x, y, 0)
        intrs = torch.eye(3, device=dev).expand(1, t, 3, 3)
        extrs = torch.eye(3, 4, device=dev).expand(1, t, 3, 4)
        out = self.model(rgbs[None], torch.zeros_like(rgbs[None, ..., 0]), q4, intrs, extrs, iters=self.n_iters)
        return out["traj"][..., :2], out["vis"]
