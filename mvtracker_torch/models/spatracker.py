"""Multi-view SpaTracker, the triplane variant (L3), counterpart of
`mvtracker_tpu/models/spatracker.py`.

Instead of a kNN into fused clouds, the fused level-0 feature cloud of
every frame is splatted onto three world-aligned planes (XY, YZ, XZ) over
a bounding box of the whole clip, and the correlation samples a bilinear
(2r+1)^2 patch around each track's projection on every plane and pyramid
level. The encoder, the update transformer (with its LoFTR support memory,
100 tokens by default), the window loop and the heads are the base class's;
only the context, the query features and the correlation differ. No kNN
and no correlation kernel runs on this path: the splat is a scatter-add
(`ops/splat.py`) and the patches are gathers and an einsum.

The planes stay fp32 under compute_dtype="bfloat16" (the JAX module
splats bf16 features into a bf16 canvas, rounding every deposit). Each
plane's pyramid is pooled once per clip rather than once per window and
iteration; pooling is per frame, so the numbers are the same.
"""

from __future__ import annotations

import torch

from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.ops.splat import splat_points
from mvtracker_torch.utils import geometry as geo

PLANE_AXES = ((0, 1), (1, 2), (0, 2))  # XY, YZ, XZ


def patch_offsets(radius: int, device=None) -> torch.Tensor:
    """(dx, dy) of a (2r+1)^2 patch, x fastest: [(2r+1)^2, 2]."""
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)


def pool_channels_last(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of [B, H, W, C] maps."""
    return geo.avg_pool_2x2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def patch_correlation(fmap, centers, offsets, ffeats, compute_dtype=None) -> torch.Tensor:
    """<track feature, bilinear sample> / sqrt(C) over a patch around each
    centre: fmap [S, h, w, C], centers [S, N, 2] in map pixels, offsets
    [P2, 2], ffeats [S, N, C] -> [S, N, P2] fp32. With `compute_dtype` the
    product runs in that dtype."""
    s, n, _ = centers.shape
    p2, c = offsets.shape[0], fmap.shape[-1]
    pts = (centers[:, :, None, :] + offsets[None, None]).reshape(s, n * p2, 2)
    sampled = geo.bilinear_sample2d(fmap, pts[..., 0], pts[..., 1]).reshape(s, n, p2, c)
    if compute_dtype is not None:
        ffeats, sampled = ffeats.to(compute_dtype), sampled.to(compute_dtype)
    return torch.einsum("snc,snpc->snp", ffeats, sampled).float() / float(c) ** 0.5


class MultiViewSpaTracker(MVTracker):
    """Triplane tracker. Beyond the base class's settings: `triplane_res`
    (square resolution of each plane) and `corr_patch_radius` (patch radius
    at every level); `support_memory_tokens` defaults to 100."""

    def __init__(self, triplane_res: int = 64, corr_patch_radius: int = 3, support_memory_tokens: int = 100,
                 **kwargs):
        # Read by `updateformer_input_dim` inside the base constructor.
        self.triplane_res = triplane_res
        self.corr_patch_radius = corr_patch_radius
        super().__init__(support_memory_tokens=support_memory_tokens, **kwargs)

    @property
    def updateformer_input_dim(self) -> int:
        """[flow embedding | 3 planes x L levels x (2r+1)^2 | track features | mask, vis]."""
        patch = (2 * self.corr_patch_radius + 1) ** 2
        return (self.flow_embed_dim + 1) * 3 + 3 * self.corr_n_levels * patch + self.fmaps_dim + 2

    def _build_context(self, fmaps, depths_strided, intrs, extrs):
        """{"planes_{l}": [T, 3, R/2^l, R/2^l, C] per level, "bbox_lo" and
        "scale": [T, 3]} (the clip's bounding box, the same row in every
        frame so that the window loop slices it like the planes)."""
        xyz, fvec = geo.init_pointcloud_from_rgbd(
            fmaps[None], depths_strided[None], intrs[None], extrs[None], stride=self.stride, level=0
        )  # [T, P, 3], [T, P, C]
        t, p, _ = fvec.shape
        r = self.triplane_res
        flat = xyz.detach().reshape(-1, 3)
        lo, hi = flat.min(dim=0).values, flat.max(dim=0).values
        scale = (r - 1) / torch.clamp(hi - lo, min=1e-6)
        grid = (xyz - lo) * scale  # [T, P, 3] in [0, R-1]
        zero_metric = torch.zeros(t, p, device=fvec.device)
        planes = torch.stack(
            [splat_points(grid[..., list(axes)], fvec.float(), zero_metric, r, r) for axes in PLANE_AXES], dim=1
        )
        context = {"bbox_lo": lo.expand(t, 3), "scale": scale.expand(t, 3), "planes_0": planes}
        for lvl in range(1, self.corr_n_levels):
            planes = pool_channels_last(planes.reshape(t * 3, *planes.shape[2:])).reshape(
                t, 3, *[d // 2 for d in planes.shape[2:4]], planes.shape[-1]
            )
            context[f"planes_{lvl}"] = planes
        return context

    def _feat_init(self, context, query_t, query_xyz):
        """The mean of the three plane samples at the query's position on its
        start frame (clamped into the video). Returns [N, C]."""
        planes = context["planes_0"]  # [T, 3, R, R, C]
        t, n = planes.shape[0], query_xyz.shape[0]
        grid = (query_xyz - context["bbox_lo"][0]) * context["scale"][0]  # [N, 3]
        feats = 0.0
        for pi, (a, b) in enumerate(PLANE_AXES):
            x = grid[None, :, a].expand(t, n)
            y = grid[None, :, b].expand(t, n)
            feats = feats + geo.bilinear_sample2d(planes[:, pi], x, y)  # [T, N, C]
        feats = feats / 3.0
        qt = query_t.clamp(0, t - 1)
        return feats[qt, torch.arange(n, device=feats.device)]

    def _corr_knn(self, context_w, coords):
        return None  # no kNN stage: `corr_knn_reuse` changes nothing

    def _corr_features(self, context_w, coords, ffeats, knn_cache=None, stats=None):
        """Patch correlation on the three planes at every level: [S, N, 3 * L * (2r+1)^2],
        plane-major."""
        grid = (coords - context_w["bbox_lo"][:, None]) * context_w["scale"][:, None]  # [S, N, 3]
        offsets = patch_offsets(self.corr_patch_radius, coords.device)
        out = []
        for pi, axes in enumerate(PLANE_AXES):
            for lvl in range(self.corr_n_levels):
                centers = grid[..., list(axes)] * 0.5**lvl
                out.append(patch_correlation(context_w[f"planes_{lvl}"][:, pi], centers, offsets, ffeats))
        return torch.cat(out, dim=-1)
