"""MVTracker forward (L3), counterpart of `mvtracker_tpu/models/mvtracker.py`.

CNN features per view, fused world-space feature clouds per pyramid level,
kNN and correlation around every track point, and the factorized
transformer predicting coordinate and feature deltas over sliding windows
of S frames with hop S/2.

Like the JAX module, all N tracks are carried through every window with
mask algebra (`active`, `chained`, `cutoff`) and outputs stay in input
order. Unlike it, the window loop is a Python loop over the windows that
actually execute (`n_exec`) instead of the static worst case; the extra
JAX windows are masked out of its outputs, so the results are the same.

The model runs one scene (no batch axis). Public layouts are the JAX
package's: rgbs [V,T,H,W,3] in 0..255, depths [V,T,H,W], query_points
[N,4] (t, x, y, z), intrs [V,T,3,3], extrs [V,T,3,4]; out traj [T,N,3] and
vis [T,N].

With `is_train=True` the forward keeps the autograd graph and also returns
`train_data`, the per-window predictions the losses need. Gradients flow
where they flow in the JAX module and nowhere else: the coords are detached
at the top of every refinement iteration, while the position embedding is
built from the undetached initial coords, and a chained window starts from
the previous window's undetached last prediction and visibility logits.

Precision follows the JAX module: with compute_dtype="bfloat16" the
encoder and the transformer run bf16 products with fp32 parameters, the
softmax runs in fp32, the cloud features are stored bf16 and the
correlation streams bf16; geometry, kNN and the carried coords and track
features stay fp32.

Options of the JAX module, all off by default (reference behaviour):
`corr_neighbors_per_level`, `corr_knn_reuse`, `corr_filter_invalid_depth`,
`global_match_init`, `chain_velocity`, `normalize_scene_in_fwd_pass`,
`use_point_transformer`, `collect_stats`, `support_memory_tokens` (the
update transformer's LoFTR memory, `models/updateformer.py`) and `knn_mesh`.

With `knn_mesh` (a `parallel.mesh.Mesh` of an initialised process group)
every rank of the mesh's `knn_shard_axis` group runs the whole forward, and
each level of at least `knn_shard_min_points` points is searched split over
that group (`_knn_sharded_call`): the same neighbours as one search, ties
included. Inside a train step, `sharded(views=, tracks=)` splits the
encoding over views and the correlation stage over tracks across a group
(`training/step.py`).

The variants subclass this module and replace `_build_context`,
`_feat_init`, `_corr_knn` and `_corr_features` (`models/spatracker.py`,
`models/cotracker2d.py`); the context is any tree of per-frame tensors,
which the window loop slices frame-wise (`take_frames`).

While a profiler records, a forward opens the ranges `mvtracker::forward`,
`::upload` (inputs to the device), `::encode` (`::encoder`, the `fnet`
call), `::clouds`, `::feat_init` and one `::window` a window, which holds
one `::correlation` and one `::transformer` an iteration and `::vis_head`
(`utils/observability.py::span`); the variants' replaced stages keep them.

With `depth_estimator` (the widths of a `models/vggt.py::VGGTConfig`) the
model holds a depth stage, a `models/vggt.py::VGGT` without the point head,
and `forward(..., depth_source="vggt_aligned")` tracks on its depth
(`vggt.py::aligned_depth`) in place of the depth it was given (which may be empty, [V, T, 0, 0]): VGGT over the
views of each timestep, its depth scaled into the rig's world by the
Umeyama sim3 of its camera centres onto the given cameras, then unprojected
through the given cameras (the reference's `--depth_estimator
vggt_aligned`; `vggt.py`'s docstring lists where it may part from it). That
stage opens `::depth_estimator` after `::upload`, holding
`::vggt_patch_embed`, `::vggt_rounds`, `::vggt_camera`, `::vggt_depth_head`
and two `::depth_align` (the input resize; the sim3, the scale and the
resize back).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mvtracker_torch.device import fp32_precision, resolve_device, to_device_fp32
from mvtracker_torch.models.encoder import BasicEncoder
from mvtracker_torch.models.layers import LayerNorm, Linear
from mvtracker_torch.models.point_transformer import SerializedPointTransformer
from mvtracker_torch.models.updateformer import EfficientUpdateFormer
from mvtracker_torch.models import vggt as vggt_lib
from mvtracker_torch.ops import corr as corr_ops
from mvtracker_torch.ops import knn as knn_ops
from mvtracker_torch.parallel import mesh as mesh_lib
from mvtracker_torch.utils import embeddings as emb
from mvtracker_torch.utils import geometry as geo
from mvtracker_torch.utils.observability import span

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

SMALL_LEVEL_POINTS = 1024  # levels at most this size share one kNN call
SENTINEL = 1e9  # coordinate of padding and filtered points in a kNN reference cloud
# Clearance tolerances of the visibility head's z-test features (the JAX
# module's `vis_geom_taus` default, the only value its checkpoints use).
VIS_GEOM_TAUS = (0.05, 0.2, 1.0)


def window_starts(num_frames: int, window_len: int) -> list[int]:
    """Sliding-window start frames relative to the anchor, hop S/2."""
    hop = window_len // 2
    return list(range(0, max(num_frames - hop, 1), hop))


def take_frames(tree, frame_idx: torch.Tensor):
    """Slice every tensor of a tree (dicts, lists and tuples; None leaves
    stay None) along its leading frame axis at `frame_idx`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: take_frames(value, frame_idx) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_frames(value, frame_idx) for value in tree)
    return tree.index_select(0, frame_idx)


def compute_scene_normalization(depths, extrs, intrs, max_depth: float = 24.0, stat_stride: int = 4):
    """The scene transform (scale, R, t) of `normalize_scene_in_fwd_pass`:
    the first frame's depth of every view on a grid of stride
    `stat_stride`, unprojected and expressed in the first camera's frame;
    scale = 1 / the mean distance of the points with a positive depth,
    (R, t) = the first camera's pose, t scaled.

    The depths are first raised to at least `max_depth`, the reference's
    clamp as it executes (it raises near depths rather than capping far
    ones); the released checkpoint was produced under it, so it stays.

    depths [V, T, H, W], extrs [V, T, 3, 4], intrs [V, T, 3, 3]."""
    s = stat_stride
    d0_raw = depths[:, 0, ::s, ::s]
    d0 = torch.clamp(d0_raw, min=max_depth)
    world = geo.unproject_depth_to_world(
        d0, geo.invert_intrinsics(intrs[:, 0]), geo.invert_extrinsics(extrs[:, 0]), stride=s
    )
    e0 = extrs[0, 0]
    in_first = torch.einsum("ij,nj->ni", e0, geo.to_homogeneous(world.reshape(-1, 3)))
    valid = (d0_raw > 0).reshape(-1).to(in_first.dtype)
    avg = (torch.linalg.norm(in_first, dim=-1) * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    scale = 1.0 / avg
    return scale, e0[:, :3], e0[:, 3] * scale


def apply_scene_transform(scale, rot, trans, xyz):
    """x' = t + R (s x) for points [..., 3]."""
    return torch.einsum("ij,...j->...i", rot, xyz * scale) + trans


def invert_scene_transform(scale, rot, trans, xyz):
    """The inverse of `apply_scene_transform`."""
    return torch.einsum("ji,...j->...i", rot, xyz - trans) / scale


def consume_stats(stats: dict) -> list[dict]:
    """The kNN statistics of a forward with `collect_stats=True` (its
    output's "knn_stats": {"knn_dists_lvl{L}": [W, iters, k_L]}) as rows
    {window, iteration, level, k, mean_dist}, sorted by level, window,
    iteration and k.

    These are the rows and the order of the JAX package's `consume_stats`,
    which returns them as a pandas DataFrame; the port returns a list of
    dicts, so that it needs no pandas (`pandas.DataFrame(rows)` gives the
    table). The port runs only the windows the reference runs, so when the
    earliest query starts after frame 0 it has no rows for the JAX module's
    extra, masked-out windows."""
    rows = []
    for name in sorted(stats, key=lambda n: int(n[len("knn_dists_lvl"):])):
        lvl = int(name[len("knn_dists_lvl"):])
        arr = np.asarray(stats[name].detach().float().cpu() if torch.is_tensor(stats[name]) else stats[name])
        for wi in range(arr.shape[0]):
            for ii in range(arr.shape[1]):
                for kk in range(arr.shape[2]):
                    rows.append({"window": wi, "iteration": ii, "level": lvl, "k": kk,
                                 "mean_dist": float(arr[wi, ii, kk])})
    return rows


class MVTracker(nn.Module):
    """Multi-view 3D point tracker at the JAX module's defaults (the flagship:
    S=12, stride 4, 128-dim features, hidden 384, 6 heads, 6+6 depth, 64
    virtual tracks, 4 levels of k=16 neighbours)."""

    def __init__(
        self,
        sliding_window_len: int = 12,
        stride: int = 4,
        fmaps_dim: int = 128,
        add_space_attn: bool = True,
        num_heads: int = 6,
        hidden_size: int = 384,
        space_depth: int = 6,
        time_depth: int = 6,
        num_virtual_tracks: int = 64,
        corr_n_groups: int = 1,
        corr_n_levels: int = 4,
        corr_neighbors: int = 16,
        corr_neighbors_per_level: Optional[tuple] = None,
        corr_add_neighbor_offset: bool = True,
        corr_add_neighbor_xyz: bool = False,
        global_match_init: bool = False,
        global_match_level: int = 1,
        global_match_temp: float = 10.0,
        chain_velocity: float = 0.0,
        corr_knn_reuse: bool = False,
        corr_filter_invalid_depth: bool = False,
        flow_embed_dim: int = 64,
        vis_geom_features: bool = False,
        vis_head_hidden: int = 0,
        compute_dtype: str = "float32",
        use_point_transformer: bool = False,
        point_transformer_depth: int = 2,
        support_memory_tokens: int = 0,
        normalize_scene_in_fwd_pass: bool = False,
        remat: bool = False,
        remat_encoder: bool = True,
        collect_stats: bool = False,
        knn_backend: str = "auto",
        knn_mesh: Optional[mesh_lib.Mesh] = None,
        knn_shard_axis: str = "model",
        knn_shard_min_points: int = 2048,
        depth_estimator: Optional[dict] = None,
        device="cuda",
    ):
        super().__init__()
        if knn_mesh is not None and not torch.distributed.is_initialized():
            raise RuntimeError("knn_mesh needs an initialised torch.distributed process group")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        device = resolve_device(device)
        self.sliding_window_len = sliding_window_len
        self.stride = stride
        self.fmaps_dim = fmaps_dim
        self.corr_n_groups = corr_n_groups
        self.corr_n_levels = corr_n_levels
        self.corr_neighbors = corr_neighbors
        # Neighbours per level, fine to coarse (None: `corr_neighbors` at
        # every level). Widening the fine level alone restores the coverage
        # a dense cloud's k neighbours lose; it widens the update
        # transformer's input (`Trainer.warm_start` migrates uniform-k
        # weights with zero rows for the added ranks).
        if corr_neighbors_per_level is not None:
            corr_neighbors_per_level = tuple(int(k) for k in corr_neighbors_per_level)
            if len(corr_neighbors_per_level) != corr_n_levels:
                raise ValueError(f"corr_neighbors_per_level needs {corr_n_levels} entries, got {corr_neighbors_per_level}")
        self.corr_neighbors_per_level = corr_neighbors_per_level
        self.corr_add_neighbor_offset = corr_add_neighbor_offset
        self.corr_add_neighbor_xyz = corr_add_neighbor_xyz
        self.flow_embed_dim = flow_embed_dim
        # Window initialisation: a soft match of each track's feature over
        # the cloud of level `global_match_level` per frame (frames not
        # chained from the previous window; stop-gradient), and a
        # first-order extrapolation of a chained window's new frames.
        self.global_match_init = global_match_init
        self.global_match_level = global_match_level
        self.global_match_temp = global_match_temp
        self.chain_velocity = chain_velocity
        # One kNN per window at the window's initial coords, reused by every
        # iteration (approximate; the reference searches every iteration).
        self.corr_knn_reuse = corr_knn_reuse
        # Zero-depth points move to SENTINEL in the kNN reference clouds; a
        # pick among them falls back to the query's nearest valid neighbour.
        self.corr_filter_invalid_depth = corr_filter_invalid_depth
        # Rigid centring and rescaling of the scene before tracking, undone
        # on the outputs (`compute_scene_normalization`).
        self.normalize_scene_in_fwd_pass = normalize_scene_in_fwd_pass
        # Mean neighbour distance per (window, iteration, level, rank), in
        # the output's "knn_stats" (`consume_stats`).
        self.collect_stats = collect_stats
        # Visibility head options (both off = the reference's single Linear
        # on the track features): per-view depth z-test features of the
        # final coords, and one exact-GELU hidden layer.
        self.vis_geom_features = vis_geom_features
        self.vis_head_hidden = vis_head_hidden
        self.support_memory_tokens = support_memory_tokens
        self.dtype = _DTYPES[compute_dtype]
        # Recompute activations in the backward instead of keeping them: the
        # update transformer with `remat`, the encoder too with
        # `remat_encoder` (the JAX module's meaning of both flags). The kNN
        # and the correlation sit outside and run once per step either way.
        self.remat = remat
        self.remat_encoder = remat_encoder
        if knn_backend not in knn_ops.BACKENDS:
            raise ValueError(f"knn_backend must be one of {knn_ops.BACKENDS}, got {knn_backend!r}")
        self.knn_backend = knn_backend  # which kNN kernel serves CUDA tensors, see `ops/knn.py`
        # Levels of at least knn_shard_min_points points search their cloud
        # split over the mesh's knn_shard_axis group.
        self.knn_mesh = knn_mesh
        self.knn_shard_axis = knn_shard_axis
        self.knn_shard_min_points = knn_shard_min_points
        # Process groups that split the encoding's views and the correlation
        # stage's tracks, set by `sharded` for one step.
        self._view_group = None
        self._track_group = None

        self.fnet = BasicEncoder(output_dim=fmaps_dim, stride=stride, dtype=self.dtype, device=device)
        self.updateformer = EfficientUpdateFormer(
            space_depth=space_depth,
            time_depth=time_depth,
            input_dim=self.updateformer_input_dim,
            hidden_size=hidden_size,
            num_heads=num_heads,
            output_dim=3 + fmaps_dim,
            mlp_ratio=4.0,
            add_space_attn=add_space_attn,
            num_virtual_tracks=num_virtual_tracks,
            dtype=self.dtype,
            support_memory_tokens=support_memory_tokens,
            device=device,
        )
        # Feature update head: LayerNorm (eps 1e-5) -> Linear -> exact GELU.
        self.ffeats_norm = LayerNorm(fmaps_dim, eps=1e-5, device=device)
        self.ffeats_updater = nn.Sequential(Linear(fmaps_dim, fmaps_dim, device=device), nn.GELU())
        vis_in = fmaps_dim + (2 * len(VIS_GEOM_TAUS) + 1 if vis_geom_features else 0)
        if vis_head_hidden > 0:
            self.vis_hidden = Linear(vis_in, vis_head_hidden, device=device)  # flax's name
            vis_in = vis_head_hidden
        self.vis_predictor = nn.Sequential(Linear(vis_in, 1, device=device))
        self.use_point_transformer = use_point_transformer
        if use_point_transformer:
            # Serialized attention over the level-0 cloud of every frame.
            self.cloud_backbone = SerializedPointTransformer(
                fmaps_dim, dim=fmaps_dim, depth=point_transformer_depth, dtype=self.dtype, device=device
            )
        # The depth stage of `depth_source="vggt_aligned"`; None builds
        # nothing, so the state dict is the tracker's alone.
        self.depth_estimator = None
        if depth_estimator is not None:
            self.depth_estimator = vggt_lib.VGGT(vggt_lib.config_from_widths(depth_estimator), device, point_head=False)

    @property
    def device(self) -> torch.device:
        return self.vis_predictor[0].weight.device

    @property
    def corr_feat_width(self) -> int:
        return self.corr_n_groups + 3 * int(self.corr_add_neighbor_offset) + 3 * int(self.corr_add_neighbor_xyz)

    def corr_k(self, lvl: int) -> int:
        """Neighbour count at pyramid level `lvl` (0 = finest)."""
        if self.corr_neighbors_per_level is not None:
            return self.corr_neighbors_per_level[lvl]
        return self.corr_neighbors

    @property
    def updateformer_input_dim(self) -> int:
        """[flow embedding | per level, k_l neighbours x F | track features | mask, vis]."""
        return (
            (self.flow_embed_dim + 1) * 3
            + sum(self.corr_k(lvl) for lvl in range(self.corr_n_levels)) * self.corr_feat_width
            + self.fmaps_dim
            + 2
        )

    # ------------------------------------------------------------------
    # Sub-computations
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def sharded(self, views=None, tracks=None):
        """Within the block, split the encoding's views over the process
        group `views` and the correlation stage's tracks over `tracks` (each
        rank computes its slice; the slices are gathered with a gradient
        that sums over the group, `parallel.mesh.gather_cat`). The outputs
        are those of the whole computation on every rank."""
        saved = self._view_group, self._track_group
        self._view_group, self._track_group = views, tracks
        try:
            yield self
        finally:
            self._view_group, self._track_group = saved

    def compute_fmaps(self, rgbs: torch.Tensor) -> torch.Tensor:
        """[V, T, H, W, 3] in 0..255 -> [V, T, H/s, W/s, C] fp32, all frames at once."""
        group = self._view_group
        if group is not None:
            sizes = mesh_lib.split_sizes(rgbs.shape[0], torch.distributed.get_world_size(group))
            me = torch.distributed.get_rank(group)
            local = rgbs.narrow(0, sum(sizes[:me]), sizes[me])
            return mesh_lib.gather_cat(self._encode(local), group, 0, sizes)
        return self._encode(rgbs)

    def _encode(self, rgbs: torch.Tensor) -> torch.Tensor:
        v, t, h, w, _ = rgbs.shape
        x = 2.0 * (rgbs.reshape(v * t, h, w, 3).float() / 255.0) - 1.0
        with span("encoder"):
            fmaps = self._maybe_remat(self.remat_encoder, self.fnet, x.permute(0, 3, 1, 2))  # NCHW
        return fmaps.permute(0, 2, 3, 1).reshape(v, t, h // self.stride, w // self.stride, self.fmaps_dim)

    def _maybe_remat(self, enabled: bool, module: nn.Module, *args, **kwargs):
        """Call `module`, rematerialised in the backward when `remat` and
        `enabled` are set and a graph is being recorded. The model draws no
        random numbers (no dropout), so the generator state is not saved."""
        if self.remat and enabled and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)
        return module(*args, **kwargs)

    def _build_context(self, fmaps, depths_strided, intrs, extrs):
        """Per-level fused clouds: list of (xyz [T, P_l, 3], fvec [T, P_l, C],
        valid [T, P_l] bool or None). `valid` (depth > 0) is kept only with
        `corr_filter_invalid_depth`; with `use_point_transformer` the level-0
        features are refined per frame."""
        clouds = []
        for lvl in range(self.corr_n_levels):
            xyz, fvec, *valid = geo.init_pointcloud_from_rgbd(
                fmaps[None], depths_strided[None], intrs[None], extrs[None], stride=self.stride, level=lvl,
                return_validity_mask=self.corr_filter_invalid_depth,
            )
            if lvl == 0 and self.use_point_transformer:
                fvec = self.cloud_backbone(xyz, fvec)
            if self.dtype is not None:
                fvec = fvec.to(self.dtype)  # the correlation streams bf16
            clouds.append((xyz.contiguous(), fvec.contiguous(), valid[0] if valid else None))
        return clouds

    def _feat_init(self, context, query_t, query_xyz):
        """Per-query feature: the k=1 neighbour in the level-0 cloud of the
        query's start frame (clamped into the video). Returns [N, C]."""
        cloud0_xyz, cloud0_fvec, _ = context[0]
        t = cloud0_xyz.shape[0]
        n = query_xyz.shape[0]
        queries = query_xyz[None].expand(t, n, 3)
        _, idx = knn_ops.knn(cloud0_xyz, queries, 1, backend=self.knn_backend)
        fvec = corr_ops.gather_neighbors(cloud0_fvec, idx)[:, :, 0]  # [T, N, C]
        qt = query_t.clamp(0, t - 1)
        return fvec[qt, torch.arange(n, device=fvec.device)]

    def _corr_knn(self, context_w, coords):
        """kNN of the track coords into every level's cloud: ({lvl: dists
        [S, N, k_l]}, {lvl: idx [S, N, k_l]}).

        Levels of at most SMALL_LEVEL_POINTS points are padded with SENTINEL
        points (which never enter a top-k while a level holds k real points)
        and searched in one call at the largest k among them; each level
        keeps its sorted prefix. With `corr_filter_invalid_depth` the
        invalid points sit at SENTINEL too, a pick beyond 1e8 falls back to
        the query's rank 0, and indices are clamped into the level (a frame
        with no valid point gives finite, meaningless features).
        """
        s = coords.shape[0]
        levels = range(self.corr_n_levels)

        def knn_ref(lvl):
            xyz_l, _, valid_l = context_w[lvl]
            return xyz_l if valid_l is None else torch.where(valid_l[..., None], xyz_l, SENTINEL)

        small = [lvl for lvl in levels if context_w[lvl][0].shape[1] <= SMALL_LEVEL_POINTS]
        batched = len(small) > 1
        use_shard = self.knn_mesh is not None and self.knn_mesh.shape[self.knn_shard_axis] > 1
        dists, idx = {}, {}
        for lvl in levels:
            if batched and lvl in small:
                continue
            ref = knn_ref(lvl)
            if use_shard and ref.shape[1] >= self.knn_shard_min_points:
                dists[lvl], idx[lvl] = self._knn_sharded_call(ref, coords, self.corr_k(lvl))
            else:
                dists[lvl], idx[lvl] = knn_ops.knn(ref, coords, self.corr_k(lvl), backend=self.knn_backend)
        if batched:
            pmax = max(context_w[lvl][0].shape[1] for lvl in small)
            kmax = max(self.corr_k(lvl) for lvl in small)
            refs = torch.cat(
                [F.pad(knn_ref(lvl), (0, 0, 0, pmax - context_w[lvl][0].shape[1]), value=SENTINEL) for lvl in small]
            )
            d_all, i_all = knn_ops.knn(refs, coords.repeat(len(small), 1, 1), kmax, backend=self.knn_backend)
            for j, lvl in enumerate(small):
                k = self.corr_k(lvl)
                dists[lvl], idx[lvl] = d_all[j * s : (j + 1) * s, :, :k], i_all[j * s : (j + 1) * s, :, :k]
        if self.corr_filter_invalid_depth:
            for lvl in levels:
                d, i = dists[lvl], idx[lvl]
                bad = d > 1e8
                idx[lvl] = torch.clamp(torch.where(bad, i[..., :1], i), max=context_w[lvl][0].shape[1] - 1)
                dists[lvl] = torch.where(bad, d[..., :1], d)
        return dists, idx

    def _knn_sharded_call(self, ref, coords, k):
        """One level's kNN split over the mesh's `knn_shard_axis` group: ref
        [S, P, 3] whole on every rank, coords [S, N, 3]. The cloud is padded
        to a multiple of the group's size with SENTINEL points (never in a
        top-k: a level holds at least k real points) and this rank searches
        its shard. The ring schedule when N * k exceeds a shard's points
        (JAX's measured crossover), else the all-gather merge. Returns
        (dists, indices into the level) [S, N, k], equal on every rank."""
        group = self.knn_mesh.group(self.knn_shard_axis)
        d = torch.distributed.get_world_size(group)
        p = ref.shape[1]
        pad = (-p) % d
        if pad:
            ref = F.pad(ref, (0, 0, 0, pad), value=SENTINEL)
        n_local = (p + pad) // d
        shard = ref[:, torch.distributed.get_rank(group) * n_local :][:, :n_local].contiguous()
        schedule = knn_ops.knn_sharded_ring if coords.shape[1] * k > n_local else knn_ops.knn_sharded
        dists, idx = schedule(shard, coords, k, group, backend=self.knn_backend)
        return dists, torch.clamp(idx, max=p - 1) if pad else idx

    def _corr_features_split(self, context_w, coords, ffeats, knn_cache=None, stats=None):
        """`_corr_features` with the tracks split over the `sharded` track
        group: this rank searches and correlates its slice of the tracks,
        and the slices are gathered before the update transformer."""
        group = self._track_group
        n = coords.shape[1]
        sizes = mesh_lib.split_sizes(n, torch.distributed.get_world_size(group))
        me = torch.distributed.get_rank(group)
        lo, size = sum(sizes[:me]), sizes[me]
        if knn_cache is not None:
            knn_cache = tuple({lvl: a.narrow(1, lo, size) for lvl, a in part.items()} for part in knn_cache)
        local_stats = {} if stats is not None else None
        fc = self._corr_features(context_w, coords.narrow(1, lo, size), ffeats.narrow(1, lo, size), knn_cache,
                                 local_stats)
        if stats is not None:
            for lvl, (mean,) in local_stats.items():  # each slice's mean, weighted back to all tracks
                stats.setdefault(lvl, []).append(mesh_lib.all_reduce(mean * size, group) / n)
        return mesh_lib.gather_cat(fc, group, 1, sizes)

    def _corr_features(self, context_w, coords, ffeats, knn_cache=None, stats=None):
        """Correlation features per (frame, track): [S, N, sum_l k_l * F].
        `knn_cache`: the (dists, idx) of `_corr_knn` to use instead of a
        search (`corr_knn_reuse`); `stats`: a dict that collects each level's
        mean neighbour distance per rank, {lvl: [tensor [k_l], ...]}."""
        s, n, _ = coords.shape
        knn_dists, knn_idx = knn_cache if knn_cache is not None else self._corr_knn(context_w, coords)
        fcorrs = []
        for lvl in range(self.corr_n_levels):
            xyz_l, fvec_l, _ = context_w[lvl]
            dists, idx = knn_dists[lvl], knn_idx[lvl]
            k, p_l = self.corr_k(lvl), xyz_l.shape[1]
            if k > p_l:
                # Fewer points than neighbours: ranks >= P_l are padding;
                # wrap the ranks so real neighbours repeat instead.
                wrap = torch.arange(k, device=idx.device) % p_l
                dists, idx = dists[..., wrap], idx[..., wrap]
            if stats is not None:
                stats.setdefault(lvl, []).append(dists.mean(dim=(0, 1)))
            fc = corr_ops.corr_sample(
                xyz_l,
                fvec_l,
                ffeats,
                coords,
                idx,
                groups=self.corr_n_groups,
                add_neighbor_offset=self.corr_add_neighbor_offset,
                add_neighbor_xyz=self.corr_add_neighbor_xyz,
                compute_dtype=self.dtype,
            )
            fcorrs.append(fc.reshape(s, n, -1))
        return torch.cat(fcorrs, dim=-1)

    def _vis_geom_features(self, geom_w, coords):
        """Per-view depth z-test features for the visibility head:
        [S, N, 2 * len(taus) + 1].

        geom_w: (depths [V, S, H, W] at full resolution, intrs [V, S, 3, 3],
        extrs [V, S, 3, 4]) of the window's frames; coords [S, N, 3] world
        points, already detached. Every view projects the points, samples
        its depth bilinearly and scores the clearance c = depth - camera z
        with tanh(c / tau) per tolerance; over the views that see a point
        (inside the image, z > 1e-3, depth > 0) a max (-1 when none does)
        and a mean (count clamped to 1) per tau, then the fraction of such
        views mapped to [-1, 1].
        """
        depths_f, intrs, extrs = geom_w
        v, s, h, w = depths_f.shape
        n = coords.shape[1]
        pix, z = geo.world_to_pixel_xy_and_camera_z(coords[None].expand(v, s, n, 3), intrs, extrs)
        z = z[..., 0]
        d = geo.bilinear_sample2d(
            depths_f.reshape(v * s, h, w, 1), pix[..., 0].reshape(v * s, n), pix[..., 1].reshape(v * s, n)
        ).reshape(v, s, n)
        inb = (pix[..., 0] >= 0) & (pix[..., 0] <= w - 1) & (pix[..., 1] >= 0) & (pix[..., 1] <= h - 1) & (z > 1e-3)
        valid = inb & (d > 0)  # a depth of 0 carries no surface evidence
        clearance = d - z
        cnt = valid.sum(dim=0).clamp_min(1)
        feats = []
        for tau in VIS_GEOM_TAUS:
            sc = torch.tanh(clearance / tau)
            feats.append(torch.where(valid, sc, torch.full_like(sc, -1.0)).amax(dim=0))
            feats.append(torch.where(valid, sc, torch.zeros_like(sc)).sum(dim=0) / cnt)
        feats.append(valid.float().mean(dim=0) * 2.0 - 1.0)
        return torch.stack(feats, dim=-1)

    def _vis_logits(self, ffeats, geom_w, coords):
        """Visibility logits [S, N] from the track features, widened with the
        z-test features and passed through the hidden layer when the model
        has them."""
        x = ffeats
        if self.vis_geom_features:
            gfeats = self._vis_geom_features(geom_w, coords.detach())
            x = torch.cat([x, gfeats.to(x.dtype)], dim=-1)
        if self.vis_head_hidden > 0:
            x = F.gelu(self.vis_hidden(x), approximate="none")
        return self.vis_predictor(x)[..., 0]

    def forward_iteration(
        self, context_w, coords_init, vis_init, track_mask, active, feat_init, iters: int, geom_w=None, stats=None
    ):
        """Iterative refinement within one window. Returns (list of coords
        [S, N, 3] per iteration, vis logits [S, N]). `geom_w` is the window's
        (full-resolution depths, intrs, extrs), needed with
        `vis_geom_features`; `stats` collects the kNN statistics
        (`_corr_features`).

        As in the JAX module, `pos_embed` sees the undetached `coords_init`
        (so a chained window sends gradient to the previous one through it
        and through `vis_init`), the coords are detached at the top of every
        iteration, and each prediction is the detached coords plus this
        iteration's delta."""
        s, n, _ = coords_init.shape
        d_in = self.updateformer_input_dim
        embed_dim = d_in if d_in % 6 == 0 else d_in + 6 - d_in % 6
        pos_embed = emb.sincos_3d(embed_dim, coords_init[0])[:, :d_in]  # [N, d_in]
        t_dim = d_in if d_in % 2 == 0 else d_in + 1
        times = torch.arange(s, dtype=torch.float32, device=coords_init.device) / s
        times_embed = emb.sincos_1d(t_dim, times)[:, :d_in]  # [S, d_in]

        coords = coords_init
        ffeats = feat_init[None].expand(s, n, -1).float()
        mask_and_vis = torch.stack([track_mask, vis_init], dim=-1)
        # With reuse, one search at the initial coords (the first
        # iteration's own search) serves every iteration.
        knn_cache = self._corr_knn(context_w, coords_init.detach()) if self.corr_knn_reuse else None
        preds = []
        for _ in range(iters):
            coords = coords.detach()
            corr_features = self._corr_features if self._track_group is None else self._corr_features_split
            with span("correlation"):
                fcorrs = corr_features(context_w, coords, ffeats, knn_cache, stats)
            flows_emb = emb.coord_embedding_3d(coords - coords[0:1], self.flow_embed_dim)
            x = torch.cat([flows_emb, fcorrs, ffeats, mask_and_vis], dim=-1)
            x = x + pos_embed[None] + times_embed[:, None]
            with span("transformer"):
                delta = self._maybe_remat(True, self.updateformer, x.permute(1, 0, 2)[None], track_mask=active[None])[0]
            delta = delta.permute(1, 0, 2)  # [S, N, 3 + C]
            coords = coords + delta[..., :3]
            ffeats = ffeats + self.ffeats_updater(self.ffeats_norm(delta[..., 3:]))
            preds.append(coords)
        with span("vis_head"):
            vis_logits = self._vis_logits(ffeats, geom_w, coords)
        return preds, vis_logits

    # ------------------------------------------------------------------
    # Full forward
    # ------------------------------------------------------------------

    def _as_input(self, x) -> torch.Tensor:
        return to_device_fp32(x, self.device)

    def forward(self, rgbs, depths, query_points, intrs, extrs, iters: int = 4, is_train: bool = False,
                depth_source: Optional[str] = None) -> dict:
        """Track the queries through the video -> {"traj" [T, N, 3], "vis"
        [T, N], "feat_init" [N, C]}. `depth_source="vggt_aligned"` tracks on
        the depth stage's estimate in place of `depths` (a model built with
        `depth_estimator`). Serving (`is_train=False`) records no
        autograd graph. `is_train=True` records one and adds "train_data":
        coord_predictions [W, iters, S, N, 3], vis_predictions [W, S, N]
        (logits), window_starts [W], window_valid [W], window_active [W, N].
        With `collect_stats` the output also holds "knn_stats":
        {"knn_dists_lvl{L}": [W, iters, k_L]}, the mean neighbour distance
        per rank over each window's (frame, track) grid (`consume_stats`)."""
        with span("forward"), contextlib.nullcontext() if is_train else torch.no_grad():
            return self._forward(rgbs, depths, query_points, intrs, extrs, iters, is_train, depth_source)

    def _global_match(self, context_w, feat_init, query_xyz, query_t, frame_idx):
        """Window init by soft match: each track's feature against the cloud
        of level `global_match_level` per frame, softmax(<f, fvec_p> * temp /
        sqrt(C)) over the points, the weighted mean of their xyz; the
        query's own frame stays at the query. fp32 with TF32 off, no
        gradient. Returns [S, N, 3]."""
        lvl = min(self.global_match_level, self.corr_n_levels - 1)
        xyz_m, fvec_m, _ = context_w[lvl]
        with torch.no_grad(), fp32_precision(exact=True):
            f = feat_init.detach().float()
            corr = torch.einsum("nc,spc->snp", f, fvec_m.float()) / float(np.sqrt(f.shape[-1]))
            weights = torch.softmax(corr * self.global_match_temp, dim=-1)
            match_xyz = torch.einsum("snp,spd->snd", weights, xyz_m.float())
        at_query = frame_idx[:, None] == query_t[None, :]
        return torch.where(at_query[..., None], query_xyz[None].expand_as(match_xyz), match_xyz)

    def _estimate_depth(self, rgbs, extrs, depth_source: str) -> torch.Tensor:
        """The depth stage's [V, T, H, W] for frames and cameras on the device."""
        if depth_source != "vggt_aligned":
            raise ValueError(f"depth_source must be None or 'vggt_aligned', got {depth_source!r}")
        if self.depth_estimator is None:
            raise ValueError("depth_source='vggt_aligned' needs a model built with depth_estimator")
        with span("depth_estimator"), torch.no_grad():
            return vggt_lib.aligned_depth(self.depth_estimator, rgbs, extrs, self.dtype)

    def _forward(self, rgbs, depths, query_points, intrs, extrs, iters: int, is_train: bool,
                 depth_source: Optional[str] = None) -> dict:
        with span("upload"):
            rgbs, depths, query_points, intrs, extrs = map(self._as_input, (rgbs, depths, query_points, intrs, extrs))
        if depth_source is not None:
            depths = self._estimate_depth(rgbs, extrs, depth_source)
        v, t, h, w, _ = rgbs.shape
        n = query_points.shape[0]
        s = self.sliding_window_len
        hop = s // 2
        dev = rgbs.device

        query_t = query_points[:, 0].long()  # truncates toward zero
        query_xyz = query_points[:, 1:].contiguous()

        norm = None
        if self.normalize_scene_in_fwd_pass:
            # Centre the first camera and rescale the scene; the outputs are
            # mapped back at the end. E' = [R_e R^T | s t_e - R_e R^T t]
            # keeps E' T(x) = s E x, so every pixel projects as before.
            norm = compute_scene_normalization(depths, extrs, intrs)
            scale, rot, trans = norm
            depths = depths * scale
            r_new = torch.einsum("vtij,kj->vtik", extrs[..., :3], rot)
            t_new = extrs[..., 3] * scale - torch.einsum("vtij,j->vti", r_new, trans)
            extrs = torch.cat([r_new, t_new[..., None]], dim=-1)
            query_xyz = apply_scene_transform(scale, rot, trans, query_xyz)

        with span("encode"):
            fmaps = self.compute_fmaps(rgbs)
        depths_strided = depths[:, :, :: self.stride, :: self.stride]
        with span("clouds"):
            context = self._build_context(fmaps, depths_strided, intrs, extrs)
        with span("feat_init"):
            feat_init = self._feat_init(context, query_t, query_xyz)

        # Windows are anchored at the earliest query time; n_exec is the
        # number the reference's `while start < T - hop` loop runs.
        qt_min = int(query_t.min())
        n_wind = len(window_starts(t, s))
        n_exec = min(max((t - qt_min - 1) // hop, 1), n_wind)

        stats = {} if self.collect_stats else None
        all_coords, all_vis, all_active, all_preds, starts = [], [], [], [], []
        for wi in range(n_exec):
            with span("window"):
                w_start = qt_min + wi * hop
                is_first = wi == 0
                frame_idx = torch.clamp(torch.arange(s, device=dev) + w_start, max=t - 1)
                active = query_t < w_start + s
                context_w = take_frames(context, frame_idx)
                geom_w = None
                if self.vis_geom_features:
                    geom_w = tuple(a.index_select(1, frame_idx) for a in (depths, intrs, extrs))

                if self.global_match_init:
                    coords_init = self._global_match(context_w, feat_init, query_xyz, query_t, frame_idx)
                else:
                    coords_init = query_xyz[None].expand(s, n, 3)
                vis_init = torch.full((s, n), 10.0, device=dev)
                if not is_first:
                    # Tracks active in the previous window continue from its
                    # second half. The new frames repeat its last frame, or with
                    # `chain_velocity` extrapolate its last displacement.
                    chained = query_t < w_start + (s - hop)
                    prev_tail, prev_vis_tail = all_coords[-1][hop:], all_vis[-1][hop:]
                    if self.chain_velocity > 0.0 and hop >= 2:
                        vel = (prev_tail[-1] - prev_tail[-2]) * self.chain_velocity
                        steps = torch.arange(1, s - hop + 1, dtype=vel.dtype, device=dev)
                        new_frames = prev_tail[-1][None] + steps[:, None, None] * vel[None]
                    else:
                        new_frames = prev_tail[-1:].expand(s - hop, n, 3)
                    chained_coords = torch.cat([prev_tail, new_frames])
                    chained_vis = torch.cat([prev_vis_tail, prev_vis_tail[-1:].expand(s - hop, n)])
                    coords_init = torch.where(chained[None, :, None], chained_coords, coords_init)
                    vis_init = torch.where(chained[None, :], chained_vis, vis_init)

                # Frames consumed by earlier windows carry a zero track mask.
                cutoff = query_t if is_first else torch.clamp(query_t, min=w_start + (s - hop))
                track_mask = (frame_idx[:, None] >= cutoff[None, :]).float()

                preds, vis_logits = self.forward_iteration(
                    context_w, coords_init, vis_init, track_mask, active, feat_init, iters, geom_w, stats
                )
                all_coords.append(preds[-1])
                all_preds.append(preds)
                starts.append(w_start)
                all_vis.append(vis_logits)
                all_active.append(active)

        # For each frame the last executed window covering it wins; frames
        # before the anchor and inactive tracks stay zero.
        all_coords = torch.stack(all_coords)  # [W, S, N, 3]
        all_vis = torch.stack(all_vis)  # [W, S, N]
        all_active = torch.stack(all_active)  # [W, N]
        t_idx = torch.arange(t, device=dev)
        w_of_t = torch.clamp(torch.div(t_idx - qt_min, hop, rounding_mode="floor"), 0, n_exec - 1)
        local_s = torch.clamp(t_idx - (qt_min + w_of_t * hop), 0, s - 1)
        traj = all_coords[w_of_t, local_s]
        vis = torch.sigmoid(all_vis[w_of_t, local_s])
        active_t = all_active[w_of_t] & (t_idx >= qt_min)[:, None]
        traj = torch.where(active_t[..., None], traj, torch.zeros_like(traj))
        vis = torch.where(active_t, vis, torch.zeros_like(vis))
        coord_predictions = torch.stack([torch.stack(p) for p in all_preds]) if is_train else None
        if norm is not None:
            # Back to the input's world frame, the zeros of inactive entries
            # included, as the JAX module maps them.
            traj = invert_scene_transform(*norm, traj)
            if is_train:
                coord_predictions = invert_scene_transform(*norm, coord_predictions)
        out = {"traj": traj, "vis": vis, "feat_init": feat_init}
        if stats is not None:
            out["knn_stats"] = {
                f"knn_dists_lvl{lvl}": torch.stack(vals).reshape(n_exec, iters, -1) for lvl, vals in stats.items()
            }
        if is_train:
            # W counts the executed windows only, so `window_valid` is all
            # true. The JAX module stacks its static worst-case window count
            # and masks the rest out; the losses are masked means (an empty
            # mask gives 0) and the mean over windows divides by the number
            # of valid ones, so both give the same loss.
            out["train_data"] = {
                "coord_predictions": coord_predictions,  # [W, iters, S, N, 3]
                "vis_predictions": all_vis,  # [W, S, N] logits
                "window_starts": torch.tensor(starts, dtype=torch.int64, device=dev),  # [W]
                "window_valid": torch.ones(n_exec, dtype=torch.bool, device=dev),  # [W]
                "window_active": all_active,  # [W, N]
            }
        return out
