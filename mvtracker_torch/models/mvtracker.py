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
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mvtracker_torch.device import resolve_device
from mvtracker_torch.models.encoder import BasicEncoder
from mvtracker_torch.models.layers import LayerNorm, Linear
from mvtracker_torch.models.updateformer import EfficientUpdateFormer
from mvtracker_torch.ops import corr as corr_ops
from mvtracker_torch.ops import knn as knn_ops
from mvtracker_torch.utils import embeddings as emb
from mvtracker_torch.utils import geometry as geo

# Options of the JAX module that this port does not implement yet, with the
# value that leaves them off. Setting any other value raises.
_NOT_PORTED = {
    "corr_knn_reuse": False,
    "corr_filter_invalid_depth": False,
    "vis_geom_features": False,
    "vis_head_hidden": 0,
    "global_match_init": False,
    "chain_velocity": 0.0,
    "normalize_scene_in_fwd_pass": False,
    "use_point_transformer": False,
    "knn_mesh": None,
    "collect_stats": False,
    "support_memory_tokens": 0,
    "corr_neighbors_per_level": None,
}

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

SMALL_LEVEL_POINTS = 1024  # levels at most this size share one kNN call


def window_starts(num_frames: int, window_len: int) -> list[int]:
    """Sliding-window start frames relative to the anchor, hop S/2."""
    hop = window_len // 2
    return list(range(0, max(num_frames - hop, 1), hop))


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
        corr_add_neighbor_offset: bool = True,
        corr_add_neighbor_xyz: bool = False,
        flow_embed_dim: int = 64,
        compute_dtype: str = "float32",
        remat: bool = False,
        remat_encoder: bool = True,
        knn_backend: str = "auto",
        device="cuda",
        **not_ported,
    ):
        super().__init__()
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"MVTracker got an unexpected keyword argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(f"MVTracker option {name}={value!r} is not ported yet")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        device = resolve_device(device)
        self.sliding_window_len = sliding_window_len
        self.stride = stride
        self.fmaps_dim = fmaps_dim
        self.corr_n_groups = corr_n_groups
        self.corr_n_levels = corr_n_levels
        self.corr_neighbors = corr_neighbors
        self.corr_add_neighbor_offset = corr_add_neighbor_offset
        self.corr_add_neighbor_xyz = corr_add_neighbor_xyz
        self.flow_embed_dim = flow_embed_dim
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
            device=device,
        )
        # Feature update head: LayerNorm (eps 1e-5) -> Linear -> exact GELU.
        self.ffeats_norm = LayerNorm(fmaps_dim, eps=1e-5, device=device)
        self.ffeats_updater = nn.Sequential(Linear(fmaps_dim, fmaps_dim, device=device), nn.GELU())
        self.vis_predictor = nn.Sequential(Linear(fmaps_dim, 1, device=device))

    @property
    def device(self) -> torch.device:
        return self.vis_predictor[0].weight.device

    @property
    def corr_feat_width(self) -> int:
        return self.corr_n_groups + 3 * int(self.corr_add_neighbor_offset) + 3 * int(self.corr_add_neighbor_xyz)

    @property
    def updateformer_input_dim(self) -> int:
        return (
            (self.flow_embed_dim + 1) * 3
            + self.corr_n_levels * self.corr_neighbors * self.corr_feat_width
            + self.fmaps_dim
            + 2
        )

    # ------------------------------------------------------------------
    # Sub-computations
    # ------------------------------------------------------------------

    def compute_fmaps(self, rgbs: torch.Tensor) -> torch.Tensor:
        """[V, T, H, W, 3] in 0..255 -> [V, T, H/s, W/s, C] fp32, all frames at once."""
        v, t, h, w, _ = rgbs.shape
        x = 2.0 * (rgbs.reshape(v * t, h, w, 3).float() / 255.0) - 1.0
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
        """Per-level fused clouds: list of (xyz [T, P_l, 3], fvec [T, P_l, C])."""
        clouds = []
        for lvl in range(self.corr_n_levels):
            xyz, fvec = geo.init_pointcloud_from_rgbd(
                fmaps[None], depths_strided[None], intrs[None], extrs[None], stride=self.stride, level=lvl
            )
            if self.dtype is not None:
                fvec = fvec.to(self.dtype)  # the correlation streams bf16
            clouds.append((xyz.contiguous(), fvec.contiguous()))
        return clouds

    def _feat_init(self, context, query_t, query_xyz):
        """Per-query feature: the k=1 neighbour in the level-0 cloud of the
        query's start frame (clamped into the video). Returns [N, C]."""
        cloud0_xyz, cloud0_fvec = context[0]
        t = cloud0_xyz.shape[0]
        n = query_xyz.shape[0]
        queries = query_xyz[None].expand(t, n, 3)
        _, idx = knn_ops.knn(cloud0_xyz, queries, 1, backend=self.knn_backend)
        fvec = corr_ops.gather_neighbors(cloud0_fvec, idx)[:, :, 0]  # [T, N, C]
        qt = query_t.clamp(0, t - 1)
        return fvec[qt, torch.arange(n, device=fvec.device)]

    def _corr_knn(self, context_w, coords):
        """kNN indices of the track coords into every level's cloud:
        {lvl: [S, N, k]}.

        Levels of at most SMALL_LEVEL_POINTS points are padded with 1e9
        points (which never enter a top-k while a level holds k real points)
        and searched in one call.
        """
        s = coords.shape[0]
        k = self.corr_neighbors
        levels = range(self.corr_n_levels)
        small = [lvl for lvl in levels if context_w[lvl][0].shape[1] <= SMALL_LEVEL_POINTS]
        batched = len(small) > 1
        idx = {}
        for lvl in levels:
            if not (batched and lvl in small):
                idx[lvl] = knn_ops.knn(context_w[lvl][0], coords, k, backend=self.knn_backend)[1]
        if batched:
            pmax = max(context_w[lvl][0].shape[1] for lvl in small)
            refs = torch.cat(
                [F.pad(context_w[lvl][0], (0, 0, 0, pmax - context_w[lvl][0].shape[1]), value=1e9) for lvl in small]
            )
            i_all = knn_ops.knn(refs, coords.repeat(len(small), 1, 1), k, backend=self.knn_backend)[1]
            for j, lvl in enumerate(small):
                idx[lvl] = i_all[j * s : (j + 1) * s]
        return idx

    def _corr_features(self, context_w, coords, ffeats):
        """Correlation features per (frame, track): [S, N, levels * k * F]."""
        s, n, _ = coords.shape
        k = self.corr_neighbors
        knn_idx = self._corr_knn(context_w, coords)
        fcorrs = []
        for lvl in range(self.corr_n_levels):
            xyz_l, fvec_l = context_w[lvl]
            idx = knn_idx[lvl]
            p_l = xyz_l.shape[1]
            if k > p_l:
                # Fewer points than neighbours: ranks >= P_l are padding;
                # wrap the ranks so real neighbours repeat instead.
                idx = idx[..., torch.arange(k, device=idx.device) % p_l]
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

    def forward_iteration(self, context_w, coords_init, vis_init, track_mask, active, feat_init, iters: int):
        """Iterative refinement within one window. Returns (list of coords
        [S, N, 3] per iteration, vis logits [S, N]).

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
        preds = []
        for _ in range(iters):
            coords = coords.detach()
            fcorrs = self._corr_features(context_w, coords, ffeats)
            flows_emb = emb.coord_embedding_3d(coords - coords[0:1], self.flow_embed_dim)
            x = torch.cat([flows_emb, fcorrs, ffeats, mask_and_vis], dim=-1)
            x = x + pos_embed[None] + times_embed[:, None]
            delta = self._maybe_remat(True, self.updateformer, x.permute(1, 0, 2)[None], track_mask=active[None])[0]
            delta = delta.permute(1, 0, 2)  # [S, N, 3 + C]
            coords = coords + delta[..., :3]
            ffeats = ffeats + self.ffeats_updater(self.ffeats_norm(delta[..., 3:]))
            preds.append(coords)
        vis_logits = self.vis_predictor(ffeats)[..., 0]
        return preds, vis_logits

    # ------------------------------------------------------------------
    # Full forward
    # ------------------------------------------------------------------

    def _as_input(self, x) -> torch.Tensor:
        # Move first, cast on the device: uint8 frames and float16 depths
        # cross the bus at their own width.
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.asarray(x))
        return x.to(self.device).float()

    def forward(self, rgbs, depths, query_points, intrs, extrs, iters: int = 4, is_train: bool = False) -> dict:
        """Track the queries through the video -> {"traj" [T, N, 3], "vis"
        [T, N], "feat_init" [N, C]}. Serving (`is_train=False`) records no
        autograd graph. `is_train=True` records one and adds "train_data":
        coord_predictions [W, iters, S, N, 3], vis_predictions [W, S, N]
        (logits), window_starts [W], window_valid [W], window_active [W, N]."""
        with contextlib.nullcontext() if is_train else torch.no_grad():
            return self._forward(rgbs, depths, query_points, intrs, extrs, iters, is_train)

    def _forward(self, rgbs, depths, query_points, intrs, extrs, iters: int, is_train: bool) -> dict:
        rgbs, depths, query_points, intrs, extrs = map(self._as_input, (rgbs, depths, query_points, intrs, extrs))
        v, t, h, w, _ = rgbs.shape
        n = query_points.shape[0]
        s = self.sliding_window_len
        hop = s // 2
        dev = rgbs.device

        query_t = query_points[:, 0].long()  # truncates toward zero
        query_xyz = query_points[:, 1:].contiguous()

        fmaps = self.compute_fmaps(rgbs)
        depths_strided = depths[:, :, :: self.stride, :: self.stride]
        context = self._build_context(fmaps, depths_strided, intrs, extrs)
        feat_init = self._feat_init(context, query_t, query_xyz)

        # Windows are anchored at the earliest query time; n_exec is the
        # number the reference's `while start < T - hop` loop runs.
        qt_min = int(query_t.min())
        n_wind = len(window_starts(t, s))
        n_exec = min(max((t - qt_min - 1) // hop, 1), n_wind)

        all_coords, all_vis, all_active, all_preds, starts = [], [], [], [], []
        for wi in range(n_exec):
            w_start = qt_min + wi * hop
            is_first = wi == 0
            frame_idx = torch.clamp(torch.arange(s, device=dev) + w_start, max=t - 1)
            active = query_t < w_start + s
            context_w = [(xyz.index_select(0, frame_idx), fvec.index_select(0, frame_idx)) for xyz, fvec in context]

            coords_init = query_xyz[None].expand(s, n, 3)
            vis_init = torch.full((s, n), 10.0, device=dev)
            if not is_first:
                # Tracks active in the previous window continue from its
                # second half; the new frames repeat its last frame.
                chained = query_t < w_start + (s - hop)
                prev_tail, prev_vis_tail = all_coords[-1][hop:], all_vis[-1][hop:]
                chained_coords = torch.cat([prev_tail, prev_tail[-1:].expand(s - hop, n, 3)])
                chained_vis = torch.cat([prev_vis_tail, prev_vis_tail[-1:].expand(s - hop, n)])
                coords_init = torch.where(chained[None, :, None], chained_coords, coords_init)
                vis_init = torch.where(chained[None, :], chained_vis, vis_init)

            # Frames consumed by earlier windows carry a zero track mask.
            cutoff = query_t if is_first else torch.clamp(query_t, min=w_start + (s - hop))
            track_mask = (frame_idx[:, None] >= cutoff[None, :]).float()

            preds, vis_logits = self.forward_iteration(
                context_w, coords_init, vis_init, track_mask, active, feat_init, iters
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
        out = {"traj": traj, "vis": vis, "feat_init": feat_init}
        if is_train:
            # W counts the executed windows only, so `window_valid` is all
            # true. The JAX module stacks its static worst-case window count
            # and masks the rest out; the losses are masked means (an empty
            # mask gives 0) and the mean over windows divides by the number
            # of valid ones, so both give the same loss.
            out["train_data"] = {
                "coord_predictions": torch.stack([torch.stack(p) for p in all_preds]),  # [W, iters, S, N, 3]
                "vis_predictions": all_vis,  # [W, S, N] logits
                "window_starts": torch.tensor(starts, dtype=torch.int64, device=dev),  # [W]
                "window_valid": torch.ones(n_exec, dtype=torch.bool, device=dev),  # [W]
                "window_active": all_active,  # [W, N]
            }
        return out

