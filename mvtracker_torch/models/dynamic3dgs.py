"""Dynamic 3D Gaussians optimization baseline, counterpart of
`mvtracker_tpu/models/dynamic3dgs.py`.

An offline per-scene baseline: a set of 3D gaussians is fitted to
multi-view video one timestep at a time, with rigidity regularizers tying
consecutive frames together, and point tracks are read off the fitted
gaussian trajectories. As in the JAX package:

* rendering goes through `ops/gsplat.py`, RGB and segmentation composited
  in one pass (6 attribute channels);
* the gaussians have a fixed capacity: densification (clone, split, prune)
  writes into free slots of an `active` mask and never changes a shape;
* Adam is explicit, so the moments of rewritten slots can be zeroed.

`jax.random` draws become draws from an explicit `torch.Generator`: the view
of each step (`train_segment`) and the split offsets (`densify`). Each of
them also takes its draws as an argument, so that a caller can pass in
another source's. A segment is a Python loop of steps on the device with no
host synchronisation inside it. Both kNN calls go through `ops/knn.knn`
with `backend="auto"`: on CUDA tensors the fused kernel `csrc/knn.cu`.

The tracks go to the evaluator's cached-prediction path
(`evaluation/cached.py`).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import NamedTuple

import numpy as np
import torch

from mvtracker_torch.device import resolve_device
from mvtracker_torch.ops import gsplat
from mvtracker_torch.ops.knn import knn
from mvtracker_torch.utils.misc import depth_ztest_visibility


@dataclasses.dataclass(frozen=True)
class D3DGSConfig:
    """Hyperparameters; the defaults are the JAX package's (the reference
    dynamic3dgs `train.py`)."""

    capacity: int = 32768  # fixed gaussian slot count
    iters_first: int = 10000  # at t=0
    iters_rest: int = 2000  # per later timestep
    segment_iters: int = 100  # steps between densification events
    knn_neighbors: int = 20  # rigidity neighbourhood
    # Neighbour weight w = exp(-tau * d^2); the reference's 2000 assumes
    # ~5 mm point spacing and must shrink for coarser clouds.
    rigidity_tau: float = 2000.0
    grad_thresh: float = 2e-4
    densify_start: int = 500
    densify_until: int = 5000
    opacity_reset_every: int = 3000
    prune_opacity: float = 0.005
    w_im: float = 1.0
    w_seg: float = 3.0
    w_rigid: float = 4.0
    w_rot: float = 4.0
    w_iso: float = 2.0
    w_floor: float = 2.0
    w_bg: float = 20.0
    w_col: float = 0.01
    floor_axis: int | None = 1  # floor at coordinate >= 0 on this axis; None disables
    lr_means_scale: float = 1.6e-4  # x scene_radius
    lr_colors: float = 2.5e-3
    lr_rotations: float = 1e-3
    lr_opacities: float = 0.05
    lr_scales: float = 1e-3
    lr_cam: float = 1e-4


class GaussianState(NamedTuple):
    """All per-slot tensors, fixed capacity C."""

    means3d: torch.Tensor  # [C, 3]
    unnorm_rotations: torch.Tensor  # [C, 4] wxyz
    rgb_colors: torch.Tensor  # [C, 3]
    seg_colors: torch.Tensor  # [C, 3] (fg, 0, bg)
    logit_opacities: torch.Tensor  # [C]
    log_scales: torch.Tensor  # [C, 3]
    cam_m: torch.Tensor  # [V, 3] per-camera colour gain (log)
    cam_c: torch.Tensor  # [V, 3] per-camera colour bias
    active: torch.Tensor  # [C] bool


_TRAINED = ("means3d", "unnorm_rotations", "rgb_colors", "logit_opacities", "log_scales", "cam_m", "cam_c")


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def _adam_init(state: GaussianState) -> AdamState:
    zeros = {k: torch.zeros_like(getattr(state, k)) for k in _TRAINED}
    return AdamState(mu=zeros, nu={k: v.clone() for k, v in zeros.items()},
                     count=torch.zeros((), dtype=torch.int32, device=state.means3d.device))


def _adam_update(grads: dict, opt: AdamState, lrs: dict, b1=0.9, b2=0.999, eps=1e-15) -> tuple[dict, AdamState]:
    """Adam with eps 1e-15, the reference's setting."""
    count = opt.count + 1
    mu = {k: b1 * opt.mu[k] + (1 - b1) * grads[k] for k in grads}
    nu = {k: b2 * opt.nu[k] + (1 - b2) * grads[k] ** 2 for k in grads}
    t = count.to(torch.float32)
    updates = {}
    for k in grads:
        mhat = mu[k] / (1 - b1**t)
        nhat = nu[k] / (1 - b2**t)
        updates[k] = -lrs[k] * mhat / (torch.sqrt(nhat) + eps)
    return updates, AdamState(mu=mu, nu=nu, count=count)


def _lrs(cfg: D3DGSConfig, scene_radius: float, freeze_shape: bool) -> dict:
    """Per-parameter learning rates; after t=0 opacity, scale and camera
    parameters are frozen."""
    return {
        "means3d": cfg.lr_means_scale * scene_radius,
        "rgb_colors": cfg.lr_colors,
        "unnorm_rotations": cfg.lr_rotations,
        "logit_opacities": 0.0 if freeze_shape else cfg.lr_opacities,
        "log_scales": 0.0 if freeze_shape else cfg.lr_scales,
        "cam_m": 0.0 if freeze_shape else cfg.lr_cam,
        "cam_c": 0.0 if freeze_shape else cfg.lr_cam,
    }


def init_from_pointcloud(
    xyz: np.ndarray,
    rgb: np.ndarray,
    is_fg: np.ndarray,
    n_views: int,
    cfg: D3DGSConfig,
    w2cs: np.ndarray,
    seed: int = 0,
    device="cuda",
) -> tuple[GaussianState, float]:
    """Gaussian slots from a fused point cloud: one gaussian per point (a
    subsample of 60 percent of the capacity at most), scale from the mean
    distance to the 3 nearest neighbours, opacity logit 0. Returns (state,
    scene_radius)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = xyz.shape[0]
    budget = int(cfg.capacity * 0.6)  # room for densification
    if n > budget:
        keep = rng.choice(n, size=budget, replace=False)
        xyz, rgb, is_fg = xyz[keep], rgb[keep], is_fg[keep]
        n = budget

    pts = torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(device)[None]
    nn_dists, _ = knn(pts, pts, k=min(4, n))  # neighbour 0 is the point itself
    if nn_dists.shape[-1] == 1:
        mean_sq = np.full((n,), 1e-2)
    else:
        mean_sq = np.clip((nn_dists[0, :, 1:] ** 2).cpu().numpy().mean(-1), 1e-7, None)

    c = cfg.capacity
    pad = c - n

    def padded(a):
        return torch.from_numpy(np.pad(a, ((0, pad), (0, 0))).astype(np.float32)).to(device)

    state = GaussianState(
        means3d=padded(xyz),
        unnorm_rotations=torch.tensor([1.0, 0, 0, 0], device=device).repeat(c, 1),
        rgb_colors=padded(rgb),
        seg_colors=padded(np.stack([is_fg, np.zeros_like(is_fg), 1 - is_fg], -1)),
        logit_opacities=torch.zeros(c, device=device),
        log_scales=padded(np.tile(np.log(np.sqrt(mean_sq))[:, None], (1, 3))),
        cam_m=torch.zeros(n_views, 3, device=device),
        cam_c=torch.zeros(n_views, 3, device=device),
        active=torch.arange(c, device=device) < n,
    )
    cam_centers = -np.einsum("vji,vj->vi", w2cs[:, :3, :3], w2cs[:, :3, 3])
    scene_radius = 1.1 * float(np.linalg.norm(cam_centers - cam_centers.mean(0), axis=-1).max())
    return state, scene_radius


class RigidityRefs(NamedTuple):
    """Frozen neighbour structure and previous-frame anchors for the t>0
    losses."""

    neighbor_idx: torch.Tensor  # [C, K] slots (foreground neighbours)
    neighbor_weight: torch.Tensor  # [C, K]
    neighbor_dist: torch.Tensor  # [C, K]
    prev_pts: torch.Tensor  # [C, 3]
    prev_rot: torch.Tensor  # [C, 4] normalized
    prev_inv_rot: torch.Tensor  # [C, 4]
    prev_offset: torch.Tensor  # [C, K, 3]
    prev_col: torch.Tensor  # [C, 3]
    init_bg_pts: torch.Tensor  # [C, 3]
    init_bg_rot: torch.Tensor  # [C, 4]


def _normalize_quat(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-8)


def _conjugate(q):
    return q * torch.tensor([1.0, -1, -1, -1], dtype=q.dtype, device=q.device)


def build_rigidity_refs(state: GaussianState, cfg: D3DGSConfig) -> RigidityRefs:
    """kNN over the foreground gaussians (rank 0, the slot itself, dropped).
    Inactive and background slots are moved to distinct far positions so
    they are never a foreground slot's neighbours; the distance there (about
    100) keeps the kNN's fp32 distances of real neighbours exact."""
    is_fg = (state.seg_colors[:, 0] > 0.5) & state.active
    c = state.means3d.shape[0]
    device = state.means3d.device
    banish = (100.0 + 1e-3 * torch.arange(c, dtype=torch.float32, device=device))[:, None].expand(c, 3)
    pts = torch.where(is_fg[:, None], state.means3d, banish)
    dists, idx = knn(pts[None], pts[None], k=cfg.knn_neighbors + 1)
    dists, idx = dists[0, :, 1:], idx[0, :, 1:]
    rot = _normalize_quat(state.unnorm_rotations)
    return RigidityRefs(
        neighbor_idx=idx,
        neighbor_weight=torch.where(is_fg[:, None], torch.exp(-cfg.rigidity_tau * dists**2), torch.zeros_like(dists)),
        neighbor_dist=dists,
        prev_pts=state.means3d,
        prev_rot=rot,
        prev_inv_rot=_conjugate(rot),
        prev_offset=state.means3d[idx] - state.means3d[:, None],
        prev_col=state.rgb_colors,
        init_bg_pts=state.means3d,
        init_bg_rot=rot,
    )


def advance_timestep(state: GaussianState, refs: RigidityRefs) -> tuple[GaussianState, RigidityRefs]:
    """Constant-velocity extrapolation of means and rotations, and the
    anchors refreshed."""
    rot = _normalize_quat(state.unnorm_rotations)
    new_pts = state.means3d + (state.means3d - refs.prev_pts)
    new_rot = _normalize_quat(rot + (rot - refs.prev_rot))
    new_refs = refs._replace(
        prev_pts=state.means3d,
        prev_rot=rot,
        prev_inv_rot=_conjugate(rot),
        prev_offset=state.means3d[refs.neighbor_idx] - state.means3d[:, None],
        prev_col=state.rgb_colors,
    )
    return state._replace(means3d=new_pts, unnorm_rotations=new_rot), new_refs


class DensifyStats(NamedTuple):
    grad_accum: torch.Tensor  # [C]
    denom: torch.Tensor  # [C]
    max_radius: torch.Tensor  # [C]


def _zero_stats(c: int, device) -> DensifyStats:
    z = torch.zeros(c, device=device)
    return DensifyStats(z, z.clone(), z.clone())


_LOSS_WEIGHTS = {"im": "w_im", "seg": "w_seg", "rigid": "w_rigid", "rot": "w_rot", "iso": "w_iso",
                 "floor": "w_floor", "bg": "w_bg", "soft_col_cons": "w_col"}


def train_segment(
    state: GaussianState,
    opt: AdamState,
    stats: DensifyStats,
    refs: RigidityRefs,
    views: dict,  # im [V,H,W,3], seg [V,H,W,3], intr [V,3,3], w2c [V,3,4]
    scene_radius: float,
    cfg: D3DGSConfig,
    is_initial: bool,
    img_wh: tuple[int, int],
    n_iters: int,
    chunk: int = 1024,
    generator: torch.Generator | None = None,
    view_draws: torch.Tensor | None = None,
):
    """`n_iters` optimization steps; each renders one camera, drawn
    uniformly from `generator` (or taken from `view_draws` [n_iters]).
    Returns (state, opt, stats, losses [n_iters])."""
    lrs = _lrs(cfg, scene_radius, freeze_shape=not is_initial)
    device = state.means3d.device
    if view_draws is None:
        view_draws = torch.randint(0, views["im"].shape[0], (n_iters,), generator=generator, device=device)
    view_draws = view_draws.to(device)
    attrs_seg = state.seg_colors
    losses = []
    for it in range(n_iters):
        vidx = view_draws[it]
        im_gt, seg_gt = gsplat.pick(views["im"], vidx), gsplat.pick(views["seg"], vidx)
        params = {k: getattr(state, k).detach().requires_grad_(True) for k in _TRAINED}
        offset = torch.zeros_like(state.means3d[:, :2], requires_grad=True)
        st = state._replace(**params)
        with torch.enable_grad():
            opac = torch.where(st.active, st.logit_opacities, torch.full_like(st.logit_opacities, -1e9))
            out = gsplat.render_gaussians(
                st.means3d, st.unnorm_rotations, st.log_scales, opac, torch.cat([st.rgb_colors, attrs_seg], dim=-1),
                gsplat.pick(views["intr"], vidx), gsplat.pick(views["w2c"], vidx), img_wh, chunk=chunk,
                means2d_offset=offset)
            im = (torch.exp(gsplat.pick(st.cam_m, vidx))[None, None] * out.rgb[..., :3]
                  + gsplat.pick(st.cam_c, vidx)[None, None])
            seg_r = out.rgb[..., 3:]
            terms = {
                "im": 0.8 * gsplat.abs_(im - im_gt).mean() + 0.2 * (1.0 - gsplat.ssim(im, im_gt)),
                "seg": 0.8 * gsplat.abs_(seg_r - seg_gt).mean() + 0.2 * (1.0 - gsplat.ssim(seg_r, seg_gt)),
            }
            if not is_initial:
                terms.update(_regularizers(st, refs, cfg))
            total = sum(getattr(cfg, _LOSS_WEIGHTS[k]) * v for k, v in terms.items())
            grads = torch.autograd.grad(total, [params[k] for k in _TRAINED] + [offset])
        pgrads = dict(zip(_TRAINED, grads[:-1]))
        seen = out.radii > 0
        stats = DensifyStats(
            grad_accum=stats.grad_accum + torch.where(seen, torch.linalg.norm(grads[-1], dim=-1),
                                                      torch.zeros_like(stats.grad_accum)),
            denom=stats.denom + seen.to(torch.float32),
            max_radius=torch.maximum(stats.max_radius, out.radii.detach()),
        )
        updates, opt = _adam_update(pgrads, opt, lrs)
        state = state._replace(**{k: getattr(state, k) + updates[k] for k in _TRAINED})
        losses.append(total.detach())
    return state, opt, stats, torch.stack(losses)


def _regularizers(st: GaussianState, refs: RigidityRefs, cfg: D3DGSConfig) -> dict:
    """The rigidity, rotation, isometry, floor, background and colour terms
    of the t>0 loss."""
    active = st.active
    is_fg = (st.seg_colors[:, 0] > 0.5) & active
    w = refs.neighbor_weight
    rot = _normalize_quat(st.unnorm_rotations)
    rel_rot = gsplat.quat_multiply(rot, refs.prev_inv_rot)
    rmat = gsplat.quat_to_rotmat(rel_rot)
    cur_off = st.means3d[refs.neighbor_idx] - st.means3d[:, None]
    off_prev = torch.einsum("cji,ckj->cki", rmat, cur_off)
    denom = torch.clamp(w.sum(), min=1e-8)
    zero = torch.zeros((), device=w.device)

    out = {
        "rigid": (w[..., None] * (off_prev - refs.prev_offset) ** 2).sum() / (3 * denom),
        "rot": (w[..., None] * (rel_rot[refs.neighbor_idx] - rel_rot[:, None]) ** 2).sum() / (4 * denom),
        "iso": (w * (torch.sqrt((cur_off**2).sum(-1) + 1e-20) - refs.neighbor_dist) ** 2).sum() / denom,
    }
    if cfg.floor_axis is not None:
        fg_count = torch.clamp(is_fg.sum(), min=1)
        out["floor"] = torch.where(is_fg, torch.clamp(st.means3d[:, cfg.floor_axis], min=0.0), zero).sum() / fg_count
    is_bg = (~(st.seg_colors[:, 0] > 0.5)) & active
    bg_count = torch.clamp(is_bg.sum(), min=1)
    out["bg"] = (
        torch.where(is_bg[:, None], gsplat.abs_(st.means3d - refs.init_bg_pts), zero).sum() / (3 * bg_count)
        + torch.where(is_bg[:, None], gsplat.abs_(rot - refs.init_bg_rot), zero).sum() / (4 * bg_count)
    )
    n_act = torch.clamp(active.sum(), min=1)
    out["soft_col_cons"] = torch.where(active[:, None], gsplat.abs_(st.rgb_colors - refs.prev_col), zero).sum() / (
        3 * n_act)
    return out


def _bmask(mask, arr):
    return mask if arr.dim() == 1 else mask[:, None]


def _set_rows(arr: torch.Tensor, dst: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """`arr` with rows `val[i]` written at `dst[i]`; a `dst` of len(arr)
    writes nothing (it lands in a discarded extra row, never wraps)."""
    out = torch.cat([arr, arr[:1]], dim=0)
    out[dst] = val
    return out[:-1]


def densify(
    state: GaussianState,
    opt: AdamState,
    stats: DensifyStats,
    scene_radius: float,
    iteration: int,
    cfg: D3DGSConfig,
    generator: torch.Generator | None = None,
    split_noise: torch.Tensor | None = None,
):
    """Clone, split and prune at fixed capacity.

    Clone: a high screen gradient and a small world scale copy the gaussian
    into a free slot. Split: a high gradient and a large scale make two
    children sampled from the gaussian with scales shrunk 1.6 times; one
    takes a free slot, the other the parent's. Prune: low opacity (0.25 at
    the last densification), and oversized in the world after iteration
    3000. Free slots go in order of the requests; requests past the free
    pool are dropped. The Adam moments of rewritten slots are zeroed.

    `split_noise` [2, C, 3] standard normal draws (drawn from `generator`
    when None) set the split offsets, in each gaussian's own frame.
    """
    c = state.means3d.shape[0]
    device = state.means3d.device
    grads = torch.where(stats.denom > 0, stats.grad_accum / torch.clamp(stats.denom, min=1),
                        torch.zeros_like(stats.denom))
    small = torch.exp(state.log_scales).max(-1).values <= 0.01 * scene_radius
    hot = (grads >= cfg.grad_thresh) & state.active
    to_clone = hot & small
    to_split = hot & ~small
    request = to_clone | to_split  # each needs one free slot

    free = ~state.active
    n_free = free.sum()
    free_slots = torch.argsort((~free).to(torch.int8), stable=True)  # the free slots first, in order
    req = request.to(torch.int64)
    rank = torch.cumsum(req, 0) - req
    granted = request & (rank < n_free)
    dst = free_slots[torch.clamp(rank, 0, c - 1)]
    dst_or_drop = torch.where(granted, dst, torch.full_like(dst, c))

    if split_noise is None:
        split_noise = torch.randn(2, c, 3, generator=generator, device=device)
    eps = split_noise.to(device) * torch.exp(state.log_scales)[None]
    rmat = gsplat.quat_to_rotmat(_normalize_quat(state.unnorm_rotations))
    offs = torch.einsum("cij,ncj->nci", rmat, eps)  # [2, C, 3]
    shrunk = state.log_scales - math.log(1.6)
    split_g = granted & to_split

    def scatter(arr, dst_val, parent_val):
        out = _set_rows(arr, dst_or_drop, dst_val)
        return torch.where(_bmask(split_g, arr), parent_val, out)

    new_vals = {
        "means3d": scatter(state.means3d,
                           torch.where(to_split[:, None], state.means3d + offs[0], state.means3d),
                           state.means3d + offs[1]),
        "log_scales": scatter(state.log_scales,
                              torch.where(to_split[:, None], shrunk, state.log_scales),
                              shrunk),
    }
    for name in ("unnorm_rotations", "rgb_colors", "seg_colors", "logit_opacities"):
        arr = getattr(state, name)
        new_vals[name] = _set_rows(arr, dst_or_drop, arr)
    active = _set_rows(state.active, dst_or_drop, torch.ones_like(state.active))

    prune_thresh = 0.25 if iteration == cfg.densify_until else cfg.prune_opacity
    to_remove = torch.sigmoid(new_vals["logit_opacities"]) < prune_thresh
    if iteration >= 3000:
        to_remove = to_remove | (torch.exp(new_vals["log_scales"]).max(-1).values > 0.1 * scene_radius)
    active = active & ~to_remove
    new_state = state._replace(active=active, **new_vals)

    touched = _set_rows(torch.zeros(c, dtype=torch.bool, device=device), dst_or_drop,
                        torch.ones(c, dtype=torch.bool, device=device)) | split_g

    def zero_rows(tree):
        return {k: v if k in ("cam_m", "cam_c") else torch.where(_bmask(touched, v), torch.zeros_like(v), v)
                for k, v in tree.items()}

    new_opt = AdamState(mu=zero_rows(opt.mu), nu=zero_rows(opt.nu), count=opt.count)
    return new_state, new_opt, _zero_stats(c, device)


def reset_opacities(state: GaussianState) -> GaussianState:
    """Every gaussian's opacity back to 0.01."""
    return state._replace(logit_opacities=torch.full_like(state.logit_opacities, float(np.log(0.01 / 0.99))))


def fit_scene(
    video: np.ndarray,  # [V, T, H, W, 3] float in [0, 1]
    seg: np.ndarray,  # [V, T, H, W] float foreground probability
    intrs: np.ndarray,  # [V, 3, 3]
    extrs: np.ndarray,  # [V, 3, 4]
    init_xyz: np.ndarray,
    init_rgb: np.ndarray,
    init_is_fg: np.ndarray,
    cfg: D3DGSConfig = D3DGSConfig(),
    seed: int = 0,
    chunk: int = 1024,
    progress: bool = False,
    device="cuda",
) -> dict:
    """The whole per-scene fit: t=0 with densification, then each later
    timestep from a constant-velocity start. Draws come from a
    `torch.Generator` on the device seeded with `seed`. Returns the
    per-timestep means and rotations stacked, and the final shape and
    appearance, as numpy arrays."""
    device = resolve_device(device)
    v, t_total, h, w_img = video.shape[:4]
    gen = torch.Generator(device=device).manual_seed(seed)
    state, scene_radius = init_from_pointcloud(init_xyz, init_rgb, init_is_fg, v, cfg, np.asarray(extrs), seed,
                                               device=device)
    opt = _adam_init(state)
    stats = _zero_stats(cfg.capacity, device)
    refs = build_rigidity_refs(state, cfg)  # replaced after t=0

    video_d = torch.from_numpy(np.ascontiguousarray(video, np.float32)).to(device)
    seg_d = torch.from_numpy(np.ascontiguousarray(seg, np.float32)).to(device)
    seg3 = torch.stack([seg_d, torch.zeros_like(seg_d), 1 - seg_d], dim=-1)
    intr_d = torch.from_numpy(np.asarray(intrs, np.float32)).to(device)
    w2c_d = torch.from_numpy(np.asarray(extrs, np.float32)).to(device)
    out_means, out_rots = [], []
    for t in range(t_total):
        views = {"im": video_d[:, t], "seg": seg3[:, t], "intr": intr_d, "w2c": w2c_d}
        is_initial = t == 0
        if not is_initial:
            state, refs = advance_timestep(state, refs)
            opt = _adam_init(state)
        n_iters = cfg.iters_first if is_initial else cfg.iters_rest
        it = 0
        while it < n_iters:
            seg_len = min(cfg.segment_iters, n_iters - it)
            state, opt, stats, losses = train_segment(state, opt, stats, refs, views, scene_radius, cfg, is_initial,
                                                      (w_img, h), seg_len, chunk, generator=gen)
            it += seg_len
            if is_initial and cfg.densify_start <= it <= cfg.densify_until and it % 100 == 0:
                state, opt, stats = densify(state, opt, stats, scene_radius, it, cfg, generator=gen)
            if is_initial and it % cfg.opacity_reset_every == 0 and it < n_iters:
                state = reset_opacities(state)
            if progress and it % 500 == 0:
                logging.info("t=%d iter=%d loss=%.4f active=%d", t, it, float(losses[-1]), int(state.active.sum()))
        if is_initial:
            refs = build_rigidity_refs(state, cfg)
        out_means.append(state.means3d.cpu().numpy())
        out_rots.append(_normalize_quat(state.unnorm_rotations).cpu().numpy())

    return {
        "means3d": np.stack(out_means),  # [T, C, 3]
        "rotations": np.stack(out_rots),  # [T, C, 4]
        "log_scales": state.log_scales.cpu().numpy(),
        "logit_opacities": state.logit_opacities.cpu().numpy(),
        "rgb_colors": state.rgb_colors.cpu().numpy(),
        "seg_colors": state.seg_colors.cpu().numpy(),
        "active": state.active.cpu().numpy(),
    }


def extract_tracks(
    fitted: dict,
    query_points: np.ndarray,  # [N, 4] (t, x, y, z)
    depths: np.ndarray | None = None,  # [V, T, H, W] for the visibility z-test
    intrs: np.ndarray | None = None,
    extrs: np.ndarray | None = None,
    vis_threshold: float = 0.02,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Tracks read off the fitted gaussian trajectories: each query attaches
    to its most influential active gaussian at the query's timestep and
    follows that gaussian's mean, carrying its offset rigidly with the
    gaussian's rotation. Visibility is the depth z-test over views. Returns
    (tracks [T, N, 3], visibility [T, N])."""
    device = resolve_device(device)

    def on(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    means, rots = on(fitted["means3d"]), on(fitted["rotations"])  # [T, C, 3], [T, C, 4]
    active = torch.from_numpy(np.asarray(fitted["active"], bool)).to(device)
    log_scales, logit_opac = on(fitted["log_scales"]), on(fitted["logit_opacities"])
    t_total = means.shape[0]
    qt = query_points[:, 0].astype(int)
    qxyz = on(query_points[:, 1:4])
    n = len(qt)

    infl = torch.empty(n, means.shape[1], device=device)
    for t in np.unique(qt):
        sel = torch.from_numpy(np.nonzero(qt == t)[0]).to(device)
        infl[sel] = gsplat.gaussian_influence(qxyz[sel], means[t], rots[t], log_scales, logit_opac)
    infl = torch.where(active[None], infl, torch.full_like(infl, -float("inf")))
    idx = torch.argmax(infl, dim=-1)

    qt_d = torch.from_numpy(qt).to(device)
    anchor_mean = means[qt_d, idx]
    anchor_rot = rots[qt_d, idx]
    local = torch.einsum("nji,nj->ni", gsplat.quat_to_rotmat(anchor_rot), qxyz - anchor_mean)
    tracks = means[:, idx] + torch.einsum("tnij,nj->tni", gsplat.quat_to_rotmat(rots[:, idx]), local)
    tracks = tracks.cpu().numpy()
    if depths is None:
        return tracks, np.ones((t_total, n), bool)
    return tracks, depth_ztest_visibility(tracks, depths, intrs, extrs, vis_threshold)


def export_cached_predictions(path, tracks: np.ndarray, visibility: np.ndarray):
    """Write the npz `evaluation/cached.py` reads ({traj, vis})."""
    np.savez(path, traj=tracks.astype(np.float32), vis=visibility)
