"""Shape-of-Motion optimization baseline, counterpart of
`mvtracker_tpu/models/shape_of_motion.py`.

An offline per-scene optimizer. The scene is static background gaussians
plus foreground gaussians whose rigid motion at each frame is a convex blend
of K shared SE(3) motion bases (continuous-6D rotations [K, T, 6] and
translations [K, T, 3], blended by per-gaussian coefficients [G, K]). It is
fitted to RGB, and optionally depth, mask and 3D track supervision, by Adam
steps over randomly drawn (frame, view) pairs; 3D tracks are read off the
optimized motion field. Rendering goes through `ops/gsplat.py`.

`jax.random` draws become draws from an explicit `torch.Generator` (the
frame, the view and the supervised track subset of each step); `fit_segment`
also takes them as an argument. A segment is a Python loop of steps on the
device with no host synchronisation inside it. The kNN of the initial
scales goes through `ops/knn.knn` with `backend="auto"`: on CUDA tensors
the fused kernel `csrc/knn.cu`.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import numpy as np
import torch

from mvtracker_torch.device import resolve_device
from mvtracker_torch.ops import gsplat
from mvtracker_torch.ops.knn import knn
from mvtracker_torch.utils.misc import depth_ztest_visibility


@dataclasses.dataclass(frozen=True)
class SOMConfig:
    num_bases: int = 10  # K motion bases (flow3d default)
    iters: int = 2000
    segment_iters: int = 200
    lr_means: float = 1.6e-4
    lr_colors: float = 2.5e-3
    lr_quats: float = 1e-3
    lr_opacities: float = 5e-2
    lr_scales: float = 5e-3
    lr_motion_coefs: float = 1e-2
    lr_motion_bases: float = 1.6e-4
    w_rgb: float = 1.0
    w_mask: float = 1.0
    w_depth: float = 0.5
    w_track: float = 2.0
    w_smooth_bases: float = 0.1
    w_scale_var: float = 0.01
    tracks_per_step: int = 64


class MotionBases(NamedTuple):
    rots: torch.Tensor  # [K, T, 6] cont-6d
    transls: torch.Tensor  # [K, T, 3]

    @property
    def num_bases(self):
        return self.rots.shape[0]

    @property
    def num_frames(self):
        return self.rots.shape[1]


def compute_transforms(bases: MotionBases, ts: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """Blend the bases at frame indices ts [B] with coefs [G, K] ->
    [G, B, 3, 4]: the 6D rotations and translations blend linearly, then
    the rotations are orthonormalized."""
    transls = torch.einsum("gk,kbi->gbi", coefs, bases.transls[:, ts])
    rots = torch.einsum("gk,kbi->gbi", coefs, bases.rots[:, ts])
    return torch.cat([gsplat.cont6d_to_rotmat(rots), transls[..., None]], dim=-1)


class SOMParams(NamedTuple):
    """Trainable scene parameters; foreground (Gf) and background (Gb)."""

    fg_means: torch.Tensor  # [Gf, 3] canonical (frame-0) positions
    fg_quats: torch.Tensor  # [Gf, 4]
    fg_log_scales: torch.Tensor  # [Gf, 3]
    fg_logit_opacities: torch.Tensor  # [Gf]
    fg_colors: torch.Tensor  # [Gf, 3]
    motion_coefs: torch.Tensor  # [Gf, K] (softmaxed before blending)
    motion_rots: torch.Tensor  # [K, T, 6]
    motion_transls: torch.Tensor  # [K, T, 3]
    bg_means: torch.Tensor  # [Gb, 3]
    bg_quats: torch.Tensor  # [Gb, 4]
    bg_log_scales: torch.Tensor  # [Gb, 3]
    bg_logit_opacities: torch.Tensor  # [Gb]
    bg_colors: torch.Tensor  # [Gb, 3]


def _coef_weights(motion_coefs: torch.Tensor) -> torch.Tensor:
    """The raw coefficients, softmaxed."""
    return torch.softmax(motion_coefs, dim=-1)


def fg_poses_at(params: SOMParams, ts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Foreground means and quaternions at frame indices ts [B] ->
    ([Gf, B, 3], [Gf, B, 4])."""
    tf = compute_transforms(MotionBases(params.motion_rots, params.motion_transls), ts,
                            _coef_weights(params.motion_coefs))
    means = torch.einsum("gbij,gj->gbi", tf[..., :3], params.fg_means) + tf[..., 3]
    quats = gsplat.quat_multiply(_rotmat_to_quat(tf[..., :3]), params.fg_quats[:, None, :])
    return means, quats


def _rotmat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> wxyz quaternion, branchless Shepperd:
    the largest of the four candidate pivots (the first on ties)."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) / 2
    case = torch.argmax(qw, dim=-1)

    w0, x0 = qw[..., 0], (m21 - m12) / (4 * qw[..., 0])
    y0, z0 = (m02 - m20) / (4 * qw[..., 0]), (m10 - m01) / (4 * qw[..., 0])
    x1, w1 = qw[..., 1], (m21 - m12) / (4 * qw[..., 1])
    y1, z1 = (m01 + m10) / (4 * qw[..., 1]), (m02 + m20) / (4 * qw[..., 1])
    y2, w2 = qw[..., 2], (m02 - m20) / (4 * qw[..., 2])
    x2, z2 = (m01 + m10) / (4 * qw[..., 2]), (m12 + m21) / (4 * qw[..., 2])
    z3, w3 = qw[..., 3], (m10 - m01) / (4 * qw[..., 3])
    x3, y3 = (m02 + m20) / (4 * qw[..., 3]), (m12 + m21) / (4 * qw[..., 3])

    q = torch.stack(
        [
            torch.stack([w0, x0, y0, z0], -1),
            torch.stack([w1, x1, y1, z1], -1),
            torch.stack([w2, x2, y2, z2], -1),
            torch.stack([w3, x3, y3, z3], -1),
        ],
        dim=-2,
    )  # [..., 4 cases, 4]
    q = torch.gather(q, -2, case[..., None, None].expand(*case.shape, 1, 4))[..., 0, :]
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-8)


def init_params(
    fg_xyz: np.ndarray,
    fg_rgb: np.ndarray,
    bg_xyz: np.ndarray,
    bg_rgb: np.ndarray,
    num_frames: int,
    cfg: SOMConfig,
    seed: int = 0,
    device="cuda",
) -> SOMParams:
    """Parameters from segmented point clouds: scales from the 3-NN
    spacing, identity motion bases, and coefficient logits from the squared
    distance to K cluster centres drawn from the foreground points."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def scales_of(xyz):
        b = torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(device)[None]
        d, _ = knn(b, b, k=min(4, len(xyz)))
        if d.shape[-1] == 1:  # one point: no spacing to measure
            sq = np.full((len(xyz),), 1e-2)
        else:
            sq = np.clip((d[0, :, 1:] ** 2).cpu().numpy().mean(-1), 1e-7, None)
        return np.tile(np.log(np.sqrt(sq))[:, None], (1, 3))

    k = cfg.num_bases
    centers = fg_xyz[rng.choice(len(fg_xyz), size=min(k, len(fg_xyz)), replace=False)]
    if len(centers) < k:
        centers = np.concatenate([centers] * (k // len(centers) + 1))[:k]
    d2 = ((fg_xyz[:, None] - centers[None]) ** 2).sum(-1)
    coefs = -d2 / np.clip(d2.mean(), 1e-8, None)  # near a centre -> high logit
    ident_rot = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (k, num_frames, 1))

    def on(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    unit = torch.tensor([1.0, 0, 0, 0], device=device)
    return SOMParams(
        fg_means=on(fg_xyz),
        fg_quats=unit.repeat(len(fg_xyz), 1),
        fg_log_scales=on(scales_of(fg_xyz)),
        fg_logit_opacities=torch.zeros(len(fg_xyz), device=device),
        fg_colors=on(fg_rgb),
        motion_coefs=on(coefs),
        motion_rots=on(ident_rot),
        motion_transls=torch.zeros(k, num_frames, 3, device=device),
        bg_means=on(bg_xyz),
        bg_quats=unit.repeat(len(bg_xyz), 1),
        bg_log_scales=on(scales_of(bg_xyz)),
        bg_logit_opacities=torch.zeros(len(bg_xyz), device=device),
        bg_colors=on(bg_rgb),
    )


def _lr_tree(cfg: SOMConfig) -> dict:
    return {
        "fg_means": cfg.lr_means,
        "fg_quats": cfg.lr_quats,
        "fg_log_scales": cfg.lr_scales,
        "fg_logit_opacities": cfg.lr_opacities,
        "fg_colors": cfg.lr_colors,
        "motion_coefs": cfg.lr_motion_coefs,
        "motion_rots": cfg.lr_motion_bases,
        "motion_transls": cfg.lr_motion_bases,
        "bg_means": cfg.lr_means,
        "bg_quats": cfg.lr_quats,
        "bg_log_scales": cfg.lr_scales,
        "bg_logit_opacities": cfg.lr_opacities,
        "bg_colors": cfg.lr_colors,
    }


def render_frame(params: SOMParams, t, intr, w2c, img_wh: tuple[int, int], chunk: int = 1024):
    """Frame t: the moving foreground and the static background in one
    pass. The 4th attribute channel is the foreground indicator, so
    `rgb[..., 3]` is the rendered foreground mask."""
    device = params.fg_means.device
    fg_means, fg_quats = fg_poses_at(params, torch.as_tensor(t, device=device).reshape(1))
    nf, nb = params.fg_means.shape[0], params.bg_means.shape[0]
    fg_flag = torch.cat([torch.ones(nf, 1, device=device), torch.zeros(nb, 1, device=device)])
    attrs = torch.cat([torch.cat([params.fg_colors, params.bg_colors]), fg_flag], dim=-1)
    return gsplat.render_gaussians(
        torch.cat([fg_means[:, 0], params.bg_means]),
        torch.cat([fg_quats[:, 0], params.bg_quats]),
        torch.cat([params.fg_log_scales, params.bg_log_scales]),
        torch.cat([params.fg_logit_opacities, params.bg_logit_opacities]),
        attrs, intr, w2c, img_wh, chunk=chunk)


def draw_steps(data: dict, cfg: SOMConfig, n_iters: int, generator: torch.Generator | None, device) -> dict:
    """The random draws of `n_iters` steps: a frame and a view each, and
    `cfg.tracks_per_step` supervised tracks where `data` has tracks."""
    v, t_total = data["video"].shape[:2]
    draws = {
        "frames": torch.randint(0, t_total, (n_iters,), generator=generator, device=device),
        "views": torch.randint(0, v, (n_iters,), generator=generator, device=device),
    }
    if "tracks3d" in data:
        draws["tracks"] = torch.randint(0, data["tracks3d"].shape[0], (n_iters, cfg.tracks_per_step),
                                        generator=generator, device=device)
    return draws


def _loss(p: SOMParams, data: dict, cfg: SOMConfig, img_wh, chunk, t, vi, sel):
    t_total = data["video"].shape[1]
    pick = gsplat.pick

    out = render_frame(p, t, pick(data["intrs"], vi), pick(data["w2cs"], vi), img_wh, chunk)
    im, mask_r = out.rgb[..., :3], out.rgb[..., 3]
    gt_im = pick(pick(data["video"], vi), t)
    losses = {"rgb": 0.8 * gsplat.abs_(im - gt_im).mean() + 0.2 * (1.0 - gsplat.ssim(im, gt_im))}
    if "mask" in data:
        losses["mask"] = ((mask_r - pick(pick(data["mask"], vi), t)) ** 2).mean()
    if "depth" in data:
        gt_d = pick(pick(data["depth"], vi), t)
        valid = (gt_d > 0).to(im.dtype)
        d = out.depth / torch.clamp(out.alpha, min=1e-6)  # expected depth is alpha-weighted
        losses["depth"] = (valid * gsplat.abs_(d - gt_d)).sum() / torch.clamp(valid.sum(), min=1)
    if "tracks3d" in data:
        # Each supervised track attaches at its first valid frame and must
        # land on its ground truth at frame t.
        tr, tv = data["tracks3d"][sel], data["tracks3d_valid"][sel]  # [K, T, 3], [K, T]
        first_valid = torch.argmax(tv.to(torch.int32), dim=1)
        anchor = torch.gather(tr, 1, first_valid[:, None, None].expand(-1, 1, 3))[:, 0]
        pred = track_points(p, anchor, first_valid, t.reshape(1), topk=8)[:, 0]
        w_valid = pick(tv, t, 1).to(im.dtype)[:, None]
        losses["track"] = (gsplat.abs_(pred - pick(tr, t, 1)) * w_valid).sum() / torch.clamp(w_valid.sum() * 3, min=1)
    if t_total >= 3:  # second difference of the bases over time
        losses["smooth_bases"] = 0.0
        for arr in (p.motion_rots, p.motion_transls):
            accel = arr[:, 2:] - 2 * arr[:, 1:-1] + arr[:, :-2]
            losses["smooth_bases"] = losses["smooth_bases"] + (accel**2).mean()
    losses["scale_var"] = torch.var(p.fg_log_scales, dim=-1, correction=0).mean()
    weights = {"rgb": cfg.w_rgb, "mask": cfg.w_mask, "depth": cfg.w_depth, "track": cfg.w_track,
               "smooth_bases": cfg.w_smooth_bases, "scale_var": cfg.w_scale_var}
    return sum(weights[k] * v for k, v in losses.items())


def fit_segment(
    params: SOMParams,
    opt_state: tuple,
    data: dict,
    cfg: SOMConfig,
    img_wh: tuple[int, int],
    n_iters: int,
    chunk: int = 1024,
    generator: torch.Generator | None = None,
    draws: dict | None = None,
):
    """`n_iters` Adam steps, each on one (frame, view) drawn uniformly.

    data: video [V,T,H,W,3], optional depth [V,T,H,W] (0 = missing), mask
    [V,T,H,W], intrs [V,3,3], w2cs [V,3,4], and optional 3D track
    supervision tracks3d [Nt,T,3] with tracks3d_valid [Nt,T], all on the
    device. `draws` ({frames, views[, tracks]}, as `draw_steps` makes them)
    replaces the draws from `generator`. Returns (params, opt_state,
    losses [n_iters])."""
    lrs = _lr_tree(cfg)
    device = params.fg_means.device
    if draws is None:
        draws = draw_steps(data, cfg, n_iters, generator, device)
    mu, nu, count = opt_state
    mu, nu = dict(mu), dict(nu)
    losses = []
    for it in range(n_iters):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params._asdict().items()}
        sel = draws["tracks"][it] if "tracks" in draws else None
        with torch.enable_grad():
            loss = _loss(SOMParams(**leaves), data, cfg, img_wh, chunk, draws["frames"][it], draws["views"][it], sel)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        count = count + 1
        tc = count.to(torch.float32)
        new_vals = {}
        for (k, p), g in zip(leaves.items(), grads):
            g = torch.zeros_like(p) if g is None else g
            mu[k] = 0.9 * mu[k] + 0.1 * g
            nu[k] = 0.999 * nu[k] + 0.001 * g * g
            mhat = mu[k] / (1 - 0.9**tc)
            nhat = nu[k] / (1 - 0.999**tc)
            new_vals[k] = p.detach() - lrs[k] * mhat / (torch.sqrt(nhat) + 1e-15)
        params = SOMParams(**new_vals)
        losses.append(loss.detach())
    return params, (mu, nu, count), torch.stack(losses)


def adam_init(params: SOMParams) -> tuple:
    zeros = {k: torch.zeros_like(v) for k, v in params._asdict().items()}
    return zeros, {k: v.clone() for k, v in zeros.items()}, torch.zeros((), dtype=torch.int32,
                                                                        device=params.fg_means.device)


def scene_data(video, intrs, w2cs, depth=None, mask=None, tracks3d=None, tracks3d_valid=None, device="cuda") -> dict:
    """The numpy inputs of a fit as the device tensors `fit_segment` takes."""
    device = resolve_device(device)

    def on(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    data = {"video": on(video), "intrs": on(intrs), "w2cs": on(w2cs)}
    if depth is not None:
        data["depth"] = on(depth)
    if mask is not None:
        data["mask"] = on(mask)
    if tracks3d is not None:
        data["tracks3d"] = on(tracks3d)
        data["tracks3d_valid"] = on(np.ones(tracks3d.shape[:2], bool) if tracks3d_valid is None else tracks3d_valid,
                                    bool)
    return data


def fit_scene(
    video: np.ndarray,  # [V, T, H, W, 3] in [0, 1]
    intrs: np.ndarray,  # [V, 3, 3]
    w2cs: np.ndarray,  # [V, 3, 4]
    fg_xyz: np.ndarray,
    fg_rgb: np.ndarray,
    bg_xyz: np.ndarray,
    bg_rgb: np.ndarray,
    depth: np.ndarray | None = None,
    mask: np.ndarray | None = None,
    tracks3d: np.ndarray | None = None,
    tracks3d_valid: np.ndarray | None = None,
    cfg: SOMConfig = SOMConfig(),
    seed: int = 0,
    chunk: int = 1024,
    progress: bool = False,
    device="cuda",
) -> SOMParams:
    """Optimize the scene representation; the draws come from a
    `torch.Generator` on the device seeded with `seed`."""
    device = resolve_device(device)
    v, t_total, h, w = video.shape[:4]
    params = init_params(fg_xyz, fg_rgb, bg_xyz, bg_rgb, t_total, cfg, seed, device=device)
    opt_state = adam_init(params)
    data = scene_data(video, intrs, w2cs, depth, mask, tracks3d, tracks3d_valid, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    it = 0
    while it < cfg.iters:
        n = min(cfg.segment_iters, cfg.iters - it)
        params, opt_state, losses = fit_segment(params, opt_state, data, cfg, (w, h), n, chunk, generator=gen)
        it += n
        if progress:
            logging.info("iter %d: loss %.4f", it, float(losses[-1]))
    return params


def track_points(
    params: SOMParams,
    query_xyz: torch.Tensor,  # [N, 3] world positions
    query_t: torch.Tensor,  # [N] frame of each query
    ts: torch.Tensor,  # [B] frames to evaluate
    topk: int = 8,
) -> torch.Tensor:
    """Move query points with the optimized motion field -> [N, B, 3].

    Each query attaches to its `topk` most influential foreground gaussians
    at its own frame (ties to the lower index, as `lax.top_k`); its
    canonical coordinate through each one's blended transform is pushed
    through the requested frames and the results blended by influence.
    `topk=1` is the reference's hard argmax."""
    bases = MotionBases(params.motion_rots, params.motion_transls)
    coefs = _coef_weights(params.motion_coefs)

    tf_q = compute_transforms(bases, query_t, coefs)  # [G, N, 3, 4]
    means_q = torch.einsum("gnij,gj->gni", tf_q[..., :3], params.fg_means) + tf_q[..., 3]
    quats_q = gsplat.quat_multiply(_rotmat_to_quat(tf_q[..., :3]), params.fg_quats[:, None, :])
    diff = query_xyz[None] - means_q  # [G, N, 3]
    local = torch.einsum("gnij,gni->gnj", gsplat.quat_to_rotmat(quats_q), diff)
    maha = torch.sum((local * torch.exp(-params.fg_log_scales)[:, None]) ** 2, -1)
    infl = torch.sigmoid(params.fg_logit_opacities)[:, None] * torch.exp(-0.5 * maha)  # [G, N]

    w_sorted, order = torch.sort(infl.T, dim=-1, descending=True, stable=True)
    w_topk, idx = w_sorted[:, :topk], order[:, :topk]  # [N, topk]
    w_topk = w_topk / torch.clamp(w_topk.sum(-1, keepdim=True), min=1e-12)

    # x_canon = R^T (x - t) through each attached gaussian's transform.
    tf_nk = tf_q.transpose(0, 1)[torch.arange(idx.shape[0], device=idx.device)[:, None], idx]  # [N, topk, 3, 4]
    r_nk, t_nk = tf_nk[..., :3], tf_nk[..., 3]
    x_canon = torch.einsum("nkji,nkj->nki", r_nk, query_xyz[:, None] - t_nk)

    coef_sel = coefs[idx]  # [N, topk, K]
    r_all = gsplat.cont6d_to_rotmat(torch.einsum("nkc,cbi->nkbi", coef_sel, bases.rots[:, ts]))
    t_all = torch.einsum("nkc,cbi->nkbi", coef_sel, bases.transls[:, ts])
    moved = torch.einsum("nkbij,nkj->nkbi", r_all, x_canon) + t_all  # [N, topk, B, 3]
    return torch.einsum("nkbi,nk->nbi", moved, w_topk)


def extract_tracks(
    params: SOMParams,
    query_points: np.ndarray,  # [N, 4] (t, x, y, z)
    t_total: int,
    depths: np.ndarray | None = None,  # [V, T, H, W]
    intrs: np.ndarray | None = None,
    w2cs: np.ndarray | None = None,
    vis_threshold: float = 0.02,
    topk: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """Tracks and per-frame visibility for the cached evaluator ->
    ([T, N, 3], [T, N])."""
    device = params.fg_means.device
    qxyz = torch.from_numpy(np.asarray(query_points[:, 1:4], np.float32)).to(device)
    qt = torch.from_numpy(query_points[:, 0].astype(np.int64)).to(device)
    with torch.no_grad():
        tracks = track_points(params, qxyz, qt, torch.arange(t_total, device=device), topk)
    tracks = tracks.cpu().numpy().transpose(1, 0, 2)
    if depths is None:
        return tracks, np.ones((t_total, tracks.shape[1]), bool)
    return tracks, depth_ztest_visibility(tracks, depths, intrs, w2cs, vis_threshold)
