"""Training losses (L7), counterpart of `mvtracker_tpu/training/losses.py`.

They take the stacked-window predictions of
`mvtracker_torch.models.mvtracker.MVTracker(is_train=True)`: coordinates
[W, iters, S, N, 3] and visibility logits [W, S, N] with per-window active
masks. Ground truth is sliced per window with clamped frame indices; padded
frames and inactive points leave through the validity mask, and every
reduction is a masked mean. All in fp32.

The port stacks only the windows that ran, so `window_valid` is all true
there; the argument is kept so that predictions stacked over a static window
count with masked-out entries, as the JAX package makes them, give the same
values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvtracker_torch.utils.geometry import (
    bilinear_sample2d,
    reduce_masked_mean,
    world_to_pixel_xy_and_camera_z,
)


def window_gt(gt: torch.Tensor, window_starts: torch.Tensor, window_len: int) -> torch.Tensor:
    """Slice per-frame ground truth [T, ...] into [W, S, ...] windows with
    frame indices clamped to T - 1."""
    t = gt.shape[0]
    steps = torch.arange(window_len, device=gt.device)
    idx = torch.clamp(window_starts.to(gt.device)[:, None] + steps[None, :], max=t - 1)  # [W, S]
    return gt[idx]


def window_validity(
    valid: torch.Tensor,  # [T, N] bool or float: per-frame validity of the ground truth
    query_t: torch.Tensor,  # [N]
    window_starts: torch.Tensor,  # [W]
    window_len: int,
    window_active: torch.Tensor,  # [W, N] bool
    num_frames: int,
    window_valid: torch.Tensor | None = None,  # [W] executed-window mask
) -> torch.Tensor:
    """[W, S, N] float validity: ground truth valid AND t >= query_t AND a
    real (unclamped) frame AND an active track AND, when given, an executed
    window."""
    s = window_len
    starts = window_starts.to(valid.device)
    frame_no = starts[:, None] + torch.arange(s, device=valid.device)[None, :]  # [W, S] unclamped
    real = frame_no < num_frames
    v = window_gt(valid.float(), starts, s)  # [W, S, N]
    started = frame_no[:, :, None] >= query_t[None, None, :]
    out = v * real[:, :, None] * started * window_active[:, None, :].float()
    if window_valid is not None:
        out = out * window_valid.float()[:, None, None]
    return out


def sequence_loss_3d(
    coord_predictions: torch.Tensor,  # [W, iters, S, N, 3]
    traj_gt_w: torch.Tensor,  # [W, S, N, 3]
    valids_w: torch.Tensor,  # [W, S, N]
    gamma: float = 0.8,
    dmin: float = 0.1,
    dmax: float = 65.0,
    dz: float = 128.0,
    window_valid: torch.Tensor | None = None,  # [W]
) -> torch.Tensor:
    """Discounted multi-iteration L1 loss on coordinates.

    Iteration i of I weighs gamma^(I - i - 1); z of prediction and ground
    truth is rescaled to (z - dmin) / (dmax - dmin) * dz; the L1 is averaged
    over xyz, masked-meaned per window over valid (frame, point) entries,
    averaged over iterations and then over the executed windows.
    """
    n_iters = coord_predictions.shape[1]
    z_scale = dz / (dmax - dmin)

    def renorm(x):
        return torch.cat([x[..., :2], (x[..., 2:] - dmin) * z_scale], dim=-1)

    gt = renorm(traj_gt_w)
    total = 0.0
    for i in range(n_iters):
        l1 = (renorm(coord_predictions[:, i]) - gt).abs().mean(dim=-1)  # [W, S, N]
        total = total + gamma ** (n_iters - i - 1) * reduce_masked_mean(l1, valids_w, dim=(1, 2))  # [W]
    if window_valid is None:
        return (total / n_iters).mean()
    wv = window_valid.to(total.dtype)
    return (total * wv / n_iters).sum() / wv.sum().clamp(min=1.0)


def balanced_ce_loss(vis_predictions: torch.Tensor, vis_gt_w: torch.Tensor, valids_w: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on visibility logits [W, S, N], balanced between
    positives (gt > 0.95) and negatives (gt < 0.05): the stable logistic
    loss, masked-meaned per window for each class apart, the two summed, and
    summed (not averaged) over windows."""
    pos = (vis_gt_w > 0.95).float()
    neg = (vis_gt_w < 0.05).float()
    label = pos * 2.0 - 1.0
    a = -label * vis_predictions
    b = F.relu(a)
    loss = b + torch.log(torch.exp(-b) + torch.exp(a - b))
    pos_loss = reduce_masked_mean(loss, pos * valids_w, dim=(1, 2))  # [W]
    neg_loss = reduce_masked_mean(loss, neg * valids_w, dim=(1, 2))
    return (pos_loss + neg_loss).sum()


def tracking_loss(
    train_data: dict,
    traj_gt: torch.Tensor,  # [T, N, 3]
    vis_gt: torch.Tensor,  # [T, N] visibility in any view
    valid: torch.Tensor,  # [T, N]
    query_t: torch.Tensor,  # [N]
    num_frames: int,
    gamma: float = 0.8,
    track_upscaling_factor: float = 1.0,
    visibility_loss_weight: float = 0.1,
):
    """The full tracking loss -> (total, {"xyz_loss", "vis_loss"})."""
    starts = train_data["window_starts"]
    window_valid = train_data.get("window_valid")
    s = train_data["coord_predictions"].shape[2]
    valids_w = window_validity(
        valid, query_t, starts, s, train_data["window_active"], num_frames, window_valid=window_valid
    )
    traj_gt_w = window_gt(traj_gt, starts, s)
    vis_gt_w = window_gt(vis_gt.float(), starts, s)
    xyz_loss = (
        sequence_loss_3d(train_data["coord_predictions"], traj_gt_w, valids_w, gamma=gamma, window_valid=window_valid)
        * track_upscaling_factor
    )
    vis_loss = balanced_ce_loss(train_data["vis_predictions"], vis_gt_w, valids_w) * visibility_loss_weight
    return xyz_loss + vis_loss, {"xyz_loss": xyz_loss, "vis_loss": vis_loss}


def _safe_normalize(x: torch.Tensor) -> torch.Tensor:
    # rsqrt(sum + eps) keeps the gradient finite at zero vectors.
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-10)


def feature_identity_loss(
    fmaps: torch.Tensor,  # [V, T, h, w, C] encoder features at the model's stride
    depths: torch.Tensor,  # [V, T, H, W] full-resolution depth
    intrs: torch.Tensor,  # [V, T, 3, 3]
    extrs: torch.Tensor,  # [V, T, 3, 4]
    traj_gt: torch.Tensor,  # [T, N, 3] ground-truth world tracks
    stride: int,
    tau: float = 0.07,
    z_tol: float = 0.05,
) -> torch.Tensor:
    """Contrastive point-identity loss on the encoder features.

    The feature sampled at a ground-truth track's projection must match the
    track's prototype (its visibility-weighted mean feature over views and
    frames, leaving the sample itself out) and differ from every other
    track's: an N-way InfoNCE per visible (view, frame, track).
    """
    v, t, h, w, c = fmaps.shape
    n = traj_gt.shape[1]
    pts = traj_gt[None].expand(v, t, n, 3)
    pix, z = world_to_pixel_xy_and_camera_z(pts, intrs, extrs)
    z = z[..., 0]
    hw_h, hw_w = depths.shape[-2:]
    px, py = pix[..., 0], pix[..., 1]
    d_at = bilinear_sample2d(
        depths.reshape(v * t, hw_h, hw_w, 1), px.reshape(v * t, n), py.reshape(v * t, n)
    ).reshape(v, t, n)
    inb = (px >= 0) & (px <= hw_w - 1) & (py >= 0) & (py <= hw_h - 1) & (z > 1e-3)
    vis_w = (inb & (d_at > 0) & (d_at - z > -z_tol)).float()  # [V, T, N]

    feats = bilinear_sample2d(
        fmaps.reshape(v * t, h, w, c).float(), (px / stride).reshape(v * t, n), (py / stride).reshape(v * t, n)
    ).reshape(v, t, n, c)
    feats = _safe_normalize(feats)

    s_sum = torch.einsum("vtn,vtnc->nc", vis_w, feats)  # [N, C]
    proto = _safe_normalize(s_sum)
    loo = _safe_normalize(s_sum[None, None] - vis_w[..., None] * feats)

    logits = torch.einsum("vtnc,mc->vtnm", feats, proto) / tau  # [V, T, N, M]
    own = torch.einsum("vtnc,vtnc->vtn", feats, loo) / tau
    eye = torch.eye(n, dtype=torch.bool, device=fmaps.device)[None, None]
    logits = torch.where(eye, own[..., None], logits)
    nll = -torch.diagonal(torch.log_softmax(logits, dim=-1), dim1=-2, dim2=-1)  # [V, T, N]
    return (nll * vis_w).sum() / vis_w.sum().clamp(min=1.0)
