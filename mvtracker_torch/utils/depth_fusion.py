"""Multi-source depth fusion (host utility), counterpart of
`mvtracker_tpu/utils/depth_fusion.py`.

Re-design of the reference demo's fused depth estimator
(`demo.py:232-410`, `_estimate_fused_depths` and helpers): estimated depth
maps (DUSt3R / VGGT / any monocular or multi-view network) are calibrated
to the sensor depth with a per-view median-ratio scale computed on a
static-prefix of frames, then blended with residual-weighted confidences
and a weighted 3x3 smoothing. Pure numpy — this is a host-side
preprocessing step ahead of tracking, not accelerator work.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def detect_static_prefix_frames(
    rgbs: np.ndarray,  # [V, T, H, W, 3] uint8-range
    diff_threshold: float = 0.5,
    max_frames: int = 10,
) -> list[int]:
    """Leading frames with no appreciable motion (mean |frame diff| <=
    threshold), used for scale calibration (reference `demo.py:232-257`)."""
    if rgbs.ndim != 5 or rgbs.shape[1] == 0:
        return []
    t = rgbs.shape[1]
    if t == 1:
        return [0]
    diffs = np.abs(
        rgbs[:, 1:].astype(np.float64) - rgbs[:, :-1].astype(np.float64)
    ).mean(axis=(0, 2, 3, 4))
    frames = [0]
    for idx, delta in enumerate(diffs):
        if delta <= diff_threshold and len(frames) < max_frames:
            frames.append(idx + 1)
        else:
            break
    return frames


def estimate_per_view_scale(
    pred: np.ndarray,  # [V, T, H, W]
    gt: np.ndarray,  # [V, T, H, W]
    frame_indices: Sequence[int],
    eps: float = 1e-6,
) -> np.ndarray:
    """Per-view median(gt/pred) over the calibration frames -> [V, 1, 1, 1].

    Mirrors reference `demo.py:259-291`: <16 valid pixels or a non-finite
    median fall back to scale 1.
    """
    v, t = pred.shape[:2]
    frames = list(frame_indices) or list(range(min(t, 3)))
    scales = np.ones(v, np.float64)
    for vi in range(v):
        p, g = pred[vi, frames], gt[vi, frames]
        valid = (p > eps) & (g > eps) & np.isfinite(p) & np.isfinite(g)
        if valid.sum() < 16:
            continue
        s = np.median(g[valid] / p[valid])
        if np.isfinite(s):
            scales[vi] = s
    return scales.reshape(v, 1, 1, 1).astype(np.float32)


def _box_smooth_weighted(depth: np.ndarray, weights: np.ndarray, k: int = 3) -> np.ndarray:
    """Weighted box smoothing (reference `demo.py:300-309`), [V,T,H,W]."""
    if k < 1:
        return depth
    pad = k // 2
    num = depth * weights
    den = weights

    def box(x):
        xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
        out = np.zeros_like(x, np.float64)
        for dy in range(k):
            for dx in range(k):
                out += xp[:, :, dy : dy + x.shape[2], dx : dx + x.shape[3]]
        return out

    return (box(num) / np.maximum(box(den), 1e-6)).astype(depth.dtype)


def fuse_depths(
    depths_gt: np.ndarray,  # [V, T, H, W] sensor depth (0 = invalid)
    estimates: Sequence[tuple[np.ndarray, Optional[np.ndarray]]],  # (depth, conf|None)
    rgbs: Optional[np.ndarray] = None,  # [V, T, H, W, 3] for static detection
) -> tuple[np.ndarray, np.ndarray]:
    """Fuse sensor depth with N estimated depth maps -> (fused, fused_conf).

    Reference behavior (`demo.py:352-412`), generalized from its fixed
    duster+vggt pair to any number of estimates:
    1. scale-calibrate each estimate per view on the static frame prefix;
    2. sigma = max(5% of the median valid sensor depth, 0.02);
    3. weights: sensor = validity * exp(-min_residual / 1.5 sigma);
       estimate_i = conf_i * exp(-residual_i / sigma), x0.1 beyond 3 sigma;
    4. normalized weighted blend + weighted 3x3 smoothing;
    5. fused confidence = sum of weights clipped at 10.
    """
    gt = depths_gt.astype(np.float32)
    static_frames = detect_static_prefix_frames(rgbs) if rgbs is not None else []

    valid_gt = np.isfinite(gt) & (gt > 0)
    scaled, confs, residuals = [], [], []
    for est, conf in estimates:
        est = est.astype(np.float32)
        est = est * estimate_per_view_scale(est, gt, static_frames)
        c = np.ones_like(est) if conf is None else np.maximum(conf.astype(np.float32), 0.0)
        # Non-finite estimate pixels (NaN/Inf at sky or failed regions of a
        # DUSt3R/VGGT map) must carry zero weight AND a finite value — a NaN
        # layer entry would poison the blend wherever its weight isn't
        # exactly zero, and the 3x3 smoothing would smear it further.
        finite = np.isfinite(est)
        c = np.where(finite, c, 0.0)
        est = np.where(finite, est, 0.0)
        c = c / max(float(c.max()), 1e-6)
        scaled.append(est)
        confs.append(c)
        # Residuals are only meaningful against VALID sensor pixels; in
        # sensor holes the estimate stands on its own confidence. (The
        # reference computes |est - gt| unmasked, which zeroes the
        # estimate's weight exactly where the sensor has nothing — a bug
        # this re-design deliberately fixes: holes get filled by the
        # calibrated estimates instead of by blur.)
        res = np.where(valid_gt, np.abs(est - gt), 0.0)
        # Masked (non-finite) estimate pixels must not vote in the joint
        # residual either: est was zeroed above, so |0 - gt| = gt would
        # collapse the SENSOR's weight exactly where the estimate failed
        # over a valid sensor reading. +inf excludes them from the minimum.
        residuals.append(np.where(finite, res, np.inf))
    sigma = (
        max(0.05 * float(np.median(gt[valid_gt])), 0.02) if valid_gt.any() else 0.1
    )

    joint_residual = np.minimum.reduce(residuals) if residuals else np.zeros_like(gt)
    # Pixels where every estimate is masked: nothing contradicts the sensor,
    # so it keeps full weight (residual 0), not exp(-inf) = 0.
    joint_residual = np.where(np.isfinite(joint_residual), joint_residual, 0.0)
    w_gt = valid_gt.astype(np.float32) * np.exp(-joint_residual / (sigma * 1.5 + 1e-6))

    weights = [w_gt]
    layers = [gt]
    for est, c, res in zip(scaled, confs, residuals):
        w = c * np.exp(-res / (sigma + 1e-6))
        w = np.where(res > 3.0 * sigma, w * 0.1, w)
        weights.append(w)
        layers.append(est)

    w_sum = np.maximum(sum(weights), 1e-6)
    fused = sum(w * d for w, d in zip(weights, layers)) / w_sum
    fused = _box_smooth_weighted(fused, w_sum)
    return fused.astype(np.float32), np.clip(w_sum, None, 10.0).astype(np.float32)
