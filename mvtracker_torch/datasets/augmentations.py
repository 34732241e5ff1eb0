"""Training-time scene augmentations (L4), host-side numpy: counterpart of
`mvtracker_tpu/datasets/augmentations.py`, with the same functions making
the same draws from the caller's `np.random.Generator` in the same order,
so a seed gives the JAX package's scenes.

Mirrors the reference Kubric training augmentations
(`mvtracker/datasets/kubric_multiview_dataset.py:1276-1721`):

- photometric: per-view (or shared) brightness/contrast/saturation jitter,
  gaussian blur (:1276-1404);
- occluders: RGB and depth eraser/replace rectangles that knock out the
  visibility of the tracks beneath them (:1295-1366, :1656-1720);
- spatial: random crop with intrinsics principal-point/center update and
  2D track shifting (:1405-1655);
- depth corruption: rectangular erasures plus the patch-wise `aug_depth`
  (`datasets/utils.py:332`);
- scene-level: random similarity transform + camera parameter noise
  (`datasets/utils.py:210,304`).

`scaled_crop_augment` resizes with `resize_linear` and `resize_nearest`
(numpy counterparts of OpenCV's `INTER_LINEAR` and `INTER_NEAREST`, which
the JAX package calls): OpenCV is absent on the GPU host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mvtracker_torch import native
from mvtracker_torch.datasets.datapoint import (
    Datapoint,
    add_camera_noise,
    aug_depth,
    transform_scene,
)


def _linear_taps(n_in: int, n_out: int):
    """Source rows and weights of OpenCV's INTER_LINEAR along one axis:
    half-pixel centres, positions in float64, edges clamped."""
    pos = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    frac[lo < 0] = 0.0
    lo[lo < 0] = 0
    edge = lo >= n_in - 1
    frac[edge] = 0.0
    lo[edge] = n_in - 1
    return lo, np.minimum(lo + 1, n_in - 1), (1.0 - frac).astype(np.float32), frac.astype(np.float32)


def resize_linear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[H, W] or [H, W, C] float32 -> [out_h, out_w(, C)], bilinear with
    half-pixel centres and clamped edges (OpenCV's `INTER_LINEAR`): rows
    first, then columns, in float32."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(w, out_w)
    y0, y1, b0, b1 = _linear_taps(h, out_h)
    tail = (1,) * (img.ndim - 2)
    rows = img[:, x0] * a0.reshape((1, -1) + tail) + img[:, x1] * a1.reshape((1, -1) + tail)
    return rows[y0] * b0.reshape((-1, 1) + tail) + rows[y1] * b1.reshape((-1, 1) + tail)


def resize_nearest(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[H, W(, C)] -> [out_h, out_w(, C)]; source index floor(dst * src /
    dst_size), in OpenCV's `INTER_NEAREST` float64 arithmetic."""
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))).astype(np.int64), w - 1)
    return img[ys[:, None], xs[None, :]]


def _adjust_hue(x: np.ndarray, factor: float) -> np.ndarray:
    """Hue rotation about the gray axis (linear-RGB approximation of
    torchvision `adjust_hue`); factor in [-0.5, 0.5] turns of the wheel."""
    theta = 2.0 * np.pi * factor
    c, s = np.cos(theta), np.sin(theta)
    one3 = 1.0 / 3.0
    sq3 = np.sqrt(1.0 / 3.0)
    m = np.array(
        [
            [c + (1 - c) * one3, one3 * (1 - c) - sq3 * s, one3 * (1 - c) + sq3 * s],
            [one3 * (1 - c) + sq3 * s, c + one3 * (1 - c), one3 * (1 - c) - sq3 * s],
            [one3 * (1 - c) - sq3 * s, one3 * (1 - c) + sq3 * s, c + one3 * (1 - c)],
        ],
        np.float32,
    )
    return x @ m.T


def photometric_augment(
    dp: Datapoint,
    rng: np.random.Generator,
    brightness: float = 0.2,
    contrast: float = 0.2,
    saturation: float = 0.2,
    hue: float = 0.0,
    blur_prob: float = 0.2,
    per_view: bool = True,
    frame_shared: bool = False,
) -> Datapoint:
    """Color jitter + optional blur; tracks/geometry untouched.

    `frame_shared=True` mirrors the reference's protocol exactly
    (`kubric:1368-1401`): factors are drawn PER FRAME and shared across all
    views (cross-view photoconsistency preserved, temporal variation
    added), and the blur sigma is drawn per frame likewise. The default
    per-view mode is the historical behavior of this framework.
    """
    video = dp.video.astype(np.float32).copy()
    v, t = video.shape[:2]

    def jitter(x, b, c, s, hu):
        lead = x.shape[:-3]
        flat = x.reshape((-1,) + x.shape[-3:])
        n_img = flat.shape[0]
        mean = np.full(n_img, x.mean(), np.float32)
        flat = native.photometric_jitter(
            flat, mean,
            np.full(n_img, b, np.float32),
            np.full(n_img, c, np.float32),
            np.full(n_img, s, np.float32),
        )
        x = flat.reshape(lead + x.shape[-3:])
        if hu:
            x = _adjust_hue(x, hu)
        return x

    if frame_shared:
        for ti in range(t):
            b = 1.0 + rng.uniform(-brightness, brightness)
            c = 1.0 + rng.uniform(-contrast, contrast)
            s = 1.0 + rng.uniform(-saturation, saturation)
            hu = rng.uniform(-hue, hue) if hue else 0.0
            video[:, ti] = jitter(video[:, ti], b, c, s, hu)
        if rng.uniform() < blur_prob:
            for ti in range(t):
                sigma = rng.uniform(0.5, 2.0)
                video[:, ti] = native.gaussian_blur(
                    video[:, ti].swapaxes(-1, -3), 5, float(sigma)
                ).swapaxes(-1, -3)
        return dataclasses.replace(dp, video=np.clip(video, 0, 255))

    n_groups = v if per_view else 1
    for g in range(n_groups):
        sel = slice(g, g + 1) if per_view else slice(None)
        b = 1.0 + rng.uniform(-brightness, brightness)
        c = 1.0 + rng.uniform(-contrast, contrast)
        s = 1.0 + rng.uniform(-saturation, saturation)
        hu = rng.uniform(-hue, hue) if hue else 0.0
        x = jitter(video[sel], b, c, s, hu)
        if rng.uniform() < blur_prob:
            x = native.gaussian_blur(x.swapaxes(-1, -3), 5, 1.0).swapaxes(-1, -3)
        video[sel] = x
    return dataclasses.replace(dp, video=np.clip(video, 0, 255))


def eraser_augment(
    dp: Datapoint,
    rng: np.random.Generator,
    prob: float = 0.5,
    max_rects: int = 3,
    bounds: tuple[int, int] = (2, 100),
) -> Datapoint:
    """RGB eraser: mean-color rectangles on frames after the first, with
    per-view visibility knocked out for tracks under the rectangle
    (reference `_add_photometric_augs` eraser branch, `kubric:1295-1321`).
    Teaches occlusion prediction."""
    video = dp.video.astype(np.float32).copy()
    vis = dp.visibility.copy() if dp.visibility is not None else None
    traj = dp.trajectory
    v, t, h, w, _ = video.shape
    blo, bhi = bounds
    # Scale the rectangle cap to the image (the reference's 100 px cap is
    # ~1/4 of its 448 px crops); full-image erasures teach nothing.
    bhi = min(bhi, max(min(h, w) // 3, blo + 1))
    for vi in range(v):
        for ti in range(1, t):
            if rng.random() >= prob:
                continue
            for _ in range(int(rng.integers(1, max_rects + 1))):
                xc, yc = int(rng.integers(0, w)), int(rng.integers(0, h))
                dx, dy = int(rng.integers(blo, bhi)), int(rng.integers(blo, bhi))
                x0 = int(np.clip(round(xc - dx / 2), 0, w - 1))
                x1 = int(np.clip(round(xc + dx / 2), 0, w - 1))
                y0 = int(np.clip(round(yc - dy / 2), 0, h - 1))
                y1 = int(np.clip(round(yc + dy / 2), 0, h - 1))
                if x1 <= x0 or y1 <= y0:
                    continue
                video[vi, ti, y0:y1, x0:x1] = video[vi, ti, y0:y1, x0:x1].reshape(
                    -1, 3
                ).mean(axis=0)
                if vis is not None and traj is not None:
                    occ = (
                        (traj[vi, ti, :, 0] >= x0) & (traj[vi, ti, :, 0] < x1)
                        & (traj[vi, ti, :, 1] >= y0) & (traj[vi, ti, :, 1] < y1)
                    )
                    vis[vi, ti, occ] = False
    return dataclasses.replace(dp, video=video, visibility=vis)


def replace_augment(
    dp: Datapoint,
    rng: np.random.Generator,
    prob: float = 0.5,
    max_rects: int = 3,
    bounds: tuple[int, int] = (2, 100),
) -> Datapoint:
    """RGB replace: paste a random patch from a random (jittered) frame of
    the same view over frames after the first; visibility knocked out
    underneath (reference `_add_photometric_augs` replace branch,
    `kubric:1323-1366`). Simulates distractor occluders with real image
    statistics."""
    video = dp.video.astype(np.float32).copy()
    vis = dp.visibility.copy() if dp.visibility is not None else None
    traj = dp.trajectory
    v, t, h, w, _ = video.shape
    blo, bhi = bounds
    # Scale the rectangle cap to the image (the reference's 100 px cap is
    # ~1/4 of its 448 px crops); full-image erasures teach nothing.
    bhi = min(bhi, max(min(h, w) // 3, blo + 1))
    # The reference builds a doubly photo-jittered alternate copy of the
    # view to source patches from; a brightness/contrast jitter suffices.
    for vi in range(v):
        b = 1.0 + rng.uniform(-0.4, 0.4)
        c = 1.0 + rng.uniform(-0.4, 0.4)
        alt = np.clip((video[vi] - video[vi].mean()) * c + video[vi].mean() * b, 0, 255)
        for ti in range(1, t):
            if rng.random() >= prob:
                continue
            for _ in range(int(rng.integers(1, max_rects + 1))):
                xc, yc = int(rng.integers(0, w)), int(rng.integers(0, h))
                dx, dy = int(rng.integers(blo, bhi)), int(rng.integers(blo, bhi))
                x0 = int(np.clip(round(xc - dx / 2), 0, w - 1))
                x1 = int(np.clip(round(xc + dx / 2), 0, w - 1))
                y0 = int(np.clip(round(yc - dy / 2), 0, h - 1))
                y1 = int(np.clip(round(yc + dy / 2), 0, h - 1))
                wid, hei = x1 - x0, y1 - y0
                if wid <= 0 or hei <= 0:
                    continue
                y00 = int(rng.integers(0, h - hei))
                x00 = int(rng.integers(0, w - wid))
                fr = int(rng.integers(0, t))
                video[vi, ti, y0:y1, x0:x1] = alt[fr, y00:y00 + hei, x00:x00 + wid]
                if vis is not None and traj is not None:
                    occ = (
                        (traj[vi, ti, :, 0] >= x0) & (traj[vi, ti, :, 0] < x1)
                        & (traj[vi, ti, :, 1] >= y0) & (traj[vi, ti, :, 1] < y1)
                    )
                    vis[vi, ti, occ] = False
    return dataclasses.replace(dp, video=video, visibility=vis)


def depth_eraser_replace_augment(
    dp: Datapoint,
    rng: np.random.Generator,
    eraser_prob: float = 0.5,
    replace_prob: float = 0.5,
    max_rects: int = 3,
    bounds: tuple[int, int] = (2, 100),
) -> Datapoint:
    """Depth eraser + replace with visibility updates (reference
    `_rescale_and_erase_depth_patches`, `kubric:1656-1720`): rectangles
    filled with {patch mean, min, max, 0} at the reference's probabilities,
    and rectangles replaced by patches from a random (view, frame)."""
    depth = dp.videodepth.copy()
    vis = dp.visibility.copy() if dp.visibility is not None else None
    traj = dp.trajectory
    v, t, h, w = depth.shape
    blo, bhi = bounds
    # Scale the rectangle cap to the image (the reference's 100 px cap is
    # ~1/4 of its 448 px crops); full-image erasures teach nothing.
    bhi = min(bhi, max(min(h, w) // 3, blo + 1))

    def rect():
        xc, yc = int(rng.integers(0, w)), int(rng.integers(0, h))
        dx, dy = int(rng.integers(blo, bhi)), int(rng.integers(blo, bhi))
        x0 = int(np.clip(round(xc - dx / 2), 0, w - 1))
        x1 = int(np.clip(round(xc + dx / 2), 0, w - 1))
        y0 = int(np.clip(round(yc - dy / 2), 0, h - 1))
        y1 = int(np.clip(round(yc + dy / 2), 0, h - 1))
        return x0, x1, y0, y1

    def knock_out(vi, ti, x0, x1, y0, y1):
        if vis is not None and traj is not None:
            occ = (
                (traj[vi, ti, :, 0] >= x0) & (traj[vi, ti, :, 0] < x1)
                & (traj[vi, ti, :, 1] >= y0) & (traj[vi, ti, :, 1] < y1)
            )
            vis[vi, ti, occ] = False

    for vi in range(v):
        for ti in range(1, t):
            if rng.random() < eraser_prob:
                for _ in range(int(rng.integers(1, max_rects + 1))):
                    x0, x1, y0, y1 = rect()
                    if x1 <= x0 or y1 <= y0:
                        continue
                    patch = depth[vi, ti, y0:y1, x0:x1]
                    fill = {
                        0: patch.mean(),
                        1: patch.min(),
                        2: patch.max(),
                        3: 0.0,
                    }[int(rng.choice([0, 1, 2, 3], p=[0.2, 0.1, 0.35, 0.35]))]
                    depth[vi, ti, y0:y1, x0:x1] = fill
                    knock_out(vi, ti, x0, x1, y0, y1)
            if rng.random() < replace_prob:
                for _ in range(int(rng.integers(1, max_rects + 1))):
                    x0, x1, y0, y1 = rect()
                    wid, hei = x1 - x0, y1 - y0
                    if wid <= 0 or hei <= 0:
                        continue
                    y00 = int(rng.integers(0, h - hei))
                    x00 = int(rng.integers(0, w - wid))
                    v_rnd = int(rng.integers(0, v))
                    t_rnd = int(rng.integers(0, t))
                    depth[vi, ti, y0:y1, x0:x1] = depth[
                        v_rnd, t_rnd, y00:y00 + hei, x00:x00 + wid
                    ]
                    knock_out(vi, ti, x0, x1, y0, y1)
    return dataclasses.replace(dp, videodepth=depth, visibility=vis)


def crop_augment(
    dp: Datapoint,
    rng: np.random.Generator,
    crop_h: int,
    crop_w: int,
) -> Datapoint:
    """Random crop (same offset across frames, per view) with intrinsics
    principal-point update and 2D-track shift; visibility is re-clipped to
    the crop (reference :1405-1655)."""
    v, t, h, w, _ = dp.video.shape
    assert crop_h <= h and crop_w <= w
    video = np.empty((v, t, crop_h, crop_w, 3), dp.video.dtype)
    depth = np.empty((v, t, crop_h, crop_w), dp.videodepth.dtype)
    intrs = dp.intrs.copy()
    traj = dp.trajectory.copy() if dp.trajectory is not None else None
    vis = dp.visibility.copy() if dp.visibility is not None else None

    for vi in range(v):
        y0 = int(rng.integers(0, h - crop_h + 1))
        x0 = int(rng.integers(0, w - crop_w + 1))
        video[vi] = dp.video[vi, :, y0 : y0 + crop_h, x0 : x0 + crop_w]
        depth[vi] = dp.videodepth[vi, :, y0 : y0 + crop_h, x0 : x0 + crop_w]
        intrs[vi, :, 0, 2] -= x0
        intrs[vi, :, 1, 2] -= y0
        if traj is not None:
            traj[vi, ..., 0] -= x0
            traj[vi, ..., 1] -= y0
            if vis is not None:
                inb = (
                    (traj[vi, ..., 0] >= 0)
                    & (traj[vi, ..., 0] < crop_w)
                    & (traj[vi, ..., 1] >= 0)
                    & (traj[vi, ..., 1] < crop_h)
                )
                vis[vi] &= inb
    return dataclasses.replace(
        dp, video=video, videodepth=depth, intrs=intrs, trajectory=traj, visibility=vis
    )


def scaled_crop_augment(
    dp: Datapoint,
    rng: np.random.Generator,
    crop_h: int,
    crop_w: int,
    pad_bounds: tuple[int, int] = (0, 25),
    resize_lim: tuple[float, float] = (0.75, 1.25),
    resize_delta: float = 0.05,
    max_crop_offset: int = 15,
) -> Datapoint:
    """The reference's full spatial augmentation (`kubric:1405-1568`):
    per-view random padding, a smoothly drifting per-frame scale (EMA random
    walk), bilinear/nearest resize with per-frame intrinsics focal+pp
    update, then a track-centered crop whose offset drifts per frame; 2D
    tracks shifted and visibility re-clipped to the crop. Every camera
    change is mirrored into `intrs` so unprojection stays consistent."""
    v, t, h, w, _ = dp.video.shape
    video = np.zeros((v, t, crop_h, crop_w, 3), np.float32)
    depth = np.zeros((v, t, crop_h, crop_w), np.float32)
    intrs = dp.intrs.copy().astype(np.float64)
    traj = dp.trajectory.copy().astype(np.float64) if dp.trajectory is not None else None
    vis = dp.visibility.copy() if dp.visibility is not None else None

    for vi in range(v):
        pad_x0, pad_x1, pad_y0, pad_y1 = (
            int(rng.integers(pad_bounds[0], pad_bounds[1])) for _ in range(4)
        )
        rgb_v = np.pad(
            dp.video[vi].astype(np.float32),
            ((0, 0), (pad_y0, pad_y1), (pad_x0, pad_x1), (0, 0)),
        )
        dep_v = np.pad(
            dp.videodepth[vi].astype(np.float32),
            ((0, 0), (pad_y0, pad_y1), (pad_x0, pad_x1)),
        )
        intrs[vi, :, 0, 2] += pad_x0
        intrs[vi, :, 1, 2] += pad_y0
        if traj is not None:
            traj[vi, :, :, 0] += pad_x0
            traj[vi, :, :, 1] += pad_y0
        hp, wp = rgb_v.shape[1:3]

        # Smooth per-frame scale walk (reference :1440-1488).
        scale = rng.uniform(resize_lim[0], resize_lim[1])
        scale_x = scale_y = scale
        delta_x = delta_y = 0.0
        rgbs_t, deps_t = [], []
        for ti in range(t):
            if ti == 1:
                delta_x = rng.uniform(-resize_delta, resize_delta)
                delta_y = rng.uniform(-resize_delta, resize_delta)
            elif ti > 1:
                delta_x = delta_x * 0.8 + rng.uniform(-resize_delta, resize_delta) * 0.2
                delta_y = delta_y * 0.8 + rng.uniform(-resize_delta, resize_delta) * 0.2
            scale_x += delta_x
            scale_y += delta_y
            scale_xy = (scale_x + scale_y) * 0.5
            scale_x = scale_x * 0.5 + scale_xy * 0.5
            scale_y = scale_y * 0.5 + scale_xy * 0.5
            scale_x = float(np.clip(scale_x, resize_lim[0], resize_lim[1]))
            scale_y = float(np.clip(scale_y, resize_lim[0], resize_lim[1]))
            h_new = max(int(hp * scale_y), crop_h + 10)
            w_new = max(int(wp * scale_x), crop_w + 10)
            sx = (w_new - 1) / float(wp - 1)
            sy = (h_new - 1) / float(hp - 1)
            rgbs_t.append(resize_linear(rgb_v[ti], h_new, w_new))
            deps_t.append(resize_nearest(dep_v[ti], h_new, w_new))
            intrs[vi, ti, 0, :] *= sx
            intrs[vi, ti, 1, :] *= sy
            if traj is not None:
                traj[vi, ti, :, 0] *= sx
                traj[vi, ti, :, 1] *= sy

        # Track-centered crop with drifting offset (reference :1489-1540).
        if vis is not None and traj is not None and vis[vi, 0].any():
            ok = vis[vi, 0] > 0
            mid_x = float(traj[vi, 0, ok, 0].mean())
            mid_y = float(traj[vi, 0, ok, 1].mean())
        else:
            mid_x, mid_y = crop_w / 2, crop_h / 2
        x0 = int(mid_x - crop_w // 2)
        y0 = int(mid_y - crop_h // 2)
        off_x = off_y = 0
        for ti in range(t):
            if ti == 1:
                off_x = int(rng.integers(-max_crop_offset, max_crop_offset + 1))
                off_y = int(rng.integers(-max_crop_offset, max_crop_offset + 1))
            elif ti > 1:
                off_x = int(
                    off_x * 0.8
                    + rng.integers(-max_crop_offset, max_crop_offset + 1) * 0.2
                )
                off_y = int(
                    off_y * 0.8
                    + rng.integers(-max_crop_offset, max_crop_offset + 1) * 0.2
                )
            x0 += off_x
            y0 += off_y
            h_new, w_new = rgbs_t[ti].shape[:2]
            y0c = 0 if h_new == crop_h else min(max(0, y0), h_new - crop_h - 1)
            x0c = 0 if w_new == crop_w else min(max(0, x0), w_new - crop_w - 1)
            video[vi, ti] = rgbs_t[ti][y0c : y0c + crop_h, x0c : x0c + crop_w]
            depth[vi, ti] = deps_t[ti][y0c : y0c + crop_h, x0c : x0c + crop_w]
            intrs[vi, ti, 0, 2] -= x0c
            intrs[vi, ti, 1, 2] -= y0c
            if traj is not None:
                traj[vi, ti, :, 0] -= x0c
                traj[vi, ti, :, 1] -= y0c

    if vis is not None and traj is not None:
        vis = (
            vis
            & (traj[..., 0] >= 0) & (traj[..., 1] >= 0)
            & (traj[..., 0] < crop_w) & (traj[..., 1] < crop_h)
        )
    return dataclasses.replace(
        dp,
        video=np.clip(video, 0, 255),
        videodepth=depth,
        intrs=intrs.astype(np.float32),
        trajectory=traj.astype(np.float32) if traj is not None else None,
        visibility=vis,
    )


def depth_corruption_augment(
    dp: Datapoint,
    rng: np.random.Generator,
    erase_prob: float = 0.3,
    max_erases: int = 3,
    patch_aug_prob: float = 0.5,
) -> Datapoint:
    """Depth-only corruption: rectangular zero-erasures (simulating sensor
    dropouts) + patch-wise scale/shift (reference :1656-1721 and
    `aug_depth`). Ground truth is untouched — the model must be robust."""
    depth = dp.videodepth.copy()
    v, t, h, w = depth.shape
    for vi in range(v):
        if rng.uniform() < erase_prob:
            for _ in range(int(rng.integers(1, max_erases + 1))):
                eh = int(rng.integers(h // 8, h // 3))
                ew = int(rng.integers(w // 8, w // 3))
                y0 = int(rng.integers(0, h - eh))
                x0 = int(rng.integers(0, w - ew))
                depth[vi, :, y0 : y0 + eh, x0 : x0 + ew] = 0.0
    if rng.uniform() < patch_aug_prob:
        depth = aug_depth(depth, rng=rng)
    return dataclasses.replace(dp, videodepth=depth)


def scene_transform_augment(
    dp: Datapoint,
    rng: np.random.Generator,
    max_scale: float = 1.5,
    max_translation: float = 1.0,
    rotate: bool = True,
) -> Datapoint:
    """Random global similarity transform of the whole scene
    (reference `transform_scene` usage in training)."""
    s = float(np.exp(rng.uniform(-np.log(max_scale), np.log(max_scale))))
    if rotate:
        theta = rng.uniform(0, 2 * np.pi)
        c, si = np.cos(theta), np.sin(theta)
        rot = np.array([[c, -si, 0], [si, c, 0], [0, 0, 1.0]])
    else:
        rot = np.eye(3)
    trans = rng.uniform(-max_translation, max_translation, size=3)

    depth, extrs, qp, traj3d, traj2d = transform_scene(
        s, rot, trans,
        depth=dp.videodepth,
        extrs=dp.extrs,
        query_points=dp.query_points_3d,
        traj3d_world=dp.trajectory_3d,
        traj2d_w_z=dp.trajectory,
    )
    return dataclasses.replace(
        dp,
        videodepth=depth,
        extrs=extrs,
        query_points_3d=qp,
        trajectory_3d=traj3d,
        trajectory=traj2d,
        track_upscaling_factor=dp.track_upscaling_factor / s,
    )


def camera_noise_augment(
    dp: Datapoint, rng: np.random.Generator, std_intr=0.01, std_extr=0.001
) -> Datapoint:
    intrs, extrs = add_camera_noise(dp.intrs, dp.extrs, std_intr, std_extr, rng)
    return dataclasses.replace(
        dp, intrs=intrs.astype(np.float32), extrs=extrs.astype(np.float32)
    )


def default_train_augmentations(
    dp: Datapoint, rng: np.random.Generator, occluders: bool = True
) -> Datapoint:
    """The standard training augmentation stack.

    `occluders=True` includes the reference's occlusion-simulating RGB and
    depth eraser/replace rectangles with visibility knockout
    (`kubric:1295-1366,1656-1720`) — the signal the visibility head trains
    on."""
    if occluders:
        dp = eraser_augment(dp, rng, prob=0.3)
        dp = replace_augment(dp, rng, prob=0.3)
        dp = depth_eraser_replace_augment(dp, rng, eraser_prob=0.3, replace_prob=0.3)
    dp = photometric_augment(dp, rng, frame_shared=True, hue=0.15)
    dp = depth_corruption_augment(dp, rng)
    dp = scene_transform_augment(dp, rng, rotate=True)
    return dp
