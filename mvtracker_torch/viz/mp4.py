"""MP4 track-overlay visualizer, counterpart of `mvtracker_tpu/viz/mp4.py`.

Re-design of the reference's `MultiViewVisualizer`
(`mvtracker/utils/visualizer_mp4.py:45-696`): draws predicted 3D tracks
projected into every view as colored trails on the video, rainbow-colored
by track index (or by time), with occluded points drawn hollow; views are
tiled into a mosaic and written as an mp4 (or returned as a frame stack).

Pure numpy drawing, since visualization is host-side and rare; the
projection runs on CPU tensors (`utils/geometry.py`). Files go out through
`datasets/image_io.py`: an mp4 or a GIF where imageio can write one, else
an .npz frame stack (the GPU host has no imageio).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import torch

from mvtracker_torch.datasets import image_io
from mvtracker_torch.utils import geometry as geo


def rainbow_colors(n: int) -> np.ndarray:
    """[n, 3] uint8 rainbow palette (track-index coloring, as in the
    reference's default color_tracks='rainbow')."""
    h = np.linspace(0, 1, max(n, 1), endpoint=False)
    i = (h * 6).astype(int) % 6
    f = h * 6 - np.floor(h * 6)
    v, p, q, t = np.ones_like(h), np.zeros_like(h), 1 - f, f
    lut = {
        0: (v, t, p), 1: (q, v, p), 2: (p, v, t),
        3: (p, q, v), 4: (t, p, v), 5: (v, p, q),
    }
    rgb = np.stack(
        [np.choose(i, [lut[k][c] for k in range(6)]) for c in range(3)], axis=-1
    )
    return (rgb * 255).astype(np.uint8)


def _draw_disk(img: np.ndarray, x: float, y: float, radius: int, color, filled=True):
    h, w, _ = img.shape
    xi, yi = int(round(x)), int(round(y))
    if not (0 <= xi < w and 0 <= yi < h):
        return
    y0, y1 = max(0, yi - radius), min(h, yi + radius + 1)
    x0, x1 = max(0, xi - radius), min(w, xi + radius + 1)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    d2 = (yy - y) ** 2 + (xx - x) ** 2
    if filled:
        mask = d2 <= radius**2
    else:
        mask = (d2 <= radius**2) & (d2 >= (radius - 1.5) ** 2)
    img[yy[mask], xx[mask]] = color


def _draw_line(img: np.ndarray, x0, y0, x1, y1, color, alpha=1.0):
    # Cap the rasterization length: near-camera projections can land at
    # ~1e8 pixels and a naive linspace would allocate gigabytes.
    cap = 8 * max(img.shape[0], img.shape[1])
    n = int(min(max(abs(x1 - x0), abs(y1 - y0)), cap)) + 1
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    h, w, _ = img.shape
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    if alpha >= 1.0:
        img[ys[ok], xs[ok]] = color
    else:
        img[ys[ok], xs[ok]] = (
            alpha * np.asarray(color) + (1 - alpha) * img[ys[ok], xs[ok]]
        ).astype(img.dtype)


def render_tracks_on_video(
    video: np.ndarray,  # [T, H, W, 3] uint8/float
    traj_2d: np.ndarray,  # [T, N, 2] pixel coords
    visibility: Optional[np.ndarray] = None,  # [T, N]
    trail_length: int = 8,
    point_radius: int = 3,
    colors: Optional[np.ndarray] = None,
    valid: Optional[np.ndarray] = None,  # [T, N] — suppress drawing entirely
) -> np.ndarray:
    """Draw per-frame points + fading trails; returns [T, H, W, 3] uint8.

    `visibility` styles the disk (filled vs hollow); `valid` removes a
    point from the render altogether (behind-camera / non-finite
    projections must not be drawn at their mirrored or NaN positions).
    """
    t, n = traj_2d.shape[:2]
    out = np.ascontiguousarray(video.astype(np.uint8)).copy()
    # Defensive sanitation: callers pass raw projections.
    traj_2d = np.nan_to_num(traj_2d, nan=-1e6, posinf=1e6, neginf=-1e6)
    if colors is None:
        colors = rainbow_colors(n)
    if visibility is None:
        visibility = np.ones((t, n), bool)
    if valid is None:
        valid = np.ones((t, n), bool)

    for ti in range(t):
        img = out[ti]
        for pi in range(n):
            if not valid[ti, pi]:
                continue
            for back in range(1, min(trail_length, ti) + 1):
                a, b = ti - back, ti - back + 1
                if not (valid[a, pi] and valid[b, pi]):
                    continue
                alpha = 1.0 - back / (trail_length + 1)
                _draw_line(
                    img,
                    traj_2d[a, pi, 0], traj_2d[a, pi, 1],
                    traj_2d[b, pi, 0], traj_2d[b, pi, 1],
                    colors[pi], alpha=alpha,
                )
            _draw_disk(
                img,
                traj_2d[ti, pi, 0], traj_2d[ti, pi, 1],
                point_radius, colors[pi], filled=bool(visibility[ti, pi]),
            )
    return out


def render_multiview_mosaic(
    video: np.ndarray,  # [V, T, H, W, 3]
    traj_3d: np.ndarray,  # [T, N, 3] world
    intrs: np.ndarray,  # [V, T, 3, 3]
    extrs: np.ndarray,  # [V, T, 3, 4]
    visibility: Optional[np.ndarray] = None,  # [T, N]
    max_cols: int = 2,
    **kwargs,
) -> np.ndarray:
    """Project world tracks into each view, draw overlays, tile a mosaic.

    This is the core of the reference `MultiViewVisualizer`
    (`visualizer_mp4.py:503-696`). Returns [T, H*rows, W*cols, 3] uint8.
    """
    v, t, h, w, _ = video.shape
    rendered = []

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    for vi in range(v):
        pix, z = geo.world_to_pixel_xy_and_camera_z(f32(traj_3d), f32(intrs[vi]), f32(extrs[vi]))
        pix_np = np.asarray(pix)
        # Behind-camera / non-finite projections must never be drawn — a
        # z <= 0 point projects to a point-mirrored (or inf/NaN) pixel
        # position, regardless of whether a visibility array was given.
        valid = (np.asarray(z[..., 0]) > 1e-6) & np.isfinite(pix_np).all(axis=-1)
        rendered.append(
            render_tracks_on_video(
                video[vi], pix_np, visibility, valid=valid, **kwargs
            )
        )

    cols = min(v, max_cols)
    rows = (v + cols - 1) // cols
    mosaic = np.zeros((t, h * rows, w * cols, 3), np.uint8)
    for vi in range(v):
        r, c = vi // cols, vi % cols
        mosaic[:, r * h : (r + 1) * h, c * w : (c + 1) * w] = rendered[vi]
    return mosaic


def save_video(frames: np.ndarray, path: str, fps: int = 12):
    """Write [T, H, W, 3] uint8 frames to disk.

    Prefers mp4 (needs imageio with an ffmpeg backend), falls back to GIF
    (imageio with pillow), then to an .npz frame stack. Returns the path
    written."""
    try:
        image_io.write_video(path, frames, fps)
        return path
    except Exception:
        pass
    try:
        gif_path = path.rsplit(".", 1)[0] + ".gif"
        image_io.write_gif(gif_path, frames, fps)
        return gif_path
    except Exception:
        np.savez_compressed(path + ".npz", frames=frames)
        return path + ".npz"


def log_video_to_tensorboard(writer, tag: str, frames: np.ndarray, step: int, fps: int = 12):
    """Log [T, H, W, 3] uint8 frames as a TensorBoard video (the reference's
    visualizer logs eval videos to TB, `visualizer_mp4.py` save_video with
    a writer)."""
    vid = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2)[None]
    writer.add_video(tag, vid, global_step=step, fps=fps)
