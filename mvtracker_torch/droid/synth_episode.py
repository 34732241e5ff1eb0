"""Fully synthetic DROID-format episodes with renderable recordings,
counterpart of `mvtracker_tpu/droid/synth_episode.py`.

The DROID data factory's CPU path (`pipeline.process_episode`) produces
gripper-track GT from robot kinematics alone — no pixels. This module
closes the loop for end-to-end evaluation without robot hardware: it
synthesizes a plausible robot episode (`trajectory.h5` + `metadata.json`,
the reference's raw-episode contract, `conversions/droid/training_data/
generate_tracks_and_metadata.py:291-386`), runs the REAL FK pipeline on
it, and then ray-traces camera recordings in which a rigid textured
gripper proxy (two finger-pad spheres + a wrist body, posed by the same
FK chain that generated the GT tracks) moves through a cluttered tabletop
scene. The rendered rgb/depth recordings are written in the exact episode
layout `datasets/droid.load_droid_episode` consumes (rgb.npz + FFV1
depth.mkv), so `cli/droid.py track` and the evaluator run the FULL
episode path — FFV1 decode, metadata, per-frame wrist poses, gripper
queries — against GT the FK pipeline itself produced.

This is the harness for the BASELINE north-star metric ("median 3D track
error on DROID eval"): the contact points ride rigidly with the rendered
finger pads, so a real tracker can track them and the median 3D error is
meaningful, not a plumbing smoke value.

`trajectory.h5` is written with the port's HDF5 writer (`datasets/hdf5.py`)
and `depth.mkv` with its FFV1 writer (`droid/depth_video.py`); the ray
tracing is the JAX package's numpy, host code.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from mvtracker_torch.datasets import hdf5
from mvtracker_torch.datasets.synthetic import _look_at, _value_noise3


def _matrix_to_euler_xyz(r: np.ndarray) -> np.ndarray:
    """Inverse of `transforms.euler_xyz_to_matrix` (R = Rz@Ry@Rx for
    extrinsic xyz). Gimbal-safe enough for synthetic camera placement."""
    sy = -r[2, 0]
    sy = np.clip(sy, -1.0, 1.0)
    pitch = np.arcsin(sy)
    if abs(sy) < 0.999999:
        roll = np.arctan2(r[2, 1], r[2, 2])
        yaw = np.arctan2(r[1, 0], r[0, 0])
    else:  # pitch at +-90deg: yaw/roll degenerate; pick yaw=0
        roll = np.arctan2(-r[1, 2], r[1, 1])
        yaw = 0.0
    return np.array([roll, pitch, yaw])


def make_raw_episode(
    raw_dir: str,
    seed: int = 0,
    n_frames: int = 48,
    n_external_cams: int = 2,
    width: int = 256,
    height: int = 192,
    fps_motion: float = 15.0,
) -> str:
    """Write `trajectory.h5` + `metadata.json` for one synthetic episode.

    EE motion: a smooth quasi-random sweep over a tabletop workspace
    (pick-and-place-like arcs) with slow orientation drift and an
    open-close gripper cycle — the same state channels a real DROID
    `trajectory.h5` carries.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    t = n_frames
    ts = np.linspace(0.0, 1.0, t)

    # Workspace: x in [0.35, 0.60], y in [-0.2, 0.2], z in [0.15, 0.45].
    f1, f2 = rng.uniform(0.7, 1.3, 2)
    ph = rng.uniform(0, 2 * np.pi, 3)
    cart = np.zeros((t, 6))
    cart[:, 0] = 0.47 + 0.10 * np.sin(2 * np.pi * f1 * ts + ph[0])
    cart[:, 1] = 0.14 * np.sin(2 * np.pi * f2 * ts + ph[1])
    cart[:, 2] = 0.30 + 0.10 * np.sin(np.pi * ts + ph[2]) * np.sin(np.pi * ts)
    # Orientation: gripper points mostly down (pitch ~ pi), slow drift.
    cart[:, 3] = np.pi + 0.25 * np.sin(2 * np.pi * 0.5 * ts + ph[0])
    cart[:, 4] = 0.2 * np.sin(2 * np.pi * 0.4 * ts + ph[1])
    cart[:, 5] = rng.uniform(-np.pi, np.pi) + 0.4 * ts
    grip = (0.5 + 0.5 * np.sin(2 * np.pi * ts - np.pi / 2))[:, None]

    hdf5.write(os.path.join(raw_dir, "trajectory.h5"), {
        "observation/robot_state/cartesian_position": cart,
        "observation/robot_state/gripper_position": grip,
    })

    # External cameras on an arc around the workspace center, ZED-like
    # focal scaled to the render resolution.
    # Focal/standoff chosen so the gripper subtends a realistic pixel
    # footprint: a real DROID ZED at 720p (f ~ 700 px) 0.6 m from the
    # gripper puts ~100 px across it; at `width` px this is equivalent to
    # f ~ 1.5 * width at 0.65 m standoff.
    target = np.array([0.47, 0.0, 0.22])
    focal = rng.uniform(1.35, 1.65) * width
    standoff = rng.uniform(0.58, 0.80)
    k = [[focal, 0.0, width / 2], [0.0, focal, height / 2], [0.0, 0.0, 1.0]]
    cam2base = {}
    cam_intrs = {}
    for ci in range(n_external_cams):
        ang = -0.9 + 1.8 * ci / max(n_external_cams - 1, 1) + rng.uniform(-0.1, 0.1)
        cam_pos = target + np.array(
            [-standoff * np.cos(ang), standoff * np.sin(ang),
             rng.uniform(0.28, 0.45)]
        )
        w2c = _look_at(cam_pos, target)  # [3, 4] world->cam
        r_cw = w2c[:, :3].T
        cam_id = str(100 + ci)
        cam2base[cam_id] = list(
            np.concatenate([cam_pos, _matrix_to_euler_xyz(r_cw)])
        )
        cam_intrs[cam_id] = {"K": k, "width": width, "height": height}

    # Wrist camera: above/behind the EE at t=0, looking at the fingertips.
    # `pipeline.compute_extrinsics` chains it through the per-frame EE pose.
    from mvtracker_torch.droid.pipeline import generate_tracks

    probe = generate_tracks(os.path.join(raw_dir, "trajectory.h5"),
                            num_track_points=4, max_frames=1)
    ee0 = probe["gripper_poses"][0]
    centroid0 = probe["contact_centroids"][0]
    # Lateral + behind offset: keep the wrist-body sphere (on the EE
    # z-axis) out of the line of sight to the finger pads.
    wrist_pos = ee0[:3, 3] - 0.24 * ee0[:3, :3] @ np.array([0.0, 0.0, 1.0]) \
        + 0.17 * ee0[:3, :3] @ np.array([1.0, 0.0, 0.0]) \
        + 0.06 * ee0[:3, :3] @ np.array([0.0, 1.0, 0.0])
    w2c = _look_at(wrist_pos, centroid0)
    wrist_serial = "200"
    cam_intrs[wrist_serial] = {"K": k, "width": width, "height": height}

    meta = {
        "cam2base": cam2base,
        "wrist_cam_serial": wrist_serial,
        "wrist_cam_extrinsics": list(
            np.concatenate([wrist_pos, _matrix_to_euler_xyz(w2c[:, :3].T)])
        ),
        "camera_intrinsics": cam_intrs,
        "synthetic": {"seed": seed, "generator": "synth_episode.make_raw_episode"},
    }
    with open(os.path.join(raw_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return raw_dir


def _shade_spheres_and_plane(
    cam_pose: np.ndarray,  # [4, 4] cam->world
    k: np.ndarray,  # [3, 3]
    height: int,
    width: int,
    centers: np.ndarray,  # [S, 3]
    rotations: np.ndarray,  # [S, 3, 3] world<-local (texture frame)
    radii: np.ndarray,  # [S]
    colors: np.ndarray,  # [S, 3]
    salts: np.ndarray,  # [S]
    plane_salt: float,
    supersample: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Ray-trace one frame: textured spheres over a checkered table plane
    at z=0. Same analytic ray-sphere machinery as the Kubric-style
    renderer (`datasets/synthetic.render_scene`), re-scaled to metric
    tabletop geometry: texture coordinates are local/radius so every
    object carries full-contrast multi-octave value noise regardless of
    its physical size.

    `supersample` renders RGB at an integer multiple and box-downsamples
    — real cameras integrate over the pixel footprint; a point-sampled
    render of a finely textured small object shimmers frame to frame,
    which destroys exactly the correlation signal the tracker needs.
    Depth stays point-sampled at the output grid (averaging depth across
    an edge would invent surfaces that exist in neither object)."""
    if supersample > 1:
        ss = supersample
        k_ss = np.asarray(k, np.float64).copy()
        k_ss[:2] *= ss
        rgb_hi, _ = _shade_spheres_and_plane(
            cam_pose, k_ss, height * ss, width * ss,
            centers, rotations, radii, colors, salts, plane_salt,
            supersample=1,
        )
        rgb = (
            rgb_hi.reshape(height, ss, width, ss, 3)
            .mean(axis=(1, 3))
            .astype(np.uint8)
        )
        _, depth = _shade_spheres_and_plane(
            cam_pose, k, height, width,
            centers, rotations, radii, colors, salts, plane_salt,
            supersample=1,
        )
        return rgb, depth
    f = k[0, 0]
    cx, cy = k[0, 2], k[1, 2]
    xs = (np.arange(width) + 0.5) - cx
    ys = (np.arange(height) + 0.5) - cy
    xx, yy = np.meshgrid(xs, ys)
    dirs_cam = np.stack([xx / f, yy / f, np.ones_like(xx)], axis=-1)

    r_cw = cam_pose[:3, :3]  # cam->world rotation
    cam_origin = cam_pose[:3, 3]
    dirs_world = dirs_cam @ r_cw.T
    dn = dirs_world / np.linalg.norm(dirs_world, axis=-1, keepdims=True)
    fwd = r_cw[:, 2]  # world-frame camera forward
    cos_fwd = dn @ fwd

    zbuf = np.full((height, width), np.inf, np.float32)
    rgb = np.zeros((height, width, 3), np.float32)

    # Table plane z=0: 0.1 m checker + low-octave noise.
    dz = dn[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_hit = -cam_origin[2] / dz
    valid = (t_hit > 0.05) & (np.abs(dz) > 1e-6)
    pts = cam_origin[None, None] + t_hit[..., None] * dn
    in_extent = valid & (np.abs(pts[..., 0] - 0.47) < 1.2) & (np.abs(pts[..., 1]) < 1.2)
    cam_z = t_hit * cos_fwd
    checker = (
        (np.floor(pts[..., 0] / 0.1) + np.floor(pts[..., 1] / 0.1)) % 2
    ).astype(bool)
    base = np.where(checker, 0.55, 0.35)
    sel = in_extent & (cam_z < zbuf)
    if sel.any():
        noise = _value_noise3(
            np.stack([pts[sel][:, 0] / 0.1, pts[sel][:, 1] / 0.1,
                      np.zeros(sel.sum())], axis=-1),
            salt=plane_salt,
        )
        zbuf[sel] = cam_z[sel]
        col = np.clip(base[sel] + 0.35 * noise, 0.05, 1.0)
        rgb[sel] = col[:, None]

    light_dir = np.array([0.4, 0.3, 0.866])
    for si in range(len(centers)):
        oc = cam_origin - centers[si]
        b = 2 * (dn @ oc)
        c = oc @ oc - radii[si] ** 2
        disc = b * b - 4 * c
        hit = disc > 0
        sq = np.sqrt(np.maximum(disc, 0))
        t0 = (-b - sq) / 2
        hit &= t0 > 0.05
        p = cam_origin[None, None] + t0[..., None] * dn
        cam_z_s = t0 * cos_fwd
        sel = hit & (cam_z_s < zbuf)
        if not sel.any():
            continue
        normal = (p[sel] - centers[si]) / radii[si]
        light = np.clip(normal @ light_dir, 0.25, 1.0)
        local = (p[sel] - centers[si]) @ rotations[si]  # world -> local
        # Texture scale: ~2.5 noise-lattice cells per radius (base_freq 5
        # * 0.5), i.e. features several px across at the chosen focal —
        # localizable but not aliased. (An earlier 1.5x scaling put 7.5
        # cells per radius = ~1.5 px features on the finger pads; the
        # point-sampled render shimmered frame to frame and correlation
        # had no stable signal to lock onto.)
        noise = _value_noise3(local / radii[si] * 0.5, salt=salts[si])
        shade = np.clip(0.65 + 1.2 * noise, 0.1, 1.6) * light
        zbuf[sel] = cam_z_s[sel]
        rgb[sel] = np.clip(colors[si][None] * shade[:, None], 0.0, 1.0)

    depth = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8), depth


def render_recordings(
    episode_out: str,
    seed: int = 0,
    max_frames: Optional[int] = None,
    include_wrist: bool = True,
) -> dict:
    """Ray-trace rgb.npz + depth.mkv recordings for a processed episode.

    Scene content per frame, posed by the episode's own FK outputs
    (tracks.npz): two finger-pad spheres (r=0.022 m, centered on the
    left/right contact frames so the FK contact points ride rigidly just
    inside their surfaces), a wrist-body sphere on the EE z-axis, and
    static textured distractor objects on the table.
    """
    from mvtracker_torch.droid.depth_video import write_depth_video

    rng = np.random.default_rng(seed + 991)
    tracks = np.load(os.path.join(episode_out, "tracks.npz"))
    extr_z = np.load(os.path.join(episode_out, "extrinsics.npz"))
    with open(os.path.join(episode_out, "metadata.json")) as f:
        meta = json.load(f)

    lf = np.asarray(tracks["left_contact_frames"])  # [T, 4, 4]
    rf = np.asarray(tracks["right_contact_frames"])
    ee = np.asarray(tracks["gripper_poses"])  # [T, 4, 4]
    t_total = lf.shape[0]
    t = t_total if max_frames is None else min(max_frames, t_total)

    # Static distractors: placed on the table away from the EE sweep.
    n_dist = 3
    dist_r = rng.uniform(0.035, 0.07, n_dist)
    dist_c = np.stack(
        [
            0.47 + rng.uniform(-0.35, 0.35, n_dist),
            rng.uniform(0.22, 0.45, n_dist) * rng.choice([-1, 1], n_dist),
            dist_r,
        ],
        axis=1,
    )
    dist_rot = np.tile(np.eye(3), (n_dist, 1, 1))
    dist_col = rng.uniform(0.3, 1.0, (n_dist, 3))

    n_sph = 3 + n_dist
    salts = seed * 0.31 + 7.7 * np.arange(n_sph)
    gripper_col = np.array(
        [[0.85, 0.82, 0.78], [0.80, 0.84, 0.88], [0.75, 0.75, 0.78]]
    )

    def spheres_at(ti: int):
        body_c = ee[ti, :3, 3] + ee[ti, :3, :3] @ np.array([0.0, 0.0, 0.015])
        centers = np.concatenate(
            [[lf[ti, :3, 3], rf[ti, :3, 3], body_c], dist_c]
        )
        rots = np.concatenate(
            [[lf[ti, :3, :3], rf[ti, :3, :3], ee[ti, :3, :3]], dist_rot]
        )
        # Pad radius 0.016: the synthetic contact pad spans a 13 mm
        # half-diagonal, so every FK contact point sits 1-16 mm inside
        # the rendered surface — close enough that the pad's rigid
        # motion IS the contact points' motion at metric eval thresholds.
        radii = np.concatenate([[0.016, 0.016, 0.045], dist_r])
        colors = np.concatenate([gripper_col, dist_col])
        return centers, rots, radii, colors

    # Camera set: static externals + (optionally) the per-frame wrist cam.
    cams = {}
    for key in extr_z.files:
        if key.startswith("external_"):
            cid = key[len("external_"):]
            cams[cid] = np.broadcast_to(np.asarray(extr_z[key]), (t, 4, 4))
        elif key == "wrist" and include_wrist:
            ws = str(meta.get("wrist_cam_serial", ""))
            if ws:
                cams[ws] = np.asarray(extr_z[key])[:t]

    written = []
    for cid, poses in cams.items():
        info = meta["camera_intrinsics"].get(cid)
        if info is None:
            continue
        k = np.asarray(info["K"], np.float64)
        h, w = int(info["height"]), int(info["width"])
        rgb_v = np.zeros((t, h, w, 3), np.uint8)
        dep_v = np.zeros((t, h, w), np.float32)
        for ti in range(t):
            centers, rots, radii, colors = spheres_at(ti)
            rgb_v[ti], dep_v[ti] = _shade_spheres_and_plane(
                np.asarray(poses[ti], np.float64), k, h, w,
                centers, rots, radii, colors, salts, plane_salt=seed * 0.53,
            )
        cam_dir = os.path.join(episode_out, "recordings", cid)
        os.makedirs(cam_dir, exist_ok=True)
        np.savez_compressed(os.path.join(cam_dir, "rgb.npz"), rgb=rgb_v)
        write_depth_video(os.path.join(cam_dir, "depth.mkv"), dep_v)
        written.append(cid)
    return {"cameras": written, "frames": t}


def build_episode(
    root: str,
    seed: int = 0,
    n_frames: int = 48,
    n_external_cams: int = 2,
    width: int = 256,
    height: int = 192,
    num_track_points: int = 24,
    include_wrist: bool = True,
    force: bool = False,
) -> str:
    """Raw synth episode -> FK pipeline -> rendered recordings.

    Returns the processed episode directory (skip-if-exists idempotent,
    like the pipeline itself). Layout: `<root>/raw/episode_<seed>` and
    `<root>/processed/episode_<seed>`.
    """
    from mvtracker_torch.droid.pipeline import process_episode

    out_dir = os.path.join(root, "processed", f"episode_{seed:03d}")
    done_marker = os.path.join(out_dir, "recordings")
    if os.path.isdir(done_marker) and not force:
        return out_dir
    raw = make_raw_episode(
        os.path.join(root, "raw", f"episode_{seed:03d}"),
        seed=seed, n_frames=n_frames, n_external_cams=n_external_cams,
        width=width, height=height,
    )
    process_episode(raw, out_dir, num_track_points=num_track_points)
    # The dataset reads metadata from the processed dir (the batch CLI
    # stages it the same way).
    with open(os.path.join(raw, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    render_recordings(out_dir, seed=seed, include_wrist=include_wrist)
    return out_dir
