"""DROID episode processing pipeline (CPU metadata path), counterpart of
`mvtracker_tpu/droid/pipeline.py`.

Re-design of the reference's episode pipeline
(`conversions/droid/training_data/generate_tracks_and_metadata.py` +
`run_pipeline_cluster_*.sh` orchestration): robot-state h5 -> gripper
contact-surface tracks -> camera extrinsics -> per-camera 2D projections ->
tracks.npz / extrinsics.npz / quality.json, with a multiprocessing batch
runner (failure logs, skip-if-exists idempotency) replacing the reference's
GNU-parallel shell workers (§2.6/§2.7 of SURVEY.md).

Depth extraction (ZED SVO NEURAL depth) is hardware-bound and stays out of
scope per SURVEY §2.9(7); the pipeline consumes already-extracted depth
artifacts when present.

The robot-state `trajectory.h5` is read with the port's own HDF5 reader
(`datasets/hdf5.py`): the GPU host has no h5py.
"""

from __future__ import annotations

import json
import logging
import os
import traceback
from typing import Optional

import numpy as np

from mvtracker_torch.datasets import hdf5
from mvtracker_torch.droid.gripper import ContactSurfaceTracker
from mvtracker_torch.droid.transforms import (
    pose6_to_T_batch,
    project_tracks_to_2d,
    rvec_tvec_to_matrix,
)

# 90-degree yaw correction applied to every EE pose
# (reference `generate_tracks_and_metadata.py:323-332`).
_R_FIX = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def compute_normalized_flow(
    contact_centroids: np.ndarray,  # [T, 3]
    contact_frames: np.ndarray,  # [T, 4, 4]
    step_size_mm: float = 1.0,
    tracks_3d: Optional[np.ndarray] = None,  # [T, N, 3]
) -> dict:
    """Resample the contact trajectory at fixed arc-length steps.

    Mirrors reference `tracking.py:124-230` (`compute_normalized_flow`):
    10mm moved in one frame -> 10 steps; 1mm over 10 frames -> 1 step.
    """
    step = step_size_mm / 1000.0
    t = len(contact_centroids)
    out: dict = {}

    seg = np.linalg.norm(np.diff(contact_centroids, axis=0), axis=1) if t > 1 else np.zeros(0)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    out["cumulative_distance_mm"] = cum * 1000.0

    if t < 2 or cum[-1] < step:
        out["normalized_centroids"] = contact_centroids.copy()
        out["normalized_frames"] = contact_frames.copy()
        out["frame_to_normalized_idx"] = np.zeros(t, np.int32)
        out["num_normalized_steps"] = t
        if tracks_3d is not None:
            out["normalized_tracks_3d"] = tracks_3d.copy()
        return out

    targets = np.arange(0.0, cum[-1] + step * 0.5, step)
    out["num_normalized_steps"] = len(targets)

    def interp_along(values: np.ndarray) -> np.ndarray:
        flat = values.reshape(t, -1)
        res = np.stack([np.interp(targets, cum, flat[:, i]) for i in range(flat.shape[1])], axis=1)
        return res.reshape((len(targets),) + values.shape[1:])

    out["normalized_centroids"] = interp_along(contact_centroids).astype(np.float32)
    out["normalized_frames"] = interp_along(contact_frames).astype(np.float32)
    if tracks_3d is not None:
        out["normalized_tracks_3d"] = interp_along(tracks_3d).astype(np.float32)
    out["frame_to_normalized_idx"] = np.minimum(
        np.searchsorted(targets, cum, side="right") - 1, len(targets) - 1
    ).astype(np.int32)
    return out


def generate_tracks(
    h5_path: str,
    num_track_points: int = 24,
    max_frames: Optional[int] = None,
    mesh_path: Optional[str] = None,
) -> dict:
    """Robot-state h5 -> contact tracks; mirrors reference
    `generate_tracks_and_metadata.py:291-386` (vectorized FK)."""
    with hdf5.File(h5_path) as f:
        cartesian = f["observation/robot_state/cartesian_position"][:]
        gripper = f["observation/robot_state/gripper_position"][:]

    t = len(cartesian) if max_frames is None else min(max_frames, len(cartesian))
    cartesian, gripper = cartesian[:t], gripper[:t]

    tracker = ContactSurfaceTracker(num_track_points, mesh_path)
    n_per_finger = len(tracker.contact_points_local)

    ee = pose6_to_T_batch(cartesian)  # [T, 4, 4]
    ee[:, :3, :3] = ee[:, :3, :3] @ _R_FIX  # reference R_fix (z+90deg)

    tracks_3d = np.zeros((t, 2 * n_per_finger, 3), np.float32)
    centroids = np.zeros((t, 3), np.float32)
    frames = np.zeros((t, 4, 4), np.float32)
    left_frames = np.zeros((t, 4, 4), np.float32)
    right_frames = np.zeros((t, 4, 4), np.float32)
    for i in range(t):
        left, right, c, fr, lf, rf = tracker.contact_points_and_frames(ee[i], gripper[i])
        tracks_3d[i, :n_per_finger] = left
        tracks_3d[i, n_per_finger:] = right
        centroids[i], frames[i] = c, fr
        left_frames[i], right_frames[i] = lf, rf

    norm = compute_normalized_flow(centroids, frames, tracks_3d=tracks_3d)
    return {
        "tracks_3d": tracks_3d,
        "contact_points_local": tracker.contact_points_local,
        "gripper_poses": ee.astype(np.float32),
        "gripper_positions": gripper,
        "cartesian_positions": cartesian,
        "contact_centroids": centroids,
        "contact_frames": frames,
        "left_contact_frames": left_frames,
        "right_contact_frames": right_frames,
        "num_frames": t,
        "num_points_per_finger": n_per_finger,
        **norm,
    }


def compute_extrinsics(
    h5_path: str,
    cam2base: dict,
    wrist_cam_serial: str = "",
    wrist_cam_extrinsics: Optional[list] = None,
    max_frames: Optional[int] = None,
) -> dict:
    """Static external-camera poses + per-frame wrist-camera poses.

    Mirrors reference `generate_tracks_and_metadata.py:389-469`, including
    the critical detail that the wrist-cam offset is computed from the
    R_fix-rotated initial EE pose.
    """
    with hdf5.File(h5_path) as f:
        cartesian = f["observation/robot_state/cartesian_position"][:]
    t = len(cartesian) if max_frames is None else min(max_frames, len(cartesian))
    cartesian = cartesian[:t]

    external = {
        cam_id: rvec_tvec_to_matrix(v)
        for cam_id, v in cam2base.items()
        if str(cam_id).isdigit()
    }

    wrist = None
    if wrist_cam_extrinsics is not None:
        ee = pose6_to_T_batch(cartesian)
        ee[:, :3, :3] = ee[:, :3, :3] @ _R_FIX
        t_base_cam0 = rvec_tvec_to_matrix(wrist_cam_extrinsics)
        t_ee_cam = np.linalg.inv(ee[0]) @ t_base_cam0
        wrist = np.einsum("tij,jk->tik", ee, t_ee_cam).astype(np.float64)

    return {
        "external_extrinsics": external,
        "wrist_extrinsics": wrist,
        "wrist_serial": wrist_cam_serial,
        "num_frames": t,
    }


def compute_2d_tracks(
    tracks_3d: np.ndarray,
    camera_intrinsics: dict,  # cam_id -> {K, width, height}
    extrinsics_data: dict,
    min_depth: float = 0.01,
) -> dict:
    """Per-camera 2D projections; mirrors reference
    `generate_tracks_and_metadata.py:233-288`."""
    out = {}
    for cam_id, pose in extrinsics_data["external_extrinsics"].items():
        if cam_id not in camera_intrinsics:
            continue
        info = camera_intrinsics[cam_id]
        out[cam_id] = project_tracks_to_2d(
            tracks_3d, np.asarray(info["K"]), pose, info["width"], info["height"],
            min_depth=min_depth,
        )
    ws = extrinsics_data.get("wrist_serial")
    we = extrinsics_data.get("wrist_extrinsics")
    if ws and we is not None and ws in camera_intrinsics:
        info = camera_intrinsics[ws]
        out[ws] = project_tracks_to_2d(
            tracks_3d, np.asarray(info["K"]), we, info["width"], info["height"],
            min_depth=min_depth,
        )
    return out


def process_episode(
    episode_dir: str,
    out_dir: str,
    num_track_points: int = 24,
    max_frames: Optional[int] = None,
    skip_if_exists: bool = True,
) -> dict:
    """One episode: h5 + calibration -> tracks.npz / extrinsics.npz /
    quality.json in `out_dir` (reference pipeline outputs, SURVEY §2.7)."""
    os.makedirs(out_dir, exist_ok=True)
    tracks_out = os.path.join(out_dir, "tracks.npz")
    if skip_if_exists and os.path.exists(tracks_out):
        return {"status": "skipped", "episode": episode_dir}

    h5_path = os.path.join(episode_dir, "trajectory.h5")
    meta_path = os.path.join(episode_dir, "metadata.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)

    tracks = generate_tracks(h5_path, num_track_points, max_frames)
    extr = compute_extrinsics(
        h5_path,
        meta.get("cam2base", {}),
        wrist_cam_serial=str(meta.get("wrist_cam_serial", "")),
        wrist_cam_extrinsics=meta.get("wrist_cam_extrinsics"),
        max_frames=max_frames,
    )
    intr = meta.get("camera_intrinsics", {})
    tracks_2d = compute_2d_tracks(tracks["tracks_3d"], intr, extr)

    np.savez_compressed(
        tracks_out,
        **{k: v for k, v in tracks.items() if isinstance(v, np.ndarray)},
        **{f"tracks_2d_{cid}": v for cid, v in tracks_2d.items()},
    )
    np.savez_compressed(
        os.path.join(out_dir, "extrinsics.npz"),
        **{f"external_{cid}": v for cid, v in extr["external_extrinsics"].items()},
        **({"wrist": extr["wrist_extrinsics"]} if extr["wrist_extrinsics"] is not None else {}),
    )
    quality = {
        "num_frames": int(tracks["num_frames"]),
        "num_track_points": int(tracks["tracks_3d"].shape[1]),
        "total_distance_mm": float(tracks["cumulative_distance_mm"][-1]),
        "num_cameras": len(extr["external_extrinsics"])
        + (1 if extr["wrist_extrinsics"] is not None else 0),
    }
    with open(os.path.join(out_dir, "quality.json"), "w") as f:
        json.dump(quality, f, indent=2)
    return {"status": "ok", "episode": episode_dir, **quality}


def _process_one_episode(ep: str, out_root: str, kwargs: dict) -> dict:
    """Top-level worker (a nested closure cannot cross the
    ProcessPoolExecutor pickle boundary)."""
    out_dir = os.path.join(out_root, os.path.basename(ep.rstrip("/")))
    return process_episode(ep, out_dir, **kwargs)


def process_episodes_batch(
    episode_dirs: list[str],
    out_root: str,
    num_workers: int = 8,
    worker_fn=None,
    **kwargs,
) -> dict:
    """Parallel batch over episodes with per-episode failure isolation.

    Replaces the reference's GNU-parallel shell worker pool
    (`run_pipeline_cluster_huggingface_compressed_lossy.sh:1003-1033`):
    failures are logged to failed_episodes.txt and do not stop the batch.

    Workers run in a SPAWN multiprocessing context — the equivalent of the
    reference pool's fork+exec-per-episode. A parent that has initialised
    CUDA cannot fork (the child's CUDA context is unusable), and fork-mode
    pools deadlock when the parent holds live threads (loader prefetch,
    TensorBoard writers): the forked child inherits a locked lock and
    blocks forever. The pipeline module tree is numpy-only, so spawn
    startup is short. `worker_fn` (a picklable
    module-level callable (ep, out_root, kwargs) -> {"status": ...}) exists
    for tests; None = the real episode processor.
    """
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed
    from concurrent.futures.process import BrokenProcessPool

    if worker_fn is None:
        worker_fn = _process_one_episode
    mp_ctx = multiprocessing.get_context("spawn")

    os.makedirs(out_root, exist_ok=True)
    failed_log = os.path.join(out_root, "failed_episodes.txt")
    results = {"ok": 0, "skipped": 0, "failed": 0}

    if num_workers <= 1:
        for ep in episode_dirs:
            try:
                r = worker_fn(ep, out_root, kwargs)
                results[r["status"]] += 1
            except Exception:
                results["failed"] += 1
                with open(failed_log, "a") as f:
                    f.write(f"{ep}\n{traceback.format_exc()}\n")
        return results

    # A worker process that DIES (OOM-killed, segfault) — as opposed to
    # raising — breaks the whole ProcessPoolExecutor: every outstanding
    # future raises BrokenProcessPool. The reference's GNU-parallel pool
    # survives this per-worker (each episode is its own process,
    # `run_pipeline...lossy.sh:1003-1033` + error-count files); here the
    # batch recovers by retrying the unaccounted episodes in a fresh pool.
    # An episode whose worker dies on every attempt is logged and marked
    # failed instead of looping forever (processing is idempotent, so
    # retrying an episode that actually completed is a cheap skip).
    max_attempts = 2
    attempts: dict[str, int] = {ep: 0 for ep in episode_dirs}
    pending = list(episode_dirs)
    while pending:
        batch_eps = []
        for ep in pending:
            if attempts[ep] >= max_attempts:
                results["failed"] += 1
                with open(failed_log, "a") as f:
                    f.write(
                        f"{ep}\nworker process died on every attempt "
                        f"({max_attempts})\n"
                    )
            else:
                batch_eps.append(ep)
        pending = []
        if not batch_eps:
            break
        accounted: set[str] = set()
        try:
            with ProcessPoolExecutor(
                max_workers=num_workers, mp_context=mp_ctx
            ) as ex:
                futs = {
                    ex.submit(worker_fn, ep, out_root, kwargs): ep
                    for ep in batch_eps
                }
                for ep in batch_eps:
                    attempts[ep] += 1
                for fut in as_completed(futs):
                    ep = futs[fut]
                    try:
                        r = fut.result()
                        results[r["status"]] += 1
                    except BrokenProcessPool:
                        raise
                    except Exception:
                        results["failed"] += 1
                        logging.exception("episode failed: %s", ep)
                        with open(failed_log, "a") as f:
                            f.write(f"{ep}\n{traceback.format_exc()}\n")
                    accounted.add(ep)
        except BrokenProcessPool:
            pending = [ep for ep in batch_eps if ep not in accounted]
            logging.warning(
                "worker pool broke (a worker process died); retrying %d "
                "unaccounted episodes in a fresh pool", len(pending),
            )
            with open(failed_log, "a") as f:
                f.write(f"# pool broken by a dead worker; retrying {len(pending)}\n")
    return results
