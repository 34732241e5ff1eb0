"""CPU controls for the card-versus-CPU limits of `chip_smoke.py` phase 15
(the DROID factory).

Each control runs the plain CPU path twice and reports how far the outputs
move under a change that rounding stands for (the card sums in other orders
than the CPU), on phase 15's synthetic episode (`DROID_EPISODE`, built here
the same way):

- `cli.droid track` at phase 15's fp32 request: the flagship MVTracker
  (seeded weights, TF32 irrelevant on the CPU, exact kNN), the gripper
  queries, the first `DROID_PLAIN_FRAMES` frames in segments of
  `DROID_CHUNK`; every query moved by up to 1e-6; median / p90 / max of
  |gap| in traj and vis;
- `cli.droid refine` on the episode with the wrist biased by `DROID_Z_TRUE`:
  the z-offset search on the same frames with every wrist point moved by up
  to 1e-6 m; |gap| of the offset and of its fitness.

Prints one JSON line per control.

    python scripts/control_torch_droid.py            # phase 15's size: about a minute to build, minutes of CPU
    python scripts/control_torch_droid.py --size tiny
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def gap_stats(a, b) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return {"median": float(np.median(d)), "p90": float(np.quantile(d, 0.9)), "max": float(d.max())}


def control_track(torch, ep, frames, chunk, extra=()):
    from mvtracker_torch.cli import droid as droid_cli
    from mvtracker_torch.evaluation.evaluator import to_host

    args = droid_cli.build_parser().parse_args(
        ["track", "--episode", ep, "--out", os.devnull, "--chunk_frames", str(chunk), "--max_frames", str(frames),
         "--dtype", "float32", "--device", "cpu", *extra])
    dp, queries, pred = droid_cli.prepare_track(args)
    pred.model.knn_backend = "exact"
    moved = queries + np.random.default_rng(1).uniform(-1e-6, 1e-6, queries.shape).astype(np.float32) * [0, 1, 1, 1]
    outs = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for q in (queries, moved.astype(np.float32)):
            res = pred(dp.video, dp.videodepth, q, dp.intrs, dp.extrs)
            outs.append((to_host(res["traj"]), to_host(res["vis"])))
    return {"control": "track", "frames": frames, "queries": int(len(queries)),
            "traj": gap_stats(outs[0][0], outs[1][0]), "vis": gap_stats(outs[0][1], outs[1][1]),
            "seconds": round(time.perf_counter() - t0, 1)}


def control_refine(ep, z_true):
    from mvtracker_torch.datasets.droid import episode_camera_ids, load_droid_episode
    from mvtracker_torch.droid.refine import collect_refinement_frames
    from mvtracker_torch.ops.icp import optimize_wrist_z_offset_multi_frame

    path = os.path.join(ep, "extrinsics.npz")
    data = dict(np.load(path))
    data["wrist"] = data["wrist"].copy()
    data["wrist"][:, :3, 3] -= z_true * data["wrist"][:, :3, 2]
    np.savez_compressed(path, **data)
    with open(os.path.join(ep, "metadata.json")) as f:
        wrist = str(json.load(f)["wrist_cam_serial"])
    dp = load_droid_episode(ep)
    frames = collect_refinement_frames(dp, episode_camera_ids(ep)[: dp.videodepth.shape[0]], wrist)
    rng = np.random.default_rng(2)
    moved = [dict(f, wrist_points_local=f["wrist_points_local"]
                  + rng.uniform(-1e-6, 1e-6, f["wrist_points_local"].shape).astype(np.float32)) for f in frames]
    t0 = time.perf_counter()
    z0, fit0 = optimize_wrist_z_offset_multi_frame(frames, device="cpu")
    z1, fit1 = optimize_wrist_z_offset_multi_frame(moved, device="cpu")
    return {"control": "refine", "frames": len(frames), "z": [z0, z1], "z_gap": abs(z0 - z1),
            "fitness_gap": abs(fit0 - fit1), "z_error_m": abs(z0 - z_true), "seconds": round(time.perf_counter() - t0, 1)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", choices=["full", "tiny"], default="full")
    parser.add_argument("--parts", default="track,refine")
    cli = parser.parse_args()

    import torch

    from chip_smoke import DROID_CHUNK, DROID_EPISODE, DROID_PLAIN_FRAMES, DROID_Z_TRUE
    from mvtracker_torch.droid.synth_episode import build_episode

    spec, frames, chunk, extra = dict(DROID_EPISODE), DROID_PLAIN_FRAMES, DROID_CHUNK, ()
    if cli.size == "tiny":
        spec.update(n_frames=6, width=64, height=48, num_track_points=4)
        frames, chunk, extra = 6, 4, ("--interp_shape", "64", "64", "--iters", "2")
    tmp = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        ep = build_episode(tmp, **spec)
        print(json.dumps({"episode": spec, "build_seconds": round(time.perf_counter() - t0, 1),
                          "threads": torch.get_num_threads()}), flush=True)
        parts = cli.parts.split(",")
        if "track" in parts:
            print(json.dumps(control_track(torch, ep, frames, chunk, extra)), flush=True)
        if "refine" in parts:
            biased = os.path.join(tmp, "biased")
            shutil.copytree(ep, biased)
            print(json.dumps(control_refine(biased, DROID_Z_TRUE)), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
