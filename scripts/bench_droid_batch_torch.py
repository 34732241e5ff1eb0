"""DROID batch-processing throughput of the port: the twin of
`scripts/bench_droid_batch.py`.

    python3 scripts/bench_droid_batch_torch.py [--episodes 20] [--frames 120] [--workers 1 2 4] [--out_json out.json]

Writes `--episodes` raw episodes in the DROID on-disk layout
(`trajectory.h5` robot states through the port's HDF5 writer,
`datasets/hdf5.py`, and `metadata.json` with the calibration), each a copy
of the JAX test fixture `tests/test_droid.py::make_episode` (`make_episode`
here), and times `droid/pipeline.py::process_episodes_batch` (FK tracks,
extrinsics, 2D projections, quality) at each worker count, in spawned
worker processes: episodes per hour on this host and the scaling against
one worker. This is host work; no kernel runs. The card's name and power
limit are printed beside the numbers (with `--device cuda`, the default,
the script needs the card it names, as the port's other entry points do).
The episodes and outputs live in a temporary directory, removed at the end,
or under `--root`, which is kept; nothing is written into the repository
unless `--out_json` or `--root` names a place there.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from scripts import timing_torch  # noqa: E402


def make_episode(root, t: int = 30, name: str = "episode_000") -> str:
    """A raw DROID episode under `root`: the arrays, calibration and layout
    of the JAX test fixture `make_episode`, its `trajectory.h5` written by
    the port's HDF5 writer. Returns the episode's directory."""
    from mvtracker_torch.datasets import hdf5

    ep = Path(root) / name
    ep.mkdir()
    rng = np.random.default_rng(0)
    ts = np.linspace(0, 1, t)
    cart = np.zeros((t, 6))
    cart[:, 0] = 0.4 + 0.1 * np.sin(2 * np.pi * ts)
    cart[:, 1] = 0.2 * ts
    cart[:, 2] = 0.3 + 0.05 * np.cos(2 * np.pi * ts)
    cart[:, 3:] = 0.3 * rng.standard_normal(3)[None] * ts[:, None]
    grip = np.clip(ts, 0, 1)[:, None]
    hdf5.write(ep / "trajectory.h5", {"observation/robot_state/cartesian_position": cart,
                                      "observation/robot_state/gripper_position": grip})
    k = [[300.0, 0, 160], [0, 300, 120], [0, 0, 1]]
    meta = {
        "cam2base": {"100": [0.5, 0.5, 0.5, 0.1, 0.2, 0.3]},
        "wrist_cam_serial": "200",
        "wrist_cam_extrinsics": [0.45, 0.05, 0.35, 0.0, 0.1, 0.0],
        "camera_intrinsics": {
            "100": {"K": k, "width": 320, "height": 240},
            "200": {"K": k, "width": 320, "height": 240},
        },
    }
    with open(ep / "metadata.json", "w") as f:
        json.dump(meta, f)
    return str(ep)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="the card named beside the numbers (cpu for the tests)")
    p.add_argument("--episodes", type=int, default=20)
    p.add_argument("--frames", type=int, default=120,
                   help="frames per episode (DROID episodes are minutes long; 120 at 15 fps = 8 s)")
    p.add_argument("--track_points", type=int, default=32)
    p.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--root", default=None, help="where the episodes and outputs are written and kept "
                   "(default: a temporary directory, removed at the end)")
    p.add_argument("--out_json", default=None)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from mvtracker_torch.device import resolve_device
    from mvtracker_torch.droid import pipeline

    device = resolve_device(args.device)
    root = Path(args.root or tempfile.mkdtemp(prefix="droid_bench_"))
    root.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        eps = []
        for i in range(args.episodes):
            gen = root / f"gen_{i}"
            gen.mkdir()
            # Batch outputs are keyed on the episode's directory name.
            eps.append(make_episode(gen, t=args.frames, name=f"episode_{i:03d}"))
        report = {"episodes": args.episodes, "frames_per_episode": args.frames,
                  "gen_s": time.perf_counter() - t0, "host_cpus": os.cpu_count(), "runs": [],
                  **timing_torch.card(device)}
        for w in args.workers:
            out = root / f"out_w{w}"
            t0 = time.perf_counter()
            res = pipeline.process_episodes_batch(eps, str(out), num_workers=w, num_track_points=args.track_points)
            el = time.perf_counter() - t0
            run = {"workers": w, "wall_s": el, "episodes_per_hour": args.episodes / el * 3600, "results": res,
                   "out_dir": str(out)}
            report["runs"].append(run)
            print(json.dumps(run))
        base = report["runs"][0]
        for run in report["runs"][1:]:
            run["scaling_vs_1w"] = run["episodes_per_hour"] / base["episodes_per_hour"]
        print(json.dumps(report, indent=2))
        print(f"host work on {os.cpu_count()} cores [{report['device']}, {report['power_limit']}]")
        if args.out_json:
            with open(args.out_json, "w") as f:
                json.dump(report, f, indent=2)
        return report
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
