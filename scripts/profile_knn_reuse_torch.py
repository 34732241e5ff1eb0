"""Exact kNN against `corr_knn_reuse=True` on the port, on one NVIDIA GPU:
the twin of `scripts/profile_knn_reuse.py`.

    python3 scripts/profile_knn_reuse_torch.py [--reps 10] [--out_json out.json]

`corr_knn_reuse` searches once per window, at the window's initial coords
(the search the first iteration makes anyway), and every iteration reuses
those neighbours, so a forward makes fewer kNN searches. At the bench config
(`bench_torch.py`: bf16 unless `--dtype float32`, seeded weights,
`make_scene` seed 0 at 4 views x 24 frames x 256^2, 256 queries, 4
iterations), with the same weights in both models, it reports:

1. ms a forward of each path, the JAX scripts' statistic (the lower of two
   means of `--reps` calls after `--warm`), point-frames per second and the
   speed-up;
2. the divergence |traj_exact - traj_reuse| per (frame, track): mean, p95
   and max, beside the spread (std) of the queries' xyz, as the JAX script
   reports it;
3. the K1 launches and kNN searches of one forward of each path,
with the card's name and power limit. With `--device cpu` (the tests) the
times are None; the divergence and the counts are computed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402
from scripts import timing_torch  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true", help="bench_torch.py's narrow widths")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"], help="the models' compute dtype")
    p.add_argument("--warm", type=int, default=3)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--out_json", default=None)
    return p


def divergence(traj_exact: np.ndarray, traj_reuse: np.ndarray, query_points: np.ndarray) -> dict:
    """The JAX script's divergence: Euclidean |exact - reuse| per (frame,
    track), and the queries' xyz spread."""
    d = np.linalg.norm(traj_exact - traj_reuse, axis=-1)
    return {"mean": float(d.mean()), "p95": float(np.percentile(d, 95)), "max": float(d.max()),
            "scene_xyz_std": float(query_points[:, 1:].std())}


def main(argv=None, state_dict=None) -> dict:
    """`state_dict`: weights for both models (seeded weights without)."""
    args = build_parser().parse_args(argv)
    import torch

    from mvtracker_torch.device import resolve_device
    from mvtracker_torch.ops import _cuda

    device = resolve_device(args.device)
    if device.type == "cuda":
        _cuda.build_all()
    (v, t, h, w, n), widths = bench_torch.configs(args.small)["headline"]
    scene_np = bench_torch.headline_scene(args.small)
    scene = [torch.as_tensor(a, device=device) for a in scene_np]
    exact = bench_torch.build_model(widths, device, state_dict=state_dict, compute_dtype=args.dtype)
    reuse = bench_torch.build_model(widths, device, state_dict=exact.state_dict(), compute_dtype=args.dtype,
                                    corr_knn_reuse=True)
    report = {}
    trajs = {}
    for tag, model in (("exact", exact), ("reuse", reuse)):
        with timing_torch.counted() as counts:
            out = bench_torch.forward(model, scene)
        trajs[tag] = out["traj"].float().cpu().numpy()
        ms = timing_torch.lower_mean_ms(lambda: bench_torch.forward(model, scene), device, args.reps, args.warm)
        report[tag] = {"ms": ms, "point_frames_per_s": None if ms is None else n * t / (ms / 1e3),
                       "launches": counts["launches"], "calls": counts["calls"]}
        line = ("not measured on the CPU" if ms is None else
                f"{ms:.1f} ms/fwd -> {report[tag]['point_frames_per_s']:,.0f} pf/s")
        print(f"{tag}: {line}; one forward: {counts['calls']['knn']} kNN searches, K1 launches "
              f"{counts['launches']['knn']}")
    report["divergence"] = divergence(trajs["exact"], trajs["reuse"], scene_np[2])
    e, r = report["exact"]["ms"], report["reuse"]["ms"]
    report["speedup"] = None if e is None else e / r
    report["config"] = {"views": v, "frames": t, "height": h, "width": w, "queries": n, "iters": bench_torch.ITERS,
                        "dtype": args.dtype, "small": args.small}
    report.update(timing_torch.card(device))
    d = report["divergence"]
    print(f"divergence |exact-reuse|: mean {d['mean']:.4g}  p95 {d['p95']:.4g}  max {d['max']:.4g}  "
          f"(scene xyz std {d['scene_xyz_std']:.3g})")
    print(f"speedup: {'not measured on the CPU' if e is None else f'{e / r:.3f}x'} "
          f"[{report['device']}, {report['power_limit']}]")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
