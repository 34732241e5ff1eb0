#!/usr/bin/env python3
"""Headline benchmark of the port (`mvtracker_torch`) on one NVIDIA GPU: the
twin of the JAX package's `bench.py`, with its keys.

    python3 bench_torch.py [--parts serving,train,eval] [--baseline BENCH.json] [--out_json out.json]

Runs the flagship MVTracker forward (bf16, seeded weights, `make_scene`
seed 0 at 4 views x 24 frames x 256^2, 256 queries, 4 iterations) and
reports tracked point-frames per second, `value = N * T / step`, where the
step is `bench.py`'s statistic: the lower of two means of 10 calls issued
back to back, after 3 warm calls, on the host clock up to a synchronize.
Beside it, on one JSON line:

- `fwd_ms` (that statistic), `fwd_ms_median`, `fwd_ms_min`, `fwd_ms_max`
  (single calls, each timed alone);
- `fwd_tflops`: one forward's operations: what `FlopCounterMode` counts
  (convolutions, matmuls) plus the kNN's 9 per (query, point) pair and the
  correlation's 2 * C * K per track, level and iteration, counted from the
  shapes of the kernel calls, which the counter cannot see. It is not XLA's
  cost analysis, which `bench.py` reads and which counts elementwise work
  too. `achieved_tflops_s` is that over `fwd_ms`, `mfu` that over the
  card's dense bf16 peak (None for a card not in `timing_torch`'s table);
- serving mode (`corr_knn_reuse=True`): `fwd_ms_serving`, `value_serving`;
- `value_batched{2,4,8}`: B scenes served as B forwards of the serving
  model in one timed unit (the port's model serves one scene; JAX `vmap`s
  it). A B that runs out of device memory stops the sweep and is printed;
- `train_step_ms`, `train_steps_per_s` at the overfit config (2 views x 12
  frames x 64^2, 32 tracks, the narrow model, 3 iterations) and
  `train_step_ms_flagship` (`remat=True`, `remat_encoder=False`, 4
  iterations);
- `eval_fps_with_support_grids`: `EvaluationPredictor` with one 5x5 grid a
  view, 4 iterations, T over the fastest of 3 requests;
- `device` (the card's name) and `power_limit`, the launches of the five
  kernels and the dispatchers' calls in each part.

`vs_baseline` is None unless `--baseline PATH` names a JSON file with a
"value"; nothing is written unless `--out_json` names a file. With `--device
cpu` (the tests) every time, rate and share is None; counts, shapes and
outputs are still computed. `--small` runs narrow widths at 2 x 8 x 64^2
with 32 queries.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from scripts import timing_torch  # noqa: E402

PARTS = ("serving", "train", "eval")
ITERS, TRAIN_ITERS = 4, 3
# The overfit config of `bench.py`'s train step.
OVERFIT_MODEL = dict(sliding_window_len=8, fmaps_dim=64, num_heads=6, hidden_size=192, space_depth=3, time_depth=3,
                     num_virtual_tracks=16, corr_n_levels=3, corr_neighbors=8)
# `--small`: the narrow widths of the JAX profiling scripts' CPU smoke runs.
SMALL_MODEL = dict(sliding_window_len=8, fmaps_dim=32, num_heads=2, hidden_size=64, space_depth=2, time_depth=2,
                   num_virtual_tracks=8, corr_n_levels=2, corr_neighbors=4)


def configs(small: bool) -> dict:
    """Scene shapes (V, T, H, W, N) and model widths of the headline, the
    overfit train step and the flagship train step."""
    if small:
        return {"headline": ((2, 8, 64, 64, 32), SMALL_MODEL), "train": ((2, 8, 64, 64, 32), SMALL_MODEL),
                "flagship_train": ((2, 8, 64, 64, 32), SMALL_MODEL)}
    return {"headline": ((4, 24, 256, 256, 256), {}), "train": ((2, 12, 64, 64, 32), OVERFIT_MODEL),
            "flagship_train": ((4, 24, 256, 256, 256), {})}


def headline_scene(small: bool, rng=None):
    """The headline scene (numpy), the first draw of `bench.py`'s generator
    (seed 0)."""
    from mvtracker_torch.scene import make_scene

    return make_scene(np.random.default_rng(0) if rng is None else rng, *configs(small)["headline"][0])


def make_data(small: bool) -> dict:
    """The scenes and targets of `bench.py`, drawn from one generator in its
    order: the headline scene, the overfit scene and its targets, the
    flagship training scene and its targets (numpy)."""
    from mvtracker_torch.scene import make_scene

    cfg = configs(small)
    rng = np.random.default_rng(0)
    data = {"headline": headline_scene(small, rng)}
    for part in ("train", "flagship_train"):
        v, t, h, w, n = cfg[part][0]
        scene = make_scene(rng, v, t, h, w, n)
        data[part] = {
            "rgbs": scene[0][None], "depths": scene[1][None], "query_points": scene[2][None],
            "intrs": scene[3][None], "extrs": scene[4][None],
            "traj_gt": rng.normal(size=(1, t, n, 3)).astype(np.float32),
            "vis_gt": np.ones((1, t, n), np.float32), "valid": np.ones((1, t, n), np.float32),
        }
    return data


def build_model(widths: dict, device, state_dict=None, compute_dtype="bfloat16", **options):
    """An MVTracker of `widths` (bf16 unless said) with seeded weights (seed
    0) or `state_dict`."""
    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.models.mvtracker import MVTracker

    model = MVTracker(**widths, compute_dtype=compute_dtype, device=device, **options)
    model.load_state_dict(random_state_dict(model, seed=0) if state_dict is None else state_dict)
    return model


def forward(model, scene, iters: int = ITERS) -> dict:
    return model(*scene, iters=iters)


def knn_operations(shapes) -> int:
    """9 operations per (query, point) pair of every kNN call (B, N, M, k)."""
    return sum(9 * b * n * m for b, n, m, _ in shapes)


def corr_operations(shapes) -> int:
    """2 * C operations per neighbour of every correlation call (B, N, K, C)."""
    return sum(2 * b * n * k * c for b, n, k, c in shapes)


def forward_flops(model, scene, iters: int = ITERS) -> dict:
    """One forward's operations: {"dense": FlopCounterMode's count outside
    the kNN and correlation dispatchers, "knn", "corr", "total",
    "knn_shapes", "corr_shapes"}."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, timing_torch.counted(counter) as counts:
        forward(model, scene, iters)
    dense = counter.get_total_flops() - counts["flops_inside"]
    knn, corr = knn_operations(counts["knn_shapes"]), corr_operations(counts["corr_shapes"])
    return {"dense": dense, "knn": knn, "corr": corr, "total": dense + knn + corr,
            "knn_shapes": counts["knn_shapes"], "corr_shapes": counts["corr_shapes"]}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (cuda; cpu for the tests: no times)")
    p.add_argument("--small", action="store_true", help="narrow widths at 2 x 8 x 64^2, 32 queries")
    p.add_argument("--parts", default=",".join(PARTS), help=f"comma-separated parts of {PARTS}")
    p.add_argument("--warm", type=int, default=3, help="warm calls before the forward's timing")
    p.add_argument("--reps", type=int, default=10, help="calls in each of the two timed runs of a forward")
    p.add_argument("--batches", type=int, nargs="*", default=[2, 4, 8])
    p.add_argument("--batch_warm", type=int, default=3)
    p.add_argument("--batch_reps", type=int, default=6)
    p.add_argument("--train_warm", type=int, default=3)
    p.add_argument("--train_reps", type=int, default=8)
    p.add_argument("--flagship_train_reps", type=int, default=5)
    p.add_argument("--eval_reps", type=int, default=3)
    p.add_argument("--baseline", default=None, help="JSON file with a 'value' to report vs_baseline against")
    p.add_argument("--out_json", default=None)
    return p


def serving_part(args, cfg, data, device, report) -> None:
    import torch

    (v, t, h, w, n), widths = cfg["headline"]
    scene = [torch.as_tensor(a, device=device) for a in data["headline"]]
    model = build_model(widths, device)
    serving = build_model(widths, device, state_dict=model.state_dict(), corr_knn_reuse=True)
    with timing_torch.counted() as counts:
        step = timing_torch.lower_mean_ms(lambda: forward(model, scene), device, args.reps, args.warm)
        single = timing_torch.spread(timing_torch.host_ms(lambda: forward(model, scene), device, args.reps))
    flops = forward_flops(model, scene)
    with timing_torch.counted() as serving_counts:
        step_serving = timing_torch.lower_mean_ms(lambda: forward(serving, scene), device, args.reps, args.warm)
    report.update({
        "value": None if step is None else n * t / (step / 1e3),
        "fwd_ms": step,
        "fwd_ms_median": single["median"], "fwd_ms_min": single["min"], "fwd_ms_max": single["max"],
        "fwd_ms_serving": step_serving,
        "value_serving": None if step_serving is None else n * t / (step_serving / 1e3),
        "fwd_tflops": flops["total"] / 1e12,
        "fwd_tflops_parts": {key: flops[key] / 1e12 for key in ("dense", "knn", "corr")},
        "forward_kernel_calls": {"knn": len(flops["knn_shapes"]), "corr": len(flops["corr_shapes"])},
    })
    peak = timing_torch.bf16_peak(report["device"])
    if step is not None:
        report["achieved_tflops_s"] = flops["total"] / 1e12 / (step / 1e3)
        report["mfu"] = None if peak is None else flops["total"] / (step / 1e3) / peak
    report["launches"]["headline"] = counts["launches"]
    report["launches"]["serving"] = serving_counts["launches"]
    report["calls"]["headline"] = counts["calls"]
    report["calls"]["serving"] = serving_counts["calls"]

    for b in args.batches:
        def served():
            return [forward(serving, scene) for _ in range(b)]

        try:
            with timing_torch.counted() as batch_counts:
                sb = timing_torch.lower_mean_ms(served, device, args.batch_reps, args.batch_warm)
        except torch.cuda.OutOfMemoryError as e:
            print(f"bench_torch: B={b} ran out of device memory, the batched sweep stops there: {e}",
                  file=sys.stderr)
            report["batched_stopped_at"] = b
            break
        report[f"value_batched{b}"] = None if sb is None else b * n * t / (sb / 1e3)
        report["launches"][f"batched{b}"] = batch_counts["launches"]
    del model, serving


def train_part(args, cfg, data, device, report) -> None:
    import torch

    from mvtracker_torch.training import step as step_lib

    optimizer = step_lib.make_optimizer(total_steps=1000)
    for part, iters, reps, options, key in (
        ("train", TRAIN_ITERS, args.train_reps, {}, "train_step_ms"),
        ("flagship_train", ITERS, args.flagship_train_reps, {"remat": True, "remat_encoder": False},
         "train_step_ms_flagship"),
    ):
        model = build_model(cfg[part][1], device, **options)
        batch = {k: torch.as_tensor(a, device=device) for k, a in data[part].items()}
        state = step_lib.init_state(model, optimizer)
        train_step = step_lib.make_train_step(model, optimizer, iters=iters)
        losses = []

        def one_step():
            _, metrics = train_step(state, batch)
            losses.append(metrics["loss"])

        with timing_torch.counted() as counts:
            report[key] = timing_torch.lower_mean_ms(one_step, device, reps, args.train_warm)
        report["launches"][part] = counts["launches"]
        report["calls"][part] = counts["calls"]
        report[f"{part}_losses"] = [float(x) for x in losses]
        del model, state, train_step
    if report["train_step_ms"] is not None:
        report["train_steps_per_s"] = 1e3 / report["train_step_ms"]


def eval_part(args, cfg, data, device, report) -> None:
    import torch

    from mvtracker_torch.evaluation.predictor import EvaluationPredictor

    (v, t, h, w, n), widths = cfg["headline"]
    scene = [torch.as_tensor(a, device=device) for a in data["headline"]]
    predictor = EvaluationPredictor(build_model(widths, device), interp_shape=None, grid_size=5,
                                    n_grids_per_view=1, n_iters=ITERS)
    with timing_torch.counted() as counts:
        times = timing_torch.host_ms(lambda: predictor(*scene)["traj"].cpu(), device, args.eval_reps, warm=1)
    report["eval_fps_with_support_grids"] = None if times is None else t / (min(times) / 1e3)
    report["launches"]["eval"] = counts["launches"]
    report["calls"]["eval"] = counts["calls"]


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    parts = [p for p in args.parts.split(",") if p]
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise ValueError(f"unknown parts {sorted(unknown)}; of {PARTS}")

    from mvtracker_torch.device import resolve_device
    from mvtracker_torch.ops import _cuda

    device = resolve_device(args.device)
    if device.type == "cuda":
        _cuda.build_all()
    cfg = configs(args.small)
    v, t, h, w, n = cfg["headline"][0]
    report = {
        "metric": "tracked_point_frames_per_s_per_chip",
        "value": None,
        "unit": "point-frames/s",
        "vs_baseline": None,
        "fwd_ms": None, "fwd_ms_serving": None, "value_serving": None,
        "fwd_tflops": None, "achieved_tflops_s": None, "mfu": None,
        "device": None,
        "train_step_ms": None, "train_steps_per_s": None, "train_step_ms_flagship": None,
        "eval_fps_with_support_grids": None,
        **{f"value_batched{b}": None for b in args.batches},
        "power_limit": None,
        **timing_torch.card(device),
        "config": {"views": v, "frames": t, "height": h, "width": w, "queries": n, "iters": ITERS,
                   "small": args.small, "parts": parts},
        "point_frames": n * t,
        "batched_stopped_at": None,
        "launches": {}, "calls": {},
    }
    data = make_data(args.small)
    for part, run in (("serving", serving_part), ("train", train_part), ("eval", eval_part)):
        if part in parts:
            run(args, cfg, data, device, report)
    if args.baseline is not None and report["value"] is not None:
        with open(args.baseline) as f:
            report["vs_baseline"] = report["value"] / json.load(f)["value"]
    print(json.dumps(report))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
