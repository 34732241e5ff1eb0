"""BASELINE north star on the port: median 3D track error (meters) on DROID
evaluation episodes, the PyTorch counterpart of
`scripts/eval_droid_track_error.py`, with its arguments, `--out_json` layout
and last printed line, and `--device` (default cuda) in place of `--cpu`.

One command, end to end: synthesizes DROID-format episodes (FK gripper-track
ground truth from the port's `droid/pipeline.process_episode`, ray-traced
recordings in the episode layout, `droid/synth_episode.py`), runs the
released checkpoint through the episode path (`datasets/droid.py` -> FFV1
depth decode -> `EvaluationPredictor`) in the checkpoint's trained world
scale, and reports:

  - median_3d_track_error_m: median over all tracks (pooled across
    episodes) of the per-track median 3D error over visible frames (the
    reference's `mte_visible_per_track`), in meters;
  - the metric-threshold evaluator summary (DROID thresholds 0.01-0.2 m);
  - per-episode fps (steady state, the first call of a shape excluded);
  - the same numbers for CopyCat (no motion) as the floor.

    python scripts/eval_droid_track_error_torch.py \
        --params_msgpack release/mvtracker_medium_synth.msgpack \
        --model_size medium --vis_geom --vis_head_hidden 128 --fp32 \
        --out_json RESULTS_droid_synth_torch.json

fp32 runs with TF32 off (`device.fp32_precision`), as `cli/eval_checkpoint.py`
does. Episodes are cached under --root.
"""

import argparse
import json
import logging
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="/tmp/droid_synth_eval")
    p.add_argument("--episodes", type=int, default=4)
    p.add_argument("--frames", type=int, default=48)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--external_cams", type=int, default=2)
    p.add_argument("--no_wrist", action="store_true",
                   help="external cameras only (the wrist view is the hardest: it rides the EE, so the gripper is "
                        "near-static in-frame while the world moves)")
    p.add_argument("--track_points", type=int, default=24)
    p.add_argument("--cams", nargs="*", default=None,
                   help="restrict eval to these camera ids (e.g. 100 101 to exclude the moving wrist view from "
                        "already-rendered episodes)")
    p.add_argument("--params_msgpack", default="release/mvtracker_medium_synth.msgpack")
    p.add_argument("--model_size", choices=["small", "medium", "flagship"], default="medium")
    p.add_argument("--vis_geom", action="store_true", default=True)
    p.add_argument("--no_vis_geom", dest="vis_geom", action="store_false")
    p.add_argument("--vis_head_hidden", type=int, default=128)
    p.add_argument("--fp32", action="store_true", default=True)
    p.add_argument("--bf16", dest="fp32", action="store_false")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--grid", type=int, default=0)
    p.add_argument("--interp", type=int, nargs=2, default=None, help="eval-time resize HxW (default: native)")
    p.add_argument("--knn_reuse", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device of the model (cuda, or cpu)")
    p.add_argument("--world_scale", default="auto",
                   help="similarity-transform the metric episode into the checkpoint's trained world scale before "
                        "inference and invert on the way out ('auto' = target median depth 4.0 [the synthetic "
                        "training domain's camera distance] / episode median depth; a number = fixed scale; 1 = "
                        "off). The reference's in-forward normalization clamps all depth below 24 up to 24 and is "
                        "useless at tabletop scale.")
    p.add_argument("--out_json", default="RESULTS_droid_synth.json")
    return p


class ScaledPredictor:
    """Runs the model in its trained world scale: depths, camera
    translations and query xyz are multiplied by S on the way in, predicted
    trajectories divided by S on the way out (on the host). A similarity
    transform: pixels, intrinsics and rotations are untouched, so the image
    content is identical."""

    def __init__(self, inner, scale):
        self.inner, self.s = inner, float(scale)

    def __call__(self, video, videodepth, queries, intrs, extrs):
        from mvtracker_torch.evaluation.evaluator import to_host

        s = self.s
        ex = np.array(extrs, copy=True)
        ex[..., :3, 3] *= s
        q = np.array(queries, copy=True)
        q[..., 1:4] *= s
        out = dict(self.inner(video, np.asarray(videodepth) * s, q, intrs, ex))
        out["traj"] = to_host(out["traj"]) / s
        return out


def build_scenes(args) -> list:
    """Build (or find cached) the episodes and load them as Datapoints."""
    from mvtracker_torch.datasets.droid import DroidEpisodeDataset
    from mvtracker_torch.droid.synth_episode import build_episode

    for seed in range(args.episodes):
        out = build_episode(args.root, seed=seed, n_frames=args.frames, n_external_cams=args.external_cams,
                            width=args.width, height=args.height, num_track_points=args.track_points,
                            include_wrist=not args.no_wrist)
        logging.info("episode ready: %s", out)
    ds = DroidEpisodeDataset(os.path.join(args.root, "processed"), cams=args.cams or None)
    return [ds[i] for i in range(len(ds))]


def load_model(args, device):
    """The preset model with the script's flags on `device`, the checkpoint
    loaded strictly (mismatched model flags raise rather than score
    half-random weights)."""
    from mvtracker_torch.presets import build_model
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import TrainConfig, Trainer

    over = {"compute_dtype": "float32"} if args.fp32 else {}
    model = build_model(args.model_size, vis_geom=args.vis_geom, vis_head_hidden=args.vis_head_hidden,
                        knn_reuse=args.knn_reuse, device=device, **over)
    trainer = Trainer(model, TrainConfig(exp_dir=os.path.join(args.root, "exp"), tensorboard=False,
                                         watchdog_timeout_s=0))
    trainer.warm_start(step_lib.init_state(model, trainer.optimizer), args.params_msgpack, strict=True)
    return model.eval()


def world_scale(args, scenes) -> float:
    if args.world_scale == "auto":
        med = float(np.median(np.concatenate([dp.videodepth[dp.videodepth > 0].ravel() for dp in scenes])))
        return 4.0 / med
    return float(args.world_scale)


def model_predictor(args, model, scale):
    """The model's predictor, wrapped in the world scale unless it is 1."""
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor

    base = EvaluationPredictor(model, interp_shape=tuple(args.interp) if args.interp else None,
                               grid_size=args.grid, n_iters=args.iters)
    return ScaledPredictor(base, scale) if scale != 1.0 else base


def track_error(evaluator, predictor, scenes, name) -> dict:
    """The evaluator's summary plus the pooled per-track median 3D error, in meters."""
    from mvtracker_torch.evaluation import metrics as metrics_lib
    from mvtracker_torch.evaluation.evaluator import to_host

    summary, _ = evaluator.evaluate_sequence(predictor, scenes)
    per_track_mte = []
    for dp in scenes:
        pred = predictor(np.asarray(dp.video, np.float32), np.asarray(dp.videodepth, np.float32),
                         np.asarray(dp.query_points_3d, np.float32), np.asarray(dp.intrs, np.float32),
                         np.asarray(dp.extrs, np.float32))
        m = metrics_lib.compute_metrics(
            np.asarray(dp.query_points_3d, np.float32)[None],
            ~dp.visibility.any(axis=0)[None],
            dp.trajectory_3d[None].astype(np.float32),
            to_host(pred["occluded"])[None],
            to_host(pred["traj"]).astype(np.float32)[None],
            distance_thresholds=evaluator.thresholds["distance_thresholds"],
            survival_distance_threshold=evaluator.thresholds["survival_distance_threshold"],
        )
        per_track_mte.append(np.asarray(m["mte_visible_per_track"])[0])
    pooled = np.concatenate(per_track_mte)
    out = {
        "median_3d_track_error_m": float(np.median(pooled)),
        "mean_3d_track_error_m": float(pooled.mean()),
        "p90_3d_track_error_m": float(np.percentile(pooled, 90)),
        "fps": summary["fps"],
        "summary_all_any": {k: round(v, 3) for k, v in summary.get("all_any", {}).items() if isinstance(v, float)},
    }
    logging.info("%s: median 3D track error %.4f m (mean %.4f, p90 %.4f), fps %.2f", name,
                 out["median_3d_track_error_m"], out["mean_3d_track_error_m"], out["p90_3d_track_error_m"], out["fps"])
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch

    from mvtracker_torch.device import fp32_precision, resolve_device
    from mvtracker_torch.evaluation.evaluator import Evaluator
    from mvtracker_torch.models.copycat import CopyCatPredictor

    device = resolve_device(args.device)
    scenes = build_scenes(args)
    model = load_model(args, device)
    scale = world_scale(args, scenes)
    logging.info("world scale for inference: %.3f", scale)
    evaluator = Evaluator("droid")
    with torch.no_grad(), fp32_precision(exact=args.fp32):
        results = {
            "protocol": {
                "episodes": args.episodes, "frames": args.frames,
                "cams": args.external_cams + (0 if args.no_wrist else 1),
                "resolution": [args.height, args.width],
                "track_points_per_finger": args.track_points,
                "queries": "gripper (FK contact points, frame 0)",
                "checkpoint": args.params_msgpack,
                "iters": args.iters, "grid": args.grid,
                "interp": args.interp, "backend": device.type,
                "world_scale": scale,
            },
            "copycat": track_error(evaluator, CopyCatPredictor(), scenes, "copycat"),
            "ours": track_error(evaluator, model_predictor(args, model, scale), scenes, "ours"),
        }
    with open(args.out_json, "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(json.dumps({
        "median_3d_track_error_m": results["ours"]["median_3d_track_error_m"],
        "copycat_median_m": results["copycat"]["median_3d_track_error_m"],
        "fps": results["ours"]["fps"],
    }))
    return results


if __name__ == "__main__":
    main()
