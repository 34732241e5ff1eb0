"""Evaluate released weights on held-out synthetic scenes against CopyCat,
the port's counterpart of `scripts/eval_checkpoint.py` with the same flags
and the same JSON layout.

    python -m mvtracker_torch.cli.eval_checkpoint \\
        --params_msgpack release/mvtracker_medium_synth.msgpack \\
        --model_size medium --vis_geom --vis_head_hidden 128 --fp32 \\
        --views 4 --res 128 --iters 3 --grid 0 --interp 128 \\
        --texture_detail 1.0 --texture_noise 1.0

The protocol: the weights are loaded strictly (`convert.load_release`), the
visibility threshold is calibrated on a calibration split (seed 555) and
applied to the held-out split (seed 777), so no reported number is tuned on
the scenes it is reported on; CopyCat, the no-motion baseline, is scored on
the same held-out scenes. The model runs on `--device` (default cuda, which
raises without a GPU). With `--fp32` the GPU's convolutions and matmuls
round as fp32 (TF32 off), as the JAX package's CPU reference computes.

The weights come from `--params_msgpack` (a flax msgpack params file), or
else from the trainer's checkpoints under `<exp_dir>/checkpoints`: the one
of `--step`, or the newest with `--step 0`, as the JAX script restores
them. The port reads its own `torch.save` checkpoints (`training/train.py`);
the JAX trainer's orbax trees are not read.
"""

from __future__ import annotations

import argparse
import json
import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from mvtracker_torch.convert import load_release
from mvtracker_torch.datasets.loader import SyntheticSceneDataset
from mvtracker_torch.device import fp32_precision
from mvtracker_torch.evaluation.evaluator import Evaluator, to_host
from mvtracker_torch.evaluation.predictor import EvaluationPredictor
from mvtracker_torch.models.copycat import CopyCatPredictor
from mvtracker_torch.presets import build_model
from mvtracker_torch.training import step as step_lib
from mvtracker_torch.training.train import TrainConfig, Trainer


class _ReThreshold:
    """Replays cached (traj, vis) per sequence with another visibility
    threshold, so one model run serves a whole threshold sweep."""

    jit_compatible = False

    def __init__(self, outputs: dict, threshold: float):
        self._outputs = outputs
        self._th = threshold
        self._seq = None

    def set_sequence(self, seq_name):
        self._seq = seq_name

    def __call__(self, *args, **kwargs):
        traj, vis = self._outputs[self._seq]
        return {"traj": traj, "vis": vis, "occluded": vis < self._th}


def run_predictor(predictor, scenes) -> dict:
    """One model run per scene -> {seq_name: (traj, vis)} as host arrays."""
    out = {}
    for dp in scenes:
        res = predictor(
            np.asarray(dp.video, np.float32),
            np.asarray(dp.videodepth, np.float32),
            np.asarray(dp.query_points_3d, np.float32),
            np.asarray(dp.intrs, np.float32),
            np.asarray(dp.extrs, np.float32),
        )
        out[dp.seq_name] = (to_host(res["traj"]), to_host(res["vis"]))
    return out


def sweep_thresholds(evaluator, outputs, scenes, thresholds) -> dict:
    """AJ, OA and the other float metrics per threshold from cached outputs."""
    rows = {}
    for th in thresholds:
        res, _ = evaluator.evaluate_sequence(_ReThreshold(outputs, th), scenes)
        rows[th] = {k: round(v, 3) for k, v in res["all_any"].items() if isinstance(v, float)}
    return rows


def parse_interp(s: str):
    """'0' = native, '192' = square, '384x512' = (H, W)."""
    if "x" in s:
        h, w = s.split("x")
        return (int(h), int(w))
    px = int(s)
    return (px, px) if px else None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--exp_dir", default=None,
                        help="experiment directory whose checkpoints to evaluate (without --params_msgpack)")
    parser.add_argument("--model_size", choices=["small", "medium", "flagship"], default="medium")
    parser.add_argument("--eval_scenes", type=int, default=8)
    parser.add_argument("--calib_scenes", type=int, default=8)
    parser.add_argument("--views", type=int, default=4)
    parser.add_argument("--res", type=int, default=128)
    parser.add_argument("--frames", type=int, default=12)
    parser.add_argument("--n_tracks", type=int, default=32)
    parser.add_argument("--texture_detail", type=float, default=1.0)
    parser.add_argument("--texture_noise", type=float, default=0.0)
    parser.add_argument("--iters", type=int, nargs="+", default=[3])
    parser.add_argument("--grid", type=int, nargs="+", default=[0, 5])
    parser.add_argument("--interp", type=str, nargs="+", default=["0"],
                        help="input resize sweep: square px ('192') or HxW ('384x512'); 0 = native")
    parser.add_argument("--vis_geom", action="store_true")
    parser.add_argument("--knn_reuse", action="store_true", help="one kNN per window, reused by every iteration")
    parser.add_argument("--vis_head_hidden", type=int, default=0)
    parser.add_argument("--fp32", action="store_true", help="float32 compute (bf16 is the serving path)")
    parser.add_argument("--corr_k0", type=int, default=0, help="neighbours at the finest level (0: uniform k)")
    parser.add_argument("--global_match", action="store_true", help="global soft-match window init")
    parser.add_argument("--chain_velocity", type=float, default=0.0,
                        help="constant-velocity init of a chained window's new frames (0: static copy)")
    parser.add_argument("--thresholds", type=float, nargs="+", default=[0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.5])
    parser.add_argument("--step", type=int, default=0, help="checkpoint step to restore (0 = latest)")
    parser.add_argument("--params_msgpack", default="",
                        help="flax msgpack params file to evaluate instead of a checkpoint of --exp_dir")
    parser.add_argument("--out_json", default=None)
    parser.add_argument("--device", default="cuda")
    return parser


@dataclass
class Result:
    """What one protocol run gives: the JSON rows the script prints, the
    model outputs per setting and split ({key: {"calib"|"heldout":
    {seq_name: (traj, vis)}}}) and the scenes of both splits."""

    rows: dict
    outputs: dict = field(default_factory=dict)
    scenes: dict = field(default_factory=dict)


def build(args: argparse.Namespace):
    """The untrained model the flags describe, on `--device`, in eval mode."""
    over = {"compute_dtype": "float32"} if args.fp32 else {}
    return build_model(
        args.model_size, vis_geom=args.vis_geom, vis_head_hidden=args.vis_head_hidden, corr_k0=args.corr_k0,
        global_match=args.global_match, chain_velocity=args.chain_velocity, knn_reuse=args.knn_reuse,
        device=args.device, **over,
    ).eval()


def run(args: argparse.Namespace) -> Result:
    """The protocol on the weights of `--params_msgpack`, or of the
    checkpoint of `--exp_dir` at `--step` (0: the newest)."""
    if not args.params_msgpack and not args.exp_dir:
        raise ValueError("pass --params_msgpack or --exp_dir")
    model = build(args)
    if args.params_msgpack:
        # Strict: a model built with other flags than the file's raises here
        # instead of reporting metrics of half-random weights.
        load_release(args.params_msgpack, model)
        step = -1
    else:
        step = restore_checkpoint(model, args.exp_dir, args.step)
    result = protocol(model, args)
    result.rows["checkpoint_step"] = step
    return result


def restore_checkpoint(model, exp_dir: str, step: int) -> int:
    """Load the trainer's checkpoint of `step` (0: the newest) from
    `<exp_dir>/checkpoints` into `model` (strictly); returns its step."""
    trainer = Trainer(model, TrainConfig(exp_dir=exp_dir, tensorboard=False, watchdog_timeout_s=0))
    steps = trainer.checkpoint_steps()
    if not steps:
        ckpt_dir = Path(trainer.ckpt_dir)
        orbax = ckpt_dir.is_dir() and any(p.is_dir() and p.name.isdigit() for p in ckpt_dir.iterdir())
        raise FileNotFoundError(
            f"no checkpoint of the port's trainer (step_<n>.pt) in {ckpt_dir}"
            + ("; it holds an orbax checkpoint tree of the JAX trainer, which the port does not read" if orbax else "")
        )
    step = step or steps[-1]
    if step not in steps:
        raise FileNotFoundError(f"no checkpoint of step {step} in {trainer.ckpt_dir} (it has {steps})")
    trainer.restore(step_lib.init_state(model, trainer.optimizer), step)
    model.eval()
    return step


def protocol(model, args: argparse.Namespace) -> Result:
    """The protocol on `model`; with `--fp32`, TF32 off while it runs."""
    with fp32_precision(exact=args.fp32):
        return evaluate(model, args)


def evaluate(model, args: argparse.Namespace) -> Result:
    """The protocol on `model`, at the precision the process has set."""
    scene_kw = dict(
        n_views=args.views, n_frames=args.frames, height=args.res, width=args.res, n_tracks=args.n_tracks,
        texture_detail=args.texture_detail, texture_noise=args.texture_noise,
    )
    calib_ds = SyntheticSceneDataset(n_scenes=args.calib_scenes, cache=True, seed=555, randomize=True, **scene_kw)
    eval_ds = SyntheticSceneDataset(n_scenes=args.eval_scenes, cache=True, seed=777, randomize=True, **scene_kw)
    calib = [calib_ds[i] for i in range(args.calib_scenes)]
    scenes = [eval_ds[i] for i in range(args.eval_scenes)]

    evaluator = Evaluator("kubric-multiview")
    copycat, _ = evaluator.evaluate_sequence(CopyCatPredictor(), scenes)
    rows = {
        "checkpoint_step": -1,
        "eval_domain": {"res": args.res, "views": args.views, "frames": args.frames, "n_tracks": args.n_tracks,
                        "texture_detail": args.texture_detail},
        "copycat": {k: round(v, 3) for k, v in copycat["all_any"].items() if isinstance(v, float)},
    }
    result = Result(rows, scenes={"calib": calib, "heldout": scenes})
    best = None  # (aj, iters, grid, threshold, interp)
    for it in args.iters:
        for g in args.grid:
            for interp_s in args.interp:
                shape = parse_interp(interp_s)
                interp = interp_s if shape else 0
                p = EvaluationPredictor(model, interp_shape=shape, grid_size=g, n_iters=it, device=args.device)
                calib_out = run_predictor(p, calib)
                calib_rows = sweep_thresholds(evaluator, calib_out, calib, args.thresholds)
                th_best = max(args.thresholds, key=lambda th: calib_rows[th]["average_jaccard"])
                heldout_out = run_predictor(p, scenes)
                heldout_rows = sweep_thresholds(evaluator, heldout_out, scenes, [0.5, th_best])
                key = f"iters{it}_grid{g}" + (f"_interp{interp}" if interp else "")
                rows[key] = {
                    "calib_threshold_sweep": calib_rows,
                    "calibrated_threshold": th_best,
                    "heldout_at_0.5": heldout_rows[0.5],
                    "heldout_calibrated": heldout_rows[th_best],
                }
                result.outputs[key] = {"calib": calib_out, "heldout": heldout_out}
                r = heldout_rows[th_best]
                logging.info(
                    "%s th=%.2f: ATE %.2f AJ %.2f OA %.2f (CopyCat ATE %.2f AJ %.2f OA %.2f)", key, th_best,
                    r["ate_visible"], r["average_jaccard"], r["occlusion_accuracy"], rows["copycat"]["ate_visible"],
                    rows["copycat"]["average_jaccard"], rows["copycat"]["occlusion_accuracy"],
                )
                if best is None or r["average_jaccard"] > best[0]:
                    best = (r["average_jaccard"], it, g, th_best, interp)
    rows["best"] = {"average_jaccard": best[0], "iters": best[1], "grid": best[2], "threshold": best[3],
                    "interp": best[4]}
    return result


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    with torch.no_grad():
        rows = run(args).rows
    print(json.dumps(rows, indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
