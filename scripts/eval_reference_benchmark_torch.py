"""One-command reference-benchmark runner on the port: a downloaded benchmark
root and a checkpoint -> the dataset-name DSL (`datasets/real_world.py`) ->
`Evaluator` -> CSV and JSON, the reference README's metric table printed.
The PyTorch counterpart of `scripts/eval_reference_benchmark.py`: the same
arguments, table and printed JSON, plus `--device` (default cuda).

    python scripts/eval_reference_benchmark_torch.py \
        --dataset kubric-multiview-views0123 \
        --dataset_root /data/benchmarks \
        --checkpoint weights/mvtracker_200000_june2025.pth

The data layout under --dataset_root is the reference's download layout:
`kubric-multiview/<split>/<scene>/`, `panoptic-multiview/<scene>/`,
`dex-ycb-multiview/<scene>/` (see `scripts/eval_reference_benchmark.py`).

The checkpoint may be the reference torch release (`.pth`, its names the
port's own, read as a state dict; a training checkpoint's "model" entry is
taken), with `--model_size reference` (the default: the reference's
published architecture), a port checkpoint (`.pt`), or a flax msgpack
params file (this repo's release or an export) with the matching
`--model_size` and flags. Loads are strict: a checkpoint that does not match
the model raises instead of evaluating half-initialized weights.
"""

import argparse
import json
import logging
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_eval_model(model_size: str, **knobs):
    if model_size == "reference":
        # The reference's published architecture: S=12, fmaps 128, 6+6
        # depth, 64 virtual tracks, 4 corr levels x k=16 (= MVTracker's
        # defaults), bf16 compute like the reference's bf16-mixed eval.
        from mvtracker_torch.models.mvtracker import MVTracker

        return MVTracker(compute_dtype="bfloat16", **knobs)
    from mvtracker_torch.presets import build_model

    return build_model(model_size, **knobs)


def setting_for_dataset(name: str) -> str:
    for prefix in ("kubric-multiview", "dexycb-multiview", "panoptic-multiview"):
        if name.startswith(prefix):
            return prefix
    raise ValueError(f"no evaluation setting for dataset {name!r}")


def run(args) -> dict:
    import torch

    from mvtracker_torch.datasets.real_world import dataset_from_name
    from mvtracker_torch.evaluation.evaluator import Evaluator
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.models.copycat import CopyCatPredictor
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import TrainConfig, Trainer

    dataset = dataset_from_name(args.dataset, args.dataset_root)
    setting = setting_for_dataset(args.dataset)
    evaluator = Evaluator(setting, compute_2d_metrics=args.metrics_2d)
    model = build_eval_model(args.model_size, vis_geom_features=args.vis_geom, vis_head_hidden=args.vis_head_hidden,
                             corr_knn_reuse=args.knn_reuse, device=args.device)
    trainer = Trainer(model, TrainConfig(exp_dir=args.scratch_dir, tensorboard=False, watchdog_timeout_s=0))
    trainer.warm_start(step_lib.init_state(model, trainer.optimizer), args.checkpoint, strict=True)
    model.eval()

    interp = tuple(args.interp) if args.interp and args.interp[0] > 0 else None
    predictor = EvaluationPredictor(model, interp_shape=interp, grid_size=args.grid, n_iters=args.iters,
                                    visibility_threshold=args.visibility_threshold)
    with torch.no_grad():
        summary, per_seq = evaluator.evaluate_sequence(predictor, dataset, max_sequences=args.max_sequences or None)
    result = {
        "dataset": args.dataset,
        "setting": setting,
        "checkpoint": args.checkpoint,
        "interp": interp,
        "iters": args.iters,
        "grid": args.grid,
        "summary": summary,
    }
    if args.with_copycat:
        cc_summary, _ = evaluator.evaluate_sequence(CopyCatPredictor(), dataset,
                                                    max_sequences=args.max_sequences or None)
        result["copycat"] = cc_summary
    if args.out_json:
        evaluator.save_json(result, args.out_json)
    if args.out_csv:
        evaluator.save_csv(per_seq, args.out_csv)
    return result


def format_table(result: dict) -> str:
    """The reference README's metric rows, one column per summary group."""
    groups = result["summary"]
    keys = [
        ("ate_visible", "ATE-visible"),
        ("mte_visible", "MTE-visible"),
        ("average_jaccard", "Average Jaccard"),
        ("average_pts_within_thresh", "avg pts-within-thresh"),
        ("occlusion_accuracy", "Occlusion accuracy"),
        ("survival", "Survival"),
    ]
    shown = [g for g in groups if g.startswith("all_") or g == "dynamic_static_mean"]
    rows = [f"{'metric':<24}" + "".join(f"{g:>16}" for g in shown)]
    for k, label in keys:
        cells = []
        for g in shown:
            v = groups[g].get(k) if isinstance(groups[g], dict) else None
            cells.append(f"{v:16.2f}" if isinstance(v, float) else f"{'-':>16}")
        rows.append(f"{label:<24}" + "".join(cells))
    return "\n".join(rows)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   help="dataset-name DSL, e.g. kubric-multiview-views0123, panoptic-multiview-views27_16_14_8, "
                        "dexycb-multiview")
    p.add_argument("--dataset_root", required=True,
                   help="parent dir holding kubric-multiview/ panoptic-multiview/ dex-ycb-multiview/")
    p.add_argument("--checkpoint", required=True,
                   help=".pth (reference torch release) or .pt (port checkpoint) or .msgpack (flax params)")
    p.add_argument("--model_size", default="reference", choices=["reference", "flagship", "medium", "small"])
    p.add_argument("--interp", type=int, nargs=2, default=[384, 512],
                   help="eval-time resize H W (the reference always evaluates through 384x512); '0 0' = native")
    p.add_argument("--iters", type=int, default=6, help="refinement iterations (reference eval default)")
    p.add_argument("--grid", type=int, default=5, help="support-grid size per view (0 disables)")
    p.add_argument("--visibility_threshold", type=float, default=0.5)
    p.add_argument("--vis_geom", action="store_true")
    p.add_argument("--vis_head_hidden", type=int, default=0)
    p.add_argument("--knn_reuse", action="store_true", help="serving mode (corr_knn_reuse)")
    p.add_argument("--metrics_2d", action="store_true", help="also compute per-view 2D TAP-Vid metrics")
    p.add_argument("--max_sequences", type=int, default=0, help="0 = all")
    p.add_argument("--with_copycat", action="store_true", help="also run the no-motion baseline for context")
    p.add_argument("--scratch_dir", default="/tmp/eval_reference_benchmark")
    p.add_argument("--out_json", default=None)
    p.add_argument("--out_csv", default=None)
    p.add_argument("--device", default="cuda", help="torch device of the model (cuda, or cpu)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    result = run(args)
    print(format_table(result))
    print(json.dumps({k: v for k, v in result.items() if k != "summary"}, indent=2))
    return result


if __name__ == "__main__":
    main()
