"""Evaluation CLI: ``python -m mvtracker_torch.cli.eval [--config X] [k=v ...]``,
the counterpart of `mvtracker_tpu/cli/eval.py` with the same arguments and
`--device` (default cuda).

Restores the newest checkpoint of `trainer.exp_dir` (the port's
`torch.save` files under `<exp_dir>/checkpoints`; the initial weights with
a warning when there is none) into the model, or into the learned 2D
tracker inside `cotracker2d`'s adapter, and evaluates over the configured
dataset, printing the summary as JSON. It evaluates on one device and
reads no mesh setting, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import logging


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--output", default=None, help="summary JSON path")
    parser.add_argument("--device", default="cuda", help="torch device to evaluate on")
    parser.add_argument("overrides", nargs="*")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    import torch

    from mvtracker_torch.cli.train import trainable_module
    from mvtracker_torch.config import build_dataset, build_model, load_config
    from mvtracker_torch.evaluation.evaluator import Evaluator
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import Trainer

    cfg = load_config(args.config, args.overrides)
    model = build_model(cfg.model, device=args.device)
    dataset = build_dataset(cfg.data)

    module = trainable_module(model)
    if module is not None:  # CopyCat, the NCC tracker and the hub wrappers have no checkpoint
        trainer = Trainer(module, cfg.trainer)
        if trainer.latest_step() is None:
            logging.warning("no checkpoint found in %s; evaluating the initial weights", trainer.ckpt_dir)
        else:
            _, step = trainer.restore_latest(step_lib.init_state(module, trainer.optimizer))
            logging.info("evaluating checkpoint at step %d", step)
        module.eval()

    predictor = EvaluationPredictor(
        model,
        interp_shape=tuple(cfg.eval.interp_shape) if cfg.eval.interp_shape else None,
        visibility_threshold=cfg.eval.visibility_threshold,
        grid_size=cfg.eval.grid_size,
        n_grids_per_view=cfg.eval.n_grids_per_view,
        num_uniformly_sampled_pts=cfg.eval.num_uniformly_sampled_pts,
        n_iters=cfg.eval.n_iters,
        device=args.device,
    )
    evaluator = Evaluator(
        cfg.eval.setting,
        compute_2d_metrics=bool(getattr(dataset, "mode_2d", False)) or "-2dpt" in cfg.data.dataset,
        query_mode=getattr(dataset, "query_mode", "first"),
    )
    with torch.no_grad():
        summary, per_seq = evaluator.evaluate_sequence(predictor, dataset, max_sequences=cfg.eval.max_sequences)
    print(json.dumps(summary, indent=2, default=float))
    if args.output:
        evaluator.save_json(summary, args.output)
        evaluator.save_csv(per_seq, args.output.replace(".json", "_per_seq.csv"))
    return summary


if __name__ == "__main__":
    main()
