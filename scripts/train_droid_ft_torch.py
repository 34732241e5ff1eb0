"""DROID-specialist fine-tune on the port (BASELINE config 4: training on
DROID data), the PyTorch counterpart of `scripts/train_droid_ft.py`, with its
arguments and printed JSON, and `--device` (default cuda) in place of
`--cpu`.

Warm-starts the released synthetic checkpoint (non-strict) and fine-tunes it
on synthetic DROID-format episodes made by the port's data factory
(`droid/synth_episode.build_episode`), consumed through the same loader and
trainer as every other dataset (`DroidTrainDataset` -> `PrefetchLoader` ->
`Trainer`). Episodes are world-scaled into the checkpoint's trained scale
(median depth 4.0), the adapter the DROID evaluation uses, so the fine-tuned
weights serve metric episodes through `scripts/eval_droid_track_error_torch.py`.
Every `--eval_every` steps (and at the end) the model is evaluated against
CopyCat on held-out monitor episodes (seeds 500 and up, 12 frames), built
under `<exp_dir>/monitor_episodes` unless they are there already; the log
goes to `<exp_dir>/eval_log.jsonl`. `--eval_root` is accepted for the JAX
script's command lines and, as there, not read.

    python scripts/train_droid_ft_torch.py --steps 4000 \
        --warm_start release/mvtracker_medium_synth.msgpack
"""

import argparse
import json
import logging
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--episodes_root", default="experiments/droid_synth_train/processed")
    p.add_argument("--eval_root", default="/tmp/droid_synth_eval")
    p.add_argument("--eval_episodes", type=int, default=2,
                   help="held-out episodes built on the fly for the in-train monitor (seeds 500+, disjoint from "
                        "both the train seeds and the reported 48-frame eval set)")
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--exp_dir", default="experiments/r5_droid_ft")
    p.add_argument("--model_size", choices=["small", "medium", "flagship"], default="medium")
    p.add_argument("--vis_geom", action="store_true", default=True)
    p.add_argument("--vis_head_hidden", type=int, default=128)
    p.add_argument("--warm_start", default="release/mvtracker_medium_synth.msgpack")
    p.add_argument("--feat_id_weight", type=float, default=0.5)
    p.add_argument("--vis_loss_weight", type=float, default=0.3)
    p.add_argument("--sync_every", type=int, default=8)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--watchdog_exit", action="store_true")
    p.add_argument("--watchdog_timeout", type=float, default=600.0)
    p.add_argument("--device", default="cuda", help="torch device to train and evaluate on")
    return p


def summary_of(result: dict) -> dict:
    return {m: round(v, 3) for m, v in result.get("all_any", {}).items() if isinstance(v, float)}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.watchdog_exit:
        from mvtracker_torch.utils.observability import install_hang_watchdog

        install_hang_watchdog(args.watchdog_timeout, exit=True)

    import torch

    from mvtracker_torch.datasets.droid import DroidTrainDataset
    from mvtracker_torch.datasets.loader import PrefetchLoader, compress_batch_for_transfer
    from mvtracker_torch.droid.synth_episode import build_episode
    from mvtracker_torch.evaluation.evaluator import Evaluator
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.models.copycat import CopyCatPredictor
    from mvtracker_torch.presets import build_model
    from mvtracker_torch.training.train import TrainConfig, Trainer

    model = build_model(args.model_size, vis_geom=args.vis_geom, vis_head_hidden=args.vis_head_hidden,
                        compute_dtype="float32", device=args.device)
    train_ds = DroidTrainDataset(args.episodes_root)
    logging.info("training on %d DROID episodes", len(train_ds))
    loader = PrefetchLoader(train_ds, batch_size=1, num_workers=args.workers, shuffle=True)

    # Held-out monitor episodes (the same 12-frame protocol, disjoint seeds),
    # scaled like the training set so metrics are in trained-world units.
    eval_dir = os.path.join(args.exp_dir, "monitor_episodes")
    for i in range(args.eval_episodes):
        build_episode(eval_dir, seed=500 + i, n_frames=12, n_external_cams=2)
    monitor_ds = DroidTrainDataset(os.path.join(eval_dir, "processed"))
    scenes = [monitor_ds[i] for i in range(len(monitor_ds))]

    cfg = TrainConfig(
        total_steps=args.steps,
        lr=args.lr,
        schedule="cos",
        warmup_steps=100,
        adaptive_iters=False,
        train_iters=3,
        save_ckpt_freq=args.save_every,
        watchdog_timeout_s=args.watchdog_timeout,
        watchdog_exit=args.watchdog_exit,
        visibility_loss_weight=args.vis_loss_weight,
        feat_id_loss_weight=args.feat_id_weight,
        sync_every=args.sync_every,
        warm_start_ckpt=args.warm_start,
        eval_freq=args.eval_every if args.eval_every else 10**9,
        telemetry_freq=200,
        exp_dir=args.exp_dir,
    )
    trainer = Trainer(model, cfg)

    evaluator = Evaluator("droid")
    copycat_res, _ = evaluator.evaluate_sequence(CopyCatPredictor(), scenes)
    copycat_summary = summary_of(copycat_res)
    logging.info("CopyCat monitor baseline: %s", copycat_summary)

    def eval_fn(state, step):
        pred = EvaluationPredictor(state.model, interp_shape=None, grid_size=0, n_iters=3)
        with torch.no_grad():
            res, _ = evaluator.evaluate_sequence(pred, scenes)
        entry = {"step": step, "ours": summary_of(res), "copycat": copycat_summary}
        logging.info(
            "monitor@%d: ATE %.2f AJ %.2f (CopyCat ATE %.2f AJ %.2f)", step,
            entry["ours"].get("ate_visible", float("nan")), entry["ours"].get("average_jaccard", float("nan")),
            copycat_summary.get("ate_visible", float("nan")), copycat_summary.get("average_jaccard", float("nan")),
        )
        with open(os.path.join(args.exp_dir, "eval_log.jsonl"), "a") as f:
            f.write(json.dumps(entry, default=float) + "\n")
        return entry["ours"]

    os.makedirs(args.exp_dir, exist_ok=True)
    data_iter = (compress_batch_for_transfer(b) for b in loader.prefetching_iter())
    state = trainer.fit(data_iter, max_steps=args.steps, eval_fn=eval_fn)
    final = eval_fn(state, args.steps)
    report = {"steps": args.steps, "ours": final, "copycat": copycat_summary}
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
