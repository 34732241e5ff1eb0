"""Generalization training on the port: train on N synthetic scenes, evaluate
on held-out scenes against CopyCat. The PyTorch counterpart of
`scripts/train_synthetic.py`: the same arguments, defaults, data, schedule,
evaluation log and printed JSON, plus `--device` (default cuda).

    python scripts/train_synthetic_torch.py --steps 8000
"""

import argparse
import json
import logging
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8000)
    parser.add_argument("--train_scenes", type=int, default=16)
    parser.add_argument("--eval_scenes", type=int, default=4)
    parser.add_argument("--exp_dir", default="/tmp/train_synth")
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--out_json", default=None)
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--motion_speed", type=float, default=1.0)
    parser.add_argument("--static_fraction", type=float, default=-1.0,
                        help="fraction of static objects per scene (-1 = randomized 0..0.5 per scene). 0 + high "
                             "--motion_speed = the identity-escape curriculum: every track moves, so the no-motion "
                             "attractor is maximally penalized")
    parser.add_argument("--rotate", action="store_true")
    parser.add_argument("--valid_vis", action="store_true", help="supervise only any-view-visible track entries")
    parser.add_argument("--views", type=int, default=2)
    parser.add_argument("--res", type=int, default=64)
    parser.add_argument("--focal", type=float, default=1.0)
    parser.add_argument("--texture_detail", type=float, default=0.0,
                        help="high-frequency texture bands (0=historical smooth bands; ~1.0 makes surface points "
                             "localizable)")
    parser.add_argument("--texture_noise", type=float, default=0.0,
                        help="hashed value-noise texture weight (non-periodic, localizable in all surface directions)")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--eval_every", type=int, default=0,
                        help="periodic held-out eval vs CopyCat every N steps (appended to <exp_dir>/eval_log.jsonl); "
                             "0 disables")
    parser.add_argument("--model_size", choices=["small", "medium", "flagship"], default="small",
                        help="small: the historical smoke config; medium: 2x width/depth for longer fresh-scene runs; "
                             "flagship: reference-width (fmaps 128, depth 6+6, 64 virtual tracks, k=16, 4 corr levels)")
    parser.add_argument("--vis_geom", action="store_true",
                        help="feed per-view depth z-test features into the visibility head (vis_geom_features)")
    parser.add_argument("--vis_head_hidden", type=int, default=0,
                        help="hidden width of the visibility head MLP (0 = reference single Linear)")
    parser.add_argument("--corr_k0", type=int, default=0,
                        help="neighbor count at the FINEST correlation level (0 = uniform preset k; widened "
                             "fine-level coverage for high-res motion, warm-start-migrated)")
    parser.add_argument("--global_match", action="store_true",
                        help="global soft-match window init (whole-scene capture range; enable once features are "
                             "trained)")
    parser.add_argument("--chain_velocity", type=float, default=0.0,
                        help="constant-velocity extrapolation factor for the chained window init (0 = reference "
                             "static copy)")
    parser.add_argument("--n_tracks", type=int, default=32)
    parser.add_argument("--frames", type=int, default=12)
    parser.add_argument("--watchdog_exit", action="store_true",
                        help="hard-kill the process after a watchdog hang dump (for a supervisor that restarts it "
                             "from the newest checkpoint)")
    parser.add_argument("--watchdog_timeout", type=float, default=600.0)
    parser.add_argument("--warm_start", default="",
                        help="msgpack/pth weights to warm-start from (non-strict merge; TrainConfig.warm_start_ckpt)")
    parser.add_argument("--no_adaptive", action="store_true",
                        help="fixed train_iters every step (the adaptive mix alternates the iteration count)")
    parser.add_argument("--sync_every", type=int, default=1,
                        help="device-sync (loss fetch) cadence; >1 lets the host run ahead of the device "
                             "(TrainConfig.sync_every)")
    parser.add_argument("--save_every", type=int, default=0, help="checkpoint frequency override (0 = auto)")
    parser.add_argument("--fp32", action="store_true",
                        help="override the preset's compute dtype to float32 (bf16 ablation)")
    parser.add_argument("--feat_id_weight", type=float, default=0.0,
                        help="aux contrastive point-identity loss on encoder features (losses.feature_identity_loss)")
    parser.add_argument("--vis_loss_weight", type=float, default=0.1,
                        help="visibility BCE weight (reference configs/train.yaml:44 uses 0.1)")
    parser.add_argument("--device", default="cuda", help="torch device to train and evaluate on")
    return parser


def rounded(summary: dict) -> dict:
    return {m: round(v, 3) for m, v in summary.items() if isinstance(v, float)}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.watchdog_exit:
        # Armed before the device is touched; fit() re-arms with its own deadline.
        from mvtracker_torch.utils.observability import install_hang_watchdog

        install_hang_watchdog(args.watchdog_timeout, exit=True)

    import torch

    from mvtracker_torch.datasets.loader import PrefetchLoader, SyntheticSceneDataset, compress_batch_for_transfer
    from mvtracker_torch.evaluation.evaluator import Evaluator
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.models.copycat import CopyCatPredictor
    from mvtracker_torch.presets import build_model
    from mvtracker_torch.training.train import TrainConfig, Trainer

    over = {"compute_dtype": "float32"} if args.fp32 else {}
    model = build_model(args.model_size, vis_geom=args.vis_geom, vis_head_hidden=args.vis_head_hidden,
                        corr_k0=args.corr_k0, global_match=args.global_match, chain_velocity=args.chain_velocity,
                        device=args.device, **over)
    kw = dict(
        n_views=args.views, n_frames=args.frames, height=args.res, width=args.res, n_tracks=args.n_tracks,
        motion_speed=args.motion_speed, rotate_objects=args.rotate, valid_from_visibility=args.valid_vis,
        focal_factor=args.focal, texture_detail=args.texture_detail, texture_noise=args.texture_noise,
    )
    if args.static_fraction >= 0.0:
        kw["static_fraction"] = args.static_fraction
    # Caching pays only when scenes repeat; with many scenes every step sees
    # a fresh one and the cache would only grow.
    train_ds = SyntheticSceneDataset(
        n_scenes=args.train_scenes, cache=args.train_scenes <= 1024, seed=0, randomize=True, augment=args.augment,
        disk_cache_dir=os.path.join(args.exp_dir, "scene_cache"),  # survives restarts (the memory cache does not)
        **kw,
    )
    eval_ds = SyntheticSceneDataset(n_scenes=args.eval_scenes, cache=True, seed=777, randomize=True, **kw)
    loader = PrefetchLoader(train_ds, batch_size=1, num_workers=args.workers, shuffle=True)
    cfg = TrainConfig(
        total_steps=args.steps,
        lr=args.lr,
        schedule="cos",
        warmup_steps=100,
        adaptive_iters=not args.no_adaptive,
        train_iters=3,
        save_ckpt_freq=args.save_every or max(min(args.steps // 2, 2500), 500),
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

    scenes = [eval_ds[i] for i in range(args.eval_scenes)]
    evaluator = Evaluator("kubric-multiview")
    copycat_res, _ = evaluator.evaluate_sequence(CopyCatPredictor(), scenes)
    copycat_summary = rounded(copycat_res.get("all_any", {}))
    logging.info("CopyCat held-out baseline: %s", copycat_summary)

    def evaluate(state):
        predictor = EvaluationPredictor(state.model, interp_shape=None, grid_size=0, n_iters=3)
        with torch.no_grad():
            return evaluator.evaluate_sequence(predictor, scenes)[0]

    def eval_fn(state, step):
        """Periodic held-out eval vs CopyCat; appended to eval_log.jsonl."""
        entry = {"step": step, "ours": rounded(evaluate(state).get("all_any", {})), "copycat": copycat_summary}
        logging.info(
            "heldout@%d: ATE %.2f AJ %.2f (CopyCat ATE %.2f AJ %.2f)", step,
            entry["ours"].get("ate_visible", float("nan")), entry["ours"].get("average_jaccard", float("nan")),
            copycat_summary.get("ate_visible", float("nan")), copycat_summary.get("average_jaccard", float("nan")),
        )
        with open(os.path.join(args.exp_dir, "eval_log.jsonl"), "a") as f:
            f.write(json.dumps(entry, default=float) + "\n")
        return entry["ours"]

    os.makedirs(args.exp_dir, exist_ok=True)
    data_iter = (compress_batch_for_transfer(b) for b in loader.prefetching_iter())
    state = trainer.fit(data_iter, max_steps=args.steps, eval_fn=eval_fn)
    ours = evaluate(state)

    report = {"steps": args.steps, "ours": ours.get("all_any", {}), "copycat": copycat_res.get("all_any", {})}
    print(json.dumps({k: report[k] if k == "steps" else {
        m: round(v, 2) for m, v in report[k].items() if isinstance(v, float)
    } for k in report}, indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2, default=float)
    return report


if __name__ == "__main__":
    main()
