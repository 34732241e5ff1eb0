"""Overfit-and-verify on the port: train on a few cached synthetic scenes,
then show the learned tracker beats the no-motion CopyCat baseline on the
same scenes. The PyTorch counterpart of `scripts/overfit_verify.py`: the same
arguments, model, data, schedule and printed table, plus `--device` (default
cuda). It runs the whole train -> checkpoint -> evaluate -> metrics path.

    python scripts/overfit_verify_torch.py --steps 400
"""

import argparse
import logging
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TABLE_KEYS = ("ate_visible", "mte_visible", "average_pts_within_thresh", "average_jaccard", "survival")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--exp_dir", default="/tmp/overfit_verify")
    parser.add_argument("--scenes", type=int, default=2)
    parser.add_argument("--motion_speed", type=float, default=1.0)
    parser.add_argument("--texture_detail", type=float, default=0.0)
    parser.add_argument("--texture_noise", type=float, default=0.0)
    parser.add_argument("--global_match", action="store_true")
    parser.add_argument("--feat_id_weight", type=float, default=0.0)
    parser.add_argument("--iters_eval", type=int, default=3,
                        help="kept from the JAX script, which evaluates with 3 iterations whatever it is set to")
    parser.add_argument("--device", default="cuda", help="torch device to train and evaluate on")
    return parser


def overfit_model(device, **kw):
    """The overfit smoke configuration (the `small` preset's widths)."""
    from mvtracker_torch.models.mvtracker import MVTracker

    return MVTracker(sliding_window_len=8, fmaps_dim=64, num_heads=6, hidden_size=192, space_depth=3, time_depth=3,
                     num_virtual_tracks=16, corr_n_levels=3, corr_neighbors=8, device=device, **kw)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch

    from mvtracker_torch.datasets.loader import PrefetchLoader, SyntheticSceneDataset
    from mvtracker_torch.evaluation.evaluator import Evaluator
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.models.copycat import CopyCatPredictor
    from mvtracker_torch.training.train import TrainConfig, Trainer

    model = overfit_model(args.device, global_match_init=args.global_match)
    ds = SyntheticSceneDataset(
        n_scenes=args.scenes, cache=True, n_views=2, n_frames=12, height=64, width=64, n_tracks=32,
        motion_speed=args.motion_speed, texture_detail=args.texture_detail, texture_noise=args.texture_noise,
    )
    loader = PrefetchLoader(ds, batch_size=1, num_workers=1, shuffle=True)
    cfg = TrainConfig(
        total_steps=args.steps, lr=3e-4, schedule="const", warmup_steps=0, adaptive_iters=False, train_iters=3,
        save_ckpt_freq=args.steps, eval_freq=10**9, telemetry_freq=50, feat_id_loss_weight=args.feat_id_weight,
        exp_dir=args.exp_dir,
    )
    state = Trainer(model, cfg).fit(iter(loader), max_steps=args.steps)

    predictor = EvaluationPredictor(state.model, interp_shape=None, grid_size=0, n_iters=3)
    evaluator = Evaluator("kubric-multiview")
    scenes = [ds[i] for i in range(args.scenes)]
    with torch.no_grad():
        ours, _ = evaluator.evaluate_sequence(predictor, scenes)
    copycat, _ = evaluator.evaluate_sequence(CopyCatPredictor(), scenes)

    rows = ["metric                     ours     copycat"]
    for key in TABLE_KEYS:
        a = ours.get("all_any", {}).get(key, float("nan"))
        b = copycat.get("all_any", {}).get(key, float("nan"))
        rows.append(f"{key:<26} {a:8.2f} {b:8.2f}")
    print("\n".join(rows))

    ours_ate = ours["all_any"]["ate_visible"]
    copy_ate = copycat["all_any"]["ate_visible"]
    print(f"\nRESULT: trained ATE {ours_ate:.2f} vs CopyCat {copy_ate:.2f} "
          f"({'BEATS' if ours_ate < copy_ate else 'DOES NOT BEAT'} baseline)")
    return {"ours": ours, "copycat": copycat}


if __name__ == "__main__":
    main()
