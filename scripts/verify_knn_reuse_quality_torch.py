"""Quality check of `corr_knn_reuse` on a model that tracks motion, on the
port: trains the overfit smoke configuration (the recipe of
`scripts/overfit_verify_torch.py`), then evaluates the same trained weights
through (a) the exact per-iteration kNN and (b) the kNN reused across
iterations, plus CopyCat for scale. The PyTorch counterpart of
`scripts/verify_knn_reuse_quality.py`: the same arguments, table, divergence
line and `<exp_dir>/knn_reuse_quality.json`, plus `--device` (default cuda).

    python scripts/verify_knn_reuse_quality_torch.py --steps 1200
"""

import argparse
import json
import logging
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KEYS = ("ate_visible", "mte_visible", "average_pts_within_thresh", "average_jaccard", "survival",
        "occlusion_accuracy")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=1200)
    parser.add_argument("--exp_dir", default="/tmp/knn_reuse_quality")
    parser.add_argument("--scenes", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="torch device to train and evaluate on")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import numpy as np
    import torch

    from mvtracker_torch.datasets.loader import PrefetchLoader, SyntheticSceneDataset
    from mvtracker_torch.evaluation.evaluator import Evaluator, to_host
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.models.copycat import CopyCatPredictor
    from mvtracker_torch.training.train import TrainConfig, Trainer
    from overfit_verify_torch import overfit_model

    model = overfit_model(args.device)
    ds = SyntheticSceneDataset(n_scenes=args.scenes, cache=True, n_views=2, n_frames=12, height=64, width=64,
                               n_tracks=32)
    loader = PrefetchLoader(ds, batch_size=1, num_workers=1, shuffle=True)
    cfg = TrainConfig(
        total_steps=args.steps, lr=3e-4, schedule="const", warmup_steps=0, adaptive_iters=False, train_iters=3,
        save_ckpt_freq=args.steps, eval_freq=10**9, telemetry_freq=200, exp_dir=args.exp_dir,
    )
    state = Trainer(model, cfg).fit(iter(loader), max_steps=args.steps)
    # The same trained weights in a model that reuses each window's kNN.
    model_reuse = overfit_model(args.device, corr_knn_reuse=True)
    model_reuse.load_state_dict(state.model.state_dict())

    evaluator = Evaluator("kubric-multiview")
    scenes = [ds[i] for i in range(args.scenes)]
    results, trajs = {}, {}
    with torch.no_grad():
        for tag, mdl in (("exact", state.model), ("reuse", model_reuse)):
            predictor = EvaluationPredictor(mdl, interp_shape=None, grid_size=0, n_iters=3)
            res, _ = evaluator.evaluate_sequence(predictor, scenes)
            results[tag] = res.get("all_any", {})
            # Raw trajectories for a direct divergence readout.
            trajs[tag] = [to_host(predictor(s.video, s.videodepth, s.query_points_3d, s.intrs, s.extrs)["traj"])
                          for s in scenes]
    res_cc, _ = evaluator.evaluate_sequence(CopyCatPredictor(), scenes)
    results["copycat"] = res_cc.get("all_any", {})

    rows = [f"{'metric':<28}" + "".join(f"{t:>10}" for t in ("exact", "reuse", "copycat"))]
    for k in KEYS:
        rows.append(f"{k:<28}" + "".join(f"{results[t].get(k, float('nan')):>10.3f}"
                                         for t in ("exact", "reuse", "copycat")))
    print("\n".join(rows))

    d = np.concatenate([np.linalg.norm(a - b, axis=-1).ravel() for a, b in zip(trajs["exact"], trajs["reuse"])])
    print(f"trajectory divergence |exact-reuse|: mean {d.mean():.4g} p95 {np.percentile(d, 95):.4g} max {d.max():.4g}")
    out = {
        "steps": args.steps,
        "results": {t: {k: float(results[t].get(k, float("nan"))) for k in KEYS} for t in results},
        "divergence": {"mean": float(d.mean()), "p95": float(np.percentile(d, 95)), "max": float(d.max())},
    }
    with open(os.path.join(args.exp_dir, "knn_reuse_quality.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
