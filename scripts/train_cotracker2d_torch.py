"""Train the port's compact learned 2D tracker (`mvtracker_torch/models/cotracker2d.py`)
on monocular proxies of randomized synthetic scenes, then evaluate it
through `MonocularToMultiViewAdapter` on held-out multi-view scenes against
the NCC template tracker and CopyCat. The PyTorch counterpart of
`scripts/train_cotracker2d.py`: the same arguments, model width, data,
schedule and printed JSON, plus `--device` (default cuda).

    python scripts/train_cotracker2d_torch.py --steps 4000
    python scripts/train_cotracker2d_torch.py --steps 30 --train_scenes 4 --eval_scenes 2
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
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--train_scenes", type=int, default=64)
    parser.add_argument("--eval_scenes", type=int, default=4)
    parser.add_argument("--exp_dir", default=os.path.join(ROOT, "experiments", "train_cotracker2d"))
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--res", type=int, default=64)
    parser.add_argument("--texture_detail", type=float, default=1.0)
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--out_json", default=None)
    parser.add_argument("--device", default="cuda", help="torch device to train and evaluate on")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from mvtracker_torch.datasets.loader import MonocularProxyDataset, PrefetchLoader, SyntheticSceneDataset
    from mvtracker_torch.evaluation.evaluator import Evaluator
    from mvtracker_torch.models.copycat import CopyCatPredictor
    from mvtracker_torch.models.cotracker2d import CoTracker2D, LearnedTracker2D
    from mvtracker_torch.models.monocular import MonocularToMultiViewAdapter, SimpleNNTracker2D
    from mvtracker_torch.training.train import TrainConfig, Trainer

    model = CoTracker2D(
        sliding_window_len=8, stride=4, fmaps_dim=64, num_heads=6, hidden_size=192, space_depth=3, time_depth=3,
        num_virtual_tracks=16, corr_n_levels=3, corr_patch_radius=3, device=args.device,
    )
    kw = dict(n_views=2, n_frames=12, height=args.res, width=args.res, n_tracks=32,
              texture_detail=args.texture_detail)
    train_ds = MonocularProxyDataset(
        SyntheticSceneDataset(n_scenes=args.train_scenes, cache=args.train_scenes <= 1024, seed=0, randomize=True,
                              **kw)
    )
    eval_ds = SyntheticSceneDataset(n_scenes=args.eval_scenes, cache=True, seed=777, randomize=True, **kw)
    loader = PrefetchLoader(train_ds, batch_size=1, num_workers=args.workers, shuffle=True)
    cfg = TrainConfig(
        total_steps=args.steps, lr=args.lr, schedule="cos", warmup_steps=100, adaptive_iters=True, train_iters=3,
        save_ckpt_freq=max(args.steps // 2, 500), eval_freq=10**9, telemetry_freq=200, exp_dir=args.exp_dir,
    )
    state = Trainer(model, cfg).fit(loader.prefetching_iter(), max_steps=args.steps)

    evaluator = Evaluator("kubric-multiview")
    scenes = [eval_ds[i] for i in range(args.eval_scenes)]
    learned = MonocularToMultiViewAdapter(LearnedTracker2D(state.model, n_iters=3), device=args.device)
    ncc = MonocularToMultiViewAdapter(SimpleNNTracker2D(), device=args.device)
    res_learned, _ = evaluator.evaluate_sequence(learned, scenes)
    res_ncc, _ = evaluator.evaluate_sequence(ncc, scenes)
    res_copycat, _ = evaluator.evaluate_sequence(CopyCatPredictor(), scenes)

    report = {
        "steps": args.steps,
        "learned_cotracker2d": res_learned.get("all_any", {}),
        "ncc_template": res_ncc.get("all_any", {}),
        "copycat": res_copycat.get("all_any", {}),
    }
    print(json.dumps({k: report[k] if k == "steps" else {
        m: round(v, 2) for m, v in report[k].items() if isinstance(v, float)
    } for k in report}, indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2, default=float)
    return report


if __name__ == "__main__":
    main()
