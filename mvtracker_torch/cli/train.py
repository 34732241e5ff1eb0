"""Training CLI: ``python -m mvtracker_torch.cli.train [--config X] [k=v ...]``,
the counterpart of `mvtracker_tpu/cli/train.py` with the same arguments and
`--device` (default cuda). Example:

    python -m mvtracker_torch.cli.train --config configs/overfit.yaml \
        trainer.total_steps=1000 data.dataset=synthetic

Trains on one device. `MVTRACKER_DISTRIBUTED=1` and a config that asks for
a mesh of more than one device raise until data parallelism is ported
(ROADMAP item 6).
"""

from __future__ import annotations

import argparse
import logging
import os


def check_single_device(cfg) -> None:
    """Raise for the multi-process and multi-device settings (ROADMAP item 6)."""
    if os.environ.get("MVTRACKER_DISTRIBUTED", "0") == "1":
        raise NotImplementedError("MVTRACKER_DISTRIBUTED=1: multi-process training is not ported yet (ROADMAP item 6)")
    if (cfg.mesh_data or 1) > 1 or cfg.mesh_model > 1 or cfg.shard_views:
        raise NotImplementedError(
            f"a device mesh (mesh_data={cfg.mesh_data}, mesh_model={cfg.mesh_model}, shard_views={cfg.shard_views}) "
            "is not ported yet (ROADMAP item 6); the port trains on one device"
        )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, help="YAML config preset")
    parser.add_argument("--device", default="cuda", help="torch device to train on")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    from mvtracker_torch.config import build_dataset, build_model, format_config_tree, load_config
    from mvtracker_torch.datasets.loader import PrefetchLoader, SyntheticSceneDataset
    from mvtracker_torch.evaluation.evaluator import Evaluator
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.training.train import Trainer

    cfg = load_config(args.config, args.overrides)
    check_single_device(cfg)
    logging.info("resolved config:\n%s", format_config_tree(cfg))

    model = build_model(cfg.model, device=args.device)
    dataset = build_dataset(cfg.data)
    loader = PrefetchLoader(dataset, batch_size=cfg.data.batch_size, num_workers=cfg.data.num_workers,
                            seed=cfg.data.seed)

    def eval_fn(state, step):
        """Evaluation every `trainer.eval_freq` steps on the training data
        (2 sequences unless `eval.max_sequences` says otherwise)."""
        predictor = EvaluationPredictor(
            state.model,
            interp_shape=tuple(cfg.eval.interp_shape) if cfg.eval.interp_shape else None,
            grid_size=cfg.eval.grid_size,
            n_iters=cfg.eval.n_iters,
        )
        summary, _ = Evaluator(cfg.eval.setting).evaluate_sequence(
            predictor, dataset, max_sequences=cfg.eval.max_sequences or 2
        )
        logging.info("eval @ step %d: %s", step, summary.get("all_any", {}))
        return summary

    static_iter = None
    if cfg.trainer.static_pretrain_steps > 0 and cfg.data.dataset == "synthetic":
        static_ds = SyntheticSceneDataset(
            n_scenes=32, seed=cfg.data.seed + 1, n_views=cfg.data.n_views, n_frames=cfg.data.n_frames,
            height=cfg.data.height, width=cfg.data.width, n_tracks=cfg.data.num_tracks, static_fraction=1.0,
        )
        static_iter = iter(PrefetchLoader(static_ds, batch_size=cfg.data.batch_size,
                                          num_workers=cfg.data.num_workers))

    trainer = Trainer(model, cfg.trainer)
    return trainer.fit(loader.prefetching_iter(), eval_fn=eval_fn, static_data_iter=static_iter)


if __name__ == "__main__":
    main()
