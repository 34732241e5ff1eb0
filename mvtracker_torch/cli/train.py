"""Training CLI: ``python -m mvtracker_torch.cli.train [--config X] [k=v ...]``,
the counterpart of `mvtracker_tpu/cli/train.py` with the same arguments and
`--device` (default cuda). Example:

    python -m mvtracker_torch.cli.train --config configs/overfit.yaml \
        trainer.total_steps=1000 data.dataset=synthetic

With `MVTRACKER_DISTRIBUTED=1` the process joins the world a launcher
describes (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`,
as `torchrun` sets them): NCCL on `cuda:LOCAL_RANK`, gloo for `--device cpu`.
In a world of more than one process the trainer runs on a (`mesh_data`,
`mesh_model`) mesh (`parallel/mesh.py`; `mesh_data` unset takes the rest),
with `shard_views`; `data.batch_size` counts scenes over all data ranks,
each loading its own stride of the dataset. A process group that is already
initialised is used as it is.

`cotracker2d` trains its learned 2D tracker on the configured dataset's
monocular proxies (`MonocularProxyDataset`: one view per scene, pixel
tracks) and evaluates it through the multi-view adapter; the
monocular-baseline zoo has no weights to train here and raises.
"""

from __future__ import annotations

import argparse
import logging
import os


def init_distributed(device: str) -> tuple[str, str]:
    """Join the launcher's world when `MVTRACKER_DISTRIBUTED=1`; returns
    (the backend, or "" without a world, and the device to train on)."""
    if os.environ.get("MVTRACKER_DISTRIBUTED", "0") != "1":
        return "", device
    import torch
    import torch.distributed as dist

    from mvtracker_torch.device import resolve_device

    if resolve_device(device).type == "cuda":
        backend, local_rank = "nccl", int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local_rank)
        device = f"cuda:{local_rank}"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return dist.get_backend(), device


def trainable_module(model):
    """The module whose weights the trainer updates and the checkpoints
    hold: the model itself, the learned 2D tracker inside the multi-view
    adapter, or None (CopyCat, the NCC tracker, a hub wrapper)."""
    import torch

    from mvtracker_torch.models.cotracker2d import LearnedTracker2D

    if isinstance(model, torch.nn.Module):
        return model
    tracker = getattr(model, "tracker_2d", None)
    return tracker.model if isinstance(tracker, LearnedTracker2D) else None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, help="YAML config preset")
    parser.add_argument("--device", default="cuda", help="torch device to train on")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    import torch

    from mvtracker_torch.config import build_dataset, build_model, format_config_tree, load_config
    from mvtracker_torch.datasets.loader import MonocularProxyDataset, PrefetchLoader, SyntheticSceneDataset
    from mvtracker_torch.evaluation.evaluator import Evaluator
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.parallel.mesh import make_mesh
    from mvtracker_torch.training.train import Trainer

    cfg = load_config(args.config, args.overrides)
    logging.info("resolved config:\n%s", format_config_tree(cfg))
    backend, device = init_distributed(args.device)
    mesh = None
    if backend and torch.distributed.get_world_size() > 1:
        mesh = make_mesh(n_data=cfg.mesh_data, n_model=cfg.mesh_model, backend=backend)
        logging.info("mesh: %s", mesh)
    # Each data coordinate loads its own stride of the dataset, its share
    # of the global batch; the ranks of one model group load the same.
    n_data, data_index = (mesh.shape["data"], mesh.coords["data"]) if mesh is not None else (1, 0)
    stride = dict(process_index=data_index, process_count=n_data) if n_data > 1 else {}
    batch_size = max(cfg.data.batch_size // n_data, 1)

    model = build_model(cfg.model, device=device)
    module = trainable_module(model)
    if module is None:
        raise ValueError(f"model family {cfg.model.name!r} has no weights to train")
    dataset = build_dataset(cfg.data)
    train_data = dataset if module is model else MonocularProxyDataset(dataset)
    loader = PrefetchLoader(train_data, batch_size=batch_size, num_workers=cfg.data.num_workers,
                            seed=cfg.data.seed, **stride)

    def eval_fn(state, step):
        """Evaluation every `trainer.eval_freq` steps on the training data
        (2 sequences unless `eval.max_sequences` says otherwise), through the
        adapter for a 2D tracker."""
        predictor = EvaluationPredictor(
            model,  # the trained module itself, or the adapter around it
            interp_shape=tuple(cfg.eval.interp_shape) if cfg.eval.interp_shape else None,
            grid_size=cfg.eval.grid_size,
            n_iters=cfg.eval.n_iters,
            device=device,
        )
        summary, _ = Evaluator(cfg.eval.setting).evaluate_sequence(
            predictor, dataset, max_sequences=cfg.eval.max_sequences or 2
        )
        logging.info("eval @ step %d: %s", step, summary.get("all_any", {}))
        return summary

    static_iter = None
    if cfg.trainer.static_pretrain_steps > 0 and cfg.data.dataset == "synthetic" and module is model:
        static_ds = SyntheticSceneDataset(
            n_scenes=32, seed=cfg.data.seed + 1, n_views=cfg.data.n_views, n_frames=cfg.data.n_frames,
            height=cfg.data.height, width=cfg.data.width, n_tracks=cfg.data.num_tracks, static_fraction=1.0,
        )
        static_iter = iter(PrefetchLoader(static_ds, batch_size=batch_size, num_workers=cfg.data.num_workers,
                                          **stride))

    trainer = Trainer(module, cfg.trainer, mesh=mesh, shard_views=cfg.shard_views)
    return trainer.fit(loader.prefetching_iter(), eval_fn=eval_fn, static_data_iter=static_iter)


if __name__ == "__main__":
    main()
