"""Crash-batch replay (L7 forensics), counterpart of
`mvtracker_tpu/training/replay.py`.

On an exception the trainer writes the offending batch to
`<exp_dir>/crash/batch_step<N>.npz` and a checkpoint (`training/train.py`,
mirroring reference `cli/train.py:741-766`). This module reads such a dump
and runs the loss and its gradient again on it (`replay`, with the model
restored from that checkpoint by `Trainer.restore_latest`). From the shell
it prints the dumped arrays' shapes:

    python -m mvtracker_torch.training.replay <exp_dir>/crash/batch_step123.npz
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np
import torch


def load_crash_batch(path_or_dir: str) -> dict:
    """Load a dumped batch npz, or the one of the latest step in a crash
    directory."""
    if os.path.isdir(path_or_dir):
        # Numeric order: lexicographic order would put step 999 after 1500.
        candidates = sorted(
            glob.glob(os.path.join(path_or_dir, "batch_step*.npz")),
            key=lambda p: int(os.path.basename(p)[len("batch_step"):-len(".npz")]),
        )
        if not candidates:
            raise FileNotFoundError(f"no crash dumps in {path_or_dir}")
        path_or_dir = candidates[-1]
    with np.load(path_or_dir) as data:
        return {k: data[k] for k in data.files}


def replay(batch: dict, model, iters: int = 1, gamma: float = 0.8, vis_weight: float = 0.1) -> dict:
    """The mean loss of the batch's scenes through `scene_loss`, with its
    gradient: {"loss": float, "nonfinite_grad_leaves": [parameter names
    whose gradient has a non-finite entry]}. The model's gradients are
    cleared afterwards."""
    from mvtracker_torch.training import step as step_lib

    n_scenes = len(batch["rgbs"])
    model.zero_grad(set_to_none=True)
    totals = []
    for i in range(n_scenes):
        scene = {k: v[i] for k, v in batch.items() if getattr(v, "ndim", 0) > 0}
        total, _ = step_lib.scene_loss(model, scene, iters, gamma, vis_weight)
        (total / n_scenes).backward()
        totals.append(total.detach())
    bad = [name for name, p in model.named_parameters() if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    loss = float(torch.stack(totals).mean())
    model.zero_grad(set_to_none=True)
    return {"loss": loss, "nonfinite_grad_leaves": bad}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("path", help="crash npz or crash dir")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    batch = load_crash_batch(args.path)
    print({k: tuple(v.shape) for k, v in batch.items()})


if __name__ == "__main__":
    main()
