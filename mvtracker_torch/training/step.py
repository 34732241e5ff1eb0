"""Training step (L7), counterpart of `mvtracker_tpu/training/step.py`.

One step is: the forward with `is_train=True` and the tracking loss per
scene, the backward, then the optimizer: zero every non-finite gradient
entry, clip by the global norm, AdamW with a one-cycle learning rate.

The optimizer is written out because its formulas are optax's, which the JAX
package trains with, and PyTorch's own differ: optax's one-cycle schedule
has its boundary at `int(pct_start * total_steps)` with `div_factor` 25 and
`final_div_factor` 1e4, its global-norm clip scales by `max_norm / norm`
with no epsilon, and its AdamW adds the decay to the Adam update before the
learning rate scales both.

A batch is a dict with a leading scene axis, as in the JAX package. The
model runs one scene, so the step loops over the scenes, means the losses
and takes the largest `reproj_dev`.

With a `mesh` (`parallel/mesh.py`) each process runs the step on the scenes
of its data coordinate, and the gradients are summed over the world before
the optimizer, so every rank applies the gradient of the mean loss over all
scenes and the parameters stay equal: the JAX step's all-reduce, which
there too comes before the non-finite guard and the clip. `shard_views` and
`shard_tracks` split the encoding and the correlation stage over the
`model` group (`MVTracker.sharded`); in JAX they are placement hints, and
here too they leave the numbers as they are (and, as there, do nothing
without a mesh). Every rank of a model group computes the same loss, so
each scales its loss by 1 / (scenes x world size) before the backward, and
the world's sum of the gradients is the gradient of the mean loss.
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import nullcontext

import torch
from torch import nn
from torch.profiler import record_function

from mvtracker_torch.parallel import mesh as mesh_lib
from mvtracker_torch.training import losses
from mvtracker_torch.utils import geometry


def _interpolated_schedule(kind: str, init_value: float, boundaries_and_scales: dict[int, float]):
    """optax's `piecewise_interpolate_schedule`: the value moves from one
    boundary's value to the next along a cosine or a line; each boundary's
    value is the previous one times its scale."""
    bounds = [0] + sorted(boundaries_and_scales)
    values = [init_value]
    for b in bounds[1:]:
        values.append(values[-1] * boundaries_and_scales[b])

    def schedule(count: int) -> float:
        if count >= bounds[-1]:
            return values[-1]
        for lo, hi, start, end in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            if lo <= count < hi:
                pct = (count - lo) / (hi - lo)
                if kind == "cosine":
                    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
                return (end - start) * pct + start
        raise ValueError(f"no schedule segment holds step {count}")

    return schedule


class Optimizer:
    """zero-nonfinite -> clip by global norm -> AdamW, with optax's formulas.

    `init(params)` makes the state {"count", "mu", "nu"} for a dict of named
    parameters; `update(params, grads, opt_state)` changes the parameters and
    the state in place. Nothing here synchronises with the device.
    """

    def __init__(self, schedule, weight_decay: float, grad_clip: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def learning_rate(self, count: int) -> float:
        """The rate applied by the update that follows `count` earlier ones."""
        return self.schedule(count)

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": {name: torch.zeros_like(p) for name, p in params.items()},
            "nu": {name: torch.zeros_like(p) for name, p in params.items()},
        }

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], opt_state: dict) -> None:
        grads = {name: zero_nonfinite(g) for name, g in grads.items()}
        g_norm = global_norm(grads.values())
        keep = g_norm < self.grad_clip  # no epsilon, as optax
        count = opt_state["count"] + 1
        lr = self.learning_rate(opt_state["count"])
        c1 = 1.0 - self.b1**count
        c2 = 1.0 - self.b2**count
        for name, p in params.items():
            g = grads[name]
            g = torch.where(keep, g, (g / g_norm) * self.grad_clip)
            mu, nu = opt_state["mu"][name], opt_state["nu"][name]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            step = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(step + self.weight_decay * p, alpha=-lr)
        opt_state["count"] = count


def zero_nonfinite(g: torch.Tensor) -> torch.Tensor:
    """`g` with every NaN or inf entry set to 0."""
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of all squared entries, as a scalar tensor."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def make_optimizer(
    lr: float = 5e-4,
    weight_decay: float = 1e-5,
    total_steps: int = 200_000,
    pct_start: float = 0.05,
    grad_clip: float = 1.0,
    schedule: str = "cos",
) -> Optimizer:
    """AdamW with a one-cycle ("cos", "linear") or constant ("const") rate,
    behind the non-finite guard and the global-norm clip."""
    # A warm-up that truncates to 0 steps would be a zero-width segment and
    # a NaN rate: keep it at least one step wide.
    total_steps = max(int(total_steps), 2)
    pct_start = max(pct_start, 1.0 / total_steps)
    div_factor, final_div_factor = 25.0, 1e4
    if schedule == "cos":
        sched = _interpolated_schedule(
            "cosine", lr / div_factor,
            {int(pct_start * total_steps): div_factor, total_steps: 1.0 / (div_factor * final_div_factor)},
        )
    elif schedule == "linear":
        sched = _interpolated_schedule(
            "linear", lr / div_factor,
            {int(pct_start * total_steps): div_factor, int(0.85 * total_steps): 1.0 / div_factor,
             total_steps: 1.0 / final_div_factor},
        )
    elif schedule == "const":
        def sched(count: int) -> float:
            return lr
    else:
        raise ValueError(schedule)
    return Optimizer(sched, weight_decay=weight_decay, grad_clip=grad_clip)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer state
    (`Optimizer.init`) and the number of steps taken."""

    model: nn.Module
    opt_state: dict
    step: int = 0


def init_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(model, optimizer.init(dict(model.named_parameters())), 0)


def scene_loss(model, scene: dict, iters: int, gamma: float, vis_weight: float, feat_id_weight: float = 0.0):
    """Loss of one scene -> (total, parts). `scene` holds rgbs [V,T,H,W,3]
    (float or uint8), depths [V,T,H,W] (float32 or float16), query_points
    [N,4], intrs, extrs, traj_gt [T,N,3], vis_gt [T,N], valid [T,N] and
    optionally track_upscaling_factor, as numpy arrays or tensors. They are
    moved to the model's device first and cast to fp32 there, so compressed
    frames and depths cross the bus at their own width."""
    dev = model.device
    rgbs, depths, query_points, intrs, extrs, traj_gt, vis_gt, valid = (
        model._as_input(scene[k])
        for k in ("rgbs", "depths", "query_points", "intrs", "extrs", "traj_gt", "vis_gt", "valid")
    )
    out = model(rgbs, depths, query_points, intrs, extrs, iters=iters, is_train=True)
    upscale = torch.as_tensor(scene.get("track_upscaling_factor", 1.0), dtype=torch.float32, device=dev)
    total, parts = losses.tracking_loss(
        out["train_data"], traj_gt, vis_gt, valid,
        query_points[:, 0].long(), rgbs.shape[1],
        gamma=gamma,
        track_upscaling_factor=upscale,
        visibility_loss_weight=vis_weight,
    )
    parts = dict(parts)
    if feat_id_weight > 0.0:
        fid = losses.feature_identity_loss(
            model.compute_fmaps(rgbs), depths, intrs, extrs, traj_gt, stride=model.stride
        )
        parts["feat_id"] = fid
        total = total + feat_id_weight * fid
    # Runtime guard on the projection algebra, checked by the trainer.
    parts["reproj_dev"] = geometry.reprojection_roundtrip_dev(out["traj"].detach(), intrs, extrs)
    return total, parts


def make_train_step(
    model,
    optimizer: Optimizer,
    iters: int = 4,
    gamma: float = 0.8,
    vis_weight: float = 0.1,
    feat_id_weight: float = 0.0,
    mesh=None,
    shard_views: bool = False,
    shard_tracks: bool = False,
):
    """Build the train step: (state, batch) -> (state, metrics).

    `batch` is a dict of arrays with a leading scene axis; with a `mesh`,
    this process's scenes (as many on every data rank). Each scene's graph
    is built, differentiated and freed in turn, its gradient scaled by
    1 / scenes, so the accumulated gradient is that of the mean loss.
    `metrics` holds scalar tensors on the model's device: `loss`,
    `grad_norm` (the global norm before the non-finite guard and the clip),
    `xyz_loss`, `vis_loss`, `reproj_dev`, and `feat_id` with that loss on;
    with a mesh, means over all scenes and the largest `reproj_dev`. The
    forward, the backward and the optimizer run inside profiler spans
    `stage::forward`, `stage::backward` and `stage::optimizer`, which cost
    nothing to speak of while no profiler records.
    """
    if shard_tracks and getattr(model, "knn_mesh", None) is not None:
        raise ValueError("shard_tracks and the model's knn_mesh both split the correlation stage; use one")
    model_group = mesh.group("model") if mesh is not None else None
    n_ranks = 1 if mesh is None else mesh.shape["data"] * mesh.shape["model"]

    def train_step(state: TrainState, batch: dict):
        if state.model is not model:
            raise ValueError("train_step was built for another model than the state holds")
        params = dict(model.named_parameters())
        n_scenes = len(batch["rgbs"])
        model.zero_grad(set_to_none=True)
        totals, per_scene = [], []
        split = model.sharded(views=model_group if shard_views else None,
                              tracks=model_group if shard_tracks else None) if mesh is not None else nullcontext()
        with split:
            for i in range(n_scenes):
                scene = {k: v[i] for k, v in batch.items() if getattr(v, "ndim", 0) > 0}
                with record_function("stage::forward"):
                    total, parts = scene_loss(model, scene, iters, gamma, vis_weight, feat_id_weight)
                with record_function("stage::backward"):
                    (total / (n_scenes * n_ranks)).backward()
                totals.append(total.detach())
                per_scene.append({k: v.detach() for k, v in parts.items()})
        grads = {name: torch.zeros_like(p) if p.grad is None else p.grad for name, p in params.items()}
        metrics = {"loss": torch.stack(totals).mean()}
        for key in per_scene[0]:
            vals = torch.stack([p[key] for p in per_scene])
            # Deviations aggregate by max (one bad scene must trip the
            # guard), losses by mean.
            metrics[key] = vals.max() if key == "reproj_dev" else vals.mean()
        if mesh is not None:
            _sum_over_world(grads)
            metrics = _aggregate(metrics, n_ranks)
        metrics["grad_norm"] = global_norm(grads.values())
        with record_function("stage::optimizer"):
            optimizer.update(params, grads, state.opt_state)
        model.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics

    return train_step


def _sum_over_world(grads: dict) -> None:
    """Replace every gradient by its sum over the world's ranks (one
    all-reduce of all of them, flattened, over the default group)."""
    flat = torch.cat([g.reshape(-1).float() for g in grads.values()])
    mesh_lib.all_reduce(flat, torch.distributed.group.WORLD)
    offset = 0
    for g in grads.values():
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def _aggregate(metrics: dict, n_ranks: int) -> dict:
    """The metrics over the world's `n_ranks` ranks: `reproj_dev` its max,
    the rest means (the ranks of a model group hold the same values, so
    these are the means over the data ranks)."""
    keys = [k for k in metrics if k != "reproj_dev"]
    world = torch.distributed.group.WORLD
    sums = mesh_lib.all_reduce(torch.stack([metrics[k].float() for k in keys]), world)
    out = {k: sums[i] / n_ranks for i, k in enumerate(keys)}
    if "reproj_dev" in metrics:
        out["reproj_dev"] = mesh_lib.all_reduce(metrics["reproj_dev"].float().clone(), world,
                                                op=torch.distributed.ReduceOp.MAX)
    return out
