"""What the port's distributed tests run on each of their processes
(`mvtracker_torch.parallel.launch.run_local`, gloo on the CPU, one intra-op
thread, a file rendezvous under the test's `tmp_path`).

This module imports no JAX: the processes import it, and the results go back
as numpy arrays and Python numbers.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from mvtracker_torch.parallel.launch import run_local


def spawn(fn, world: int, tmp_path, *args, timeout: float = 120.0) -> list:
    """`fn(rank, world, *args)` on `world` gloo processes; results by rank."""
    return run_local(fn, world, tmp_path, *args, timeout=timeout, threads=1)


# ---------------------------------------------------------------------------
# What the processes run
# ---------------------------------------------------------------------------


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def mesh_layout(rank, world, n_data, n_model):
    """The mesh's shape, this rank's coordinates, the ranks of its groups,
    its slice of a 4-scene batch, and what a mesh asking for another backend
    than the world's raises."""
    from mvtracker_torch.parallel import mesh as mesh_lib

    try:
        mesh_lib.make_mesh(n_data, n_model, backend="nccl")
        refused = None
    except ValueError as e:
        refused = str(e)
    mesh = mesh_lib.make_mesh(n_data, n_model, backend="gloo")
    batch = {"x": np.arange(4 * 3).reshape(4, 3), "scalar": np.float32(1.0)}
    groups = {axis: dist.get_process_group_ranks(mesh.group(axis)) for axis in ("data", "model")}
    return mesh.shape, mesh.coords, groups, mesh_lib.shard_batch_pytree(batch, mesh), refused


def knn_cases(rank, world, cases):
    """Each case (ref [B, N, 3], query, k, schedule, backend): this rank's
    equal shard of the cloud, searched over a group of all ranks."""
    from mvtracker_torch.ops import knn as knn_ops
    from mvtracker_torch.parallel.mesh import make_mesh

    group = make_mesh(1, world, backend="gloo").group("model")
    out = []
    for ref, query, k, schedule, backend in cases:
        n_local = ref.shape[1] // world
        shard = torch.from_numpy(ref[:, rank * n_local : (rank + 1) * n_local]).contiguous()
        fn = {"gather": knn_ops.knn_sharded, "ring": knn_ops.knn_sharded_ring}[schedule]
        out.append(_numpy(fn(shard, torch.from_numpy(query), k, group, backend=backend)))
    return out


def tracker_forward(rank, world, n_model, cfg, state_dict, scene, min_points, iters):
    """MVTracker with a knn_mesh of (world / n_model) x n_model; returns its
    traj and vis and how often each schedule ran."""
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.ops import knn as knn_ops
    from mvtracker_torch.parallel.mesh import make_mesh
    from scripts.timing_torch import recording

    mesh = make_mesh(world // n_model, n_model, backend="gloo")
    model = MVTracker(**cfg, knn_mesh=mesh, knn_shard_min_points=min_points, device="cpu").eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    ran = []
    with recording(knn_ops, "knn_sharded", ran, lambda a, kw, o: "gather"), \
            recording(knn_ops, "knn_sharded_ring", ran, lambda a, kw, o: "ring"):
        out = model(*scene, iters=iters)
    calls = {name: ran.count(name) for name in ("gather", "ring")}
    return {"traj": out["traj"].numpy(), "vis": out["vis"].numpy(), "calls": calls}


def train_step(rank, world, n_model, cfg, state_dict, batch, shard_views, shard_tracks, iters, total_steps):
    """One step of the sharded train step on this rank's scenes; returns the
    parameters, Adam's first moment and the metrics after it."""
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.parallel import mesh as mesh_lib
    from mvtracker_torch.training import step as step_lib

    mesh = mesh_lib.make_mesh(world // n_model, n_model, backend="gloo")
    model = MVTracker(**cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    optimizer = step_lib.make_optimizer(total_steps=total_steps)
    state = step_lib.init_state(model, optimizer)
    step = step_lib.make_train_step(model, optimizer, iters=iters, mesh=mesh, shard_views=shard_views,
                                    shard_tracks=shard_tracks)
    state, metrics = step(state, mesh_lib.shard_batch_pytree(batch, mesh))
    return {"params": _numpy(dict(model.named_parameters())), "mu": _numpy(state.opt_state["mu"]),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def trainer_stop(rank, world, exp_dir, stop_rank, stop_after, sync_every):
    """`Trainer.fit` of a tiny model on a world x 1 mesh, each rank on its
    stride of the scenes, where rank `stop_rank` alone asks to stop after
    step `stop_after` (as its signal handler would); returns the step this
    rank ended on."""
    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.datasets.loader import PrefetchLoader, SyntheticSceneDataset
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.parallel.mesh import make_mesh
    from mvtracker_torch.training.train import TrainConfig, Trainer

    model = MVTracker(sliding_window_len=4, fmaps_dim=16, num_heads=2, hidden_size=32, space_depth=1, time_depth=1,
                      num_virtual_tracks=4, corr_n_levels=2, corr_neighbors=4, device="cpu")
    model.load_state_dict(random_state_dict(model, 0))
    cfg = TrainConfig(total_steps=9, warmup_steps=0, adaptive_iters=False, train_iters=1, sync_every=sync_every,
                      telemetry_freq=100, save_ckpt_freq=1000, tensorboard=False, watchdog_timeout_s=0,
                      exp_dir=exp_dir, schedule="const")
    trainer = Trainer(model, cfg, mesh=make_mesh(world, 1, backend="gloo"))
    data = PrefetchLoader(SyntheticSceneDataset(n_scenes=2, n_views=2, n_frames=6, height=32, width=32, n_tracks=8),
                          batch_size=1, num_workers=1, shuffle=False, process_index=rank, process_count=world)

    def on_step(step, metrics):
        if rank == stop_rank and step == stop_after:
            trainer._stop_requested = True

    return trainer.fit(iter(data), on_step=on_step).step


def train_cli(rank, world, argv):
    """`cli.train` as a launcher would start it on this rank; returns the
    sum of each parameter after training."""
    os.environ.update(MVTRACKER_DISTRIBUTED="1", RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    from mvtracker_torch.cli import train as cli_train

    state = cli_train.main(argv)
    return {name: float(p.detach().double().sum()) for name, p in state.model.named_parameters()}


def refine_sharded(rank, world, intrs, extrs, points, obs, weights, iterations):
    """`refine_cameras_sharded` with this rank's equal slice of the points."""
    from mvtracker_torch.ops import bundle_adjust as ba

    per = points.shape[0] // world
    sl = slice(rank * per, (rank + 1) * per)
    group = dist.group.WORLD
    extrs_out, points_out = ba.refine_cameras_sharded(
        *map(torch.from_numpy, (intrs, extrs, points[sl], obs[:, sl], weights[:, sl])), group, iterations=iterations)
    return extrs_out.numpy(), points_out.numpy()
