"""Training loop (L7), counterpart of `mvtracker_tpu/training/train.py`.

- auto-resume from the newest checkpoint in the experiment directory
  (`torch.save` files under `<exp_dir>/checkpoints`, the newest
  `keep_ckpts` kept);
- SIGUSR1 and SIGTERM make the loop save a checkpoint and return, for
  preemption;
- per-step data and step times, logged with mean, median and std every
  `telemetry_freq` steps;
- adaptive refinement-iteration count: 1 during warm-up, then 10% one
  iteration, 15% a random middle count, 75% the full count;
- guards: a non-finite loss raises at once, a reprojection round-trip
  deviation beyond `reproj_guard_atol` warns and raises after
  `reproj_guard_patience` steps in a row;
- crash forensics: on an exception the offending batch and a checkpoint are
  written before the exception goes on;
- warm start (`Trainer.warm_start`, `TrainConfig.warm_start_ckpt`) from a
  flax msgpack params file or a torch `.pth`/`.pt` state dict, with the JAX
  trainer's two migrations (the update transformer's unrolled pre-scan
  layout, and a uniform-k input projection widened to
  `corr_neighbors_per_level`), strict or with a non-strict fallback;
- an evaluation hook (`eval_fn` every `eval_freq` steps) and a
  static-pretrain iterator for the first `static_pretrain_steps` steps;
- observability: TensorBoard scalars under `<exp_dir>/tb` (through
  `torch.utils.tensorboard`; off with a warning when it cannot be
  imported), W&B mirroring (off with a warning when `wandb` is absent), a
  `torch.profiler` trace window under `<exp_dir>/profile`, a faulthandler
  hang watchdog (a long first deadline, re-armed after every step and
  around checkpoints and evaluations, cancelled when `fit` ends), and the
  GPU's memory in the telemetry.

Crash batches are replayed with `training/replay.py`.

With a `mesh` (`parallel/mesh.py`) every process runs `fit` with its own data
iterator, which gives the scenes of its data coordinate (`cli/train.py`
stripes the loader so). Rank 0 alone restores or warm-starts and then
broadcasts the parameters, the optimizer state and the step; it alone
writes checkpoints, TensorBoard, W&B and the crash dump, and runs the
evaluation hook. A stop signal on any rank stops every rank after the same
step. The watchdog runs on every rank.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import signal
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from mvtracker_torch import convert
from mvtracker_torch.parallel import mesh as mesh_lib
from mvtracker_torch.training import step as step_lib
from mvtracker_torch.utils import observability as obs


@dataclasses.dataclass
class TrainConfig:
    """The trainer's settings; names, order and defaults are the JAX
    package's."""

    total_steps: int = 200_000
    lr: float = 5e-4
    weight_decay: float = 1e-5
    schedule: str = "cos"
    grad_clip: float = 1.0
    gamma: float = 0.8  # sequence-loss discount
    visibility_loss_weight: float = 0.1
    feat_id_loss_weight: float = 0.0  # contrastive point-identity loss on encoder features; 0 = off
    train_iters: int = 4
    warmup_steps: int = 100
    save_ckpt_freq: int = 500
    eval_freq: int = 10_000  # `fit`'s eval_fn(state, step) runs every eval_freq steps
    telemetry_freq: int = 100
    seed: int = 0
    exp_dir: str = "experiments/default"
    adaptive_iters: bool = True
    keep_ckpts: int = 3
    static_pretrain_steps: int = 0  # the first N steps draw from `fit`'s static_data_iter
    tensorboard: bool = True  # per-step scalars to <exp_dir>/tb
    # Hang watchdog: dump every thread's stack if a step makes no progress
    # for this long; 0 disables. With watchdog_exit the process ends after
    # the dump, for runs a supervisor restarts from the newest checkpoint.
    watchdog_timeout_s: float = 600.0
    watchdog_exit: bool = False
    watchdog_first_deadline_s: float = 1800.0  # the first step's deadline (cold kernel builds)
    # Reprojection round-trip guard: warn per offending step, raise after
    # this many in a row. atol 0 disables.
    reproj_guard_atol: float = 1.0
    reproj_guard_patience: int = 5
    wandb: bool = False  # mirror the TensorBoard stream to Weights & Biases
    wandb_project: str = "mvtracker_tpu"
    # torch.profiler trace of profile_n_steps steps from profile_start_step
    # into <exp_dir>/profile; -1 disables.
    profile_start_step: int = -1
    profile_n_steps: int = 3
    # Weights to start from (a flax .msgpack or a torch .pth/.pt), applied
    # non-strictly in `fit` when the experiment has no checkpoint yet. "" = none.
    warm_start_ckpt: str = ""
    # Fetch the loss (a device synchronisation) only every N steps, so the
    # host can run ahead of the device; the guards then see every Nth step.
    sync_every: int = 1


def augment_train_iters(step: int, cfg: TrainConfig, rng: np.random.Generator) -> int:
    """Adaptive refinement-iteration count (same draws from `rng` as the JAX
    package's function)."""
    if not cfg.adaptive_iters:
        return cfg.train_iters
    if step < cfg.warmup_steps:
        return 1
    r = rng.random()
    if r < 0.10:
        return 1
    if r < 0.25 and cfg.train_iters > 2:
        return int(rng.integers(2, cfg.train_iters))
    return cfg.train_iters


_CKPT_NAME = re.compile(r"step_(\d+)\.pt$")


class Trainer:
    def __init__(self, model, cfg: TrainConfig, mesh=None, shard_views: bool = False):
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.shard_views = shard_views
        self.is_main = mesh is None or mesh.rank == 0
        self.optimizer = step_lib.make_optimizer(
            lr=cfg.lr,
            weight_decay=cfg.weight_decay,
            total_steps=cfg.total_steps,
            grad_clip=cfg.grad_clip,
            schedule=cfg.schedule,
        )
        self._steps = {}  # iters -> train step
        self._stop_requested = False
        self._tb = None
        self.profile_trace: Optional[str] = None  # the path of the last profiler window's trace

    def _tb_writer(self):
        if self._tb is None and self.cfg.tensorboard and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                logging.warning("tensorboard requested but unavailable (%s); continuing without", e)
                self.cfg.tensorboard = False
                return None
            self._tb = SummaryWriter(os.path.join(self.cfg.exp_dir, "tb"))
        return self._tb

    def _watchdog(self, first: bool = False) -> None:
        """(Re-)arm the hang watchdog: the long deadline for the first step
        and for checkpoint and evaluation blocks, else the per-step one."""
        cfg = self.cfg
        if cfg.watchdog_timeout_s > 0:
            timeout = max(cfg.watchdog_timeout_s, cfg.watchdog_first_deadline_s) if first else cfg.watchdog_timeout_s
            obs.reset_hang_watchdog(timeout, exit=cfg.watchdog_exit)

    # -- checkpointing -------------------------------------------------
    @property
    def ckpt_dir(self) -> str:
        return os.path.abspath(os.path.join(self.cfg.exp_dir, "checkpoints"))

    def checkpoint_steps(self) -> list[int]:
        """Steps of the checkpoints on disk, ascending."""
        if not os.path.isdir(self.ckpt_dir):
            return []
        return sorted(int(m.group(1)) for m in map(_CKPT_NAME.match, os.listdir(self.ckpt_dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.checkpoint_steps()
        return steps[-1] if steps else None

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step}.pt")

    def save(self, state: step_lib.TrainState, step: int) -> None:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        payload = {"model": state.model.state_dict(), "opt_state": state.opt_state, "step": step}
        tmp = self._ckpt_path(step) + f".tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, self._ckpt_path(step))  # a reader never sees half a file
        steps = self.checkpoint_steps()
        for old in steps[: max(len(steps) - max(self.cfg.keep_ckpts, 1), 0)]:
            os.remove(self._ckpt_path(old))
        logging.info("saved checkpoint at step %d", step)

    def restore_latest(self, state: step_lib.TrainState) -> tuple[step_lib.TrainState, int]:
        """Load the newest checkpoint into `state` (the model in place);
        returns (state, its step), or (state, 0) when there is none."""
        latest = self.latest_step()
        if latest is None:
            return state, 0
        return self.restore(state, latest), latest

    def restore(self, state: step_lib.TrainState, step: int) -> step_lib.TrainState:
        """Load the checkpoint of `step` into `state` (the model in place)."""
        payload = torch.load(self._ckpt_path(step), map_location=state.model.device, weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.opt_state = payload["opt_state"]
        state.step = int(payload["step"])
        logging.info("resumed from checkpoint step %d", step)
        return state

    # -- warm start ----------------------------------------------------
    def _migrate_corr_width(self, loaded: dict, current: dict) -> dict:
        """Widen a uniform-k checkpoint's update-transformer input projection
        to this model's `corr_neighbors_per_level`.

        The input columns are [flow embedding | per level, k_l neighbours
        x F features, neighbour-major | track features | mask, vis]
        (`MVTracker.forward_iteration`). The columns of the ranks the old
        checkpoint had move to their new places; those of added ranks are
        zero, so the model computes what the old one did until training
        uses them. Only a width difference that corr width explains is
        migrated; anything else is left to the merge, which flags it."""
        model = self.model
        key = "updateformer.input_transform.weight"
        if getattr(model, "corr_neighbors_per_level", None) is None or key not in loaded or key not in current:
            return loaded
        old = loaded[key]
        d_old, d_new = old.shape[1], current[key].shape[1]
        if d_old == d_new:
            return loaded
        fe = (model.flow_embed_dim + 1) * 3
        f = model.corr_feat_width
        levels = model.corr_n_levels
        corr_old = d_old - fe - model.fmaps_dim - 2
        if corr_old <= 0 or corr_old % (f * levels):
            return loaded
        k_old = corr_old // (f * levels)
        new = torch.zeros((old.shape[0], d_new), dtype=old.dtype)
        new[:, :fe] = old[:, :fe]
        src = dst = fe
        for lvl in range(levels):
            k_new = model.corr_k(lvl)
            ncopy = min(k_old, k_new) * f
            new[:, dst : dst + ncopy] = old[:, src : src + ncopy]
            src += k_old * f
            dst += k_new * f
        new[:, dst:] = old[:, src:]
        loaded[key] = new
        logging.info(
            "warm-start: migrated input_transform %d -> %d columns (uniform k=%d -> per-level %s, new neighbour "
            "columns zero-init)", d_old, d_new, k_old, tuple(model.corr_k(lvl) for lvl in range(levels)),
        )
        return loaded

    def warm_start(self, state: step_lib.TrainState, path: str, strict: bool = False) -> step_lib.TrainState:
        """Load model weights from a file into `state.model` before training.

        `path`: a flax msgpack params file (bf16 leaves are widened, then
        every value is cast to its parameter's dtype; an unrolled pre-scan
        update transformer is stacked first, `convert.read_flax_params`), or
        a `.pth`/`.pt` state dict of the reference model or of the port (the
        same names; a training checkpoint's "model" entry is taken; read with
        `torch.load(weights_only=True)`, so a file holding other Python
        objects is refused). The corr-width migration runs on the loaded
        state dict. Every leaf that matches a parameter by name and shape is
        loaded; with a leaf skipped or a parameter left at its value, a
        warning names each and the load goes on, or with `strict=True` a
        ValueError is raised and nothing is loaded. The optimizer state is
        left as it is."""
        model = state.model
        current = model.state_dict()
        unread = []
        if path.endswith((".pth", ".pt")):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(ckpt, dict) and "model" in ckpt and not any(str(k).startswith("fnet") for k in ckpt):
                ckpt = ckpt["model"]
            loaded = {k: torch.as_tensor(v) for k, v in ckpt.items()}
        else:
            loaded, unread = convert.read_flax_params(path)
        loaded = self._migrate_corr_width(loaded, current)

        merged, skipped_keys = dict(current), list(unread)
        used = 0
        for k, v in loaded.items():
            if k in current and tuple(current[k].shape) == tuple(v.shape):
                merged[k] = v.to(current[k].dtype)
                used += 1
            else:
                skipped_keys.append(k)
        for k in skipped_keys:
            logging.warning("warm-start: skipping %s %s", k, tuple(loaded[k].shape) if k in loaded else "(not a parameter)")
        skipped, missing = len(skipped_keys), len(current) - used
        if skipped or missing:
            if strict:
                missing_keys = sorted(set(current) - {k for k in loaded if k in current and k not in skipped_keys})
                raise ValueError(
                    f"strict warm-start from {path}: {skipped} leaves skipped {skipped_keys[:8]}, {missing} left at "
                    f"init {missing_keys[:8]} — model config does not match the checkpoint"
                )
            logging.warning("warm-start non-strict: %d loaded, %d skipped, %d left at init", used, skipped, missing)
        else:
            logging.info("warm-start strict: all %d leaves loaded from %s", used, path)
        model.load_state_dict(merged, strict=True)
        return state

    # -- main loop -----------------------------------------------------
    def _get_step_fn(self, iters: int):
        if iters not in self._steps:
            self._steps[iters] = step_lib.make_train_step(
                self.model,
                self.optimizer,
                iters=iters,
                gamma=self.cfg.gamma,
                vis_weight=self.cfg.visibility_loss_weight,
                feat_id_weight=self.cfg.feat_id_loss_weight,
                mesh=self.mesh,
                shard_views=self.shard_views,
            )
        return self._steps[iters]

    def _broadcast_state(self, state: step_lib.TrainState, step: int) -> int:
        """Rank 0's parameters, buffers, optimizer state and step on every
        rank; returns the step."""
        group = torch.distributed.group.WORLD
        for t in state.model.state_dict().values():
            mesh_lib.broadcast(t, 0, group)
        for name in sorted(state.opt_state["mu"]):
            mesh_lib.broadcast(state.opt_state["mu"][name], 0, group)
            mesh_lib.broadcast(state.opt_state["nu"][name], 0, group)
        meta = torch.tensor([int(state.opt_state["count"]), state.step, step], device=state.model.device)
        mesh_lib.broadcast(meta, 0, group)
        state.opt_state["count"], state.step, step = (int(v) for v in meta.tolist())
        return step

    def _should_stop(self, agreed: bool) -> bool:
        """Without a mesh, this process's stop request; with one, what the
        ranks `agreed` on at the last synchronised step."""
        return self._stop_requested if self.mesh is None else agreed

    def _any_rank_stops(self) -> bool:
        flag = torch.tensor([float(self._stop_requested)], device=self.model.device)
        return bool(mesh_lib.all_reduce(flag, torch.distributed.group.WORLD, op=torch.distributed.ReduceOp.MAX).item())

    def _install_signal_handlers(self):
        def handler(signum, frame):
            logging.warning("signal %d received: checkpoint-and-exit requested", signum)
            self._stop_requested = True

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):  # not the main thread
                pass

    def fit(
        self,
        data_iter: Iterator[dict],
        state: Optional[step_lib.TrainState] = None,
        eval_fn: Optional[Callable[[step_lib.TrainState, int], dict]] = None,
        max_steps: Optional[int] = None,
        static_data_iter: Optional[Iterator[dict]] = None,
        on_step: Optional[Callable[[int, dict], None]] = None,
    ) -> step_lib.TrainState:
        """Train until `max_steps` (default `cfg.total_steps`) or a stop
        signal; resumes from the newest checkpoint of `cfg.exp_dir`, or when
        there is none warm-starts from `cfg.warm_start_ckpt` if set. The
        model's own parameters are the starting point otherwise, so no batch
        is used up to initialise them. The first `cfg.static_pretrain_steps`
        steps draw from `static_data_iter` when it is given.
        `eval_fn(state, step)` runs after every `cfg.eval_freq`-th step.
        `on_step(step, metrics)`, when given, is called after every step with
        the number of steps taken so far and that step's metrics (scalar
        tensors, not yet synchronised)."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        self._install_signal_handlers()
        os.makedirs(cfg.exp_dir, exist_ok=True)
        if state is None:
            state = step_lib.init_state(self.model, self.optimizer)
        start_step = 0
        if self.is_main:
            if cfg.warm_start_ckpt and self.latest_step() is None:
                state = self.warm_start(state, cfg.warm_start_ckpt)
            state, start_step = self.restore_latest(state)
        if self.mesh is not None:
            start_step = self._broadcast_state(state, start_step)

        total = max_steps if max_steps is not None else cfg.total_steps
        data_times, step_times = [], []
        step = start_step
        reproj_bad_streak = 0
        batch = None
        profiler = None
        if cfg.profile_start_step >= 0:
            profiler = obs.ProfilerTraceWindow(
                os.path.join(cfg.exp_dir, "profile"), start=cfg.profile_start_step, n_steps=cfg.profile_n_steps)
        self._watchdog(first=True)  # the first step builds the kernels
        wandb_run = None
        if cfg.wandb and self.is_main:
            try:
                import wandb

                wandb_run = wandb.init(project=cfg.wandb_project, dir=cfg.exp_dir, config=dataclasses.asdict(cfg),
                                       sync_tensorboard=True)
            except Exception as e:  # absent, or no way to reach its service: train on without it
                logging.warning("wandb requested but unavailable (%s); continuing without", e)
        stop = False  # with a mesh: every rank's request, reduced where the step synchronises
        try:
            while step < total and not self._should_stop(stop):
                if profiler is not None:
                    profiler.step(step)
                t0 = time.perf_counter()
                use_static = static_data_iter is not None and step < cfg.static_pretrain_steps
                batch = next(static_data_iter if use_static else data_iter)
                t1 = time.perf_counter()

                iters = augment_train_iters(step, cfg, rng)
                state, metrics = self._get_step_fn(iters)(state, batch)
                do_sync = (
                    cfg.sync_every <= 1
                    or (step + 1) % cfg.sync_every == 0
                    or (step + 1) % cfg.telemetry_freq == 0
                    or (step + 1) % cfg.save_ckpt_freq == 0
                    or (eval_fn is not None and (step + 1) % cfg.eval_freq == 0)
                    or (step + 1) >= total
                )
                if do_sync:
                    loss = float(metrics["loss"])  # blocks: the synchronisation point
                    if self.mesh is not None:
                        # do_sync falls on the same steps on every rank, so
                        # all ranks stop after the same step.
                        stop = self._any_rank_stops()
                t2 = time.perf_counter()

                data_times.append(t1 - t0)
                step_times.append(t2 - t1)
                step += 1
                self._watchdog()
                if on_step is not None:
                    on_step(step, metrics)
                if not do_sync:
                    continue
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
                if cfg.reproj_guard_atol > 0 and "reproj_dev" in metrics:
                    rdev = float(metrics["reproj_dev"])
                    if not rdev < cfg.reproj_guard_atol:
                        reproj_bad_streak += 1
                        logging.warning(
                            "reprojection round-trip deviation %.3g exceeds atol %g at step %d "
                            "(%d/%d consecutive before abort)",
                            rdev, cfg.reproj_guard_atol, step, reproj_bad_streak, cfg.reproj_guard_patience,
                        )
                        if reproj_bad_streak >= cfg.reproj_guard_patience:
                            raise FloatingPointError(
                                f"reprojection round-trip deviation {rdev:.3g} exceeded atol "
                                f"{cfg.reproj_guard_atol} for {reproj_bad_streak} consecutive steps "
                                "(intrinsics/extrinsics mis-application upstream?)"
                            )
                    else:
                        reproj_bad_streak = 0

                tb = self._tb_writer()
                if tb is not None:
                    tb.add_scalar("train/loss", loss, step)
                    for k in ("xyz_loss", "vis_loss", "grad_norm"):
                        if k in metrics:
                            tb.add_scalar(f"train/{k}", float(metrics[k]), step)

                if step % cfg.telemetry_freq == 0:
                    mem = obs.device_memory_stats()
                    if mem:
                        logging.info("step %d device memory (MiB): %s", step, mem)
                        if tb is not None:
                            tb.add_scalar("sys/peak_hbm_mb", max(m["peak_bytes_in_use_mb"] for m in mem.values()), step)
                    dt, st = np.asarray(data_times), np.asarray(step_times)
                    logging.info(
                        "step %d loss=%.4f xyz=%.4f vis=%.4f grad_norm=%.4f | data %.0f/%.0f/%.0f ms "
                        "step %.0f/%.0f/%.0f ms (mean/med/std)",
                        step, loss, float(metrics["xyz_loss"]), float(metrics["vis_loss"]),
                        float(metrics["grad_norm"]),
                        dt.mean() * 1e3, np.median(dt) * 1e3, dt.std() * 1e3,
                        st.mean() * 1e3, np.median(st) * 1e3, st.std() * 1e3,
                    )
                    data_times, step_times = [], []
                # Checkpoints and evaluations may outlast a step's deadline:
                # the long deadline holds for their duration.
                long_block = step % cfg.save_ckpt_freq == 0 or (eval_fn is not None and step % cfg.eval_freq == 0)
                if long_block:
                    self._watchdog(first=True)
                if step % cfg.save_ckpt_freq == 0 and self.is_main:
                    self.save(state, step)
                if eval_fn is not None and step % cfg.eval_freq == 0 and self.is_main:
                    eval_fn(state, step)
                if long_block:
                    self._watchdog()
        except Exception:
            # Crash forensics: two best-effort saves, each on its own, so a
            # failed batch dump (or no batch at all, when the first fetch
            # raised) does not also lose the checkpoint.
            if not self.is_main:
                raise
            crash_dir = os.path.join(cfg.exp_dir, "crash")
            os.makedirs(crash_dir, exist_ok=True)
            try:
                arrays = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in batch.items()}
                np.savez(os.path.join(crash_dir, f"batch_step{step}.npz"), **arrays)
            except Exception:
                logging.exception("failed to dump the crash batch")
            try:
                self.save(state, step)
            except Exception:
                logging.exception("failed to save the crash checkpoint")
            raise
        finally:
            if profiler is not None:
                profiler.close(step - 1)
                self.profile_trace = profiler.path
            if cfg.watchdog_timeout_s > 0:
                obs.cancel_hang_watchdog()
            if self._tb is not None:
                self._tb.flush()
            if wandb_run is not None:
                wandb_run.finish()

        if self._should_stop(stop) and self.is_main:
            self.save(state, step)
        return state
