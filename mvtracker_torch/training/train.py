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
  written before the exception goes on.

Not ported yet: warm start from a weights file and its two layout
migrations, the evaluation hook (`eval_fn`, `eval_freq`: evaluation itself
is not ported), TensorBoard and W&B, the profiler window, the hang watchdog,
the static-pretrain iterator, crash replay, and the device mesh.
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

from mvtracker_torch.training import step as step_lib


@dataclasses.dataclass
class TrainConfig:
    """The trainer's settings; names and defaults are the JAX package's."""

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
    telemetry_freq: int = 100
    seed: int = 0
    exp_dir: str = "experiments/default"
    adaptive_iters: bool = True
    keep_ckpts: int = 3
    # Reprojection round-trip guard: warn per offending step, raise after
    # this many in a row. atol 0 disables.
    reproj_guard_atol: float = 1.0
    reproj_guard_patience: int = 5
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
    def __init__(self, model, cfg: TrainConfig):
        self.model = model
        self.cfg = cfg
        self.optimizer = step_lib.make_optimizer(
            lr=cfg.lr,
            weight_decay=cfg.weight_decay,
            total_steps=cfg.total_steps,
            grad_clip=cfg.grad_clip,
            schedule=cfg.schedule,
        )
        self._steps = {}  # iters -> train step
        self._stop_requested = False

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
        payload = torch.load(self._ckpt_path(latest), map_location=state.model.device, weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.opt_state = payload["opt_state"]
        state.step = int(payload["step"])
        logging.info("resumed from checkpoint step %d", latest)
        return state, latest

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
            )
        return self._steps[iters]

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
        max_steps: Optional[int] = None,
        on_step: Optional[Callable[[int, dict], None]] = None,
    ) -> step_lib.TrainState:
        """Train until `max_steps` (default `cfg.total_steps`) or a stop
        signal; resumes from the newest checkpoint of `cfg.exp_dir`. The
        model's own parameters are the starting point, so no batch is used
        up to initialise them. `on_step(step, metrics)`, when given, is
        called after every step with the number of steps taken so far and
        that step's metrics (scalar tensors, not yet synchronised)."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        self._install_signal_handlers()
        os.makedirs(cfg.exp_dir, exist_ok=True)
        if state is None:
            state = step_lib.init_state(self.model, self.optimizer)
        state, start_step = self.restore_latest(state)

        total = max_steps if max_steps is not None else cfg.total_steps
        data_times, step_times = [], []
        step = start_step
        reproj_bad_streak = 0
        batch = None
        try:
            while step < total and not self._stop_requested:
                t0 = time.perf_counter()
                batch = next(data_iter)
                t1 = time.perf_counter()

                iters = augment_train_iters(step, cfg, rng)
                state, metrics = self._get_step_fn(iters)(state, batch)
                do_sync = (
                    cfg.sync_every <= 1
                    or (step + 1) % cfg.sync_every == 0
                    or (step + 1) % cfg.telemetry_freq == 0
                    or (step + 1) % cfg.save_ckpt_freq == 0
                    or (step + 1) >= total
                )
                if do_sync:
                    loss = float(metrics["loss"])  # blocks: the synchronisation point
                t2 = time.perf_counter()

                data_times.append(t1 - t0)
                step_times.append(t2 - t1)
                step += 1
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

                if step % cfg.telemetry_freq == 0:
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
                if step % cfg.save_ckpt_freq == 0:
                    self.save(state, step)
        except Exception:
            # Crash forensics: two best-effort saves, each on its own, so a
            # failed batch dump (or no batch at all, when the first fetch
            # raised) does not also lose the checkpoint.
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

        if self._stop_requested:
            self.save(state, step)
        return state
