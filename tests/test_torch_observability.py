"""The port's observability and forensics against the JAX package's on the
CPU: `RankedLogger`'s records, the faulthandler hang watchdog (dump within
its deadline, cancel, exit), the `torch.profiler` trace window, device
memory stats without a GPU, TensorBoard events from `Trainer.fit`, and crash
replay: a batch the trainer dumps replays through the port's `scene_loss`
to the JAX `replay`'s loss on the same batch and converted weights.

Every test that arms the watchdog cancels it in a `finally`: faulthandler's
timer is one per process and would fire into a later test."""

import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.training import replay as t_replay
from mvtracker_torch.training.train import Trainer
from mvtracker_torch.utils import observability as t_obs
from mvtracker_tpu.convert import convert_reference_state_dict
from mvtracker_tpu.models.mvtracker import MVTracker as JaxMVTracker
from mvtracker_tpu.training import replay as j_replay
from mvtracker_tpu.utils import observability as j_obs
from tests.test_torch_modules import carried_weights
from tests.test_torch_training import config as train_config
from tests.test_torch_training import tiny_loader, tiny_model

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(sliding_window_len=4, fmaps_dim=16, num_heads=2, hidden_size=32, space_depth=1, time_depth=1,
            num_virtual_tracks=4, corr_n_levels=2, corr_neighbors=4)
# Replay, port against JAX in fp32: the loss sums in another order
# (`tests/test_torch_step.py` holds scene_loss to 2e-6 relative).
REPLAY_RTOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_ranked_logger_records_like_jax(caplog):
    caplog.set_level(logging.INFO)
    for mod in (t_obs, j_obs):
        log = mod.RankedLogger("mvt.obs", rank_zero_only=False)
        log.info("step %d", 3)
        log.info("only on rank 1", rank=1)
        mod.RankedLogger("mvt.obs", rank_zero_only=True).warning("zero")
    got = [r.getMessage() for r in caplog.records]
    assert got == ["[rank 0] step 3", "[rank 0] zero"] * 2


def test_watchdog_dumps_within_its_deadline_and_cancels(capfd):
    try:
        t_obs.install_hang_watchdog(0.3, repeat=False, exit=False)
        time.sleep(1.0)
    finally:
        t_obs.cancel_hang_watchdog()
    err = capfd.readouterr().err
    assert "Timeout (0:00:00.300000)!" in err and "test_torch_observability.py" in err
    try:
        t_obs.install_hang_watchdog(0.3, repeat=False)
        t_obs.reset_hang_watchdog(0.6, repeat=False)
        t_obs.cancel_hang_watchdog()
        time.sleep(0.9)
    finally:
        t_obs.cancel_hang_watchdog()
    assert "Timeout" not in capfd.readouterr().err


def test_watchdog_exit_ends_the_process():
    code = ("import time\nfrom mvtracker_torch.utils import observability as obs\n"
            "obs.install_hang_watchdog(0.5, exit=True)\ntime.sleep(60)\nprint('not reached')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "not reached" not in out.stdout
    assert "Timeout" in out.stderr and time.perf_counter() - t0 < 50


def test_profiler_window_writes_a_trace(tmp_path):
    window = t_obs.ProfilerTraceWindow(str(tmp_path), start=2, n_steps=2)
    x = torch.rand(64, 64)
    for i in range(6):
        window.step(i)
        x = torch.tanh(x @ x.T / 64)
    window.close()
    assert window.path == str(tmp_path / "trace_steps2-3.json")
    events = json.loads(Path(window.path).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"aten::mm", "aten::tanh"} <= names
    assert t_obs.device_memory_stats() == {}  # no GPU here


def test_trainer_writes_tensorboard_events_and_a_trace(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    cfg = train_config(tmp_path, telemetry_freq=1, profile_start_step=1, profile_n_steps=2)
    assert cfg.tensorboard and cfg.watchdog_timeout_s == 600.0
    losses = []
    trainer = Trainer(tiny_model(), cfg)
    trainer.fit(iter(tiny_loader()), max_steps=4, on_step=lambda step, m: losses.append(float(m["loss"])))
    tb = EventAccumulator(os.path.join(cfg.exp_dir, "tb"))
    tb.Reload()
    assert {"train/loss", "train/xyz_loss", "train/vis_loss", "train/grad_norm"} <= set(tb.Tags()["scalars"])
    got = [(e.step, e.value) for e in tb.Scalars("train/loss")]
    assert [s for s, _ in got] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got], losses, rtol=1e-6)
    assert trainer.profile_trace == os.path.join(cfg.exp_dir, "profile", "trace_steps1-2.json")
    assert os.path.getsize(trainer.profile_trace) > 0


def test_crash_batch_replays_to_the_jax_loss(tmp_path):
    """An evaluation hook that raises at step 2 makes the trainer dump the
    batch it trained on; `load_crash_batch` picks the newest dump by step
    number; `replay` of that batch on the converted weights gives the JAX
    `replay`'s loss and no non-finite gradient."""
    model = tiny_model()
    model.load_state_dict(carried_weights(model, seed=0)[0])

    def boom(state, step):
        raise RuntimeError(f"injected failure at step {step}")

    cfg = train_config(tmp_path, eval_freq=2, tensorboard=False)
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        Trainer(model, cfg).fit(iter(tiny_loader()), eval_fn=boom, max_steps=5)
    crash = Path(cfg.exp_dir) / "crash"
    assert sorted(os.listdir(crash)) == ["batch_step2.npz"]
    batch = t_replay.load_crash_batch(str(crash))
    np.savez(crash / "batch_step10.npz", **{k: v + (1 if k == "rgbs" else 0) for k, v in batch.items()})
    assert t_replay.load_crash_batch(str(crash))["rgbs"][0, 0, 0, 0, 0, 0] == batch["rgbs"][0, 0, 0, 0, 0, 0] + 1
    with pytest.raises(FileNotFoundError):
        t_replay.load_crash_batch(str(tmp_path))

    replayed = tiny_model()
    replayed.load_state_dict(model.state_dict())  # the weights the trainer had reached at the crash
    replayed.train()
    got = t_replay.replay(batch, replayed, iters=1)
    params = jax.tree.map(jnp.asarray, convert_reference_state_dict(
        {k: v.detach().numpy() for k, v in replayed.state_dict().items()}))
    want = j_replay.replay({k: jnp.asarray(v) for k, v in batch.items()}, JaxMVTracker(**TINY), params, iters=1)
    assert got["nonfinite_grad_leaves"] == [] and want["nonfinite_grad_leaves"] == []
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=REPLAY_RTOL)
    assert all(p.grad is None for p in replayed.parameters())

