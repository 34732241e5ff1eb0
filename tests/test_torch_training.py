"""The port's `Trainer` on the tiny model and loader the JAX package's own
training tests use (`tests/test_training.py`): the loss falls, a fresh
trainer resumes from the newest checkpoint, the adaptive-iteration schedule
makes the JAX function's draws, a crash leaves the batch and a checkpoint
behind, and the guards raise."""

import logging
import os
import signal

import numpy as np
import pytest
import torch

from mvtracker_torch.convert import random_state_dict
from mvtracker_torch.datasets.loader import PrefetchLoader, SyntheticSceneDataset
from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.training import step as step_lib
from mvtracker_torch.training.train import TrainConfig, Trainer, augment_train_iters
from mvtracker_tpu.datasets.loader import PrefetchLoader as JaxPrefetchLoader
from mvtracker_tpu.datasets.loader import SyntheticSceneDataset as JaxSyntheticSceneDataset
from mvtracker_tpu.training import train as j_train

DATA = dict(n_scenes=2, cache=True, n_views=2, n_frames=6, height=32, width=32, n_tracks=8)


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    """One intra-op thread while this file runs. The suite runs in several
    worker processes; a PyTorch thread pool per process oversubscribes the
    cores, and the backward then runs many times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_model(seed=0):
    model = MVTracker(
        sliding_window_len=4, fmaps_dim=16, num_heads=2, hidden_size=32, space_depth=1, time_depth=1,
        num_virtual_tracks=4, corr_n_levels=2, corr_neighbors=4, device="cpu",
    )
    model.load_state_dict(random_state_dict(model, seed))
    return model


def tiny_loader(batch_size=1):
    return PrefetchLoader(SyntheticSceneDataset(**DATA), batch_size=batch_size, num_workers=1, shuffle=False)


def config(tmp_path, **kw):
    base = dict(
        total_steps=30, warmup_steps=0, adaptive_iters=False, train_iters=1, save_ckpt_freq=1000,
        telemetry_freq=10, exp_dir=str(tmp_path / "exp"), schedule="const",
    )
    return TrainConfig(**{**base, **kw})


def test_loader_and_scenes_equal_the_jax_packages():
    """The copied data modules give the JAX package's batches, key by key."""
    want = next(iter(JaxPrefetchLoader(JaxSyntheticSceneDataset(**DATA), batch_size=2, num_workers=1, shuffle=False)))
    got = next(iter(tiny_loader(batch_size=2)))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    augmented = SyntheticSceneDataset(**DATA, augment=True)[0]  # a fresh unseeded generator per touch
    plain = SyntheticSceneDataset(**DATA)[0]
    assert augmented.video.shape == plain.video.shape and np.isfinite(augmented.video).all()
    assert not np.array_equal(augmented.video, plain.video)


def test_loader_shuffle_workers_and_prefetch_equal_the_jax_packages():
    """Shuffled epochs, a ragged last batch, the thread pool and the
    prefetching thread: the same batches in the same order as the JAX
    package's loader, over two epochs."""
    data = dict(DATA, n_scenes=3, randomize=True)
    kw = dict(batch_size=2, num_workers=2, shuffle=True, seed=4, drop_last=False)
    want = JaxPrefetchLoader(JaxSyntheticSceneDataset(**data), **kw).prefetching_iter()
    got = PrefetchLoader(SyntheticSceneDataset(**data), **kw).prefetching_iter()
    for _ in range(4):  # two epochs of a full and a ragged batch
        g, w = next(got), next(want)
        assert g["rgbs"].shape == w["rgbs"].shape
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    got.close()
    want.close()


def test_loader_statefulness():
    loader = tiny_loader()
    it = iter(loader)
    next(it)
    state = loader.state_dict()
    expected = next(it)
    loader2 = tiny_loader()
    loader2.load_state_dict(state)
    np.testing.assert_allclose(next(iter(loader2))["rgbs"], expected["rgbs"])


def test_augment_train_iters_draws_equal_the_jax_function():
    for train_iters in (4, 2):
        cfg = TrainConfig(warmup_steps=10, train_iters=train_iters)
        j_cfg = j_train.TrainConfig(warmup_steps=10, train_iters=train_iters)
        rng, j_rng = np.random.default_rng(0), np.random.default_rng(0)
        got = [augment_train_iters(step, cfg, rng) for step in range(300)]
        want = [j_train.augment_train_iters(step, j_cfg, j_rng) for step in range(300)]
        assert got == want
        assert got[:10] == [1] * 10 and set(got) <= set(range(1, train_iters + 1))
        assert rng.random() == j_rng.random()  # the generators moved in step
    assert augment_train_iters(500, TrainConfig(adaptive_iters=False, train_iters=3), rng) == 3


def test_overfit_loss_decreases(tmp_path, caplog):
    """30 steps at a constant rate on two scenes: the loss falls."""
    trainer = Trainer(tiny_model(), config(tmp_path, lr=3e-4))
    losses = []
    with caplog.at_level(logging.INFO):
        state = trainer.fit(
            iter(tiny_loader()), max_steps=30, on_step=lambda step, metrics: losses.append((step, float(metrics["loss"])))
        )
    assert state.step == 30 and [step for step, _ in losses] == list(range(1, 31))
    losses = [loss for _, loss in losses]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first, f"loss did not decrease: {first} -> {last}"
    telemetry = [r.getMessage() for r in caplog.records if "mean/med/std" in r.getMessage()]
    assert len(telemetry) == 3 and telemetry[0].startswith("step 10 loss=")


def test_checkpoint_resume_and_keep(tmp_path):
    cfg = config(tmp_path, total_steps=10, save_ckpt_freq=5, telemetry_freq=100, keep_ckpts=2)
    model = tiny_model()
    t1 = Trainer(model, cfg)
    state = t1.fit(iter(tiny_loader()), max_steps=6)
    assert state.step == 6 and t1.checkpoint_steps() == [5]
    at_5 = torch.load(os.path.join(t1.ckpt_dir, "step_5.pt"), weights_only=True)

    # A fresh trainer and a fresh model resume from the step-5 checkpoint.
    model2 = tiny_model(seed=7)
    t2 = Trainer(model2, cfg)
    seen = []
    real = t2._get_step_fn

    def checked_step_fn(iters):
        fn = real(iters)

        def stepper(state, batch):
            if not seen:
                for name, p in state.model.named_parameters():
                    assert torch.equal(p, at_5["model"][name]), name
                assert state.opt_state["count"] == 5
                for name, mu in state.opt_state["mu"].items():
                    assert torch.equal(mu, at_5["opt_state"]["mu"][name]), name
            seen.append(state.step)
            return fn(state, batch)

        return stepper

    t2._get_step_fn = checked_step_fn
    state2 = t2.fit(iter(tiny_loader()), max_steps=16)
    assert seen == list(range(5, 16)) and state2.step == 16
    assert t2.checkpoint_steps() == [10, 15]  # keep_ckpts newest
    assert t2.latest_step() == 15


def test_crash_forensics(tmp_path):
    """On an exception in the step, the offending batch and a checkpoint are
    written and the exception goes on."""
    trainer = Trainer(tiny_model(), config(tmp_path, total_steps=5))

    class Boom(Exception):
        pass

    calls = []
    real = trainer._get_step_fn

    def failing(iters):
        fn = real(iters)

        def stepper(state, batch):
            calls.append(1)
            if len(calls) >= 2:
                raise Boom("injected failure")
            return fn(state, batch)

        return stepper

    trainer._get_step_fn = failing
    loader = tiny_loader()
    with pytest.raises(Boom):
        trainer.fit(iter(loader), max_steps=5)
    dumps = list((tmp_path / "exp" / "crash").glob("batch_step*.npz"))
    assert [d.name for d in dumps] == ["batch_step1.npz"]
    data = np.load(dumps[0])
    second = tiny_loader()
    it = iter(second)
    next(it)
    np.testing.assert_array_equal(data["rgbs"], next(it)["rgbs"])  # the batch that failed, not the one before
    assert trainer.checkpoint_steps() == [1]
    # The dumped batch goes through the loss again.
    model = tiny_model()
    scene = {k: v[0] for k, v in data.items() if v.ndim > 0}
    total, _ = step_lib.scene_loss(model, scene, 1, 0.8, 0.1)
    assert np.isfinite(float(total.detach()))


def test_non_finite_loss_raises(tmp_path):
    trainer = Trainer(tiny_model(), config(tmp_path, total_steps=5))
    real = trainer._get_step_fn

    def poisoned(iters):
        fn = real(iters)

        def stepper(state, batch):
            state, metrics = fn(state, batch)
            if state.step == 2:
                metrics = dict(metrics, loss=torch.tensor(float("nan")))
            return state, metrics

        return stepper

    trainer._get_step_fn = poisoned
    with pytest.raises(FloatingPointError, match="non-finite loss at step 2"):
        trainer.fit(iter(tiny_loader()), max_steps=5)
    assert trainer.checkpoint_steps() == [2]  # crash forensics ran


def test_reprojection_guard_patience(tmp_path, caplog):
    trainer = Trainer(tiny_model(), config(tmp_path, total_steps=10, reproj_guard_patience=3))
    real = trainer._get_step_fn
    bad_steps = {1, 3, 4, 5}  # one alone, then three in a row

    def drifting(iters):
        fn = real(iters)

        def stepper(state, batch):
            state, metrics = fn(state, batch)
            assert float(metrics["reproj_dev"]) < 1e-3  # the real guard value is tiny
            if state.step in bad_steps:
                metrics = dict(metrics, reproj_dev=torch.tensor(7.0))
            return state, metrics

        return stepper

    trainer._get_step_fn = drifting
    with caplog.at_level(logging.WARNING), pytest.raises(FloatingPointError, match="3 consecutive steps"):
        trainer.fit(iter(tiny_loader()), max_steps=10)
    assert sum("reprojection round-trip deviation" in r.getMessage() for r in caplog.records) == 4
    assert trainer.latest_step() == 5


def test_stop_signal_checkpoints_and_returns(tmp_path):
    trainer = Trainer(tiny_model(), config(tmp_path, total_steps=10))
    real = trainer._get_step_fn

    def signalling(iters):
        fn = real(iters)

        def stepper(state, batch):
            out = fn(state, batch)
            if state.step == 3:
                os.kill(os.getpid(), signal.SIGUSR1)
            return out

        return stepper

    trainer._get_step_fn = signalling
    previous = signal.getsignal(signal.SIGUSR1), signal.getsignal(signal.SIGTERM)
    try:
        state = trainer.fit(iter(tiny_loader()), max_steps=10)
    finally:
        signal.signal(signal.SIGUSR1, previous[0])
        signal.signal(signal.SIGTERM, previous[1])
    assert state.step == 3 and trainer.checkpoint_steps() == [3]


def test_sync_every_skips_the_fetch(tmp_path):
    """With sync_every=4 the loss is fetched, and the guards run, on steps
    4 and 8 and on the last step only."""
    trainer = Trainer(tiny_model(), config(tmp_path, total_steps=9, sync_every=4, telemetry_freq=100))
    fetched = []
    real = trainer._get_step_fn

    def spying(iters):
        fn = real(iters)

        def stepper(state, batch):
            state, metrics = fn(state, batch)
            step = state.step

            class Loss:
                def __float__(self):
                    fetched.append(step)
                    return float(metrics["loss"])

            return state, dict(metrics, loss=Loss())

        return stepper

    trainer._get_step_fn = spying
    trainer.fit(iter(tiny_loader()), max_steps=9)
    assert fetched == [4, 8, 9]
