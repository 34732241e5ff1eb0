"""The other model families through the port's entry points on the CPU:
`build_model` for the 15 names the port refused before (the triplane
SpaTracker, the learned 2D tracker, the monocular-baseline zoo), each
family's preset loading as the JAX package loads it, `cli.train` then
`cli.eval` on `configs/spatracker_multiview.yaml` and
`configs/cotracker2d.yaml` at tiny widths, and `Trainer.fit` of the 2D
tracker on monocular proxies."""

import dataclasses
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from mvtracker_torch import config as t_config
from mvtracker_torch.cli import eval as t_eval
from mvtracker_torch.cli import train as t_train
from mvtracker_torch.datasets.loader import MonocularProxyDataset, PrefetchLoader, SyntheticSceneDataset
from mvtracker_torch.models.cotracker2d import CoTracker2D, LearnedTracker2D
from mvtracker_torch.models.monocular import MonocularToMultiViewAdapter, SimpleNNTracker2D
from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.models.spatracker import MultiViewSpaTracker
from mvtracker_torch.training.train import TrainConfig, Trainer
from mvtracker_tpu import config as j_config
from tests.test_torch_config_cli import as_jax_has_it

ROOT = Path(__file__).resolve().parent.parent
ZOO = t_config.MONOCULAR_BASELINES
OTHER_PRESETS = sorted(
    str(p.relative_to(ROOT)) for p in ROOT.glob("configs/*.yaml")
    if not p.name.startswith(("mvtracker", "overfit", "copycat"))
)
# Tiny widths for the CLIs (seconds of CPU work per step).
TINY_MODEL = ["model.sliding_window_len=4", "model.fmaps_dim=16", "model.num_heads=2", "model.hidden_size=32",
              "model.space_depth=1", "model.time_depth=1", "model.num_virtual_tracks=4", "model.corr_n_levels=2",
              "model.corr_patch_radius=1"]
TINY_RUN = ["data.n_views=2", "data.n_frames=6", "data.height=32", "data.width=32", "data.num_tracks=8",
            "data.num_workers=1", "trainer.warmup_steps=0", "trainer.adaptive_iters=false", "trainer.train_iters=1",
            "trainer.telemetry_freq=1", "trainer.total_steps=2", "trainer.save_ckpt_freq=2", "trainer.tensorboard=false",
            "eval.grid_size=0", "eval.n_iters=1", "eval.max_sequences=1"]


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_no_family_is_refused():
    assert t_config._FAMILIES_NOT_PORTED == {}
    assert set(ZOO) == set(j_config._MONOCULAR_BASELINES)


@pytest.mark.parametrize("name", ["spatracker_multiview", "cotracker2d", *ZOO])
def test_build_model_every_family(name, caplog):
    """All 15 names build on the CPU. The zoo has no hub cache here: each
    logs what is missing and falls back to the NCC tracker, on the device
    asked for."""
    with caplog.at_level(logging.WARNING):
        model = t_config.build_model(t_config.ModelConfig(name=name), device="cpu")
    if name == "spatracker_multiview":
        assert isinstance(model, MultiViewSpaTracker) and not model.training
        assert model.support_memory_tokens == 100 and model.device.type == "cpu"
        return
    assert isinstance(model, MonocularToMultiViewAdapter) and model.jit_compatible is False
    assert model.device.type == "cpu"
    if name == "cotracker2d":
        assert isinstance(model.tracker_2d, LearnedTracker2D) and model.tracker_2d.device.type == "cpu"
        return
    assert isinstance(model.tracker_2d, SimpleNNTracker2D)
    report = [r.getMessage() for r in caplog.records if name in r.getMessage()]
    assert report and "falling back to the in-repo NCC tracker" in report[0]
    assert ("not cached" in report[0]) or ("vendored repo" in report[0]) or ("unknown hub baseline" in report[0])


def test_support_memory_defaults_per_family():
    """None keeps each family's own default; a value flows through."""
    small = ["model.fmaps_dim=16", "model.hidden_size=32", "model.num_heads=2", "model.space_depth=1",
             "model.time_depth=1", "model.corr_n_levels=2"]
    mvt = t_config.build_model(t_config.load_config(None, small).model, device="cpu")
    assert type(mvt) is MVTracker and mvt.support_memory_tokens == 0 and not hasattr(mvt.updateformer, "gnn")
    spat = t_config.build_model(t_config.load_config(None, small + ["model.name=spatracker_multiview"]).model,
                                device="cpu")
    assert spat.support_memory_tokens == 100
    mem = t_config.build_model(t_config.load_config(None, small + ["model.support_memory_tokens=16"]).model,
                               device="cpu")
    assert mem.updateformer.support_memory.shape == (1, 16, 32)
    want = j_config.build_model(j_config.load_config(None, ["model.name=spatracker_multiview"]).model)
    assert (spat.triplane_res, spat.corr_patch_radius) == (want.triplane_res, want.corr_patch_radius)


@pytest.mark.parametrize("path", OTHER_PRESETS)
def test_other_presets_load_like_jax(path):
    got, want = t_config.load_config(str(ROOT / path)), j_config.load_config(str(ROOT / path))
    for section in ("model", "data", "eval"):
        assert as_jax_has_it(section, getattr(got, section)) == dataclasses.asdict(getattr(want, section)), section


def test_checkpoint_2d_loads(tmp_path):
    """`checkpoint_2d` restores the learned 2D tracker from a torch file of
    the trainer (its "model" entry) or a bare state dict."""
    overrides = ["model.name=cotracker2d"] + TINY_MODEL
    first = t_config.build_model(t_config.load_config(None, overrides).model, device="cpu")
    sd = {k: v + 0.5 for k, v in first.tracker_2d.model.state_dict().items()}
    for i, payload in enumerate(({"model": sd, "step": 3}, sd)):
        torch.save(payload, tmp_path / f"c{i}.pt")
        built = t_config.build_model(
            t_config.load_config(None, overrides + [f"model.checkpoint_2d={tmp_path / f'c{i}.pt'}"]).model,
            device="cpu")
        for k, v in built.tracker_2d.model.state_dict().items():
            assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("config", ["configs/spatracker_multiview.yaml", "configs/cotracker2d.yaml"])
def test_cli_train_then_eval(tmp_path, config, caplog):
    """2 steps of `cli.train`, then `cli.eval` restores step 2 (into the 2D
    tracker inside the adapter for cotracker2d) and evaluates one scene."""
    exp = f"trainer.exp_dir={tmp_path / 'exp'}"
    extra = ["model.triplane_res=16", "model.support_memory_tokens=4"] if "spatracker" in config else []
    argv = ["--config", str(ROOT / config), "--device", "cpu", *TINY_MODEL, *TINY_RUN, *extra, exp]
    state = t_train.main(argv)
    assert state.step == 2
    model_cls = MultiViewSpaTracker if "spatracker" in config else CoTracker2D
    assert type(state.model) is model_cls
    assert sorted(p.name for p in (tmp_path / "exp" / "checkpoints").iterdir()) == ["step_2.pt"]
    with caplog.at_level(logging.INFO):
        summary = t_eval.main(argv)
    assert "evaluating checkpoint at step 2" in caplog.text
    assert summary["n_sequences"] == 1 and np.isfinite(summary["all_any"]["average_jaccard"])


def test_cli_train_refuses_the_zoo(tmp_path):
    with pytest.raises(ValueError, match="no weights to train"):
        t_train.main(["--config", str(ROOT / "configs/cotracker3_offline.yaml"), "--device", "cpu", *TINY_RUN,
                      f"trainer.exp_dir={tmp_path}"])


def test_trainer_fit_on_monocular_proxies(tmp_path):
    """48 steps on one monocular proxy scene reduce the tracking loss, as
    the JAX package's `test_cotracker2d.py::test_overfit_loss_decreases`
    (there 2.94 -> about 2.45 with Adam at 3e-3). The port's optimizer is
    AdamW with the global-norm clip; a constant rate of 3e-3, no decay."""
    ds = MonocularProxyDataset(SyntheticSceneDataset(n_scenes=1, cache=True, n_views=2, n_frames=6, height=48,
                                                     width=48, n_tracks=8, texture_detail=1.0))
    assert ds[0].video.shape[0] == 1 and np.all(ds[0].trajectory_3d[..., 2] == 0)
    model = CoTracker2D(sliding_window_len=4, stride=4, fmaps_dim=16, num_heads=2, hidden_size=32, space_depth=1,
                        time_depth=1, num_virtual_tracks=4, corr_n_levels=2, corr_patch_radius=2, device="cpu")
    cfg = TrainConfig(total_steps=48, lr=3e-3, schedule="const", weight_decay=0.0, warmup_steps=0,
                      adaptive_iters=False, train_iters=2, save_ckpt_freq=10**9, telemetry_freq=10**9,
                      tensorboard=False, exp_dir=str(tmp_path))
    losses = []
    Trainer(model, cfg).fit(iter(PrefetchLoader(ds, batch_size=1, num_workers=1, shuffle=False)),
                            on_step=lambda step, metrics: losses.append(float(metrics["loss"])))
    assert len(losses) == 48 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.88, losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.95, losses
