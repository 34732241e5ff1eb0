"""The port's config system and its config-driven CLIs against the JAX
package's (`mvtracker_tpu/config.py`, `cli/{train,eval,serve}.py`) on the
CPU: every shipped model preset loads to the same settings and builds a
port model, overrides parse alike, the DROID and the real datasets build, every trainer setting runs, `Trainer.fit`'s
evaluation hook and static-pretrain iterator, `python -m mvtracker_torch.cli.train` then `cli.eval` on one
experiment directory, and the server's answers against the predictor."""

import dataclasses
import io
import json
import logging
import os
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from mvtracker_torch import config as t_config
from mvtracker_torch import presets
from mvtracker_torch.cli import eval as t_eval
from mvtracker_torch.cli import eval_checkpoint
from mvtracker_torch.cli import serve as t_serve
from mvtracker_torch.cli import train as t_train
from mvtracker_torch.evaluation.predictor import EvaluationPredictor
from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.scene import make_scene
from mvtracker_torch.training import step as step_lib
from mvtracker_torch.training.train import TrainConfig, Trainer
from mvtracker_tpu import config as j_config
from mvtracker_tpu.datasets import synthetic as j_synth
from tests.test_kubric_loader import write_kubric_scene
from tests.test_real_world_datasets import write_panoptic_scene
from tests.test_torch_augmentations import assert_same_datapoint
from tests.test_torch_training import config as train_config
from tests.test_torch_training import tiny_loader, tiny_model

ROOT = Path(__file__).resolve().parent.parent
PRESETS = sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("configs/mvtracker*.yaml")) + ["configs/overfit.yaml"]
# configs/overfit.yaml narrowed to a few seconds of CPU work.
TINY = [
    "model.sliding_window_len=4", "model.fmaps_dim=16", "model.num_heads=2", "model.hidden_size=32",
    "model.space_depth=1", "model.time_depth=1", "model.num_virtual_tracks=4", "model.corr_n_levels=2",
    "model.corr_neighbors=4", "data.n_views=2", "data.n_frames=6", "data.height=32", "data.width=32",
    "data.num_tracks=8", "data.num_workers=1", "trainer.warmup_steps=0", "trainer.adaptive_iters=false",
    "trainer.train_iters=1", "trainer.telemetry_freq=1", "eval.grid_size=0", "eval.n_iters=1",
]


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("path", PRESETS)
def test_preset_loads_like_jax_and_builds(path):
    """Every section of the resolved config equals the JAX package's, the
    trainer's too, and the model builds with no NotImplementedError."""
    got, want = t_config.load_config(str(ROOT / path)), j_config.load_config(str(ROOT / path))
    for section in ("model", "data", "eval"):
        assert dataclasses.asdict(getattr(got, section)) == dataclasses.asdict(getattr(want, section)), section
    assert dataclasses.asdict(got.trainer) == dataclasses.asdict(want.trainer)
    assert (got.mesh_data, got.mesh_model, got.shard_views) == (want.mesh_data, want.mesh_model, want.shard_views)
    model = t_config.build_model(got.model, device="cpu")
    assert isinstance(model, MVTracker)
    mc = got.model
    assert (model.fmaps_dim, model.corr_neighbors, model.corr_knn_reuse, model.remat) == (
        mc.fmaps_dim, mc.corr_neighbors, mc.corr_knn_reuse, mc.remat)
    assert model.use_point_transformer == mc.use_point_transformer
    assert model.normalize_scene_in_fwd_pass == mc.normalize_scene_in_fwd_pass


def test_overrides_parse_like_jax():
    overrides = ["model.corr_neighbors=24", "trainer.lr=1e-3", "model.remat=yes", "eval.max_sequences=3",
                 "eval.interp_shape=[64, 96]", "data.view_subset=[0, 2]", "model.compute_dtype=bfloat16"]
    got = t_config.load_config(str(ROOT / "configs/overfit.yaml"), overrides)
    want = j_config.load_config(str(ROOT / "configs/overfit.yaml"), overrides)
    for section in ("model", "data", "eval"):
        assert dataclasses.asdict(getattr(got, section)) == dataclasses.asdict(getattr(want, section))
    assert got.trainer.lr == want.trainer.lr == 1e-3 and got.eval.max_sequences == 3
    with pytest.raises(KeyError, match="unknown config key"):
        t_config.load_config(None, ["model.no_such_key=1"])
    with pytest.raises(ValueError, match="key=value"):
        t_config.load_config(None, ["model.remat"])


def test_format_config_tree_matches_jax():
    cfg = t_config.load_config(str(ROOT / "configs/overfit.yaml"))
    lines = t_config.format_config_tree(cfg).splitlines()
    want = j_config.format_config_tree(j_config.load_config(str(ROOT / "configs/overfit.yaml"))).splitlines()
    assert lines[0] == "config" and lines == want


@pytest.mark.parametrize("name,item", [
    ("spatracker_multiview", "A.4"), ("cotracker2d", "A.4"), ("delta", "A.4"), ("monocular_nn", "A.4"),
])
def test_unported_families_raise(name, item):
    """The families of ROADMAP A.4 that once raised here are ported: none is
    left in `_FAMILIES_NOT_PORTED`, and each builds on the CPU
    (`tests/test_torch_families.py` holds all 15 names)."""
    assert name not in t_config._FAMILIES_NOT_PORTED and item not in t_config._FAMILIES_NOT_PORTED.values()
    assert t_config.build_model(t_config.ModelConfig(name=name), device="cpu") is not None


def test_config_model_options():
    """CopyCat builds; the scan unroll is ignored at any value; a correlation
    backend other than the port's one raises; the LoFTR memory builds."""
    assert type(t_config.build_model(t_config.ModelConfig(name="copycat"))).__name__ == "CopyCat"
    small = dict(fmaps_dim=16, hidden_size=32, num_heads=2, space_depth=1, time_depth=1, corr_n_levels=2)
    t_config.build_model(t_config.ModelConfig(**small, transformer_scan_unroll=7), device="cpu")
    with pytest.raises(NotImplementedError, match="corr_backend"):
        t_config.build_model(t_config.ModelConfig(**small, corr_backend="pallas"), device="cpu")
    model = t_config.build_model(t_config.ModelConfig(**small, support_memory_tokens=100), device="cpu")
    assert model.updateformer.support_memory.shape == (1, 100, 32)
    with pytest.raises(ValueError, match="unknown model family"):
        t_config.build_model(t_config.ModelConfig(name="nope"))


@pytest.mark.parametrize("dataset", ["kubric", "droid", "panoptic-multiview"])
def test_unported_datasets_raise(tmp_path, dataset):
    """Every dataset name builds (`droid` too, since its slice was ported)
    on a fixture and gives the JAX package's `build_dataset`'s scenes."""
    dc = dict(dataset=dataset, root=str(tmp_path), num_tracks=6)
    if dataset == "droid":
        from mvtracker_tpu.droid.synth_episode import build_episode

        build_episode(str(tmp_path), seed=1, n_frames=5, width=64, height=48, num_track_points=3)
        dc.update(root=str(tmp_path / "processed"), n_frames=4)
    else:
        scene = j_synth.render_scene(seed=3, n_views=2, n_frames=3, height=32, width=40, n_tracks=10)
        if dataset == "kubric":
            write_kubric_scene(scene, str(tmp_path / "scene_000"))
        else:
            write_panoptic_scene(scene, str(tmp_path / "panoptic-multiview" / "seq0"))
    got, want = t_config.build_dataset(t_config.DataConfig(**dc)), j_config.build_dataset(j_config.DataConfig(**dc))
    assert type(got).__name__ == type(want).__name__ and len(got) == len(want) == 1
    assert_same_datapoint(got[0], want[0])


@pytest.mark.parametrize("name,on", [
    ("tensorboard", True), ("wandb", True), ("profile_start_step", 1), ("watchdog_timeout_s", 600.0),
    ("watchdog_exit", True),
])
def test_unported_trainer_settings_raise(tmp_path, monkeypatch, caplog, name, on):
    """Each of the JAX trainer's observability settings now runs in `fit`:
    TensorBoard writes its events, W&B turns off with a warning where the
    package is absent, the profiler writes a trace, and the watchdog is
    armed (the first step's long deadline, then the per-step one), re-armed
    and cancelled, with `watchdog_exit` passed on to faulthandler (recorded
    here instead of armed, so no timer outlives the test)."""
    from mvtracker_torch.training import train as t_train_mod

    arms, cancels = [], []
    monkeypatch.setattr(t_train_mod.obs, "reset_hang_watchdog", lambda timeout, exit=False: arms.append((timeout, exit)))
    monkeypatch.setattr(t_train_mod.obs, "cancel_hang_watchdog", lambda: cancels.append(True))
    off = dict(tensorboard=False, wandb=False, profile_start_step=-1, watchdog_timeout_s=0.0, watchdog_exit=False)
    cfg = train_config(tmp_path, **{**off, name: on})
    if name == "watchdog_exit":
        cfg.watchdog_timeout_s = 5.0
    with caplog.at_level(logging.WARNING):
        Trainer(tiny_model(), cfg).fit(iter(tiny_loader()), max_steps=3)
    exp = Path(cfg.exp_dir)
    assert (exp / "tb").exists() == (name == "tensorboard")
    if name == "tensorboard":
        assert any(p.name.startswith("events.out.tfevents") for p in (exp / "tb").iterdir())
    wandb_warned = any("wandb requested but unavailable" in r.getMessage() for r in caplog.records)
    assert wandb_warned == (name == "wandb")
    traces = sorted(os.listdir(exp / "profile")) if (exp / "profile").exists() else []
    assert traces == (["trace_steps1-2.json"] if name == "profile_start_step" else [])
    if name.startswith("watchdog"):
        first, exit_flag = max(cfg.watchdog_timeout_s, cfg.watchdog_first_deadline_s), name == "watchdog_exit"
        assert arms == [(first, exit_flag)] + [(cfg.watchdog_timeout_s, exit_flag)] * 3
        assert cancels == [True]
    else:
        assert arms == [] and cancels == []


def test_fit_hooks(tmp_path):
    """`eval_fn(state, step)` after every eval_freq-th step, and the first
    static_pretrain_steps batches from the static iterator."""
    drawn, evals = [], []

    def tagged(tag):
        for batch in tiny_loader():
            drawn.append(tag)
            yield batch

    def forever(tag):
        while True:
            yield from tagged(tag)

    trainer = Trainer(tiny_model(), train_config(tmp_path, eval_freq=2, static_pretrain_steps=3))
    trainer.fit(forever("main"), eval_fn=lambda state, step: evals.append((step, state.step)), max_steps=5,
                static_data_iter=forever("static"))
    assert drawn == ["static"] * 3 + ["main"] * 2
    assert evals == [(2, 2), (4, 4)]


def test_cli_train_then_eval(tmp_path, capsys, caplog):
    """`cli.train` takes 2 steps with a static-pretrain step and an
    evaluation after step 2, saves step 2; `cli.eval` restores it and
    prints the summary."""
    exp = str(tmp_path / "exp")
    common = ["--config", str(ROOT / "configs/overfit.yaml"), "--device", "cpu", *TINY,
              f"trainer.exp_dir={exp}", "eval.max_sequences=1"]
    with caplog.at_level(logging.INFO):
        state = t_train.main(common + ["trainer.total_steps=2", "trainer.save_ckpt_freq=2", "trainer.eval_freq=2",
                                       "trainer.static_pretrain_steps=1"])
    assert state.step == 2 and (Path(exp) / "checkpoints" / "step_2.pt").exists()
    messages = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("resolved config:") for m in messages)
    assert any(m.startswith("eval @ step 2:") for m in messages)
    capsys.readouterr()
    with caplog.at_level(logging.INFO):
        summary = t_eval.main(common + ["--output", str(tmp_path / "summary.json")])
    assert any(r.getMessage() == "evaluating checkpoint at step 2" for r in caplog.records)
    printed = json.loads(capsys.readouterr().out)
    assert printed["all_any"]["average_jaccard"] == pytest.approx(summary["all_any"]["average_jaccard"])
    assert json.loads((tmp_path / "summary.json").read_text())["n_sequences"] == 1


def test_cli_eval_copycat(tmp_path, capsys):
    summary = t_eval.main(["--config", str(ROOT / "configs/copycat.yaml"), "--device", "cpu", "data.n_views=2",
                           "data.n_frames=6", "data.height=32", "data.width=32", "data.num_tracks=8",
                           "eval.max_sequences=1", f"trainer.exp_dir={tmp_path}"])
    assert summary["n_sequences"] == 1


def test_clis_default_to_cuda():
    for module in (t_train, t_eval, t_serve):
        assert module.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_train.main(["--config", str(ROOT / "configs/overfit.yaml")])


def post(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.load(io.BytesIO(resp.read()))


def test_serve_answers_like_the_predictor():
    """The server on 127.0.0.1 in a thread: two requests answered with the
    predictor's own tracks, bit for bit; uint8 frames reach the predictor
    as posted (a byte a channel) and answer as the same values posted as
    fp32; a malformed request reported as an error; /healthz counts them."""
    model = tiny_model().eval()
    server, predictor = t_serve.build_server(model, port=0, interp_shape=None, grid_size=2, n_iters=1, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    try:
        for seed in (0, 1):
            scene = make_scene(np.random.default_rng(seed), 2, 6, 32, 32, 5)
            got = post(f"http://{host}:{port}/track", dict(zip(("rgbs", "depths", "query_points", "intrs", "extrs"),
                                                                scene)))
            want = EvaluationPredictor(model, interp_shape=None, grid_size=2, n_iters=1, device="cpu")(*scene)
            assert np.array_equal(got["traj"], want["traj"].numpy()) and np.array_equal(got["vis"], want["vis"].numpy())
        names = ("rgbs", "depths", "query_points", "intrs", "extrs")
        rgbs, *rest = make_scene(np.random.default_rng(2), 2, 6, 32, 32, 5)
        answers = []
        for frames in (rgbs.astype(np.uint8), rgbs.astype(np.uint8).astype(np.float32)):
            answers.append(post(f"http://{host}:{port}/track", dict(zip(names, [frames, *rest]))))
            assert predictor.last_upload_bytes == frames.nbytes + sum(a.nbytes for a in rest)
        for key in ("traj", "vis"):
            assert np.array_equal(answers[0][key], answers[1][key]), key
        with pytest.raises(urllib.error.HTTPError):
            post(f"http://{host}:{port}/track", {"rgbs": np.zeros(3)})
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health == {"device": "cpu", "shapes": 1, "requests": 4, "errors": 1}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_serve_loads_the_trainers_checkpoint(tmp_path):
    """`--ckpt_dir` reads the newest checkpoint of the port's trainer."""
    model = MVTracker(device="cpu")
    trainer = Trainer(model, TrainConfig(exp_dir=str(tmp_path)))
    with torch.no_grad():
        model.vis_predictor[0].bias.fill_(0.25)
    trainer.save(step_lib.init_state(model, trainer.optimizer), 3)
    args = t_serve.build_parser().parse_args(["--ckpt_dir", str(tmp_path), "--device", "cpu"])
    assert float(t_serve.load_model(args).vis_predictor[0].bias) == 0.25


def test_presets_and_protocol_flags_build_the_options():
    """The presets' knobs (the round-4 evaluation recipe) build a model
    without NotImplementedError, and the protocol CLI passes them on."""
    model = presets.build_model("medium", corr_k0=24, global_match=True, chain_velocity=1.0, knn_reuse=True,
                                device="cpu")
    assert model.corr_neighbors_per_level == (24, 12, 12) and model.global_match_init and model.corr_knn_reuse
    assert model.chain_velocity == 1.0
    args = eval_checkpoint.build_parser().parse_args(
        ["--corr_k0", "24", "--global_match", "--chain_velocity", "1.0", "--knn_reuse", "--device", "cpu"])
    built = eval_checkpoint.build(args)
    assert built.corr_neighbors_per_level == (24, 12, 12) and built.global_match_init and built.corr_knn_reuse
    helps = {a.dest: a.help for a in eval_checkpoint.build_parser()._actions}
    assert not any("not ported" in helps[k] for k in ("corr_k0", "global_match", "chain_velocity", "knn_reuse"))
