"""The port's config system and its config-driven CLIs against the JAX
package's (`mvtracker_tpu/config.py`, `cli/{train,eval,serve}.py`) on the
CPU: every shipped model preset loads to the same settings and builds a
port model, overrides parse alike, unported families, datasets and trainer
settings raise, `Trainer.fit`'s evaluation hook and static-pretrain
iterator, `python -m mvtracker_torch.cli.train` then `cli.eval` on one
experiment directory, and the server's answers against the predictor."""

import dataclasses
import io
import json
import logging
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
from tests.test_torch_training import config as train_config
from tests.test_torch_training import tiny_loader, tiny_model

ROOT = Path(__file__).resolve().parent.parent
PRESETS = sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("configs/mvtracker*.yaml")) + ["configs/overfit.yaml"]
# The port leaves these trainer settings off by default (not ported); the
# JAX package turns them on.
JAX_ONLY_DEFAULTS = {"tensorboard", "watchdog_timeout_s"}
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
    """Every section of the resolved config equals the JAX package's (the
    trainer's but for the two settings the port leaves off), and the model
    builds with no NotImplementedError."""
    got, want = t_config.load_config(str(ROOT / path)), j_config.load_config(str(ROOT / path))
    for section in ("model", "data", "eval"):
        assert dataclasses.asdict(getattr(got, section)) == dataclasses.asdict(getattr(want, section)), section
    g, w = dataclasses.asdict(got.trainer), dataclasses.asdict(want.trainer)
    assert set(g) == set(w)
    assert {k for k in g if g[k] != w[k]} <= JAX_ONLY_DEFAULTS
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
    assert len(lines) == len(want) and lines[0] == "config"
    differ = [(a, b) for a, b in zip(lines, want) if a != b]
    assert all(any(k in a for k in JAX_ONLY_DEFAULTS) for a, _ in differ), differ


@pytest.mark.parametrize("name,item", [
    ("spatracker_multiview", "item 7"), ("cotracker2d", "item 7"), ("delta", "item 7"), ("monocular_nn", "item 7"),
])
def test_unported_families_raise(name, item):
    with pytest.raises(NotImplementedError, match=item):
        t_config.build_model(t_config.ModelConfig(name=name), device="cpu")


def test_config_model_options():
    """CopyCat builds; the scan unroll is ignored at any value; a correlation
    backend other than the port's one, and the LoFTR memory, raise."""
    assert type(t_config.build_model(t_config.ModelConfig(name="copycat"))).__name__ == "CopyCat"
    small = dict(fmaps_dim=16, hidden_size=32, num_heads=2, space_depth=1, time_depth=1, corr_n_levels=2)
    t_config.build_model(t_config.ModelConfig(**small, transformer_scan_unroll=7), device="cpu")
    with pytest.raises(NotImplementedError, match="corr_backend"):
        t_config.build_model(t_config.ModelConfig(**small, corr_backend="pallas"), device="cpu")
    with pytest.raises(NotImplementedError, match="support_memory_tokens"):
        t_config.build_model(t_config.ModelConfig(**small, support_memory_tokens=100), device="cpu")
    with pytest.raises(ValueError, match="unknown model family"):
        t_config.build_model(t_config.ModelConfig(name="nope"))


@pytest.mark.parametrize("dataset", ["kubric", "droid", "panoptic-multiview"])
def test_unported_datasets_raise(dataset):
    with pytest.raises(NotImplementedError, match="item 4"):
        t_config.build_dataset(t_config.DataConfig(dataset=dataset))


@pytest.mark.parametrize("name,on", [
    ("tensorboard", True), ("wandb", True), ("profile_start_step", 1), ("watchdog_timeout_s", 600.0),
    ("watchdog_exit", True),
])
def test_unported_trainer_settings_raise(tmp_path, name, on):
    Trainer(tiny_model(), train_config(tmp_path))  # the defaults are accepted
    with pytest.raises(NotImplementedError, match=name):
        Trainer(tiny_model(), train_config(tmp_path, **{name: on}))


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


@pytest.mark.parametrize("argv,env", [
    (["mesh_model=2"], {}), (["shard_views=true"], {}), (["mesh_data=4"], {}), ([], {"MVTRACKER_DISTRIBUTED": "1"}),
])
def test_cli_refuses_more_than_one_device(monkeypatch, argv, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for main in (t_train.main, t_eval.main):
        with pytest.raises(NotImplementedError, match="item 6"):
            main(["--device", "cpu", *argv])


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
    predictor's own tracks, bit for bit; a malformed one reported as an
    error; /healthz counts them."""
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
        with pytest.raises(urllib.error.HTTPError):
            post(f"http://{host}:{port}/track", {"rgbs": np.zeros(3)})
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health == {"device": "cpu", "shapes": 1, "requests": 2, "errors": 1}
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
