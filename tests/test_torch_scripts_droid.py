"""Port parity on the CPU of the DROID north star and fine-tuning scripts
against their JAX twins, on one tiny episode the port's factory builds (2
external cameras, 8 frames, 64x48, 4 contact points a finger) and the
release checkpoint:

- `eval_droid_track_error`: 1 iteration; the JSON layout and protocol,
  CopyCat's median to 1e-6 m, the model's within a measured limit;
- `train_droid_ft`: 2 steps from the release (warm-up rate, feature-identity
  and visibility terms), both steps' losses within a measured limit, the
  monitor's CopyCat summary equal. The JAX run's end-of-run monitor
  evaluation is CopyCat (no compile): the model-scored monitor is compared
  by the north star above."""

import json
import shutil

import numpy as np
import pytest

from mvtracker_torch.droid.synth_episode import build_episode
from tests.test_torch_scripts import (  # noqa: F401  (fixtures)
    ROOT, METRIC_ATOL, assert_close_tree, jax_config_kept, last_json, printed_json, run_jax_script, run_port_script,
    single_intra_op_thread)

RELEASE = str(ROOT / "release" / "mvtracker_medium_synth.msgpack")
EPISODE = dict(seed=0, n_frames=8, n_external_cams=2, width=64, height=48, num_track_points=4, include_wrist=False)
NORTH_STAR_ARGS = ["--episodes", "1", "--frames", "8", "--width", "64", "--height", "48", "--external_cams", "2",
                   "--no_wrist", "--track_points", "4", "--iters", "1", "--params_msgpack", RELEASE]
# Limits from `scripts/control_torch_north_star.py --tests` (CPU, one intra-op
# thread), 3 times the larger of the control and the port-vs-JAX reading:
# - the model's median, mean and p90 3D error (m): the control (the queries
#   moved by up to 1e-6) moved the tracks by up to 8.45e-6 (median 5.03e-7),
#   and a track's error moves by no more than its track; port against JAX
#   read 0.0, 0.0 and 1.49e-8;
NORTH_STAR_ATOL = 3e-5
# - the fine-tune's two losses, relative: the control (4 intra-op threads
#   against 1) read 0.0 and 1.70e-7; port against JAX 8.41e-7 and 1.70e-7.
FT_LOSS_RTOL = 3e-6


@pytest.fixture(scope="module")
def episode_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("droid")
    build_episode(str(root), **EPISODE)
    return root


def test_north_star_matches_jax(episode_root, tmp_path, monkeypatch, jax_config_kept):
    base = NORTH_STAR_ARGS + ["--root", str(episode_root)]
    got, out = run_port_script("eval_droid_track_error", base + ["--out_json", str(tmp_path / "t.json")])
    want_line = last_json(run_jax_script(monkeypatch, "eval_droid_track_error",
                                         base + ["--out_json", str(tmp_path / "j.json")]))
    got_line = last_json(out)
    assert list(got_line) == list(want_line) == ["median_3d_track_error_m", "copycat_median_m", "fps"]
    saved = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert saved == json.loads(json.dumps(got, default=float))
    assert saved["protocol"] == want["protocol"]  # backend "cpu" on both
    for who in ("copycat", "ours"):
        assert sorted(saved[who]) == sorted(want[who])
    assert got_line["copycat_median_m"] == pytest.approx(want_line["copycat_median_m"], abs=1e-6)
    for key in ("median_3d_track_error_m", "mean_3d_track_error_m", "p90_3d_track_error_m"):
        assert saved["ours"][key] == pytest.approx(want["ours"][key], abs=NORTH_STAR_ATOL), key
    assert got_line["median_3d_track_error_m"] == saved["ours"]["median_3d_track_error_m"]
    assert_close_tree(saved["copycat"]["summary_all_any"], want["copycat"]["summary_all_any"], 0.0)
    assert_close_tree(saved["ours"]["summary_all_any"], want["ours"]["summary_all_any"], METRIC_ATOL)


def record_losses(monkeypatch, trainer_cls, losses):
    get = trainer_cls._get_step_fn

    def patched(self, iters):
        fn = get(self, iters)

        def step(state, batch):
            state, metrics = fn(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics

        return step

    monkeypatch.setattr(trainer_cls, "_get_step_fn", patched)


def test_droid_finetune_matches_jax(episode_root, tmp_path, monkeypatch, jax_config_kept):
    from mvtracker_torch.training import train as t_train
    from mvtracker_tpu.evaluation import predictor as j_predictor
    from mvtracker_tpu.models.copycat import CopyCatPredictor
    from mvtracker_tpu.training import train as j_train

    losses = {"t": [], "j": []}
    record_losses(monkeypatch, t_train.Trainer, losses["t"])
    record_losses(monkeypatch, j_train.Trainer, losses["j"])
    monkeypatch.setattr(j_predictor, "EvaluationPredictor", lambda *a, **kw: CopyCatPredictor())
    outs = {}
    for who in ("t", "j"):
        exp = tmp_path / who
        # The monitor episode is the tiny one, placed where the script looks
        # for it, so that neither builds a 256x192 one.
        shutil.copytree(episode_root / "processed" / "episode_000",
                        exp / "monitor_episodes" / "processed" / "episode_500")
        argv = ["--episodes_root", str(episode_root / "processed"), "--eval_root", str(episode_root),
                "--eval_episodes", "1", "--steps", "2", "--workers", "1", "--eval_every", "0",
                "--save_every", "2", "--warm_start", RELEASE, "--exp_dir", str(exp)]
        if who == "t":
            report, out = run_port_script("train_droid_ft", argv)
        else:
            out = run_jax_script(monkeypatch, "train_droid_ft", argv)
        outs[who] = printed_json(out)
    assert len(losses["t"]) == len(losses["j"]) == 2
    np.testing.assert_allclose(losses["t"], losses["j"], rtol=FT_LOSS_RTOL)
    assert outs["t"] == json.loads(json.dumps(report))
    assert outs["t"]["steps"] == outs["j"]["steps"] == 2
    assert_close_tree(outs["t"]["copycat"], outs["j"]["copycat"], 0.0)
    assert sorted(outs["t"]["ours"]) == sorted(outs["j"]["ours"])
    assert all(np.isfinite(v) for k, v in outs["t"]["ours"].items() if not k.endswith("vis0"))
    assert (tmp_path / "t" / "checkpoints" / "step_2.pt").exists()
    log = [json.loads(x) for x in (tmp_path / "t" / "eval_log.jsonl").read_text().splitlines()]
    assert [e["step"] for e in log] == [2]
