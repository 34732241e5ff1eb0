"""The port's measurement scripts (`scripts/*_torch.py`, the twins of the
JAX profiling scripts) on the CPU at `bench_torch.py`'s narrow widths:

- the reuse twin's exact-vs-reuse divergence against the JAX models'
  divergence on the same weights and scene, and its fewer kNN calls;
- the batched twin's folded stages against separate calls;
- the train-step ablations: the same first loss, what each one cuts, and the
  package as it was afterwards;
- the sharded-kNN twin on 2 gloo ranks against the exact search;
- the DROID twin's episode writer against the JAX test fixture, and its
  batch outputs against JAX's `process_episode`;
- the supervisor with stubbed `python3` and `sleep`;
- `timing_torch`'s call recorder and its counts of calls and launches.
"""

import json
import os
import subprocess
import sys
import types
from collections import Counter
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import bench_torch
from mvtracker_torch.datasets import hdf5
from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.ops import _cuda
from mvtracker_torch.ops import corr as corr_ops
from mvtracker_torch.ops import knn as knn_ops
from mvtracker_tpu.droid import pipeline as j_pipe
from mvtracker_tpu.models.mvtracker import MVTracker as JaxMVTracker
from scripts import bench_droid_batch_torch as droid_batch
from scripts import eval_fps_torch, profile_components_torch
from scripts import profile_batched_serving_torch as batched
from scripts import profile_knn_reuse_torch as reuse
from scripts import profile_sharded_knn_torch as sharded
from scripts import profile_torch_train_step as train_step
from scripts import timing_torch
from tests.test_droid import make_episode as jax_make_episode
from tests.test_torch_droid import _same
from tests.test_torch_modules import carried_weights
from tests.torch_dist import spawn

ROOT = Path(__file__).resolve().parent.parent
SUPERVISOR = ROOT / "scripts" / "run_supervised_train_torch.sh"
# fp32 both sides. The divergence (mean 1.4e-2, max 5.2e-2 here) reads
# within 4e-7 of JAX's; the limit leaves room for summation order and is far
# below a reuse that searched every iteration (divergence 0).
DIVERGENCE_ATOL = 1e-5
# A fold changes only the order of summation; on the CPU it reads 0.
FOLD_CPU_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small():
    (v, t, h, w, n), widths = bench_torch.configs(True)["headline"]
    return (v, t, h, w, n), widths


def test_reuse_divergence_matches_jax():
    """Tracks moved by the carried weights' scaled flow head, so the reused
    neighbours are stale and the paths part; the twin's divergence equals
    the JAX models' (the JAX script's formula) on the same weights."""
    _, widths = small()
    sd, params = carried_weights(MVTracker(**widths, device="cpu"), seed=0)
    report = reuse.main(["--small", "--device", "cpu", "--dtype", "float32"], state_dict=sd)
    scene = bench_torch.headline_scene(True)
    trajs = [np.asarray(JaxMVTracker(**widths, corr_knn_reuse=r).apply(params, *scene,
                                                                       iters=bench_torch.ITERS)["traj"])
             for r in (False, True)]
    want = reuse.divergence(*trajs, scene[2])
    got = report["divergence"]
    assert want["max"] > 1e-3  # the paths do part
    for key in ("mean", "p95", "max"):
        assert abs(got[key] - want[key]) <= DIVERGENCE_ATOL, (key, got[key], want[key])
    assert got["scene_xyz_std"] == want["scene_xyz_std"]
    assert report["reuse"]["calls"]["knn"] < report["exact"]["calls"]["knn"]
    assert report["exact"]["ms"] is None and report["speedup"] is None and report["device"] == "cpu"


def test_folded_stages_equal_separate_calls():
    (v, t, h, w, n), widths = small()
    model = bench_torch.build_model(widths, "cpu", compute_dtype="float32", corr_knn_reuse=True)
    scenes = [[torch.as_tensor(a) for a in bench_torch.headline_scene(True)],
              [torch.as_tensor(a) for a in bench_torch.headline_scene(True, np.random.default_rng(1))]]
    check = batched.fold_check(model, scenes)
    assert check["knn_window"]["bit_equal"]
    for name in ("encoder", "corr_window", "updateformer"):
        assert check[name]["rel"] <= FOLD_CPU_RTOL, (name, check[name])
    report = batched.main(["--small", "--device", "cpu", "--batches", "1", "2"])
    assert report["scaling_ratio"][2] == dict.fromkeys(("full_fwd", "encoder", "knn_window", "corr_window",
                                                        "updateformer"))


def test_train_ablations_cut_what_they_name():
    original_corr, original_fmaps = corr_ops.corr_sample, MVTracker.compute_fmaps
    report = train_step.main(["--ablations", "--small", "--device", "cpu"])
    rows = report["variants"]
    assert list(rows) == list(train_step.VARIANTS)
    for name, row in rows.items():
        assert row["ms"] is None and row["loss"] == pytest.approx(rows["full"]["loss"], rel=1e-6), name
    assert rows["full"]["encoder_grad_norm"] > 0 and rows["no_enc_bwd"]["encoder_grad_norm"] == 0.0
    assert rows["full"]["calls"]["corr_bwd"] > 0 and rows["no_enc_bwd"]["calls"]["corr_bwd"] > 0
    assert "corr_bwd" not in rows["no_corr_bwd"]["calls"] and "corr_bwd" not in rows["fwd_loss_only"]["calls"]
    assert rows["fwd_loss_only"]["encoder_grad_norm"] is None
    assert corr_ops.corr_sample is original_corr and MVTracker.compute_fmaps is original_fmaps


def test_sharded_twin_equals_exact_search_on_two_ranks(tmp_path):
    from mvtracker_torch.ops import knn as knn_ops

    cases = sharded.shapes([4096], [64, 512])
    got = spawn(sharded.rank_run, 2, tmp_path, cases, "cpu", 0, 1)
    for c, (ref, query) in enumerate(cases):
        want_d, want_i = knn_ops.knn_exact_plain(torch.from_numpy(ref), torch.from_numpy(query), sharded.K)
        for rank in got:
            for schedule in ("gather", "ring"):
                np.testing.assert_array_equal(rank[c][schedule]["d"], want_d.numpy())
                np.testing.assert_array_equal(rank[c][schedule]["i"], want_i.numpy())
    report = sharded.main(["--device", "cpu", "--ranks", "2", "--points", "4096", "--queries", "64", "512",
                           "--threads", "1", "--timeout", "120"])
    assert report["bit_equal_to_exact"] and report["rule_agrees"] is None
    assert [row["predicted"] for row in report["rows"]] == ["gather", "ring"]  # M * k against N / D = 2048


def test_droid_episode_writer_and_batch_match_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = droid_batch.make_episode(tmp_path / "port", t=30)
    theirs = jax_make_episode(tmp_path / "jax", t=30)
    with h5py.File(Path(theirs) / "trajectory.h5") as f:
        want = {name: f[name][()] for name in ("observation/robot_state/cartesian_position",
                                                "observation/robot_state/gripper_position")}
    with h5py.File(Path(ours) / "trajectory.h5") as f:
        _same({name: f[name][()] for name in want}, want)
    _same(hdf5.read_all(Path(ours) / "trajectory.h5"), want)
    assert json.loads((Path(ours) / "metadata.json").read_text()) == json.loads(
        (Path(theirs) / "metadata.json").read_text())

    root = tmp_path / "bench"
    report = droid_batch.main(["--device", "cpu", "--episodes", "2", "--frames", "30", "--workers", "1", "2",
                               "--track_points", "8", "--root", str(root)])
    assert [run["results"] for run in report["runs"]] == [{"ok": 2, "skipped": 0, "failed": 0}] * 2
    result = j_pipe.process_episode(theirs, str(tmp_path / "want"), num_track_points=8)
    want_out = [{k: v for k, v in result.items() if k not in ("status", "episode")}] + [
        dict(np.load(tmp_path / "want" / name)) for name in ("tracks.npz", "extrinsics.npz")]
    for w in (1, 2):
        for i in range(2):
            out = root / f"out_w{w}" / f"episode_{i:03d}"
            got = [json.loads((out / "quality.json").read_text())] + [
                dict(np.load(out / name)) for name in ("tracks.npz", "extrinsics.npz")]
            _same(got, want_out)


def _stubs(tmp_path, probe_rc: int) -> dict:
    """A `python3` that answers the probe with `probe_rc` and a `sleep` that
    returns at once, each logging its call; the environment to run with."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "calls.log"
    (bindir / "python3").write_text(f'#!/bin/bash\necho "probe" >> "{log}"\nexit {probe_rc}\n')
    (bindir / "sleep").write_text(f'#!/bin/bash\necho "sleep $1" >> "{log}"\n')
    for stub in bindir.iterdir():
        stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}", SETTLE_S="0", PROBE_SLEEP_S="0",
               PROBE_TRIES="2", MAX_ATTEMPTS="3")
    return {"env": env, "log": log}


def test_supervisor_restarts_until_the_command_succeeds(tmp_path):
    stubs = _stubs(tmp_path, probe_rc=0)
    marker = tmp_path / "failed_once"
    command = ["bash", "-c", f'if [ -e "{marker}" ]; then exit 0; fi; touch "{marker}"; exit 3']
    out = subprocess.run(["bash", str(SUPERVISOR), *command], env=stubs["env"], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert "attempt 2:" in out.stderr and "attempt 3:" not in out.stderr and "run completed cleanly" in out.stderr
    # Probe, settle, attempt 1 fails, restart pause, probe, settle, attempt 2.
    assert stubs["log"].read_text().split("\n")[:-1] == ["probe", "sleep 0", "sleep 30", "probe", "sleep 0"]


def test_supervisor_gives_up_when_the_card_never_answers(tmp_path):
    stubs = _stubs(tmp_path, probe_rc=1)
    out = subprocess.run(["bash", str(SUPERVISOR), "bash", "-c", "exit 0"], env=stubs["env"], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 2 and "card never came back" in out.stderr
    assert stubs["log"].read_text().split("\n")[:-1] == ["probe", "sleep 0", "probe", "sleep 0"]
    usage = subprocess.run(["bash", str(SUPERVISOR)], env=stubs["env"], capture_output=True, text=True, timeout=60)
    assert usage.returncode == 64 and "train_synthetic_torch.py --watchdog_exit" in usage.stderr


@pytest.mark.parametrize("script", [eval_fps_torch, profile_components_torch], ids=lambda m: m.__name__)
def test_cpu_runs_report_counts_and_no_times(script):
    report = script.main(["--small", "--device", "cpu"])
    assert report["device"] == "cpu" and report["power_limit"] is None
    rows = report["stages"].values() if "stages" in report else [report]
    for row in rows:
        assert all(row[key] is None for key in ("ms", "ms_per_request", "share", "fps") if key in row)
        assert not row["launches"]
    assert any(row["calls"].get("knn") for row in rows)


def test_twins_refuse_without_a_card():
    """The default device is the card; without one every twin raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for module in (bench_torch, eval_fps_torch, profile_components_torch, reuse, batched, sharded, droid_batch):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            module.main(["--small"] if module in (bench_torch, eval_fps_torch) else [])
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        train_step.main(["--ablations"])


def test_scripts_import_no_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['mvtracker_tpu'] = None\n"
            "import bench_torch\n"
            "from scripts import (timing_torch, eval_fps_torch, profile_components_torch, profile_knn_reuse_torch,\n"
            "    profile_batched_serving_torch, profile_torch_train_step, profile_sharded_knn_torch,\n"
            "    bench_droid_batch_torch)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
def test_recording_keeps_what_it_picks_and_puts_the_attribute_back(raises):
    module = types.SimpleNamespace(add=lambda a, b=0: a + b)
    original, calls = module.add, []

    def block():
        with timing_torch.recording(module, "add", calls, keep=lambda args, kw, out: (args, kw.get("b"), out)):
            assert module.add(1, b=2) == 3 and module.add(4) == 4
            if raises:
                raise ValueError("inside the block")

    if raises:
        with pytest.raises(ValueError, match="inside the block"):
            block()
    else:
        block()
    assert calls == [((1,), 2, 3), ((4,), None, 4)]
    assert module.add is original


def test_counted_reports_the_launches_made_inside_the_block(monkeypatch):
    """The launch counts are the change of `_cuda.launches` over the block,
    every kernel named, zeros too; earlier launches are not counted."""
    monkeypatch.setattr(_cuda, "launches", Counter({"knn": 5, "corr": 2}))
    with timing_torch.counted() as counts:
        _cuda.launches["knn"] += 3
        _cuda.launches["corr_bwd"] += 1
    assert counts["launches"] == {"knn": 3, "knn_tiled": 0, "knn_exact": 0, "corr": 0, "corr_bwd": 1}
    assert list(counts["launches"]) == list(_cuda.SOURCES)
    assert timing_torch.launches() == {"knn": 8, "knn_tiled": 0, "knn_exact": 0, "corr": 2, "corr_bwd": 1}


def test_counted_sees_the_dispatchers_calls_and_the_flops_inside():
    """On CPU tensors: the dispatchers' calls and shapes, the flops of their
    plain versions, no launch; the dispatchers are put back afterwards."""
    from torch.utils.flop_counter import FlopCounterMode

    ref, query = torch.rand(2, 30, 3), torch.rand(2, 7, 3)
    fvec, targets = torch.rand(2, 30, 8), torch.rand(2, 7, 8)
    dispatchers = (knn_ops.knn, corr_ops.corr_select, corr_ops.corr_select_backward)
    with FlopCounterMode(display=False) as flops, timing_torch.counted(flops) as counts:
        _, idx = knn_ops.knn(ref, query, 4)
        corr_ops.corr_select(fvec, targets, idx)
    assert counts["calls"] == {"knn": 1, "corr": 1, "corr_bwd": 0}
    assert counts["knn_shapes"] == [(2, 30, 7, 4)] and counts["corr_shapes"] == [(2, 7, 4, 8)]
    assert 0 < counts["flops_inside"] == flops.get_total_flops()
    assert not any(counts["launches"].values())
    assert (knn_ops.knn, corr_ops.corr_select, corr_ops.corr_select_backward) == dispatchers
