"""The port's headline benchmark (`bench_torch.py`, the twin of `bench.py`)
on the CPU at its narrow widths (`--small`): the JSON line carries
`bench.py`'s keys with every time None and the counts computed; its forward
on weights carried from the JAX init equals the JAX model's; the operation
count's kNN and correlation terms follow the closed form at the shapes the
forward gives the kernels."""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench_torch
from __graft_entry__ import _make_scene
from mvtracker_torch.convert import params_from_flax
from mvtracker_tpu.models.mvtracker import MVTracker as JaxMVTracker
from tests.test_torch_mvtracker import BF16_TRAJ_ATOL, BF16_VIS_ATOL

ROOT = Path(__file__).resolve().parent.parent
# What a CPU run may not report: every time, rate and share.
TIMED = ("value", "fwd_ms", "fwd_ms_serving", "value_serving", "achieved_tflops_s", "mfu", "train_step_ms",
         "train_steps_per_s", "train_step_ms_flagship", "eval_fps_with_support_grids", "value_batched2",
         "fwd_ms_median", "fwd_ms_min", "fwd_ms_max", "power_limit")


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bench_py_keys() -> list:
    """The keys of the dict `bench.py` prints (its `out = {...}`)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "out" and isinstance(
                node.value, ast.Dict):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py has no `out = {...}`")


def test_cpu_run_prints_bench_keys_without_times(capsys):
    report = bench_torch.main(["--small", "--device", "cpu", "--batches", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(report))
    keys = bench_py_keys()
    assert len(keys) == 15 and set(keys) <= set(report) and "value_batched2" in report
    for key in TIMED:
        assert report[key] is None, key
    assert report["vs_baseline"] is None and report["device"] == "cpu"
    v, t, h, w, n = bench_torch.configs(True)["headline"][0]
    assert report["point_frames"] == n * t == 256
    assert report["fwd_tflops"] > 0
    for part in ("headline", "serving", "batched2", "train", "flagship_train", "eval"):
        assert not any(report["launches"][part].values()), part  # no kernel runs on the CPU
    for part in ("headline", "serving", "train", "flagship_train", "eval"):
        assert report["calls"][part]["knn"] > 0 and report["calls"][part]["corr"] > 0, part
    for part in ("train", "flagship_train"):
        assert report["calls"][part]["corr_bwd"] > 0 and np.isfinite(report[f"{part}_losses"]).all()
    assert report["calls"]["serving"]["knn"] < report["calls"]["headline"]["knn"]


def test_forward_matches_jax_on_jax_init():
    """The bench's forward on the JAX init's weights (`bench.py`: `init` with
    PRNGKey(0) on the scene) against JAX's `apply`, both bf16, the JAX model
    on its kernel's correlation path as in `test_torch_mvtracker.py`, whose
    tolerance this is."""
    (v, t, h, w, n), widths = bench_torch.configs(True)["headline"]
    scene = bench_torch.headline_scene(True)
    jax_scene = _make_scene(np.random.default_rng(0), v, t, h, w, n)
    for a, b in zip(scene, jax_scene):
        np.testing.assert_array_equal(a, b)
    jm = JaxMVTracker(**widths, compute_dtype="bfloat16", corr_backend="pallas_interpret")
    params = jax.jit(lambda k, *a: jm.init(k, *a, iters=bench_torch.ITERS))(jax.random.PRNGKey(0), *jax_scene)
    model = bench_torch.build_model(widths, "cpu", state_dict=params_from_flax(params))
    got = bench_torch.forward(model, scene)
    want = jm.apply(params, *jax_scene, iters=bench_torch.ITERS)
    for key, (max_tol, median_tol) in (("traj", BF16_TRAJ_ATOL), ("vis", BF16_VIS_ATOL)):
        gap = np.abs(got[key].float().numpy() - np.asarray(want[key]))
        assert got[key].shape == want[key].shape
        assert gap.max() <= max_tol and np.median(gap) <= median_tol, (key, gap.max(), np.median(gap))


def test_operation_count_closed_form():
    """The kNN term is 9 B M N and the correlation term 2 B N K C summed over
    the calls one forward makes, at the shapes the model gives them: the
    queries' k=1 lookup over the level-0 clouds of all frames, then per
    iteration one padded search of the two small levels (each <= 1024
    points) over the window's frames, and one correlation per level. The
    counter's part is positive and the same on two calls."""
    (v, t, h, w, n), widths = bench_torch.configs(True)["headline"]
    model = bench_torch.build_model(widths, "cpu")
    scene = [torch.as_tensor(a) for a in bench_torch.headline_scene(True)]
    first, second = bench_torch.forward_flops(model, scene), bench_torch.forward_flops(model, scene)
    assert first["dense"] > 0 and first["dense"] == second["dense"]
    s, k, c, iters = widths["sliding_window_len"], widths["corr_neighbors"], widths["fmaps_dim"], bench_torch.ITERS
    points = [v * (h // 4 >> lvl) * (w // 4 >> lvl) for lvl in range(widths["corr_n_levels"])]
    assert t == s and max(points) <= 1024  # one window; both levels share one search
    knn_shapes = [(t, points[0], n, 1)] + [(2 * s, max(points), n, k)] * iters
    corr_shapes = [(s, n, k, c)] * (len(points) * iters)
    assert first["knn_shapes"] == knn_shapes and first["corr_shapes"] == corr_shapes
    assert first["knn"] == sum(9 * b * pts * m for b, pts, m, _ in knn_shapes)
    assert first["corr"] == sum(2 * b * m * kk * cc for b, m, kk, cc in corr_shapes)
    assert first["total"] == first["dense"] + first["knn"] + first["corr"]
