"""Port parity on the CPU of the synthetic-data and benchmark scripts
(`scripts/*_torch.py`) against their JAX twins, each at a tiny size (the
DROID pair is in `test_torch_scripts_droid.py`):

- `train_synthetic` warm-started from a msgpack of JAX init weights with no
  step, so both evaluate the same weights; `eval_reference_benchmark` on a
  Kubric-layout scene with those weights as a reference-named `.pth` and as
  a flax `.msgpack`: metrics within a measured limit, CopyCat's equal;
- `overfit_verify` and `verify_knn_reuse_quality`, which start from each
  package's own init: the port trains a step; the JAX script runs with its
  trainer and predictor stood in for (no compile), so what is compared is
  the printed layout and CopyCat's numbers.

The JAX scripts point JAX at a compilation cache of the repo's and take no
argv; they run here with `sys.argv` set and the suite's own JAX settings
kept (tests/conftest.py)."""

import contextlib
import importlib
import io
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mvtracker_torch import convert

ROOT = Path(__file__).resolve().parent.parent
# The metrics of a model-scored summary (AJ, OA, ATE, ... in percent or
# centimetres). `scripts/control_torch_north_star.py --tests` read port
# against JAX at most 2.98e-6 over the 126 metrics of `train_synthetic`'s and
# `eval_reference_benchmark`'s summaries here, and 0.0 over the north star's;
# on these few points a track crossing a threshold moves a metric by 100 /
# (points x frames), above 0.1. The limit admits rounding and no crossing.
METRIC_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def keep_jax_config(monkeypatch):
    """The JAX scripts point JAX's compilation cache at the repo and may pick
    its platform; the suite's settings stay."""
    import jax

    update = jax.config.update

    def keep(name, value):
        if name not in ("jax_compilation_cache_dir", "jax_platforms", "jax_persistent_cache_min_compile_time_secs"):
            update(name, value)

    monkeypatch.setattr(jax.config, "update", keep)


@pytest.fixture
def jax_config_kept(monkeypatch):
    keep_jax_config(monkeypatch)


def script(name):
    if str(ROOT / "scripts") not in sys.path:
        sys.path.insert(0, str(ROOT / "scripts"))
    return importlib.import_module(name)


def run_jax_script(monkeypatch, name, argv) -> str:
    """A JAX script's main() with `argv` (they read sys.argv); its stdout."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        script(name).main()
    return out.getvalue()


def run_port_script(name, argv):
    """The port script's main(argv + --device cpu); (its result, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = script(f"{name}_torch").main(argv + ["--device", "cpu"])
    return result, out.getvalue()


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def printed_json(out: str) -> dict:
    """The JSON object a script printed last, over several lines."""
    return json.loads(out[out.rindex("\n{") + 1 if "\n{" in out else out.index("{"):])


def assert_close_tree(got, want, atol, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            assert_close_tree(got[key], want[key], atol, f"{path}/{key}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=atol, nan_ok=True), path
    else:
        assert got == want, path


def rows_of(out: str, first: str) -> list:
    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith(first))
    return [line.split() for line in lines[start:] if line.strip()]


@pytest.fixture(scope="module")
def small_jax_params():
    """The `small` preset's JAX init weights (PRNGKey(0))."""
    import jax

    from mvtracker_tpu.datasets.synthetic import render_scene
    from mvtracker_tpu.presets import build_model

    sc = render_scene(seed=3, n_views=2, n_frames=6, height=32, width=32, n_tracks=8)
    model = build_model("small")
    params = jax.jit(lambda: model.init(jax.random.PRNGKey(0), sc.video.astype(np.float32),
                                        sc.videodepth.astype(np.float32), sc.query_points_3d.astype(np.float32),
                                        sc.intrs.astype(np.float32), sc.extrs.astype(np.float32), iters=1))()
    return jax.tree.map(np.asarray, params)


def test_train_synthetic_matches_jax(small_jax_params, tmp_path, monkeypatch, jax_config_kept):
    """Both warm-started from the same msgpack, no step: the held-out
    evaluation of those weights and CopyCat's, and the printed layout."""
    weights = tmp_path / "w.msgpack"
    convert.save_flax_msgpack(small_jax_params, str(weights))
    argv = ["--steps", "0", "--train_scenes", "1", "--eval_scenes", "1", "--views", "2", "--res", "32",
            "--frames", "6", "--n_tracks", "8", "--workers", "1", "--warm_start", str(weights)]
    report, out = run_port_script("train_synthetic", argv + ["--exp_dir", str(tmp_path / "t"),
                                                             "--out_json", str(tmp_path / "t.json")])
    want = printed_json(run_jax_script(monkeypatch, "train_synthetic",
                                       argv + ["--exp_dir", str(tmp_path / "j"), "--out_json", str(tmp_path / "j.json")]))
    got = printed_json(out)
    assert got["steps"] == want["steps"] == 0
    assert_close_tree(got["copycat"], want["copycat"], 0.0)
    assert_close_tree(got["ours"], want["ours"], 0.01)  # printed with 2 decimals
    saved, saved_j = (json.loads((tmp_path / f"{w}.json").read_text()) for w in "tj")
    assert_close_tree(saved["ours"], saved_j["ours"], METRIC_ATOL)
    assert saved == json.loads(json.dumps(report, default=float))


@pytest.fixture
def jax_layout_only(monkeypatch):
    """For the scripts whose JAX run starts from other weights than the
    port's: JAX's trainer returns at once and its predictor is CopyCat, so
    the JAX run prints its layout and CopyCat's numbers without compiling."""
    from mvtracker_tpu.evaluation import predictor as j_predictor
    from mvtracker_tpu.models.copycat import CopyCatPredictor
    from mvtracker_tpu.training import train as j_train

    monkeypatch.setattr(j_train.Trainer, "fit", lambda self, *a, **kw: SimpleNamespace(params=None))
    monkeypatch.setattr(j_predictor, "EvaluationPredictor", lambda *a, **kw: CopyCatPredictor())


def test_overfit_verify_rows_match_jax(tmp_path, monkeypatch, jax_config_kept, jax_layout_only):
    """The rows and the result line are the JAX script's, CopyCat's column
    equal; the port trained its step and wrote its checkpoint."""
    _, out = run_port_script("overfit_verify", ["--steps", "1", "--scenes", "1", "--exp_dir", str(tmp_path / "t")])
    want = run_jax_script(monkeypatch, "overfit_verify", ["--steps", "1", "--scenes", "1",
                                                          "--exp_dir", str(tmp_path / "j")])
    got_rows, want_rows = rows_of(out, "metric"), rows_of(want, "metric")
    assert [r[0] for r in got_rows] == [r[0] for r in want_rows]
    assert [r[-1] for r in got_rows[1:-1]] == [r[-1] for r in want_rows[1:-1]]  # CopyCat
    assert got_rows[-1][:2] == want_rows[-1][:2] == ["RESULT:", "trained"]
    assert all(np.isfinite(float(r[1])) for r in got_rows[1:-1])
    assert (tmp_path / "t" / "checkpoints" / "step_1.pt").exists()


def test_verify_knn_reuse_quality_matches_jax(tmp_path, monkeypatch, jax_config_kept, jax_layout_only):
    """The JAX script's layout (table, divergence line, JSON); CopyCat's
    column equal; the port's exact and reuse rows from one trained step's
    weights, the two apart by the kNN reuse alone."""
    got, out = run_port_script("verify_knn_reuse_quality", ["--steps", "1", "--scenes", "1",
                                                            "--exp_dir", str(tmp_path / "t")])
    (tmp_path / "j").mkdir()  # JAX's trainer, which makes it, is stood in for
    want_out = run_jax_script(monkeypatch, "verify_knn_reuse_quality",
                              ["--steps", "1", "--scenes", "1", "--exp_dir", str(tmp_path / "j")])
    got_rows, want_rows = rows_of(out, "metric"), rows_of(want_out, "metric")
    assert [r[0] for r in got_rows] == [r[0] for r in want_rows]
    assert [r[3] for r in got_rows[1:-1]] == [r[3] for r in want_rows[1:-1]]
    assert got_rows[-1][:3] == want_rows[-1][:3] == ["trajectory", "divergence", "|exact-reuse|:"]
    want = json.loads((tmp_path / "j" / "knn_reuse_quality.json").read_text())
    assert json.loads((tmp_path / "t" / "knn_reuse_quality.json").read_text()) == got
    assert sorted(got) == sorted(want) and got["results"].keys() == want["results"].keys()
    assert got["results"]["copycat"] == want["results"]["copycat"]
    assert np.isfinite(got["divergence"]["max"]) and all(
        np.isfinite(v) for v in got["results"]["exact"].values())


@pytest.fixture(scope="module")
def kubric_benchmark(tmp_path_factory, small_jax_params):
    """A Kubric-layout benchmark root of one scene, the small preset's
    weights, and the JAX script's run on them (json, csv, stdout)."""
    from mvtracker_tpu.datasets import synthetic
    from tests.test_kubric_loader import write_kubric_scene

    root = tmp_path_factory.mktemp("benchmarks")
    sc = synthetic.render_scene(seed=3, n_views=2, n_frames=6, height=32, width=32, n_tracks=8)
    write_kubric_scene(sc, str(root / "kubric-multiview" / "scene_000"))
    convert.save_flax_msgpack(small_jax_params, str(root / "w.msgpack"))
    torch.save(convert.params_from_flax(small_jax_params), root / "w.pth")
    (root / "j").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        keep_jax_config(mp)
        out = run_jax_script(mp, "eval_reference_benchmark", benchmark_args(root, "msgpack", root / "j"))
    return root, out


def benchmark_args(root, fmt, out):
    return ["--dataset", "kubric-multiview", "--dataset_root", str(root), "--checkpoint", str(root / f"w.{fmt}"),
            "--model_size", "small", "--interp", "0", "0", "--iters", "1", "--grid", "2", "--with_copycat",
            "--scratch_dir", str(out / "scratch"), "--out_json", str(out / "summary.json"),
            "--out_csv", str(out / "per_seq.csv")]


@pytest.mark.parametrize("fmt", ["pth", "msgpack"])
def test_eval_reference_benchmark_matches_jax(kubric_benchmark, tmp_path, fmt):
    """The same weights as a reference-named `.pth` and as a flax `.msgpack`
    (the JAX run reads the latter), strict loads: summaries within the
    metric limit, CopyCat's equal, the printed table's rows, the printed
    JSON, and the CSV's columns the same."""
    root, want_out = kubric_benchmark
    got, out = run_port_script("eval_reference_benchmark", benchmark_args(root, fmt, tmp_path))
    assert [r[0] for r in rows_of(out, "metric")] == [r[0] for r in rows_of(want_out, "metric")]
    got_json, want_json = printed_json(out), printed_json(want_out)
    assert sorted(got_json) == sorted(want_json)
    for key in ("dataset", "setting", "interp", "iters", "grid"):
        assert got_json[key] == want_json[key], key
    saved = json.loads((tmp_path / "summary.json").read_text())
    want = json.loads((root / "j" / "summary.json").read_text())
    for tree in (saved["summary"], want["summary"], saved["copycat"], want["copycat"]):
        tree.pop("fps", None)
    assert_close_tree(saved["summary"], want["summary"], METRIC_ATOL)
    assert_close_tree(saved["copycat"], want["copycat"], 0.0)
    csv_head = (tmp_path / "per_seq.csv").read_text().splitlines()[0]
    assert csv_head == (root / "j" / "per_seq.csv").read_text().splitlines()[0]
