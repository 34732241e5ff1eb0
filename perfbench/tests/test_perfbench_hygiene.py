"""No benchmark process may hold the JAX stack or the JAX package, and the
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from perfbench.lib.hygiene import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "mvtracker_tpu.models", "mvtracker_torch",
             "mvtracker_torch.ops.knn", "jaxtyping", "flaxen", "mvtracker_tpux", "torch"]
    assert forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "mvtracker_tpu.models"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "perfbench" / "reference").glob("*.py")):
        assert not _imports(path) & {"mvtracker_torch", "mvtracker_tpu", "jax", "jaxlib", "flax", "perfbench"}, path


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in sorted((ROOT / "perfbench").rglob("*.py")):
        assert not _imports(path) & {"mvtracker_tpu", "jax", "jaxlib", "flax"}, path


@pytest.mark.parametrize("traced", [0, 1])
def test_a_benchmark_process_loads_no_forbidden_module(traced):
    """The harness and the program on a tiny clip, in a fresh interpreter,
    through the reference, a control and (traced) every metric reader."""
    code = (
        "import json, sys, time; sys.path[:0] = [%r, %r]\n"
        "from conftest import TINY_CONFIG, tiny_traffic\n"
        "from perfbench.lib import harness, hygiene\n"
        "from pathlib import Path\n"
        "per_layer = [(m['name'], m['unit']) for m in json.loads(Path(%r).read_text())['per_layer']]\n"
        "loaded, load = [], harness.load_reader\n"
        "harness.load_reader = lambda root, name: loaded.append(name) or load(root, name)\n"
        "r = harness.run(Path(%r), TINY_CONFIG, tiny_traffic('predictor', pool=1), {}, per_layer, 1, 0.1, %r, 'cpu',"
        " time.perf_counter(), controls=('fp8_e4m3',))\n"
        "print(len(loaded))\n"
        "print(hygiene.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "perfbench" / "tests"), str(ROOT / "BENCHMARK.json"), str(ROOT / "perfbench"),
         bool(traced))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    readers, bad = out.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    assert int(readers) == (len(json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]) if traced else 0)


def test_a_forbidden_module_loaded_after_the_window_stops_the_run(monkeypatch):
    """The harness's last look, after the reference and the readers: a
    forbidden name in `sys.modules` then ends the run without a result."""
    import time

    from conftest import TINY_CONFIG, tiny_traffic

    from perfbench.lib import check, harness

    real = check.load_reference

    def load_and_taint(root, config):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(root, config)

    monkeypatch.setattr(check, "load_reference", load_and_taint)
    with pytest.raises(SystemExit, match="after the window"):
        harness.run(ROOT / "perfbench", TINY_CONFIG, tiny_traffic("forward", pool=1), {}, [], 1, 0.1, False, "cpu",
                    time.perf_counter())
