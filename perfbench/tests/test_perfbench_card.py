"""A traced run on the card at narrow widths: every per-layer metric is read,
the trace links each kernel to its launch, and no share passes 100%."""

import json
import time
from pathlib import Path

import pytest
from conftest import TINY_CONFIG, tiny_traffic

from perfbench.lib import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["forward", "predictor"])
def test_traced_run_reads_every_per_layer_metric(cuda_card, entry):
    per_layer = [(m["name"], m["unit"]) for m in BENCH["per_layer"]]
    config = dict(TINY_CONFIG, compute_dtype="bfloat16")
    res = harness.run(ROOT, config, tiny_traffic(entry, height=128, width=128), {}, per_layer, 7, 1.0, True,
                      cuda_card, time.perf_counter())
    assert set(res["metrics"]) == {name for name, _ in per_layer}
    for name, entry_ in res["metrics"].items():
        if entry_["unit"] == "%":
            assert 0 < entry_["value"] <= 100, (name, entry_)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
