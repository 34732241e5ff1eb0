"""BENCHMARK.json keeps to the benchmark's contract, and every name it holds
is found in a file of perfbench/."""

import json
import re
from pathlib import Path

from perfbench.lib import check

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    paths = BENCH["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells, each run with its allowance, fits in 43200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_end_to_end_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and len(BENCH["end_to_end"]) <= 16
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def _cells_reporting(metric: dict) -> set:
    return set(metric.get("workloads", [w["name"] for w in BENCH["workloads"]]))


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in e2e
        assert _cells_reporting(m) <= _cells_reporting(e2e[m["moves"]])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in BENCH["workloads"]:
        assert any(w["name"] in _cells_reporting(m) for m in BENCH["end_to_end"] if m["name"] != "setup_s")
        assert any(w["name"] in _cells_reporting(m) for m in BENCH["per_layer"])


def test_every_name_has_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / "perfbench" / cfg["reference"]).is_file()
    for w in BENCH["workloads"]:
        assert any((ROOT / "perfbench" / "traffic" / f"{w['traffic']}{ext}").is_file() for ext in (".json", ".py"))
        limits = json.loads((ROOT / "perfbench" / "limits" / f"{w['name']}.json").read_text())
        assert set(limits) == set(check.NAMES)
    for m in BENCH["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
