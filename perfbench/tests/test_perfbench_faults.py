"""A run with the timed path broken underneath comes out not correct, and
the control (the reference in fp8, in the program's place) fails the cell's
limits while the program passes them: the whole run but the look for a card,
on the CPU at narrow widths, against each cell's own limits."""

import json
import time
from pathlib import Path

import pytest
import torch
from conftest import TINY_CONFIG, tiny_traffic

from perfbench.lib import check, harness, traffic
from perfbench.lib.faults import FAULTS

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _cell(name):
    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    mix = traffic.load(ROOT, cell["traffic"])
    limits = json.loads((ROOT / "limits" / f"{name}.json").read_text())
    return mix["entry"], limits


def _run(name, breaker=None, dtype="float32", controls=()):
    entry, limits = _cell(name)
    config = dict(TINY_CONFIG, compute_dtype=dtype)
    return harness.run(ROOT, config, tiny_traffic(entry), limits, [], 3, 1.0, False, "cpu", time.perf_counter(),
                       breaker=breaker, controls=controls)


@pytest.mark.parametrize("name", CELLS)
def test_unbroken_run_is_correct(name):
    assert _run(name)["correct"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_the_run_not_correct(name, fault):
    res = _run(name, breaker=FAULTS[fault])
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_that_the_program_passes(name):
    res = _run(name, dtype="bfloat16", controls=("fp8_e4m3",))
    assert res["correct"], res["checked"]
    control = res["control"]["fp8_e4m3"]
    _, limits = _cell(name)
    ok, _ = check.judge(control, limits, 0)
    assert not ok, control


def test_a_fault_on_a_quarter_of_the_queries_shows_in_the_p90_and_not_in_the_median():
    """The arithmetic of `check.numbers`: a quarter of the queries off by
    far more than rounding leaves `traj_x` near 1 and lifts `traj_p90x`."""
    g = torch.Generator().manual_seed(0)
    ref = (torch.randn(10, 40, 3, generator=g), torch.rand(10, 40, generator=g))
    base = (ref[0] + 1e-3 * torch.randn(10, 40, 3, generator=g), ref[1] + 1e-3 * torch.randn(10, 40, generator=g))
    prog = (ref[0] + 1e-3 * torch.randn(10, 40, 3, generator=g), ref[1] + 1e-3 * torch.randn(10, 40, generator=g))
    prog[0][:, 30:] += 0.05
    values = check.numbers([(0, *prog)], [ref], [base])
    assert values["traj_x"] < 1.5 and values["vis_x"] < 1.5
    assert values["traj_p90x"] > 10
