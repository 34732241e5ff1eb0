#!/usr/bin/env python3
"""Readings that the correctness limits of a cell are set from, and the
proof that the limits fail what they must.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 5]
        [--control-seeds 3] [--faults half_left_out,quarter_left_out] [--fault-seeds 3]

For every seed, in one process: the cell's run with a short window at its
own load (the program's numbers, as a run compares them); on the first
`--control-seeds` seeds also the plain reference computed in fp8 e4m3
(`reference/lowp.py`) in the program's place (the control's numbers); on
the first `--fault-seeds` seeds the run again with each fault of
`--faults` (`lib/faults.py`) planted in the timed path. Prints one JSON line
a run, then a summary: the largest program reading and the smallest control
and fault readings of each number, and how `check.judge` rules on each
against the cell's limits file. The cells' own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from perfbench.run import cell_files  # noqa: E402

CONTROL = "fp8_e4m3"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="", help="comma-separated names of lib/faults.py")
    ap.add_argument("--fault-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    from perfbench.lib import check, harness
    from perfbench.lib.faults import FAULTS

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, config, traffic, limits, per_layer = cell_files(bench, args.workload)
    faults = [f for f in args.faults.split(",") if f]
    runs = {"program": [], CONTROL: [], **{f: [] for f in faults}}

    def one(seed, kind, **kw):
        t0 = time.perf_counter()
        res = harness.run(HERE, config, traffic, limits, per_layer, seed, args.seconds, False, "cuda",
                          time.perf_counter(), **kw)
        values = {k: v["value"] for k, v in res["checked"].items()}
        runs[kind].append(values)
        print(json.dumps({"seed": seed, "run": kind, "attempted": res["attempted"], "failed": res["failed"],
                          "correct": res["correct"], "numbers": values, "seconds": time.perf_counter() - t0}),
              flush=True)
        torch.cuda.empty_cache()
        return res

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        res = one(seed, "program", controls=[CONTROL] if i < args.control_seeds else ())
        if CONTROL in res.get("control", {}):
            values = {n: res["control"][CONTROL][n] for n in check.NAMES}
            runs[CONTROL].append(values)
            ok, _ = check.judge(values, limits, 0)
            print(json.dumps({"seed": seed, "run": CONTROL, "correct": ok, "numbers": values}), flush=True)
        if i < args.fault_seeds:
            for f in faults:
                one(seed, f, breaker=FAULTS[f])

    summary = {"workload": args.workload, "limits": limits,
               "program_max": {n: max(r[n] for r in runs["program"]) for n in check.NAMES}}
    for kind in [CONTROL] + faults:
        if runs[kind]:
            summary[kind] = {"min": {n: min(r[n] for r in runs[kind]) for n in check.NAMES},
                             "judged_correct": [check.judge(r, limits, 0)[0] for r in runs[kind]]}
    summary["program_judged_correct"] = [check.judge(r, limits, 0)[0] for r in runs["program"]]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
