#!/usr/bin/env python3
"""Run one cell of the benchmark of `mvtracker_torch` on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in `BENCHMARK.json`; its configuration
file, its traffic mix (`perfbench/traffic/<traffic>.json` or `.py`, see
`lib/traffic.py`) and its limits (`perfbench/limits/<cell>.json`) are found
by name. With `--trace 0` the last line of standard output is the cell's
end-to-end metrics; with `--trace 1` its per-layer metrics, from a profiled
tail of requests. Each number of the correctness check is printed with its
limit as the last lines of standard error and under the result's last key,
"checked".

Exits 2 without a result when there is no CUDA card (or fewer than the cell
asks for), or when the program is not beside this folder; exits 3 when a
forbidden module (the JAX stack or the JAX package) is loaded at any of the
harness's three looks, the last after everything the run loads.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))


def cell_files(bench: dict, name: str) -> tuple[dict, dict, dict, dict, list]:
    """(cell, configuration, traffic, limits, [(per-layer metric, unit)])."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    from perfbench.lib import traffic as traffic_files

    traffic = traffic_files.load(HERE, cell["traffic"])
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    per_layer = [(m["name"], m["unit"]) for m in bench["per_layer"]
                 if "workloads" not in m or name in m["workloads"]]
    return cell, config, traffic, limits, per_layer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None, help="default: BENCHMARK.json's run_seconds")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic, limits, per_layer = cell_files(bench, args.workload)
    if not (ROOT / "mvtracker_torch").is_dir():
        print("mvtracker_torch is not beside perfbench/: nothing to measure", file=sys.stderr)
        return 2
    # Caches of the program live inside the checkout, at fixed paths.
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".perfbench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".perfbench_cache" / "torch_extensions"))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from perfbench.lib import harness

    seconds = bench["run_seconds"] if args.seconds is None else args.seconds
    try:
        result = harness.run(HERE, config, traffic, limits, per_layer, args.seed, seconds, bool(args.trace),
                             "cuda", T_START)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'nvidia-smi failed'}",
          file=sys.stderr)
    for name, entry in result["checked"].items():
        print(f"check {name}: {entry['value']} limit {entry['limit']}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
