#!/usr/bin/env python3
"""The program's own spans in a cell's traced run, read beside the
benchmark's outside spans.

    python3 perfbench/program_spans.py --workload <cell> --seeds 1,2,3 [--seconds 10] [--out file.json]

For every seed, in one process: the cell's run with `--trace 1` as
`run.py` makes it (`harness.run`, a short window), keeping the records of
its traced requests. From those records it prints to standard error the
table of the program's `mvtracker::` spans a request (`lib/program_trace.py`:
calls, host ms, kernels launched, device, self device and idle ms, blocking
calls and their host ms), each blocking call by the span and the host operation it falls in, the
device time under `mvtracker::encoder`, `knn`, `corr` and `transformer`
beside the outside spans `perfbench::fnet`, `knn`, `corr` and
`updateformer`, the share of the requests' device idle time put down to a
program span, the host time of each traced request, and the CUDA calls of
the requests by name. One JSON line a seed goes to standard output: the
run's result with its per-layer metrics, and the numbers above. The cells'
own runs never run this; the span table is the one that their traced runs
hand to the metric readers (`harness.traced`, `TraceContext.program`).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from perfbench.run import cell_files  # noqa: E402

# The outside span (perfbench/spans/) on the same boundary as each program span.
TWINS = {"encoder": "fnet", "knn": "knn", "corr": "corr", "transformer": "updateformer"}


def reading(kept: dict) -> dict:
    """Everything this script reports of one traced run, from what
    `harness.traced` returned (`harness.run`'s `keep`)."""
    from perfbench.lib import program_trace, spans, trace

    recs, prog, n = kept["records"], kept["program"], kept["requests"]
    host = [r for r in recs if r[0] == "host"]
    requests = sorted((r[2], r[3]) for r in host if r[1] == spans.PREFIX + "request")
    outside = kept["summary"].get("span_device_s", {})
    calls = defaultdict(lambda: [0, 0.0])
    for r in recs:
        if r[0] == "runtime" and any(lo <= r[2] <= hi for lo, hi in requests):
            calls[r[1]][0] += 1
            calls[r[1]][1] += (r[3] - r[2]) * 1e-3
    return {
        "requests": n,
        "request_ms": [(e - s) * 1e-3 for s, e in requests],
        "spans": {k: {f: v / n for f, v in row.items()} for k, row in sorted(prog["spans"].items())},
        "twins_ms": {k: [1e3 * prog["spans"].get(k, {}).get("device_s", 0.0) / n, 1e3 * outside.get(v, 0.0) / n]
                     for k, v in TWINS.items()},
        "idle_ms": 1e3 * prog["idle_s"] / n,
        "idle_in_spans_share": prog["idle_in_spans_s"] / prog["idle_s"] if prog["idle_s"] else None,
        "blocking_calls": [[name, call, op, 1e3 * s] for (name, call, _, s), op in
                           zip(prog["blocking_calls"], trace.host_at(host, [b[2] for b in prog["blocking_calls"]]))],
        "annotations_as_device": sum(1 for r in recs if r[0] == "device" and r[1].startswith(program_trace.PREFIX)),
        "cuda_calls": {k: [c, ms / n] for k, (c, ms) in sorted(calls.items(), key=lambda kv: -kv[1][1])},
    }


def print_table(seed: int, read: dict) -> None:
    out = sys.stderr
    print(f"seed {seed}: {read['requests']} traced requests, host ms {[round(x, 3) for x in read['request_ms']]}",
          file=out)
    print(f"{'span':<14}{'calls':>9}{'host ms':>12}{'launches':>10}{'device ms':>12}{'self ms':>12}{'idle ms':>12}"
          f"{'blocking':>10}{'block ms':>11}", file=out)
    for name, row in read["spans"].items():
        print(f"{name:<14}{row['calls']:>9.1f}{1e3 * row['host_s']:>12.3f}{row['launches']:>10.1f}"
              f"{1e3 * row['device_s']:>12.3f}{1e3 * row['self_device_s']:>12.3f}{1e3 * row['idle_s']:>12.3f}"
              f"{row['blocking']:>10.1f}{1e3 * row['blocking_s']:>11.3f}", file=out)
    for name, (prog_ms, outside_ms) in read["twins_ms"].items():
        gap = (prog_ms / outside_ms - 1.0) if outside_ms else float("nan")
        print(f"device ms a request under mvtracker::{name} {prog_ms:.4f}, under perfbench::{TWINS[name]} "
              f"{outside_ms:.4f} ({100 * gap:+.3f}%)", file=out)
    print(f"idle {read['idle_ms']:.3f} ms a request, {read['idle_in_spans_share']} of it inside a program span; "
          f"program-span device ranges read as device operations: {read['annotations_as_device']}", file=out)
    per_request = len(read["blocking_calls"]) // max(read["requests"], 1)
    for name, call, op, ms in read["blocking_calls"][:per_request]:
        print(f"blocking call in the first request: {call} in {name} ({op}), {ms:.3f} ms", file=out)
    print("cuda calls a request (count, host ms): " + ", ".join(
        f"{k} {c / read['requests']:.1f} {ms:.3f}" for k, (c, ms) in read["cuda_calls"].items()), file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None, help="also write every seed's JSON here")
    args = ap.parse_args(argv)

    from perfbench.lib import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, config, traffic, limits, per_layer = cell_files(bench, args.workload)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        kept = {}
        result = harness.run(HERE, config, traffic, limits, per_layer, seed, args.seconds, True, "cuda",
                             time.perf_counter(), keep=kept)
        read = reading(kept)
        print_table(seed, read)
        print("metrics: " + json.dumps(result["metrics"]), file=sys.stderr)
        line = {"workload": args.workload, "seed": seed, "correct": result["correct"],
                "metrics": result["metrics"], "device": result["device"], **read}
        lines.append(line)
        print(json.dumps(line), flush=True)
    medians = [statistics.median(x["request_ms"]) for x in lines]
    print(f"traced request medians ms by seed: {medians}", file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
