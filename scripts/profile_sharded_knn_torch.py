"""The all-gather merge against the ring for the port's sharded kNN, on
ranks that share one NVIDIA GPU: the twin of `scripts/profile_sharded_knn.py`.

    python3 scripts/profile_sharded_knn_torch.py [--ranks 4] [--out_json out.json]

`ops/knn.py::knn_sharded` (each rank searches its shard, one all-gather of
the D x k candidates, a merge) against `knn_sharded_ring` (the shards go
around the ring: D searches and D - 1 shard moves a rank) at N in {16384,
131072} cloud points, M in {256, 4096} queries and k=16, on D ranks started
by `parallel/launch.py` and grouped by `parallel/mesh.py`. It reports each
schedule's ms a call and how often the JAX package's rule "the ring iff
M * k > N / D" (the port's `MVTracker._knn_sharded_call`) picks the faster.

On the one-card host the ranks are processes on the one card joined by gloo,
whose collectives go through host memory (NCCL refuses two ranks on one
device). So this measures the gloo schedule, not NVLink, as the JAX script
measures its CPU mesh and not the TPU's interconnect. Both schedules are held
against the exact search of the whole cloud on the same device
(`knn(..., backend="exact")`: K5 on the card, whose indices are a stable
sort's): distances and indices equal to the bit. (The card's square root
rounds the last bit of about 0.1 percent of these distances otherwise than
the CPU's, so the reference runs where the schedules run.)
Each call is timed on every rank's host clock up to a synchronize (`--warm`
untimed calls first). A round is `--reps` calls of each schedule, the two
schedules taking turns; a round's time is the slowest rank's mean. A
schedule's time is its lowest round, its spread the highest round less the
lowest. Where the two times lie closer than the larger spread, the winner is
"unresolved" and the rule is scored on the other shapes only. With
`--device cpu` (the tests) the ranks run on the CPU and the times are None.

The bit check holds the port's two schedules against another kernel of the
port (K5); the independent check against the plain exact search
(`knn_exact_plain`) is the CPU test's
(`tests/test_torch_profile_scripts.py`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from scripts import timing_torch  # noqa: E402

K = 16


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--points", type=int, nargs="+", default=[16_384, 131_072])
    p.add_argument("--queries", type=int, nargs="+", default=[256, 4096])
    p.add_argument("--warm", type=int, default=1)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--threads", type=int, default=None, help="intra-op threads a rank (the host's cores / D)")
    p.add_argument("--out_json", default=None)
    return p


def shapes(points, queries, seed: int = 0):
    """[(ref [1, N, 3], query [1, M, 3])] from one generator, as the JAX
    script draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for n in points:
        for m in queries:
            out.append((rng.normal(size=(1, n, 3)).astype(np.float32), rng.normal(size=(1, m, 3)).astype(np.float32)))
    return out


def rank_run(rank, world, cases, device, warm, reps, rounds=1):
    """On one rank: each case's shard searched by both schedules; their
    results (numpy), ms a call in each round, and the launches of the timed
    calls (all of them, warm ones included)."""
    import torch

    from mvtracker_torch.ops import knn as knn_ops
    from mvtracker_torch.parallel.mesh import make_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    group = make_mesh(1, world, backend="gloo").group("model")
    out = []
    for ref, query in cases:
        ref, query = torch.as_tensor(ref, device=device), torch.as_tensor(query, device=device)
        n_local = ref.shape[1] // world
        shard = ref[:, rank * n_local : (rank + 1) * n_local].contiguous()
        schedules = {"gather": knn_ops.knn_sharded, "ring": knn_ops.knn_sharded_ring}
        row = {}
        for name, fn in schedules.items():
            d, i = fn(shard, query, K, group)
            row[name] = {"d": d.cpu().numpy(), "i": i.cpu().numpy(), "ms": [], "launches": {}}
        for r in range(rounds if device == "cuda" else 1):
            for name, fn in schedules.items():
                with timing_torch.counted() as counts:
                    times = timing_torch.host_ms(lambda: fn(shard, query, K, group), device, reps,
                                                 warm if r == 0 else 0)
                if times is not None:
                    row[name]["ms"].append(float(np.mean(times)))
                for k, v in counts["launches"].items():
                    if v:
                        row[name]["launches"][k] = row[name]["launches"].get(k, 0) + v
        for name in schedules:
            row[name]["ms"] = row[name]["ms"] or None
            row[name]["calls"] = warm + reps * rounds if device == "cuda" else 1
        out.append(row)
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from mvtracker_torch.device import resolve_device
    from mvtracker_torch.ops import _cuda
    from mvtracker_torch.ops import knn as knn_ops
    from mvtracker_torch.parallel.launch import run_local

    device = resolve_device(args.device)
    if device.type == "cuda":
        _cuda.build_all()  # the ranks load what this process built
    d = args.ranks
    cases = shapes(args.points, args.queries)
    for ref, _ in cases:
        if ref.shape[1] % d:
            raise ValueError(f"{ref.shape[1]} points do not split into {d} equal shards")
    exact = [tuple(a.cpu() for a in knn_ops.knn(torch.as_tensor(ref, device=device),
                                                torch.as_tensor(query, device=device), K, backend="exact"))
             for ref, query in cases]
    with tempfile.TemporaryDirectory() as rendezvous:
        ranks = run_local(rank_run, d, rendezvous, cases, device.type, args.warm, args.reps, args.rounds,
                          timeout=args.timeout, threads=args.threads or max(1, (os.cpu_count() or 1) // d))
    rows, agree, unresolved = [], 0, 0
    for c, ((ref, query), (want_d, want_i)) in enumerate(zip(cases, exact)):
        n, m = ref.shape[1], query.shape[1]
        row = {"N": n, "M": m, "k": K, "M*k": m * K, "N/D": n // d}
        for name in ("gather", "ring"):
            for r, got in enumerate(ranks):
                res = got[c][name]
                if not (np.array_equal(res["d"], want_d.numpy()) and np.array_equal(res["i"], want_i.numpy())):
                    raise AssertionError(f"{name} at N={n} M={m} on rank {r}: {int((res['d'] != want_d.numpy()).sum())} "
                                         f"distances and {int((res['i'] != want_i.numpy()).sum())} indices differ "
                                         "from the exact search")
            times = [got[c][name]["ms"] for got in ranks]
            rounds = None if None in times else np.max(times, axis=0)  # each round's slowest rank
            row[f"{name}_ms"] = None if rounds is None else float(rounds.min())
            row[f"{name}_spread_ms"] = None if rounds is None else float(rounds.max() - rounds.min())
            row[f"{name}_launches"] = [got[c][name]["launches"] for got in ranks]  # each rank's, in its calls
            row[f"{name}_calls"] = ranks[0][c][name]["calls"]
        row["predicted"] = "ring" if m * K > n // d else "gather"
        if row["gather_ms"] is not None:
            if abs(row["gather_ms"] - row["ring_ms"]) <= max(row["gather_spread_ms"], row["ring_spread_ms"]):
                row["winner"] = "unresolved"
                unresolved += 1
            else:
                row["winner"] = "gather" if row["gather_ms"] < row["ring_ms"] else "ring"
                agree += row["winner"] == row["predicted"]
        rows.append(row)
    if rows[0]["gather_ms"] is None:
        agree = unresolved = None
    report = {"ranks": d, "schedule": "gloo through host memory, the ranks sharing one device", "rows": rows,
              "rule_agrees": agree, "rule_unresolved": unresolved, "rule_cases": len(rows), "rounds": args.rounds,
              "bit_equal_to_exact": True,
              **timing_torch.card(device)}
    print(f"{'N':>8} {'M':>6} {'k':>3} {'M*k':>7} {'N/D':>7} {'gather ms (spread)':>19} {'ring ms (spread)':>17} "
          "winner (rule)")
    for row in rows:
        cells = (f"{'-':>19} {'-':>17} -" if row["gather_ms"] is None else
                 f"{row['gather_ms']:>10.2f} ({row['gather_spread_ms']:5.2f}) {row['ring_ms']:>8.2f} "
                 f"({row['ring_spread_ms']:5.2f}) {row['winner']}")
        print(f"{row['N']:>8} {row['M']:>6} {row['k']:>3} {row['M*k']:>7} {row['N/D']:>7} {cells} ({row['predicted']})")
    agreed = ("not measured on the CPU" if agree is None else
              f"{agree}/{len(rows) - unresolved} shapes with a winner ({unresolved} inside the spread of "
              f"{args.rounds} rounds)")
    print(f"both schedules equal to the exact search to the bit on all {d} ranks; the rule 'ring iff M*k > N/D' "
          f"picks the faster: {agreed}; the gloo schedule on {d} ranks sharing one device, not NVLink "
          f"[{report['device']}, {report['power_limit']}]")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
