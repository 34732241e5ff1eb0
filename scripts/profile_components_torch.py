"""Per-stage timing of the port's flagship forward on one NVIDIA GPU: the
twin of `scripts/profile_components.py`.

    python3 scripts/profile_components_torch.py [--reps 20] [--out_json out.json]

At the bench config (`bench_torch.py`: bf16, seeded weights, `make_scene`
seed 0 at 4 views x 24 frames x 256^2, 256 queries, 4 iterations) it times,
through the model's own methods:

- `compute_fmaps`, the encoder over all V x T frames;
- `_build_context`, the fused clouds of every level;
- `_feat_init`, the queries' k=1 lookup (K1);
- `_corr_knn` of one window (K1 at each level) and `_corr_features` of one
  window on those neighbours (K2 at each level), each run once per window
  and iteration, so their totals are estimated as a call x iterations x
  windows, as the JAX script estimates its scanned stages;
- the `EfficientUpdateFormer` on one window's input, also a call x
  iterations x windows;
- the full forward.

Each stage is timed with CUDA events around `--reps` calls after `--warm`
untimed ones (the full forward around `--full_reps`). Prints, per stage, ms a
call, its estimated total, the share of the full forward, and the kernels'
launches and the kNN and correlation calls a call, with the card's name and
power limit; returns them as a dict. With `--device cpu` (the tests) every time and share is None and each
stage runs once.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402
from scripts import timing_torch  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true", help="bench_torch.py's narrow widths")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--full_reps", type=int, default=10)
    p.add_argument("--warm", type=int, default=2)
    p.add_argument("--out_json", default=None)
    return p


def stage_inputs(model, scene) -> dict:
    """What each stage takes, computed once by the stages before it (no
    autograd): fmaps, the strided depths, the context, the query times and
    xyz, and one window's context, coords [S, N, 3] at the queries, track
    features [S, N, C] (zeros), neighbours, update-transformer input [1, N,
    S, D] (ones) and track mask."""
    import torch

    from mvtracker_torch.models.mvtracker import take_frames

    rgbs, depths, query, intrs, extrs = (model._as_input(a) for a in scene)
    s, n = model.sliding_window_len, query.shape[0]
    with torch.no_grad():
        fmaps = model.compute_fmaps(rgbs)
        depths_strided = depths[:, :, :: model.stride, :: model.stride]
        context = model._build_context(fmaps, depths_strided, intrs, extrs)
        context_w = take_frames(context, torch.arange(s, device=model.device))
        coords = query[None, :, 1:].expand(s, n, 3).contiguous()
        knn_cache = model._corr_knn(context_w, coords)
    return {
        "rgbs": rgbs, "fmaps": fmaps, "depths_strided": depths_strided, "intrs": intrs, "extrs": extrs,
        "context": context, "query_t": query[:, 0].long(), "query_xyz": query[:, 1:].contiguous(),
        "context_w": context_w, "coords": coords, "knn_cache": knn_cache,
        "ffeats": torch.zeros((s, n, model.fmaps_dim), device=model.device),
        "x_uf": torch.ones((1, n, s, model.updateformer_input_dim), device=model.device),
        "active": torch.ones((1, n), dtype=torch.bool, device=model.device),
    }


def stages(model, scene, x: dict) -> dict:
    """{stage: (callable, runs per forward)}; a per-window stage runs once
    per window and iteration."""
    from mvtracker_torch.models.mvtracker import window_starts

    windows = len(window_starts(scene[0].shape[1], model.sliding_window_len))
    per_window = bench_torch.ITERS * windows
    return {
        "encoder": (lambda: model.compute_fmaps(x["rgbs"]), 1),
        "build_context": (lambda: model._build_context(x["fmaps"], x["depths_strided"], x["intrs"], x["extrs"]), 1),
        "feat_init": (lambda: model._feat_init(x["context"], x["query_t"], x["query_xyz"]), 1),
        "corr_knn": (lambda: model._corr_knn(x["context_w"], x["coords"]), per_window),
        "corr_features": (lambda: model._corr_features(x["context_w"], x["coords"], x["ffeats"], x["knn_cache"]),
                          per_window),
        "updateformer": (lambda: model.updateformer(x["x_uf"], track_mask=x["active"]), per_window),
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from mvtracker_torch.device import resolve_device
    from mvtracker_torch.ops import _cuda

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        _cuda.build_all()
    widths = bench_torch.configs(args.small)["headline"][1]
    scene = [torch.as_tensor(a, device=device) for a in bench_torch.headline_scene(args.small)]
    model = bench_torch.build_model(widths, device)

    def timed(fn, reps):
        with timing_torch.counted() as counts, torch.no_grad():
            ms = timing_torch.event_ms(fn, device, reps, args.warm)
        return ms, timing_torch.per_call(counts, reps + args.warm if on_card else 1)

    full_ms, full_counts = timed(lambda: bench_torch.forward(model, scene), args.full_reps)
    x = stage_inputs(model, scene)
    report = {"full_forward": {"ms": full_ms, "runs": 1, "total_ms": full_ms, "share": None if full_ms is None else 1.0,
                               **full_counts}}
    for name, (fn, runs) in stages(model, scene, x).items():
        ms, counts = timed(fn, args.reps)
        total = None if ms is None else ms * runs
        report[name] = {"ms": ms, "runs": runs, "total_ms": total,
                        "share": None if total is None else total / full_ms, **counts}
    parts = [report[k]["total_ms"] for k in report if k != "full_forward"]
    accounted = None if None in parts else sum(parts)
    result = {"stages": report, "accounted_ms": accounted,
              "accounted_share": None if accounted is None else accounted / full_ms,
              "config": {"views": scene[0].shape[0], "frames": scene[0].shape[1], "queries": scene[2].shape[0],
                         "iters": bench_torch.ITERS, "small": args.small},
              **timing_torch.card(device)}
    print(f"== component timing of the port ({result['config']}) [{result['device']}, {result['power_limit']}] ==")
    for name, row in report.items():
        cells = ("not measured on the CPU" if row["ms"] is None else
                 f"{row['ms']:9.3f} ms x {row['runs']:2d} = {row['total_ms']:9.2f} ms  {100 * row['share']:5.1f}% "
                 "of the forward")
        print(f"{name:16s} {cells}   a call: launches {row['launches']}, kNN and correlation calls {row['calls']}")
    if accounted is not None:
        print(f"accounted {accounted:.2f} ms, {100 * result['accounted_share']:.1f}% of the forward")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
