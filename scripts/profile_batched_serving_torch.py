"""Batched-scene serving on the port, stage by stage, on one NVIDIA GPU: the
twin of `scripts/profile_batched_serving.py`.

    python3 scripts/profile_batched_serving_torch.py [--batches 1 2 4 8] [--out_json out.json]

For B scenes it times the serving forward (`corr_knn_reuse=True`, bench
config: bf16, seeded weights, `make_scene` seed 0 at 4 views x 24 frames x
256^2, 256 queries, 4 iterations) and each stage, and reports

    r(B) = time(B) / (B * time(1))

per stage: about 1 where a stage is serial work, above 1 where batching
loses, below 1 where the stage left the card idle at B=1 and batching takes
that capacity back. The JAX script `vmap`s each stage. The port's model
serves one scene, so the full forward at B is B forwards in one timed unit
(as `bench_torch.py`'s `value_batched`), and each stage gets the B scenes
folded into an axis it already batches:

- the encoder: B x V x T images in one `compute_fmaps` call;
- the kNN: B x S frame clouds of one window on K1's leading axis
  (`_corr_knn`);
- the correlation: the B scenes' tracks on K2's track axis
  (`_corr_features`); as in the JAX script the B scenes are copies of one
  scene, so they share its clouds;
- the update transformer: batch B.

The folding lives here; no module changes. Before timing, the folds are held
against separate calls on two different inputs a stage (scenes 0 and 1,
tracks of two scenes in one cloud, two transformer inputs), in fp32 with
TF32 off: the kNN's indices and distances must be equal to the bit, the
others within `FOLD_RTOL` (a fold changes only the order of summation).
Stages are timed with CUDA events around `--reps` calls after `--warm`,
the full forward by the JAX scripts' statistic. Prints each B's row, r(B),
the fold check and the card's name and power limit; returns them as a dict.
With `--device cpu` (the tests) times and ratios are None.
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
from scripts.profile_components_torch import stage_inputs  # noqa: E402

FOLD_RTOL = 1e-5


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true", help="bench_torch.py's narrow widths")
    p.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--warm", type=int, default=2)
    p.add_argument("--reps", type=int, default=16)
    p.add_argument("--full_warm", type=int, default=2)
    p.add_argument("--full_reps", type=int, default=6)
    p.add_argument("--out_json", default=None)
    return p


def _split(x, parts: int, dim: int):
    return list(x.chunk(parts, dim=dim))


def fold_encoder(model, rgbs_list):
    """B scenes' [V, T, H, W, 3] through one encoder call -> B fmaps."""
    import torch

    return _split(model.compute_fmaps(torch.cat(rgbs_list, dim=0)), len(rgbs_list), 0)


def fold_knn(model, contexts_w, coords_list):
    """B windows' clouds and coords [S, N, 3] on the frame axis of one
    `_corr_knn` -> B (dists, idx) by level."""
    import torch

    b = len(coords_list)
    levels = range(model.corr_n_levels)
    context = [tuple(None if contexts_w[0][lvl][j] is None else torch.cat([c[lvl][j] for c in contexts_w], dim=0)
                     for j in range(3)) for lvl in levels]
    dists, idx = model._corr_knn(context, torch.cat(coords_list, dim=0))
    return [({lvl: _split(dists[lvl], b, 0)[i] for lvl in levels}, {lvl: _split(idx[lvl], b, 0)[i] for lvl in levels})
            for i in range(b)]


def fold_corr(model, context_w, coords_list, ffeats_list, caches):
    """B track sets in one window's clouds on the track axis of one
    `_corr_features` -> B correlation features [S, N, F]."""
    import torch

    b = len(coords_list)
    levels = range(model.corr_n_levels)
    cache = tuple({lvl: torch.cat([c[part][lvl] for c in caches], dim=1) for lvl in levels} for part in (0, 1))
    out = model._corr_features(context_w, torch.cat(coords_list, dim=1), torch.cat(ffeats_list, dim=1), cache)
    return _split(out, b, 1)


def fold_updateformer(model, x_list, active_list):
    """B inputs [1, N, S, D] as batch B of one update-transformer call."""
    import torch

    return _split(model.updateformer(torch.cat(x_list, dim=0), track_mask=torch.cat(active_list, dim=0)),
                  len(x_list), 0)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _flat(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _flat(item)]
    return [tree]


def _gap(folded, separate) -> dict:
    """max |folded - separate| over max |separate|, and whether all are equal
    to the bit."""
    a, b = _flat(folded), _flat(separate)
    worst, scale = 0.0, 0.0
    for x, y in zip(a, b, strict=True):
        worst = max(worst, float((x.double() - y.double()).abs().max()))
        scale = max(scale, float(y.double().abs().max()))
    return {"rel": worst / scale if scale else worst, "bit_equal": all(bool((x == y).all()) for x, y in zip(a, b))}


def fold_check(model, scenes) -> dict:
    """Each fold at B=2 against two separate calls, on `model` (fp32)."""
    import torch

    from mvtracker_torch.device import fp32_precision

    with torch.no_grad(), fp32_precision(exact=True):
        xs = [stage_inputs(model, scene) for scene in scenes]
        enc = _gap(fold_encoder(model, [x["rgbs"] for x in xs]), [model.compute_fmaps(x["rgbs"]) for x in xs])
        knn = _gap(fold_knn(model, [x["context_w"] for x in xs], [x["coords"] for x in xs]),
                   [model._corr_knn(x["context_w"], x["coords"]) for x in xs])
        # Two scenes' tracks in scene 0's window: scene 1's queries searched
        # in scene 0's clouds.
        ctx = xs[0]["context_w"]
        coords = [x["coords"] for x in xs]
        caches = [model._corr_knn(ctx, c) for c in coords]
        ffeats = [torch.randn(c.shape[:2] + (model.fmaps_dim,), generator=torch.Generator().manual_seed(i)).to(c)
                  for i, c in enumerate(coords)]
        corr = _gap(fold_corr(model, ctx, coords, ffeats, caches),
                    [model._corr_features(ctx, c, f, k) for c, f, k in zip(coords, ffeats, caches)])
        gen = torch.Generator().manual_seed(2)
        x_uf = [torch.randn(xs[0]["x_uf"].shape, generator=gen).to(xs[0]["x_uf"]) for _ in range(2)]
        active = [xs[0]["active"], xs[0]["active"].clone()]
        active[1][:, ::3] = False
        uf = _gap(fold_updateformer(model, x_uf, active),
                  [model.updateformer(x, track_mask=m) for x, m in zip(x_uf, active)])
    return {"encoder": enc, "knn_window": knn, "corr_window": corr, "updateformer": uf}


def fold_failures(check: dict) -> list:
    """The folds that break their limits: the kNN not equal to the bit, the
    others past `FOLD_RTOL`."""
    return [name for name, gap in check.items()
            if not (gap["bit_equal"] if name == "knn_window" else gap["rel"] <= FOLD_RTOL)]


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from mvtracker_torch.device import resolve_device
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.ops import _cuda
    from mvtracker_torch.scene import make_scene

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        _cuda.build_all()
    (v, t, h, w, n), widths = bench_torch.configs(args.small)["headline"]
    scenes_np = [bench_torch.headline_scene(args.small), make_scene(np.random.default_rng(1), v, t, h, w, n)]
    scenes = [[torch.as_tensor(a, device=device) for a in s] for s in scenes_np]
    model = bench_torch.build_model(widths, device, corr_knn_reuse=True)
    fp32 = MVTracker(**widths, compute_dtype="float32", corr_knn_reuse=True, device=device)
    fp32.load_state_dict(model.state_dict())
    check = fold_check(fp32, scenes)
    bad = fold_failures(check)
    print(f"fold check (B=2 folded against 2 separate calls, fp32, TF32 off): "
          f"{ {k: (g['rel'], g['bit_equal']) for k, g in check.items()} }")
    if bad:
        raise AssertionError(f"folded stages {bad} differ from separate calls: {check}")
    del fp32

    scene = scenes[0]
    x = stage_inputs(model, scene)
    report = {"config": [v, t, h, w, n], "batches": {}, "launches": {}, "fold_check": check}
    for b in args.batches:
        rgbs = [x["rgbs"]] * b
        ctxs, coords = [x["context_w"]] * b, [x["coords"]] * b
        caches, ffeats = [x["knn_cache"]] * b, [x["ffeats"]] * b
        x_uf, active = [x["x_uf"]] * b, [x["active"]] * b
        row, launches = {}, {}
        with timing_torch.counted() as counts:
            row["full_fwd"] = timing_torch.lower_mean_ms(lambda: [bench_torch.forward(model, scene) for _ in range(b)],
                                                         device, args.full_reps, args.full_warm)
        launches["full_fwd"] = counts["launches"]
        for name, fn in (("encoder", lambda: fold_encoder(model, rgbs)),
                         ("knn_window", lambda: fold_knn(model, ctxs, coords)),
                         ("corr_window", lambda: fold_corr(model, x["context_w"], coords, ffeats, caches)),
                         ("updateformer", lambda: fold_updateformer(model, x_uf, active))):
            with timing_torch.counted() as counts, torch.no_grad():
                row[name] = timing_torch.event_ms(fn, device, args.reps, args.warm)
            launches[name] = timing_torch.per_call(counts, args.reps + args.warm if on_card else 1)["launches"]
        report["batches"][b] = row
        report["launches"][b] = launches
        print(b, row, flush=True)
    if 1 in report["batches"]:
        base = report["batches"][1]
        report["scaling_ratio"] = {
            b: {k: None if base[k] is None else report["batches"][b][k] / (b * base[k]) for k in base}
            for b in args.batches}
    report.update(timing_torch.card(device))
    print(json.dumps(report))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
