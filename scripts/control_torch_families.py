"""CPU controls for the card-versus-CPU limits of `chip_smoke.py` phase 12
(the triplane SpaTracker, the learned 2D tracker and the NCC tracker).

Each control runs the plain CPU path twice on the flagship request (4 views
x 24 frames x 256^2, 256 queries; seeded weights, the flow head x5 as the
script's other phases) and reports how far the outputs move under a change
that the card makes anyway or that rounding stands for:

- SpaTracker, fp32 at `configs/spatracker_multiview.yaml`'s width: the
  splat's deposits in another order (the card sums each cell in another
  order than the CPU), every query moved by 1e-6, and rgb + 1e-3;
- CoTracker2D through `LearnedTracker2D` at `configs/cotracker2d.yaml`'s
  width, inside the multi-view adapter: queries + 1e-6 and rgb + 1e-3;
- the NCC tracker (`monocular_nn`) on the first scene of
  `configs/cotracker3_offline.yaml`'s dataset (a rendered 4 x 24 x 256^2
  scene, 256 tracks), each query on the view `pick_best_view` gives it: the
  share of (frame, track) positions that stay equal under rgb + 1e-3
  (about 1.3e-6 of a grey level), and with the scores in float64 instead of
  float32: how often rounding alone decides a winner.

Prints one JSON line per control (median / p90 / max of |gap|, or the
shares). `--size tiny` runs the same at a small size in seconds; `--parts`
picks some of spatracker, cotracker2d and ncc.

    python scripts/control_torch_families.py            # full size, minutes of CPU
    python scripts/control_torch_families.py --parts ncc
    python scripts/control_torch_families.py --size tiny
"""

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLOW_HEAD_GAIN = 5.0
SIZES = {"full": (4, 24, 256, 256, 256), "tiny": (2, 8, 64, 64, 16)}


def gap(a, b) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return {"median": float(np.median(d)), "p90": float(np.quantile(d, 0.9)), "max": float(d.max())}


def seeded(model, seed=0):
    from mvtracker_torch.convert import random_state_dict

    sd = random_state_dict(model, seed=seed)
    for name in sd:
        if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
            sd[name] = sd[name] * FLOW_HEAD_GAIN
    model.load_state_dict(sd)
    return model


@contextlib.contextmanager
def splat_order_reversed():
    """The splat of `models/spatracker.py` with every cloud's points in
    reverse order, so that each cell sums its deposits in another order."""
    from mvtracker_torch.models import spatracker

    real = spatracker.splat_points

    def reversed_points(points_xy, features, metric, height, width):
        return real(points_xy.flip(1), features.flip(1), metric.flip(1), height, width)

    spatracker.splat_points = reversed_points
    try:
        yield
    finally:
        spatracker.splat_points = real


def ncc_queries(dp):
    """(view, queries [M, 3] (t, x, y)) for every view that `pick_best_view`
    gives some of the scene's queries, as the adapter builds them."""
    import torch

    from mvtracker_torch.models.monocular import pick_best_view

    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in (dp.query_points_3d, dp.videodepth, dp.intrs,
                                                                   dp.extrs)]
    view, pix = pick_best_view(*args)
    qt = args[0][:, :1]
    out = []
    for vi in range(dp.video.shape[0]):
        sel = view == vi
        if bool(sel.any()):
            out.append((vi, torch.cat([qt[sel], pix[sel]], dim=1)))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", choices=sorted(SIZES), default="full")
    parser.add_argument("--parts", default="spatracker,cotracker2d,ncc", help="comma-separated controls to run")
    args = parser.parse_args(argv)
    parts = set(args.parts.split(","))

    import torch

    from mvtracker_torch.scene import make_scene

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    v, t, h, w, n = SIZES[args.size]
    scene = [torch.from_numpy(np.array(a)) for a in make_scene(np.random.default_rng(0), v, t, h, w, n)]
    moved_q = [a.clone() for a in scene]
    moved_q[2][:, 1:] += 1e-6
    moved_rgb = [a.clone() for a in scene]
    moved_rgb[0] += 1e-3
    torch.manual_seed(0)

    def report(name, **fields):
        print(json.dumps({"control": name, "size": args.size, **fields}), flush=True)

    if "spatracker" in parts:
        spatracker_controls(root, scene, moved_q, moved_rgb, report)
    if "cotracker2d" in parts:
        cotracker2d_controls(root, scene, moved_q, moved_rgb, report)
    if "ncc" in parts:
        ncc_controls(args, root, (v, t, h, w, n), report)


def spatracker_controls(root, scene, moved_q, moved_rgb, report):
    import torch

    from mvtracker_torch.config import build_model, load_config

    cfg = load_config(os.path.join(root, "configs", "spatracker_multiview.yaml")).model
    model = seeded(build_model(cfg, device="cpu"))
    t0 = time.perf_counter()
    with torch.no_grad():
        base = model(*scene, iters=4)
        seconds = time.perf_counter() - t0
        with splat_order_reversed():
            order = model(*scene, iters=4)
        query = model(*moved_q, iters=4)
        rgb = model(*moved_rgb, iters=4)
    moved = float(np.median(np.abs(base["traj"].numpy() - scene[2][None, :, 1:].numpy()).max(-1)))
    for label, out in (("splat order reversed", order), ("queries + 1e-6", query), ("rgb + 1e-3", rgb)):
        report(f"spatracker fp32: {label}", traj=gap(out["traj"], base["traj"]), vis=gap(out["vis"], base["vis"]),
               request_s=seconds, median_track_motion=moved)


def cotracker2d_controls(root, scene, moved_q, moved_rgb, report):
    """CoTracker2D through LearnedTracker2D, inside the adapter."""
    import torch

    from mvtracker_torch.config import build_model, load_config

    cfg = load_config(os.path.join(root, "configs", "cotracker2d.yaml")).model
    adapter = build_model(cfg, device="cpu")
    seeded(adapter.tracker_2d.model)
    with torch.no_grad():
        base = adapter(*scene)
        query = adapter(*moved_q)
        rgb = adapter(*moved_rgb)
    for label, out in (("queries + 1e-6", query), ("rgb + 1e-3", rgb)):
        report(f"cotracker2d adapter fp32: {label}", traj=gap(out["traj"], base["traj"]),
               vis=gap(out["vis"], base["vis"]))



def ncc_controls(args, root, size, report):
    """The NCC tracker on a rendered scene, each query on its best view."""
    import torch

    from mvtracker_torch.config import build_dataset, load_config
    from mvtracker_torch.models.monocular import SimpleNNTracker2D

    v, t, h, w, n = size
    data = load_config(os.path.join(root, "configs", "cotracker3_offline.yaml")).data
    if args.size == "tiny":
        data.n_views, data.n_frames, data.height, data.width, data.num_tracks = v, t, h, w, n
    dp = build_dataset(data)[0]
    rgbs = torch.from_numpy(np.asarray(dp.video, np.float32))
    for label, other, moved in (("rgb + 1e-3", SimpleNNTracker2D(), 1e-3),
                                ("float64 scores", SimpleNNTracker2D(dtype=torch.float64), 0.0)):
        equal, vis_equal, total, parted = 0, 0, 0, 0
        for vi, queries in ncc_queries(dp):
            tracks, vis = SimpleNNTracker2D()(rgbs[vi], queries)
            tracks_m, vis_m = other(rgbs[vi] + moved, queries)
            same = (tracks == tracks_m).all(-1)
            equal += int(same.sum())
            parted += int((~same).any(0).sum())
            vis_equal += int((vis == vis_m).sum())
            total += vis.numel()
        report(f"ncc {label}", share_equal_positions=equal / total, share_equal_visibility=vis_equal / total,
               positions=total, tracks_parted=parted)


if __name__ == "__main__":
    main()
