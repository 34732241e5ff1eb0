"""Evaluation-path frames per second of the port on one NVIDIA GPU: the
twin of `scripts/eval_fps.py`.

    python3 scripts/eval_fps_torch.py [--reps 5] [--out_json out.json]

The full `EvaluationPredictor` at the evaluation defaults (a 384x512
resize, one 5x5 support grid a view, 6 iterations) with the flagship
MVTracker (bf16, seeded weights) on the port's `render_scene` (seed 0, 4
views x 24 frames at 256^2, 128 tracks). After `--warm` untimed requests,
`--reps` requests are timed together on the host clock up to a synchronize
(the JAX script's mean of one run). Prints ms a request, frames per second, the peak
device memory above the resident set, the kernels' launches a request, and
the card's name and power limit; returns them as a dict. With `--device cpu`
(the tests) the times and the memory are None. `--small` runs narrow widths
at 2 views x 8 frames of 64^2 resized to 96x128.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_torch import SMALL_MODEL  # noqa: E402
from scripts import timing_torch  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--warm", type=int, default=1)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out_json", default=None)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.datasets.synthetic import render_scene
    from mvtracker_torch.device import resolve_device
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.ops import _cuda

    device = resolve_device(args.device)
    if device.type == "cuda":
        _cuda.build_all()
    if args.small:
        v, t, size, n, interp, widths = 2, 8, 64, 16, (96, 128), SMALL_MODEL
    else:
        v, t, size, n, interp, widths = 4, 24, 256, 128, (384, 512), {}
    dp = render_scene(n_views=v, n_frames=t, height=size, width=size, n_tracks=n, seed=0)
    scene = [torch.as_tensor(a, device=device)
             for a in (dp.video, dp.videodepth, dp.query_points_3d, dp.intrs, dp.extrs)]
    model = MVTracker(**widths, compute_dtype="bfloat16", device=device)
    model.load_state_dict(random_state_dict(model, seed=0))
    predictor = EvaluationPredictor(model, interp_shape=interp, grid_size=5, n_grids_per_view=1, n_iters=6)

    def request():
        return predictor(*scene)["traj"].cpu()

    if device.type == "cuda":
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with timing_torch.counted() as counts:
        ms = timing_torch.lower_mean_ms(request, device, args.reps, args.warm, rounds=1)
    calls = args.warm + args.reps if device.type == "cuda" else 1
    report = {
        "ms_per_request": ms,
        "fps": None if ms is None else t / (ms / 1e3),
        "peak_mib_above_resident": (torch.cuda.max_memory_allocated() - resident) / 2**20
        if device.type == "cuda" else None,
        "config": {"views": v, "frames": t, "size": size, "tracks": n, "interp": list(interp),
                   "support": v * 25, "iters": 6},
        **timing_torch.per_call(counts, calls),
        **timing_torch.card(device),
    }
    line = "not measured on the CPU" if ms is None else f"{ms:.1f} ms/datapoint -> {report['fps']:.2f} frames/s"
    print(f"eval predictor: {line} ({v} views x {t} frames @{interp[0]}x{interp[1]}, {n} queries + {v * 25} "
          f"support, 6 iters); peak {report['peak_mib_above_resident']} MiB above the resident set; launches a "
          f"request {report['launches']} [{report['device']}, {report['power_limit']}]")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
