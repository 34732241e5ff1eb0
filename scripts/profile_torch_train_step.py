#!/usr/bin/env python3
"""Where the time of the port's flagship train step goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_train_step.py [--steps 3] [--top 25] [--compare-remat]

Builds `mvtracker_torch`'s flagship MVTracker (bf16, seeded random weights,
`remat=True, remat_encoder=False`, the configuration the JAX package's
benchmark trains) and takes train steps on one scene of 4 views x 24 frames
x 256^2 with 256 queries and 4 iterations (the batch of `chip_smoke.py`'s
training phase): one warm-up step, `--steps` timed ones, the last under
`torch.profiler`. Prints the card, the step times, the device-busy share
(union of the profiled step's kernel intervals over its wall time, and over
the median unprofiled step's, since the profiler slows the host), the host
and device time of the spans `stage::forward`, `stage::backward` and
`stage::optimizer` that the train step records, the peak memory, and the
top kernels by device time. The kernels are built before the first step, so
that step's time is the framework's warm-up, not `nvcc`. With `--compare-remat` it then times the same
steps with `remat=False` and prints both peaks.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from scripts.profile_torch_forward import busy_us  # noqa: E402

V, T, H, W, N_QUERIES, ITERS = 4, 24, 256, 256, 256, 4


def make_batch(torch, make_scene, dev):
    rng = np.random.default_rng(0)
    scene = make_scene(rng, V, T, H, W, N_QUERIES)
    batch = {
        "rgbs": scene[0][None], "depths": scene[1][None], "query_points": scene[2][None],
        "intrs": scene[3][None], "extrs": scene[4][None],
        "traj_gt": rng.normal(size=(1, T, N_QUERIES, 3)).astype(np.float32),
        "vis_gt": np.ones((1, T, N_QUERIES), np.float32),
        "valid": np.ones((1, T, N_QUERIES), np.float32),
    }
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def timed_steps(torch, train_step, state, batch, steps: int):
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, metrics, times


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.ops import _cuda
    from mvtracker_torch.scene import make_scene
    from mvtracker_torch.training import step as step_lib

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--compare-remat", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    _cuda.build_all()
    batch = make_batch(torch, make_scene, dev)

    def build(remat: bool):
        model = MVTracker(compute_dtype="bfloat16", remat=remat, remat_encoder=False, device=dev)
        model.load_state_dict(random_state_dict(model, seed=0))
        optimizer = step_lib.make_optimizer()
        return step_lib.init_state(model, optimizer), step_lib.make_train_step(model, optimizer, iters=ITERS)

    state, train_step = build(remat=True)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, _, first = timed_steps(torch, train_step, state, batch, 1)  # warm-up
    state, metrics, times = timed_steps(torch, train_step, state, batch, args.steps - 1)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, metrics, profiled = timed_steps(torch, train_step, state, batch, 1)
    wall_ms = profiled[0]
    print(f"remat=True remat_encoder=False: first step {first[0]:.2f} ms, step ms {[round(x, 2) for x in times]}, "
          f"profiled step {wall_ms:.2f} ms, loss {float(metrics['loss']):.6f}, grad_norm {float(metrics['grad_norm']):.4f}")
    print(f"memory: resident {resident / 2**20:.1f} MiB (weights, AdamW state, batch), peak {peak / 2**20:.1f} MiB, "
          f"per step {(peak - resident) / 2**20:.1f} MiB [{smi}]")

    kernels = [e for e in prof.events() if e.device_type.name == "CUDA" and not e.name.startswith("stage::")]
    dev_total_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    busy_ms = busy_us(kernels) / 1e3
    plain_ms = float(np.median(times)) if times else float("nan")
    print(f"profiled step: wall {wall_ms:.2f} ms, {len(kernels)} device kernels, kernel time "
          f"{dev_total_us / 1e3:.2f} ms, device busy {busy_ms:.2f} ms; busy share {busy_ms / wall_ms:.3f} of the "
          f"profiled step, {busy_ms / plain_ms:.3f} of the median unprofiled step ({plain_ms:.2f} ms) [{smi}]")
    # A span's host entry carries the device time of the kernels launched
    # inside it on its own thread. The backward's kernels are launched by the
    # autograd engine's thread, so its device time is what the forward and
    # the optimizer leave of the step's kernel time.
    host = {e.key: e for e in prof.key_averages() if e.key.startswith("stage::") and e.cpu_time_total > 0}
    for key, e in host.items():
        print(f"{key}: host {e.cpu_time_total / 1e3:.2f} ms, device {e.device_time_total / 1e3:.2f} ms")
    rest_ms = (dev_total_us - sum(e.device_time_total for e in host.values())) / 1e3
    print(f"stage::backward device time, as the step's kernel time outside the forward and optimizer spans: "
          f"{rest_ms:.2f} ms")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=args.top, max_name_column_width=60))

    if args.compare_remat:
        del state, train_step, prof, kernels
        torch.cuda.empty_cache()
        state, train_step = build(remat=False)
        torch.cuda.synchronize()
        resident2 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, _, first2 = timed_steps(torch, train_step, state, batch, 1)
        state, _, times2 = timed_steps(torch, train_step, state, batch, max(args.steps - 1, 1))
        peak2 = torch.cuda.max_memory_allocated()
        print(f"remat=False: first step {first2[0]:.2f} ms, step ms {[round(x, 2) for x in times2]}; peak "
              f"{peak2 / 2**20:.1f} MiB, per step {(peak2 - resident2) / 2**20:.1f} MiB, against "
              f"{(peak - resident) / 2**20:.1f} MiB with remat=True [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
