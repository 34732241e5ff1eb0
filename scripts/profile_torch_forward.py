#!/usr/bin/env python3
"""Where the time of the port's flagship forward goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_forward.py [--requests 3] [--top 25]

Builds `mvtracker_torch`'s flagship MVTracker (bf16, seeded random
weights), answers one warm-up request and then `--requests` timed ones at
4 views x 24 frames x 256^2 with 256 queries (the shape of `chip_smoke.py`),
and profiles the last one with `torch.profiler`. Prints the card, the
request times, the device-busy share (union of the profiled request's
kernel intervals over its wall time, and over the median unprofiled
request's, since the profiler slows the host), the calls, host time and
device time of each of the program's `mvtracker::` spans
(`mvtracker_torch/utils/observability.py::span`) and the top kernels by
CUDA time. The spans' device times are `key_averages()`'s, which leave out
the kernels the port launches through ctypes (K1 to K5 under `knn` and
`corr`); `perfbench/program_spans.py` links every device operation to its
launch.
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

V, T, H, W, N_QUERIES, ITERS = 4, 24, 256, 256, 256, 4


def busy_us(events) -> float:
    """Union of the device kernels' intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def span_rows(prof, prefix: str = "mvtracker::") -> dict:
    """{span: (calls, host ms, device ms)} of the program's spans whose name
    starts with `prefix`, from the host ranges of a profile: a range's device
    time is that of the kernels launched inside it on its own thread."""
    return {e.key: (e.count, e.cpu_time_total / 1e3, e.device_time_total / 1e3)
            for e in prof.key_averages() if e.key.startswith(prefix) and e.cpu_time_total > 0}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.scene import make_scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    model = MVTracker(compute_dtype="bfloat16", device=dev).eval()
    model.load_state_dict(random_state_dict(model, seed=0))
    scene = [torch.as_tensor(a, device=dev) for a in make_scene(np.random.default_rng(0), V, T, H, W, N_QUERIES)]

    model(*scene, iters=ITERS)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(args.requests - 1):
        t0 = time.perf_counter()
        model(*scene, iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(*scene, iters=ITERS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    times.append(wall_ms)
    print(f"request ms {[round(x, 2) for x in times]} (last one profiled)")

    events = prof.events()
    # Device-side events, without the spans' own device ranges.
    kernels = [e for e in events if e.device_type.name == "CUDA" and not e.name.startswith("mvtracker::")]
    dev_total_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    busy_ms = busy_us(kernels) / 1e3
    # The profiler slows the host, so the profiled request's wall time is
    # longer than a plain one's; the share is given against both.
    plain_ms = float(np.median(times[:-1])) if len(times) > 1 else float("nan")
    print(f"profiled request: wall {wall_ms:.2f} ms, {len(kernels)} device kernels, "
          f"kernel time {dev_total_us / 1e3:.2f} ms, device busy {busy_ms:.2f} ms; busy share "
          f"{busy_ms / wall_ms:.3f} of the profiled request, {busy_ms / plain_ms:.3f} of the median "
          f"unprofiled request ({plain_ms:.2f} ms)")
    for key, (calls, host_ms, device_ms) in span_rows(prof).items():
        print(f"{key}: calls {calls}, cpu total {host_ms:.2f} ms, device total {device_ms:.2f} ms")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=args.top, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
