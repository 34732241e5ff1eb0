"""Warm-up, timing and counting for the port's measurement scripts
(`bench_torch.py` and `scripts/*_torch.py`, the twins of `bench.py` and the
JAX profiling scripts) and for `chip_smoke.py`'s phase 17.

It takes the place of the JAX scripts' scalar-fetch sync (`bench.py:96-104`):
- a request or a step is timed on the host clock up to
  `torch.cuda.synchronize()` (`host_ms`, `lower_mean_ms`);
- a stage is timed with CUDA events around many calls (`event_ms`);
- warm-up calls come first and are not timed.

On the CPU (`--device cpu`, the tests) every timer runs its function once, so
that outputs and counts are still computed, and returns None: no CPU time is
reported under a device metric's name.

`counted()` counts, within a block, the calls of the kNN and correlation
dispatchers (`ops/knn.py::knn`, `ops/corr.py::corr_select`,
`corr_select_backward`), which are the same on every device, and the launches
of the five kernels, which happen on the card only.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time

import torch

# Dense bf16 peak of the card (NVIDIA's data sheet, without sparsity), by the
# name `torch.cuda.get_device_name` gives. "H100 80GB HBM3" is the SXM part.
BF16_PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12, "NVIDIA H100 SXM": 989e12}


def card(device) -> dict:
    """{"device": the card's name, "power_limit": its power limit as
    nvidia-smi prints it}; on the CPU {"device": "cpu", "power_limit": None}."""
    if torch.device(device).type != "cuda":
        return {"device": "cpu", "power_limit": None}
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "power_limit": limit}


def bf16_peak(name) -> float | None:
    return BF16_PEAK_FLOPS.get(name)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def host_ms(fn, device, reps: int, warm: int = 0) -> list[float] | None:
    """`warm` untimed calls, then `reps` calls each timed on the host clock
    from a synchronised start to `torch.cuda.synchronize()`; ms a call."""
    if not _on_card(device):
        fn()
        return None
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def lower_mean_ms(fn, device, reps: int, warm: int, rounds: int = 2) -> float | None:
    """The JAX scripts' statistic: after `warm` untimed calls, the lowest of
    `rounds` means of `reps` calls issued back to back with one synchronize
    at the end."""
    if not _on_card(device):
        fn()
        return None
    for _ in range(warm):
        fn()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    return min(run() for _ in range(rounds))


def event_ms(fn, device, reps: int, warm: int = 2) -> float | None:
    """A stage: `warm` untimed calls, then CUDA events around `reps` calls;
    mean ms a call."""
    if not _on_card(device):
        fn()
        return None
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spread(times: list[float] | None) -> dict:
    """Median, min and max of single-call times (all None without times)."""
    if not times:
        return {"median": None, "min": None, "max": None}
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def kernel_counters() -> dict:
    from mvtracker_torch.ops import corr as corr_ops
    from mvtracker_torch.ops import knn as knn_ops

    return {"knn": knn_ops.knn_cuda, "knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda,
            "corr": corr_ops.corr_select_cuda, "corr_bwd": corr_ops.corr_select_backward_cuda}


@contextlib.contextmanager
def counted(flop_counter=None):
    """Count within the block. Yields a dict that holds, on exit:
    "calls": {"knn", "corr", "corr_bwd"} calls of the dispatchers;
    "launches": {kernel: launches} of the five kernels;
    "knn_shapes": (B, N, M, k) of every kNN call, "corr_shapes": (B, N, K, C)
    of every correlation call.

    With a `torch.utils.flop_counter.FlopCounterMode` active around the
    block, "flops_inside" is what it counted inside the dispatchers (the
    plain versions on the CPU; the kernels, called through ctypes, it never
    sees), so that its total less that is the same on every device."""
    from mvtracker_torch.ops import corr as corr_ops
    from mvtracker_torch.ops import knn as knn_ops

    out = {"calls": {"knn": 0, "corr": 0, "corr_bwd": 0}, "knn_shapes": [], "corr_shapes": [], "flops_inside": 0}
    kernels = kernel_counters()
    before = {name: fn.launches for name, fn in kernels.items()}
    originals = {(knn_ops, "knn"): knn_ops.knn, (corr_ops, "corr_select"): corr_ops.corr_select,
                 (corr_ops, "corr_select_backward"): corr_ops.corr_select_backward}

    def wrap(fn, key, shape):
        def counting(*args, **kwargs):
            out["calls"][key] += 1
            if shape is not None:
                shape(*args)
            flops0 = flop_counter.get_total_flops() if flop_counter is not None else 0
            result = fn(*args, **kwargs)
            if flop_counter is not None:
                out["flops_inside"] += flop_counter.get_total_flops() - flops0
            return result
        return counting

    def knn_shape(ref, query, k, *rest):
        out["knn_shapes"].append((ref.shape[0], ref.shape[1], query.shape[1], int(k)))

    def corr_shape(fvec, targets, idx, *rest):
        out["corr_shapes"].append((idx.shape[0], idx.shape[1], idx.shape[2], fvec.shape[-1]))

    knn_ops.knn = wrap(originals[(knn_ops, "knn")], "knn", knn_shape)
    corr_ops.corr_select = wrap(originals[(corr_ops, "corr_select")], "corr", corr_shape)
    corr_ops.corr_select_backward = wrap(originals[(corr_ops, "corr_select_backward")], "corr_bwd", None)
    try:
        yield out
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
        out["launches"] = {name: fn.launches - before[name] for name, fn in kernels.items()}


def per_call(counts: dict, calls: int) -> dict:
    """Launches and dispatcher calls of a `counted` block divided by the
    number of calls it timed."""
    return {"launches": {k: v / calls for k, v in counts["launches"].items() if v},
            "calls": {k: v / calls for k, v in counts["calls"].items() if v}}
