"""Warm-up, timing and counting for the port's measurement scripts
(`bench_torch.py` and `scripts/*_torch.py`, the twins of `bench.py` and the
JAX profiling scripts), `chip_smoke.py` and the card tests.

It takes the place of the JAX scripts' scalar-fetch sync (`bench.py:96-104`):
- a request or a step is timed on the host clock up to
  `torch.cuda.synchronize()` (`host_ms`, `lower_mean_ms`);
- a stage is timed with CUDA events around many calls (`event_ms`);
- a kernel's own device time is read from launches replayed from a CUDA
  graph (`device_ms`, on the card only);
- warm-up calls come first and are not timed.

On the CPU (`--device cpu`, the tests) `host_ms`, `lower_mean_ms` and
`event_ms` run their function once, so that outputs and counts are still
computed, and return None: no CPU time is reported under a device metric's
name.

The five kernels' launches are counted in `mvtracker_torch/ops/_cuda.py`'s
`launches`, read here by `launches`. `counted()` counts, within a block, those
launches, which happen on the card only, and the calls of the kNN and
correlation dispatchers (`ops/knn.py::knn`, `ops/corr.py::corr_select`,
`corr_select_backward`), which are the same on every device; `recording`
is how it sees the calls.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from unittest import mock

import torch

from mvtracker_torch.ops import _cuda

# NVIDIA's data sheet for the H100 SXM part, dense rates without sparsity, by
# the name `torch.cuda.get_device_name` gives. "H100 80GB HBM3" is the SXM part.
_H100_SXM = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
PEAKS = {"NVIDIA H100 80GB HBM3": _H100_SXM, "NVIDIA H100 SXM": _H100_SXM}


def card(device) -> dict:
    """{"device": the card's name, "power_limit": its power limit as
    nvidia-smi prints it}; on the CPU {"device": "cpu", "power_limit": None}."""
    if torch.device(device).type != "cuda":
        return {"device": "cpu", "power_limit": None}
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "power_limit": limit}


def bf16_peak(name) -> float | None:
    return PEAKS.get(name, {}).get("bf16_flops")


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


def device_ms(fn, reps: int, replays: int = 3) -> float:
    """Device ms per call of `fn` on the card: `reps` calls captured in one
    CUDA graph, the graph replayed `replays` times between CUDA events. A
    replay needs no host work per launch, so this is the kernels' own time,
    back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def spread(times: list[float] | None) -> dict:
    """Median, min and max of single-call times (all None without times)."""
    if not times:
        return {"median": None, "min": None, "max": None}
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def launches(since: dict | None = None) -> dict:
    """{kernel: launches} of the five kernels (`_cuda.SOURCES`), zeros
    included: all so far, or those since `since`, an earlier reading."""
    return {name: _cuda.launches[name] - (since[name] if since else 0) for name in _cuda.SOURCES}


@contextlib.contextmanager
def recording(module, name: str, calls: list, keep=lambda args, kw, out: args):
    """Record what `keep` picks of each call of `module.name` into `calls`
    while the block runs; the calls themselves are unchanged, and the
    attribute is put back when the block ends, also when it raises."""
    original = getattr(module, name)

    def wrapper(*args, **kw):
        out = original(*args, **kw)
        calls.append(keep(args, kw, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def counted(flop_counter=None):
    """Count within the block. Yields a dict that holds, on exit:
    "calls": {"knn", "corr", "corr_bwd"} calls of the dispatchers;
    "launches": {kernel: launches} of the five kernels, zeros included;
    "knn_shapes": (B, N, M, k) of every kNN call, "corr_shapes": (B, N, K, C)
    of every correlation call.

    With a `torch.utils.flop_counter.FlopCounterMode` active around the
    block, "flops_inside" is what it counted inside the dispatchers (the
    plain versions on the CPU; the kernels, called through ctypes, it never
    sees), so that its total less that is the same on every device."""
    from mvtracker_torch.ops import corr as corr_ops
    from mvtracker_torch.ops import knn as knn_ops

    out = {"calls": {}, "knn_shapes": [], "corr_shapes": [], "flops_inside": 0}
    corr_bwd = []
    before = launches()

    def knn_shape(args, kw, result):
        ref, query = args[:2]
        return ref.shape[0], ref.shape[1], query.shape[1], int(kw["k"] if "k" in kw else args[2])

    def corr_shape(args, kw, result):
        fvec, _, idx = args[:3]
        return idx.shape[0], idx.shape[1], idx.shape[2], fvec.shape[-1]

    def inside(fn):
        def measured(*args, **kwargs):
            flops0 = flop_counter.get_total_flops()
            result = fn(*args, **kwargs)
            out["flops_inside"] += flop_counter.get_total_flops() - flops0
            return result
        return measured

    with contextlib.ExitStack() as stack:
        if flop_counter is not None:
            for module, name in ((knn_ops, "knn"), (corr_ops, "corr_select"), (corr_ops, "corr_select_backward")):
                stack.enter_context(mock.patch.object(module, name, inside(getattr(module, name))))
        stack.enter_context(recording(knn_ops, "knn", out["knn_shapes"], knn_shape))
        stack.enter_context(recording(corr_ops, "corr_select", out["corr_shapes"], corr_shape))
        stack.enter_context(recording(corr_ops, "corr_select_backward", corr_bwd, lambda a, kw, o: None))
        try:
            yield out
        finally:
            out["calls"] = {"knn": len(out["knn_shapes"]), "corr": len(out["corr_shapes"]), "corr_bwd": len(corr_bwd)}
            out["launches"] = launches(before)


def per_call(counts: dict, calls: int) -> dict:
    """Launches and dispatcher calls of a `counted` block divided by the
    number of calls it timed."""
    return {"launches": {k: v / calls for k, v in counts["launches"].items() if v},
            "calls": {k: v / calls for k, v in counts["calls"].items() if v}}
