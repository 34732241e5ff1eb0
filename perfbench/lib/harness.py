"""One run of one cell: set-up, the measured window, the traced requests,
the check against the reference, and the result line.

Set-up builds the model from the configuration file, loads weights drawn on
the device from the seed, makes the traffic's pool of clips with its
generator (`lib/traffic.py`), keeps them in pinned host memory, and answers
`warmup_requests` requests. The window then sends requests in a closed loop, one in flight,
cycling through the pool, until `seconds` have passed; the request that is
in flight at the deadline finishes and counts. With `trace`, a
`FlopCounterMode` request and `profiled_requests` traced requests follow
the window; the per-layer metrics read them and the window's request times
(`TraceContext`). From the traced records they get two summaries: the
device time under the benchmark's outside spans (`perfbench/spans/`,
`trace.summarize`) and the table of the program's own `mvtracker::` spans
(`program_trace.summarize`), in which a span is found by its name, so a
span that the program opens later is read by a new reader with no edit
here. The `FlopCounterMode` request also keeps the counter's operations by
module (`flops_by_module`), so a layer's roofline is its module's
operations over its span's device time.
The process is searched for forbidden modules (`lib/hygiene.py`) at the end
of set-up, as the window closes, and once more as the last step, after the
reference, the controls and the metric readers have loaded.
"""

from __future__ import annotations

import importlib.util
import math
import statistics
import sys
import time
from pathlib import Path

import torch

from perfbench.lib import check, counts, hygiene, program, program_trace, spans, stats, trace, weights

GIB = 2**30


def clip_seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + 7_919 * (i + 1)) % (2**63)


def make_clips(traffic: dict, seed: int, device) -> list:
    clips = []
    for i in range(traffic["pool"]):
        c = traffic["make_clip"](clip_seed(seed, i), i, traffic, device)
        if torch.device(device).type == "cuda":
            c = {k: v.pin_memory() for k, v in c.items()}
        clips.append(c)
    return clips


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(call, clips, seconds: float, device):
    """Closed loop for `seconds`: (latencies s, answers [(clip, traj, vis)],
    failures, window seconds)."""
    lat, answers, failed = [], [], 0
    _sync(device)
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    end = start
    while end < deadline:
        ci = i % len(clips)
        t0 = time.perf_counter()
        try:
            traj, vis = call(clips[ci])
        except (RuntimeError, ValueError) as exc:  # a request that fails is counted and reported
            print(f"request {i} failed: {exc!r}", file=sys.stderr)
            failed += 1
        else:
            answers.append((ci, traj, vis))
        end = time.perf_counter()
        lat.append(end - t0)
        i += 1
    return lat, answers, failed, end - start


def point_frames(clip: dict) -> int:
    """The user's queries x frames of one request (no support points)."""
    return clip["queries"].shape[0] * clip["rgbs"].shape[1]


def e2e_metrics(clips: list, lat: list, answers: list, window_s: float, peak_window: int, setup_s: float) -> dict:
    work = sum(point_frames(clips[ci]) for ci, _, _ in answers)
    return {
        "point_frames_per_s": {"value": work / window_s, "unit": "point-frames/s"},
        "request_p90_ms": {"value": stats.percentile(lat, 90) * 1e3, "unit": "ms"},
        "device_peak_gib": {"value": peak_window / GIB, "unit": "GiB"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }


def load_reader(root: Path, name: str):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class TraceContext:
    """What a per-layer metric reader reads (see `perfbench/metrics/`):

    - `summary`: `trace.summarize` of the traced requests (busy time,
      kernels, `span_device_s` under the outside spans, the breakdown);
    - `calls`: the recorded calls of the wrapped functions, by span;
    - `requests`: the number of traced requests; `plain_request_s`: the
      window's request times;
    - `flops_per_request`: the model's operations a request (`count_flops`);
    - `peaks`: the card's peaks (`counts.peaks`), None on a card without;
    - `program`: `program_trace.summarize` of the traced requests, with the
      program's spans under `program["spans"][name]`, summed over the
      requests; None where no trace was read;
    - `flops_by_module`: `FlopCounterMode`'s operations a request by the
      counter's module name (`"MVTracker.updateformer"`, `"Global"` for all),
      weighted as `flops_per_request`; None where nothing was counted.
    """

    def __init__(self, summary: dict, calls: dict, requests: int, plain_request_s: list, flops_per_request: float,
                 peaks: dict | None, program: dict | None = None, flops_by_module: dict | None = None):
        self.summary = summary
        self.calls = calls
        self.requests = requests
        self.plain_request_s = plain_request_s
        self.flops_per_request = flops_per_request
        self.peaks = peaks
        self.program = program
        self.flops_by_module = flops_by_module


def shape_key(clip: dict) -> tuple:
    return tuple((k, tuple(v.shape)) for k, v in sorted(clip.items()))


def flops_per_request(model, call, clips, answers, span_specs) -> tuple[float, dict]:
    """The window's mean operations a request, and the same by module: each
    distinct shape of the pool counted once (`count_flops`), weighted by the
    window's requests."""
    by_shape = {}
    for c in clips:
        if shape_key(c) not in by_shape:
            by_shape[shape_key(c)] = count_flops(model, call, c, span_specs)
    used = [clips[ci] for ci, _, _ in answers] or clips[:1]
    total = sum(by_shape[shape_key(c)][0] for c in used) / len(used)
    by_module = {}
    for c in used:
        for name, flops in by_shape[shape_key(c)][1].items():
            by_module[name] = by_module.get(name, 0.0) + flops / len(used)
    return total, by_module


def count_flops(model, call, clip, span_specs) -> tuple[float, dict]:
    """One request's model operations: `FlopCounterMode`'s convolutions and
    matmuls outside the kNN and correlation dispatchers, plus their counts
    from the shapes of the calls; and the counter's own operations by its
    module names, summed over operators, with nothing taken out or added
    (the kernels that run through ctypes, it never sees)."""
    from torch.utils.flop_counter import FlopCounterMode

    sp = spans.install(model, span_specs)
    sp.recording = True
    try:
        with FlopCounterMode(display=False) as counter:
            sp.flop_counter = counter
            call(clip)
    finally:
        sp.close()
    dense = counter.get_total_flops() - sp.flops_inside
    knn = sum(counts.knn_operations(c["args"][0]["shape"][0], c["args"][0]["shape"][1], c["args"][1]["shape"][1])
              for c in sp.calls.get("knn", []))
    corr = sum(counts.corr_operations(*c["args"][2]["shape"], c["args"][0]["shape"][-1])
               for c in sp.calls.get("corr", []))
    by_module = {name: float(sum(ops.values())) for name, ops in counter.get_flop_counts().items()}
    return float(dense + knn + corr), by_module


def traced(model, call, clips, traffic, span_specs, device) -> dict:
    """Profile `profiled_requests` requests with the spans in place: the
    outside spans' `summary`, the wrapped functions' `calls`, the number of
    `requests`, the `program`'s span table over the requests, the `records`
    (`trace.records`) and the optional spans the program lacks
    (`spans_missing`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = traffic["profiled_requests"]
    sp = spans.install(model, span_specs)
    sp.recording = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                with record_function(spans.PREFIX + "request"):
                    call(clips[i % len(clips)])
            _sync(device)
    finally:
        sp.close()
    recs = trace.records(prof)
    req = sorted((r[2], r[3]) for r in recs if r[0] == "host" and r[1] == spans.PREFIX + "request")
    rng = (req[0][0], max(e for _, e in req)) if req else None
    summary = trace.summarize(recs, list(span_specs), rng)
    return {"summary": summary, "calls": sp.calls, "requests": n, "program": program_trace.summarize(recs, req),
            "records": recs, "spans_missing": sp.missing}


def run(root: Path, config: dict, traffic: dict, limits: dict, per_layer: list, seed: int, seconds: float,
        trace_on: bool, device, t_start: float, breaker=None, controls=(), keep: dict | None = None) -> dict:
    """The result line's object. `breaker` (`lib/faults.py`), for the
    tests and the control runs, wraps the request's call to plant a fault in
    the timed path. `controls` names lower-precision round trips of
    `reference/lowp.py`: the reference computed in each, in the program's
    place, is compared like the program and reported under "control" (the
    control runs, not the cells' runs). A traced run puts what `traced`
    returns into `keep` where one is given (`program_spans.py`)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    model = program.build_model(config, dev)
    shapes = program.state_shapes(model)
    gain = config["assumed"]["flow_head_gain"]
    state = weights.seeded_state(shapes, seed, dev, gain)
    model.load_state_dict(state)
    del state
    clips = make_clips(traffic, seed, dev)
    call = program.build_call(model, traffic)
    if breaker is not None:
        call = breaker(call, model, traffic)
    for i in range(traffic["warmup_requests"]):
        call(clips[i % len(clips)])
    _sync(dev)
    bad = hygiene.forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded during set-up: {bad}")
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    lat, answers, failed, window_s = window(call, clips, seconds, dev)
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    bad = hygiene.forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded by the window's close: {bad}")

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(max(peak_setup, peak_window))}
    result = {"correct": False, "attempted": len(lat), "failed": failed, "metrics": {}, "device": device_info}
    if trace_on:
        span_specs = spans.load_specs(root)
        flops, flops_by_module = flops_per_request(model, call, clips, answers, span_specs)
        tr = traced(model, call, clips, traffic, span_specs, dev)
        if keep is not None:
            keep.update(tr)
        summary, prog = tr["summary"], tr["program"]
        if cuda:
            device_info["memory_peak_bytes"] = int(max(peak_setup, peak_window, torch.cuda.max_memory_allocated()))
        ctx = TraceContext(summary, tr["calls"], tr["requests"], lat, flops, counts.peaks(device_info["kind"]), prog,
                           flops_by_module)
        for name, unit in per_layer:
            value = load_reader(root, name)(ctx)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": unit}
        device_info["busy_s"] = summary.get("busy_s", 0.0)
        device_info["window_s"] = summary.get("window_s", 0.0)
        if summary.get("breakdown"):
            result["breakdown"] = summary["breakdown"]
        if tr["spans_missing"]:
            result["spans_missing"] = tr["spans_missing"]
        print(f"trace: {summary.get('device_ops')} device ops, {summary.get('linked_share')} linked to their launch, "
              f"span device s {summary.get('span_device_s')}, "
              f"flops a request {flops}, program spans {sorted(prog['spans'])}, flops a request by module "
              f"{ {k: v for k, v in flops_by_module.items() if k.count('.') <= 1} }", file=sys.stderr)
    else:
        result["metrics"] = e2e_metrics(clips, lat, answers, window_s, peak_window, setup_s)
    print(f"window: {len(lat)} requests in {window_s:.3f} s, latency median "
          f"{statistics.median(lat) * 1e3:.3f} ms, p90 {stats.percentile(lat, 90) * 1e3:.3f} ms, "
          f"set-up {setup_s:.3f} s, peak {peak_window / GIB:.3f} GiB", file=sys.stderr)

    # The check: the program's state goes, the reference runs on the same
    # clips, queries and weights (drawn again from the seed).
    del call, model
    if cuda:
        torch.cuda.empty_cache()
    from perfbench.reference.lowp import LOWP

    ref_mod = check.load_reference(root, config)
    state = weights.seeded_state(shapes, seed, dev, gain)
    t_ref = time.perf_counter()
    reference = check.reference_answers(ref_mod, config, traffic, state, clips, dev)
    base = check.reference_answers(ref_mod, config, traffic, state, clips, dev, lowp=LOWP["bf16"])
    print(f"reference: {len(clips)} clips in fp32 and in bf16 in {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    values = check.numbers(answers, reference, base)
    print(f"check: repeated answers of one clip differ by at most {check.repeat_gap(answers)}", file=sys.stderr)
    if controls:
        result["control"] = {}
        for name in controls:
            low = check.reference_answers(ref_mod, config, traffic, state, clips, dev, lowp=LOWP[name])
            result["control"][name] = check.numbers([(i, *a) for i, a in enumerate(low)], reference, base)
    del state
    ok, checked = check.judge(values, limits, failed)
    print("check, printed and not judged: " + ", ".join(f"{k} {v}" for k, v in values.items() if k not in checked),
          file=sys.stderr)
    result["correct"] = bool(ok and all(math.isfinite(v) for v in values.values()))
    result["checked"] = checked
    bad = hygiene.forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded after the window: {bad}")
    return result
