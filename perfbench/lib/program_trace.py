"""Reading the program's own spans in a trace of a few requests.

The port opens a `record_function` range `mvtracker::<name>` at each layer
boundary of a request while a profiler records
(`mvtracker_torch/utils/observability.py::span`). `summarize` works on the
records of `trace.records` alone, so that the CPU tests can feed it made-up
events, and computes for each span name, over the profiled requests:

- `calls`; `host_s`, the union of its host ranges; `launches`, the kernels
  (copies and memsets left out) launched inside it;
- `device_s`: the union of the device operations launched inside it (the
  runtime call with the operation's correlation id starts inside one of its
  ranges), as `trace.summarize` links them;
- `self_device_s`: of those, the ones launched inside none of its child
  spans (the span is the innermost program span at the launch);
- `idle_s`: the request's device gaps whose midpoint falls, on the main
  host thread, inside this span as the innermost program span;
- `blocking`, `blocking_s`: the runtime calls that stop the host until the
  card has caught up (`is_blocking`) for which it is the innermost program
  span, and their host time.

Besides: `upload_s`, the sum over the `upload` ranges of the time from the
range's start to the later of its end and the end of the last device
operation launched inside it; `host_wait_s` and `waits`, the host time and
number of blocking calls inside a root span (`predict`, `forward`) and
outside `upload`; `idle_s`, the device idle time inside the requests, and
`idle_in_spans_s`, its part put down to a program span; `blocking_calls`,
each blocking call as (innermost span, call, start, host s). A request range is the
(start, end) of one profiled request on the trace's clock.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

from perfbench.lib.stats import busy_union, gaps
from perfbench.lib.trace import is_kernel

PREFIX = "mvtracker::"
ROOTS = ("predict", "forward")
OUTSIDE = "outside any program span"
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                        "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"})


def is_blocking(name: str) -> bool:
    """A CUDA API call (`cuda*` or its `cu*` twin) that returns only once
    the card has done the work before it: a synchronize, or a copy without
    `Async`."""
    return name in SYNC_CALLS or (name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name)


class Nest:
    """The program's ranges on one host thread, which nest; `at(t)` is the
    index of the innermost range that holds t, or -1."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))  # (name, start, end)
        self.starts = [r[1] for r in self.ranges]
        # The enclosing range of each, by a stack swept in order of start.
        self.parent, stack = [], []
        for i, (_, s, e) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][2] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ranges[i][2] < t:
            i = self.parent[i]
        return i

    def name_at(self, t: float) -> str:
        i = self.at(t)
        return self.ranges[i][0] if i >= 0 else OUTSIDE

    def inside(self, t: float, names) -> bool:
        """Whether some range of `names` holds t."""
        i = self.at(t)
        while i >= 0:
            if self.ranges[i][0] in names:
                return True
            i = self.parent[i]
        return False


def main_thread(host) -> object:
    """The host thread that opened the most program spans."""
    threads = Counter(r[5] for r in host if r[1].startswith(PREFIX))
    return threads.most_common(1)[0][0] if threads else None


def summarize(recs, request_ranges) -> dict:
    """The per-span table and the request-level numbers above, summed over
    the requests of `request_ranges` (divide by their number for a request's)."""
    host = [r for r in recs if r[0] == "host"]
    thread = main_thread(host)
    bounds = sorted(request_ranges)
    firsts = [s for s, _ in bounds]

    def in_requests(t):
        i = bisect.bisect_right(firsts, t) - 1
        return i >= 0 and t <= bounds[i][1]

    spans = [(r[1][len(PREFIX):], r[2], r[3]) for r in host
             if r[5] == thread and r[1].startswith(PREFIX) and in_requests(r[2])]
    nest = Nest(spans)
    runtime = {r[4]: r for r in recs if r[0] == "runtime"}
    device = [r for r in recs if r[0] == "device" and any(r[3] > lo and r[2] < hi for lo, hi in bounds)]

    table = defaultdict(lambda: {"calls": 0, "host_s": 0.0, "launches": 0, "device_s": 0.0, "self_device_s": 0.0,
                                 "idle_s": 0.0, "blocking": 0, "blocking_s": 0.0})
    host_ranges = defaultdict(list)
    for name, s, e in spans:
        table[name]["calls"] += 1
        host_ranges[name].append((s, e))
    for name, ranges in host_ranges.items():
        table[name]["host_s"] = busy_union(ranges) * 1e-6

    # Each linked device operation, by the program ranges open at its launch.
    under = defaultdict(list)
    mine = defaultdict(list)
    upload_end = {}
    for r in device:
        launch = runtime.get(r[4])
        if launch is None:
            continue
        i = nest.at(launch[2])
        if i < 0:
            continue
        mine[nest.ranges[i][0]].append((r[2], r[3]))
        while i >= 0:
            name = nest.ranges[i][0]
            under[name].append((r[2], r[3]))  # a union: a name twice on the path counts once
            table[name]["launches"] += is_kernel(r[1])
            if name == "upload":
                upload_end[i] = max(upload_end.get(i, r[3]), r[3])
            i = nest.parent[i]
    for name in table:
        table[name]["device_s"] = busy_union(under[name]) * 1e-6
        table[name]["self_device_s"] = busy_union(mine[name]) * 1e-6

    idle = idle_in_spans = 0.0
    for lo, hi in bounds:
        intervals = [(max(r[2], lo), min(r[3], hi)) for r in device if r[3] > lo and r[2] < hi]
        for s, e in gaps(intervals, lo, hi):
            idle += e - s
            name = nest.name_at((s + e) / 2)
            if name != OUTSIDE:
                table[name]["idle_s"] += (e - s) * 1e-6
                idle_in_spans += e - s

    blocking_calls = []
    host_wait = 0.0
    waits = 0
    for r in sorted((r for r in recs if r[0] == "runtime" and is_blocking(r[1]) and in_requests(r[2])),
                    key=lambda r: r[2]):
        name = nest.name_at(r[2])
        dt = (r[3] - r[2]) * 1e-6
        blocking_calls.append((name, r[1], r[2], dt))
        if name != OUTSIDE:
            table[name]["blocking"] += 1
            table[name]["blocking_s"] += dt
        if nest.inside(r[2], ROOTS) and not nest.inside(r[2], ("upload",)):
            host_wait += dt
            waits += 1

    upload = 0.0
    for i, (name, s, e) in enumerate(nest.ranges):
        if name == "upload":
            upload += max(e, upload_end.get(i, e)) - s
    return {
        "requests": len(bounds),
        "spans": {k: dict(v) for k, v in table.items()},
        "upload_s": upload * 1e-6,
        "host_wait_s": host_wait,
        "waits": waits,
        "idle_s": idle * 1e-6,
        "idle_in_spans_s": idle_in_spans * 1e-6,
        "blocking_calls": blocking_calls,
    }


def metrics(summary: dict) -> dict:
    """A request's numbers of the four program-span metrics, each None where
    the trace holds none of the spans it reads (a program without them):
    `upload_ms.serve`, `host_wait_ms.serve`, `syncs_per_request.serve`,
    `transformer_idle_ms.serve`."""
    n = summary["requests"]
    spans = summary["spans"]
    has_root = any(name in spans for name in ROOTS)
    return {
        "upload_ms.serve": 1e3 * summary["upload_s"] / n if "upload" in spans and n else None,
        "host_wait_ms.serve": 1e3 * summary["host_wait_s"] / n if has_root and n else None,
        "syncs_per_request.serve": summary["waits"] / n if has_root and n else None,
        "transformer_idle_ms.serve": 1e3 * spans["transformer"]["idle_s"] / n if "transformer" in spans and n
        else None,
    }
