"""Reading a `torch.profiler` trace of a few requests.

`records(prof)` turns the profiler's events into plain tuples; `summarize`
works on those alone, so that the CPU tests can feed it made-up events.

A record is (kind, name, start_us, end_us, corr, thread):
- "device": an operation on the card (a kernel, a copy, a memset);
- "runtime": a CUDA API call on the host (`cudaLaunchKernel`, `cuLaunchKernel`), which
  shares its correlation id with the device operation it started;
- "host": any other host event: an aten operator or a span of ours.

A device operation belongs to a span when the runtime call that launched it
(the same correlation id) lies inside one of the span's host ranges.
`linked_share` reports the share of device operations whose launch the
trace holds; an operation without one belongs to no span.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from perfbench.lib.spans import PREFIX
from perfbench.lib.stats import busy_union, gaps

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def records(prof) -> list[tuple]:
    out = []
    for e in prof.events():
        dev = e.device_type.name
        start, end = float(e.time_range.start), float(e.time_range.end)
        if dev == "CUDA":
            kind = "annotation" if (getattr(e, "is_user_annotation", False) or e.name.startswith(PREFIX)) \
                else "device"
        elif dev == "CPU":
            kind = "runtime" if e.name.startswith(("cuda", "cu")) and not e.name.startswith("cudnn") else "host"
        else:
            continue
        out.append((kind, e.name, start, end, int(e.id), e.thread))
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(COPY_PREFIXES)


class Intervals:
    """Sorted, possibly nested host ranges; `covers(t)` tests membership."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)
        self.starts = [s for s, _ in self.ranges]
        # The largest end among the ranges up to each index.
        self.reach, best = [], float("-inf")
        for _, e in self.ranges:
            best = max(best, e)
            self.reach.append(best)

    def covers(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.reach[i] >= t


def host_at(host, times) -> list[str]:
    """For each of the sorted `times`, the name of the innermost host event
    of the busiest host thread that spans it. Events of one thread nest, so
    a stack of open events sweeps them in order of start."""
    threads = defaultdict(int)
    for r in host:
        threads[r[5]] += 1
    main = max(threads, key=threads.get) if threads else None
    events = sorted((r for r in host if r[5] == main), key=lambda r: (r[2], -r[3]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][2] <= t:
            while stack and stack[-1][3] < events[i][2]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][3] < t:
            stack.pop()
        out.append(stack[-1][1] if stack else "host outside any recorded op")
    return out


def summarize(recs, span_names, request_range=None, top=10) -> dict:
    """What the metric readers read: device busy time, launches, the device
    time under each span, and the breakdown of device time and idle gaps.

    `request_range` = (start_us, end_us) of the profiled requests on the
    trace's clock (default: the first to the last device operation)."""
    device = [r for r in recs if r[0] == "device"]
    runtime = {r[4]: r for r in recs if r[0] == "runtime"}
    host = [r for r in recs if r[0] == "host"]
    if not device:
        return {"device_ops": 0}
    lo, hi = request_range or (min(r[2] for r in device), max(r[3] for r in device))
    inside = [r for r in device if r[3] > lo and r[2] < hi]
    intervals = [(max(r[2], lo), min(r[3], hi)) for r in inside]
    busy_us = busy_union(intervals)

    linked = [r for r in inside if r[4] in runtime]
    span_device = {}
    for name in span_names:
        ranges = Intervals([(r[2], r[3]) for r in host if r[1] == PREFIX + name])
        mine = [r for r in linked if ranges.covers(runtime[r[4]][2])]
        span_device[name] = busy_union([(r[2], r[3]) for r in mine]) * 1e-6

    by_name = defaultdict(float)
    for r in inside:
        by_name[r[1][:160]] += (r[3] - r[2]) * 1e-6
    idle = defaultdict(float)
    holes = gaps(intervals, lo, hi)
    for (s, e), label in zip(holes, host_at(host, [(s + e) / 2 for s, e in holes])):
        idle[label[:160]] += (e - s) * 1e-6
    return {
        "device_ops": len(inside),
        "kernels": sum(1 for r in inside if is_kernel(r[1])),
        "busy_s": busy_us * 1e-6,
        "window_s": (hi - lo) * 1e-6,
        "span_device_s": span_device,
        "linked_share": len(linked) / len(inside),
        "breakdown": {
            "device_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        },
    }
