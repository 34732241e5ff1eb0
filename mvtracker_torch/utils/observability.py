"""Rank-aware logging, hang watchdog, profiler window and device memory
(L7 aux), counterpart of `mvtracker_tpu/utils/observability.py`.

- `RankedLogger` (reference `mvtracker/cli/utils/pylogger.py:7-51`):
  prefixes every record with the process rank and can restrict emission to
  rank 0. The rank is `torch.distributed`'s when a process group is up, else
  0.
- `install_hang_watchdog` (reference `cli/utils/helpers.py:45-47`):
  faulthandler dumps all thread stacks if the process makes no progress for
  `timeout_s`. faulthandler's timer is one per process: whoever arms it
  cancels it (`cancel_hang_watchdog`) in a `finally`.
- `ProfilerTraceWindow`: a `torch.profiler` trace (CPU and CUDA activities)
  over a window of train steps, written as a chrome trace.
- `device_memory_stats`: per-GPU memory in use and its peak, from
  `torch.cuda.memory_stats`, under the JAX package's keys.
- `span`: a `mvtracker::<name>` range in whichever `torch.profiler` is
  recording (the benchmark's traced run, `ProfilerTraceWindow`, an
  operator's own), and a shared no-op after one check while none is. The
  ranges sit on the profiler's clock, the one the device operations are
  stamped with, so an idle gap on the card can be matched to the span the
  host was in.
"""

from __future__ import annotations

import contextlib
import faulthandler
import logging
import os
import sys
from typing import Optional

import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import record_function

SPAN_PREFIX = "mvtracker::"
_NO_SPAN = contextlib.nullcontext()


def _process_rank() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def span(name: str):
    """`record_function("mvtracker::" + name)` while a profiler records, else
    a shared no-op context: one check when nothing records. The check reads
    the flag every `torch.profiler` sets for the whole process, so a span in
    another thread is recorded by a profiler that records all threads. The
    spans of one request are the ranges inside its root range (`predict`,
    or `forward` called directly) on the thread that made it."""
    if not autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return record_function(SPAN_PREFIX + name)


class RankedLogger(logging.LoggerAdapter):
    """Logger adapter that prefixes records with the process rank.

    With `rank_zero_only=True`, records from other ranks are dropped.
    """

    def __init__(self, name: str = __name__, rank_zero_only: bool = False, extra: Optional[dict] = None):
        super().__init__(logging.getLogger(name), extra or {})
        self.rank_zero_only = rank_zero_only

    def log(self, level: int, msg, *args, rank: Optional[int] = None, **kwargs):
        """Log, optionally only on a given rank (`rank=`), with the prefix.
        `rank_zero_only` wins if set."""
        if not self.isEnabledFor(level):
            return
        current = _process_rank()
        if self.rank_zero_only and current != 0:
            return
        if rank is not None and current != rank:
            return
        msg, kwargs = self.process(f"[rank {current}] {msg}", kwargs)
        self.logger.log(level, msg, *args, **kwargs)


def _dump_stream():
    """Where the dump goes: stderr, or the process's own stderr where
    `sys.stderr` has no file descriptor (a stream captured in memory, as
    under pytest's capsys), which faulthandler cannot write to."""
    try:
        sys.stderr.fileno()
        return sys.stderr
    except (AttributeError, OSError, ValueError):
        return sys.__stderr__


def install_hang_watchdog(timeout_s: float = 600.0, repeat: bool = True, exit: bool = False) -> None:
    """Dump all thread stacks if no progress for `timeout_s` seconds.

    Call `reset_hang_watchdog()` on progress (once per train step) to push
    the deadline forward, and `cancel_hang_watchdog()` when done. With
    `exit=True` the process ends after the dump (`os._exit`), for runs that
    a supervisor restarts from the newest checkpoint.
    """
    faulthandler.dump_traceback_later(timeout_s, repeat=repeat, file=_dump_stream(), exit=exit)


def reset_hang_watchdog(timeout_s: float = 600.0, repeat: bool = True, exit: bool = False) -> None:
    """Re-arm the watchdog (progress heartbeat)."""
    faulthandler.dump_traceback_later(timeout_s, repeat=repeat, file=_dump_stream(), exit=exit)


def cancel_hang_watchdog() -> None:
    faulthandler.cancel_dump_traceback_later()


class ProfilerTraceWindow:
    """Record a `torch.profiler` trace over a window of steps.

    Call `step(i)` once per train step: recording starts when `start <= i <
    start + n_steps` first holds and stops at `i >= start + n_steps` (or on
    `close()`), and the trace is written to
    `<log_dir>/trace_steps<first>-<last>.json` (chrome trace format). CUDA
    activity is recorded when a GPU is present.
    """

    def __init__(self, log_dir: str, start: int, n_steps: int = 3):
        self.log_dir = log_dir
        self.start = start
        self.stop_at = start + n_steps
        self.path: Optional[str] = None
        self._prof = None
        self._first = None

    def step(self, i: int) -> None:
        # >= so a resume past the nominal start still records a window.
        if self._prof is None and self.start <= i < self.stop_at:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            self._first = i
            logging.info("profiler trace started at step %d -> %s", i, self.log_dir)
        elif self._prof is not None and i >= self.stop_at:
            self._finish(i - 1)

    def _finish(self, last: int) -> None:
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_steps{self._first}-{last}.json")
        prof.export_chrome_trace(self.path)
        logging.info("profiler trace written to %s", self.path)

    def close(self, last: Optional[int] = None) -> None:
        """Stop a window still recording and write its trace."""
        if self._prof is not None:
            self._finish(self.stop_at - 1 if last is None else last)


def device_memory_stats() -> dict:
    """{device index: {"bytes_in_use_mb", "peak_bytes_in_use_mb"}} of every
    GPU this process has used (the caching allocator's current and peak
    allocated bytes, in MiB); {} without CUDA."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        if s:
            stats[str(i)] = {
                "bytes_in_use_mb": s.get("allocated_bytes.all.current", 0) / 2**20,
                "peak_bytes_in_use_mb": s.get("allocated_bytes.all.peak", 0) / 2**20,
            }
    return stats
