"""Run a function on several processes of this host joined in one
`torch.distributed` world: the tests' gloo worlds on the CPU, and several
ranks sharing one card.

`run_local(fn, world, rendezvous_dir, *args)` starts `world` processes with
the spawn start method. Each joins a gloo world through a file rendezvous in
`rendezvous_dir` (no TCP port to clash with another run), sets `threads`
intra-op threads when given, and returns `fn(rank, world, *args)` to the
caller, which gets the results by rank. `fn` and its arguments and results
are pickled: `fn` is a module-level function. A process that raises, dies or
gives no result within `timeout` seconds fails the call with its traceback,
and every process has ended when the call returns.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
import uuid


def _child(fn, rank, world, init, results, args, threads):
    import torch
    import torch.distributed as dist

    try:
        if threads is not None:
            torch.set_num_threads(threads)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        try:
            results.put((rank, None, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc(), None))


def run_local(fn, world: int, rendezvous_dir, *args, timeout: float = 120.0, threads: int | None = None) -> list:
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + os.path.join(os.path.abspath(str(rendezvous_dir)), "rendezvous_" + uuid.uuid4().hex)
    procs = [ctx.Process(target=_child, args=(fn, r, world, init, results, args, threads), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world:
            try:
                rank, err, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                exited = [r for r, p in enumerate(procs) if not p.is_alive() and r not in out]
                raise TimeoutError(f"{world - len(out)} of {world} processes gave no result within {timeout} s "
                                   f"(ranks {exited} have exited)") from None
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                out[rank] = value
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(world)]
