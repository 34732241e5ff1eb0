#!/usr/bin/env python3
"""Where the port's two correlation kernels stand on the card.

    python3 scripts/profile_torch_corr.py [--parent DIR] [--buckets DIR]

1. Compiles `mvtracker_torch/csrc/corr.cu` (K2, the forward) and
   `csrc/corr_bwd.cu` (K3, the backward) with `nvcc -Xptxas -v` and prints,
   for every kernel instance, its registers, shared memory and spill bytes.
2. Times them at the tracker's four levels (B=12 windows, N=256 tracks, K=16,
   C=128, a bf16 cloud of 16384, 4096, 1024 and 256 points, fp32 track
   features), as device time of launches replayed from a CUDA graph:
   - K2 as the path calls it (fp32 targets rounded in the kernel), and on
     targets cast to bf16 first, with that cast;
   - K3 with the wrapper's tile plan, with one copy of the tile where the
     plan keeps several, at other tile sizes, and with no index in the cloud
     (what the tiles' zeroing, index scan and dense write cost without a
     contribution);
   - the path's calls under `torch.profiler`, device time per kernel;
   - with `--buckets DIR`, the other way of finding a tile's contributions,
     a first pass that buckets them by tile, built from `DIR/corr_bwd.cu`:
     a version of this K3 whose C entry takes two more arguments, an int
     scratch of 3 * B * tiles + B * N * K after `d_fvec` and a flag after
     the dtype code that selects the bucket pass;
   - with `--parent DIR`, the designs they replaced, built from
     `DIR/corr.cu` and `DIR/corr_bwd.cu` and called as their wrappers called
     them (K2 after a separate cast of the targets; K3 into a zeroed fp32
     buffer, then cast), with their sums per forward and per train step.
   A level's launches per forward and per train step: 12.

Needs CUDA and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.timing_torch import device_ms  # noqa: E402

B, N, K, C = 12, 256, 16, 128
LEVELS = (16384, 4096, 1024, 256)
PER_PASS = 12  # launches of one level per forward, and per train step's backward
SWEEP_ROWS = {16384: (32, 64, 128, 256, 384), 4096: (16, 32, 64, 128, 256), 1024: (4, 8, 16, 32, 94),
              256: (2, 4, 8, 16, 24)}


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not os.path.exists(tool):
        return names
    out = subprocess.run([tool, *names], capture_output=True, text=True).stdout.split("\n")
    return [o or n for o, n in zip(out, names)]


def resources(_cuda) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("corr", "corr_bwd"):
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(tmp, f"{name}.so"),
                   str(_cuda.CSRC / f"{name}.cu")]
            out = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
            blocks = re.split(r"Compiling entry function '([^']+)'", out)[1:]
            entries = demangle(blocks[0::2])
            for entry, block in zip(entries, blocks[1::2]):
                regs = re.search(r"Used (\d+) registers", block)
                spill = re.search(r"(\d+) bytes spill stores", block)
                stack = re.search(r"(\d+) bytes stack frame", block)
                smem = re.search(r"(\d+) bytes smem", block)
                print(f"{name}.cu {entry}: {regs.group(1) if regs else '?'} registers, "
                      f"{smem.group(1) if smem else '0'} bytes static smem, {stack.group(1) if stack else '?'} bytes stack, "
                      f"{spill.group(1) if spill else '?'} bytes spilled")


P, I = ctypes.c_void_p, ctypes.c_int
PARENT_ENTRIES = (("corr", "corr_forward", [P] * 4 + [I] * 6 + [P]),
                  ("corr_bwd", "corr_backward", [P] * 6 + [I] * 6 + [P]))
BUCKETS_ENTRIES = (("corr_bwd", "corr_backward", [P] * 7 + [I] * 10 + [P]),)


def build_from(_cuda, src: str, entries, tmp: str, tag: str):
    """C entries of other versions of the sources, built from `src`, with
    their signatures."""
    libs = {}
    for name, entry, args in entries:
        so = os.path.join(tmp, f"lib{name}_{tag}.so")
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so, os.path.join(src, f"{name}.cu")],
                       check=True, capture_output=True)
        fn = getattr(ctypes.CDLL(so), entry)
        fn.restype, fn.argtypes = ctypes.c_int, args
        libs[name] = fn
    return libs


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="directory with the previous corr.cu and corr_bwd.cu to time beside")
    parser.add_argument("--buckets", help="directory with a corr_bwd.cu that can bucket the contributions first")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_corr: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mvtracker_torch.ops import _cuda
    from mvtracker_torch.ops import corr as corr_ops
    from mvtracker_torch.ops import knn as knn_ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    resources(_cuda)
    tmp = tempfile.mkdtemp()
    parent = build_from(_cuda, args.parent, PARENT_ENTRIES, tmp, "parent") if args.parent else None
    bucketing = build_from(_cuda, args.buckets, BUCKETS_ENTRIES, tmp, "buckets")["corr_bwd"] if args.buckets else None
    lib = _cuda.load("corr_bwd")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    sums, sums_level = {}, {}

    def add(key, ms):
        sums[key] = sums.get(key, 0.0) + ms * PER_PASS
        sums_level[key] = ms

    for lvl, p in enumerate(LEVELS):
        xyz = (torch.rand(B, p, 3, generator=gen, device=dev) * 4 - 2).contiguous()
        q = (torch.randn(B, N, 3, generator=gen, device=dev) * 0.5).contiguous()
        idx = knn_ops.knn_plain(xyz, q, K)[1]
        fvec = torch.randn(B, p, C, generator=gen, device=dev).bfloat16()
        targets = torch.randn(B, N, C, generator=gen, device=dev)
        g = torch.randn(B, N, K, generator=gen, device=dev)
        row = []

        # K2
        k2 = device_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
        k2_cast = device_ms(lambda: corr_ops.corr_select_cuda(fvec, targets.bfloat16(), idx), reps=100)
        add("K2", k2)
        add("K2 on targets cast first, with the cast", k2_cast)
        row += [f"K2 {k2:.5f}", f"K2 on cast targets + cast {k2_cast:.5f}"]
        if parent:
            out = torch.empty(B, N, K, device=dev)

            def old_k2():
                t16 = targets.bfloat16()
                parent["corr"](fvec.data_ptr(), t16.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, p, K, C, 1,
                               torch.cuda.current_stream().cuda_stream)

            old_k2()
            torch.cuda.synchronize()
            if not torch.allclose(out, corr_ops.corr_select_cuda(fvec, targets, idx), atol=1e-3, rtol=0):
                raise AssertionError(f"level {lvl}: the parent K2 disagrees")
            ms = device_ms(old_k2, reps=100)
            add("K2 parent, with the cast", ms)
            row.append(f"K2 parent + cast {ms:.5f}")

        # K3
        rows, tiles, copies = corr_ops.corr_backward_plan(B, p, C, sms)

        def k3(rows, tiles, copies=None, buckets=False):
            copies = copies or corr_ops.corr_backward_copies(rows, C)
            d_fvec = torch.empty_like(fvec)
            d_targets = torch.empty_like(targets)
            stream = torch.cuda.current_stream().cuda_stream
            head = (fvec.data_ptr(), targets.data_ptr(), idx.data_ptr(), g.data_ptr(), d_targets.data_ptr(),
                    d_fvec.data_ptr())
            if buckets:
                scratch = torch.empty(3 * B * tiles + B * N * K, dtype=torch.int32, device=dev)
                status = bucketing(*head, scratch.data_ptr(), B, N, p, K, C, rows, tiles, copies, 1, 1, stream)
            else:
                status = lib.corr_backward(*head, B, N, p, K, C, rows, tiles, copies, 1, stream)
            _cuda.check(lib, status, "corr_backward")
            return d_fvec, d_targets

        want_fvec, want_targets = corr_ops.corr_select_backward_plain(fvec, targets, idx, g)
        variants = [(False, "K3 scan")] + ([(True, "K3 buckets")] if bucketing else [])
        for buckets, name in variants:
            d_fvec, d_targets = k3(rows, tiles, buckets=buckets)
            torch.cuda.synchronize()
            gap = (d_fvec.float() - want_fvec.float()).abs()
            if not bool((gap <= 2.0**-7 * want_fvec.float().abs() + 1e-4).all()) or \
                    float((d_targets - want_targets).abs().max()) > 1e-4:
                raise AssertionError(f"level {lvl}: {name} disagrees with the plain version")
        for buckets, name in variants:
            ms = device_ms(lambda: k3(rows, tiles, buckets=buckets), reps=50)
            add(name, ms)
            row.append(f"{name} {ms:.5f}")
        if copies > 1:
            ms = device_ms(lambda: k3(rows, tiles, 1), reps=50)
            row.append(f"K3 scan with one copy {ms:.5f}")
        add("K3 scan with one copy", ms if copies > 1 else sums_level["K3 scan"])
        if parent:
            def old_k3():
                acc = torch.zeros((B, p, C), dtype=torch.float32, device=dev)
                d_t = torch.empty_like(targets)
                parent["corr_bwd"](fvec.data_ptr(), targets.data_ptr(), idx.data_ptr(), g.data_ptr(), d_t.data_ptr(),
                                   acc.data_ptr(), B, N, p, K, C, 1, torch.cuda.current_stream().cuda_stream)
                return acc.to(fvec.dtype), d_t

            old_fvec, _ = old_k3()
            torch.cuda.synchronize()
            if float((old_fvec.float() - want_fvec.float()).abs().max()) > 0.5:
                raise AssertionError(f"level {lvl}: the parent K3 disagrees")
            ms = device_ms(old_k3, reps=50)
            add("K3 parent, with zero-fill and cast", ms)
            row.append(f"K3 parent + zero-fill + cast {ms:.5f}")
        distinct = sum(int(torch.unique(idx[b]).numel()) for b in range(B))
        print(f"level {lvl}: fvec [{B},{p},{C}] bf16, targets fp32, idx [{B},{N},{K}] ({distinct} distinct rows); "
              f"K3 plan {tiles} tiles of {rows} rows per b ({B * tiles} blocks), {copies} copies; ms: " + ", ".join(row),
              flush=True)
        sweep = []
        for r in SWEEP_ROWS[p]:
            t = -(-p // r)
            sweep.append(f"{r} rows ({B * t} blocks): scan {device_ms(lambda: k3(r, t), reps=50):.5f}"
                         + (f", buckets {device_ms(lambda: k3(r, t, buckets=True), reps=50):.5f}" if bucketing else ""))
        print(f"level {lvl} K3 by tile size, ms: " + "; ".join(sweep), flush=True)
        full_idx = idx
        idx = torch.full_like(full_idx, -1)
        print(f"level {lvl} K3 with no index in the cloud, ms: scan {device_ms(lambda: k3(rows, tiles), reps=50):.5f}",
              flush=True)
        idx = full_idx
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                corr_ops.corr_select_cuda(fvec, targets, idx)
                corr_ops.corr_select_backward_cuda(fvec, targets, idx, g)
                if bucketing:
                    k3(rows, tiles, buckets=True)
            torch.cuda.synchronize()
        per = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if ev.count and dev_us:
                per.append(f"{ev.key[:60]} {dev_us / ev.count / 1e3:.5f} ms x{ev.count}")
        print(f"level {lvl} under the profiler (20 calls each of K2, K3{', K3 buckets' if bucketing else ''}), "
              "device ms per kernel: "
              + "; ".join(per), flush=True)
    print("sums over the four levels, 12 launches each (K2 per forward, K3 per train step), ms: "
          + ", ".join(f"{key} {ms:.5f}" for key, ms in sums.items()))
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
