#!/usr/bin/env python3
"""Where the port's three kNN kernels stand on the card, and how the tiled
kernel's time moves with the number of spans.

    python3 scripts/profile_torch_knn.py

1. Compiles `mvtracker_torch/csrc/knn*.cu` with `nvcc -Xptxas -v` and prints,
   for every kernel, the registers per thread and the spill bytes. The
   three kernels share one scan (`knn_common.cuh`); a change that pushes it
   into spills can cost half its speed and shows nowhere else.
2. Times, with CUDA events over back-to-back launches, the fused and the
   exact kernel and the tiled kernel at 1, 2, 3, 6 and 12 spans (where the
   cloud has that many tiles) on the tracker's shapes: the flagship level 0,
   the large cloud's level 0 and query-feature lookup, and one frame of the
   large cloud with a tracker's worth of queries.

Needs CUDA and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = [  # label, B, N, M, k
    ("flagship level 0", 12, 16384, 256, 16),
    ("large level 0", 12, 281600, 256, 16),
    ("large query features", 18, 281600, 256, 1),
    ("one large frame, 256 queries", 1, 281600, 256, 16),
]
SPLITS = (1, 2, 3, 6, 12)


def resources(_cuda) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("knn", "knn_tiled", "knn_exact"):
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(tmp, f"{name}.so"),
                   str(_cuda.CSRC / f"{name}.cu")]
            out = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
            for block in re.split(r"Compiling entry function", out)[1:]:
                entry = re.search(r"\d(knn_[a-z_]*[a-z])(?:ILb(\d)E)?E", block)
                regs = re.search(r"Used (\d+) registers", block)
                spill = re.search(r"(\d+) bytes spill stores", block)
                if entry and regs:
                    one = {"1": " (k = 1)", "0": " (k > 1)", None: ""}[entry.group(2)]
                    print(f"{name}.cu {entry.group(1)}{one}: {regs.group(1)} registers, "
                          f"{spill.group(1) if spill else '?'} bytes spilled")


def event_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_knn: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mvtracker_torch.ops import _cuda
    from mvtracker_torch.ops import knn as knn_ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    resources(_cuda)
    lib = _cuda.load("knn_tiled")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, n, m, k in SHAPES:
        ref = (torch.rand(b, n, 3, generator=gen, device="cuda") * 4 - 2).contiguous()
        query = (torch.randn(b, m, 3, generator=gen, device="cuda") * 0.5).contiguous()
        want = knn_ops.knn_cuda(ref, query, k)[0]
        resident = knn_ops.tiled_resident_blocks(0, k == 1)
        chosen = knn_ops.tiled_plan(b, n, m, resident)[0]
        row = [f"fused {event_ms(torch, lambda: knn_ops.knn_cuda(ref, query, k)):.5f}",
               f"exact {event_ms(torch, lambda: knn_ops.knn_exact_cuda(ref, query, k)):.5f}"]
        tiles = -(-n // knn_ops.TILE)
        for want_splits in SPLITS:
            if want_splits > tiles:
                continue
            span = -(-tiles // want_splits) * knn_ops.TILE
            splits = -(-n // span)
            dist = torch.empty(b, m, k, device="cuda")
            idx = torch.empty(b, m, k, dtype=torch.int64, device="cuda")
            ws_d = torch.empty(b, m, splits, k, device="cuda")
            ws_i = torch.empty(b, m, splits, k, dtype=torch.int32, device="cuda")

            def call():
                return lib.knn_tiled_forward(ref.data_ptr(), query.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                                             ws_d.data_ptr(), ws_i.data_ptr(), b, n, m, k, splits, span, stream)

            ms = event_ms(torch, call)
            if not torch.equal(dist, want):
                raise AssertionError(f"{label}: tiled with {splits} spans disagrees with the fused kernel")
            row.append(f"tiled x{splits} {ms:.5f}")
        print(f"{label}: B={b} N={n} M={m} k={k}, {-(-m // 8) * b} query blocks, {resident} resident blocks, "
              f"the wrapper takes {chosen} span(s); ms: " + ", ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
