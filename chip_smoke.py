#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mvtracker_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. print the card's name and power limit, build the CUDA kernels from
   `mvtracker_torch/csrc/` with nvcc;
2. each kernel against its plain PyTorch version, on the card, at every
   shape the tracker's forward gives it (4 views x 24 frames x 256^2,
   256 queries), plus a k > N and a far-from-origin kNN case; per shape the
   kernel's device time (launches replayed from a CUDA graph), its time
   called from Python through the wrapper, the plain version's device time
   and the bound;
3. the main path: the flagship MVTracker in bf16 with seeded random weights
   answers 3 requests (scenes of seeds 0, 1, 2), with launch counters
   showing every kNN and correlation went through the kernels;
4. the fp32 forward through the kernels against the plain CPU path, same
   weights and scene;
5. a JSON line per kernel, then the result line.

Needs CUDA; exits non-zero without it. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet) for the bound.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Flagship request shape (as the JAX package's benchmark, `bench.py`).
V, T, H, W, N_QUERIES = 4, 24, 256, 256, 256
ITERS = 4
LEVEL_POINTS = (16384, 4096, 1024, 256)  # V * (H/4/2^l) * (W/4/2^l)
WINDOW = 12

# Launches per forward at that shape: 3 windows x 4 iterations.
K1_PER_FWD = 1 + 3 * ITERS * 3  # feat_init + (level 0, level 1, levels 2-3 batched)
K2_PER_FWD = 3 * ITERS * 4  # one per level

# Tolerances of the kernel-vs-plain checks.
KNN_RTOL = 1e-5  # both compute d^2 directly in fp32; only rounding differs
KNN_ATOL = 1e-6
CORR_TOL = {"float32": 1e-4, "bfloat16": 1e-3}  # fp32 sums of 128 products, other order
# fp32 forward through the kernels vs the plain CPU path (TF32 off).
E2E_TRAJ_MAX, E2E_TRAJ_MEDIAN = 2e-4, 1e-5
E2E_VIS_MAX, E2E_VIS_MEDIAN = 5e-4, 1e-5
# Gain on the flow head's random weights for phase 4, so that tracks move
# by about a hundredth of a unit and the check sees the updates. Much more
# and the random model turns chaotic: at gain 30 an rgb change of 1e-3 on
# the plain CPU path alone moves the output by 0.25.
FLOW_HEAD_GAIN = 5.0


def log(msg: str) -> None:
    print(msg, flush=True)


def wrapper_ms(fn, reps: int, warmup: int = 2) -> float:
    """ms per call of `fn` called back to back from Python, CUDA events
    around the loop: the device time or the host's work per call (wrapper,
    ctypes, device guard), whichever paces the loop."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, replays: int = 3) -> float:
    """Device ms per call of `fn`: `reps` calls captured in one CUDA graph,
    the graph replayed `replays` times between CUDA events. A replay needs no
    host work per launch, so this is the kernels' own time, back to back."""
    import torch

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


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_knn(knn_ops, ref, query, k):
    """Kernel vs plain on one input; returns the max abs distance error."""
    import torch

    d_k, i_k = knn_ops.knn_cuda(ref, query, k)
    n = ref.shape[1]
    d_p, i_p = knn_ops.knn_plain(ref, query, k + 1 if k < n else k)
    torch.cuda.synchronize()
    d_pk = d_p[..., :k]
    err = (d_k - d_pk).abs()
    tol = KNN_ATOL + KNN_RTOL * d_pk
    if not bool((err <= tol).all()):
        raise AssertionError(f"knn distances differ: max err {err.max().item():.3e}")
    real = min(k, n)
    # Every returned index really lies at the returned distance.
    rows = torch.gather(ref, 1, i_k[..., :real].reshape(ref.shape[0], -1, 1).expand(-1, -1, 3))
    true_d = (rows.reshape(*i_k[..., :real].shape, 3) - query[:, :, None]).pow(2).sum(-1).clamp_min(1e-12).sqrt()
    if not bool(((true_d - d_k[..., :real]).abs() <= KNN_ATOL + KNN_RTOL * true_d).all()):
        raise AssertionError("knn kernel index does not match its distance")
    if k > n:
        if not bool((d_k[..., n:] > 1e8).all() and (i_k[..., n:] == 0).all()):
            raise AssertionError("knn k > N fill contract broken")
        return float(err[..., :n].max())
    # Neighbour sets equal unless the k-th and (k+1)-th d^2 are within tolerance.
    same = (i_k.sort(-1).values == i_p[..., :k].sort(-1).values).all(-1)
    if k < n:
        d2 = d_p.pow(2)
        near_tie = (d2[..., k] - d2[..., k - 1]) <= 2 * (KNN_ATOL + KNN_RTOL * d2[..., k])
        same = same | near_tie
    if not bool(same.all()):
        raise AssertionError("knn neighbour sets differ beyond ties")
    return float(err.max())


def phase_kernels(torch, knn_ops, corr_ops, gen):
    """Phase 2: kernel vs plain at the path shapes; returns per-kernel rows."""
    dev = torch.device("cuda")
    stats = {"knn": {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0, "by": {}},
             "corr": {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0, "by": {}}}

    def cloud(b, n):
        return (torch.rand(b, n, 3, generator=gen, device=dev) * 4 - 2).contiguous()

    def queries(b, m):
        return (torch.randn(b, m, 3, generator=gen, device=dev) * 0.5).contiguous()

    s = WINDOW
    knn_shapes = [  # (label, B, N, M, k, launches per forward)
        ("feat_init", T, LEVEL_POINTS[0], N_QUERIES, 1, 1),
        ("level0", s, LEVEL_POINTS[0], N_QUERIES, 16, 3 * ITERS),
        ("level1", s, LEVEL_POINTS[1], N_QUERIES, 16, 3 * ITERS),
        ("levels2-3", 2 * s, LEVEL_POINTS[2], N_QUERIES, 16, 3 * ITERS),
    ]
    st = stats["knn"]
    for label, b, n, m, k, per_fwd in knn_shapes:
        ref, query = cloud(b, n), queries(b, m)
        st["err"] = max(st["err"], check_knn(knn_ops, ref, query, k))
        ms = device_ms(lambda: knn_ops.knn_cuda(ref, query, k), reps=50)
        host = wrapper_ms(lambda: knn_ops.knn_cuda(ref, query, k), reps=50)
        plain = device_ms(lambda: knn_ops.knn_plain(ref, query, k), reps=5)
        nbytes = (ref.numel() + query.numel()) * 4 + b * m * k * (4 + 8)
        bnd, by = bound(nbytes, 9.0 * b * m * n)  # 3 sub, 3 mul, 2 add, 1 compare
        log(f"K1 knn {label}: B={b} N={n} M={m} k={k} kernel_ms={ms:.5f} wrapper_ms={host:.5f} "
            f"plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}) launches/forward={per_fwd}")
        st["ms"] += ms * per_fwd
        st["plain_ms"] += plain * per_fwd
        st["bound_ms"] += bnd * per_fwd
        st["by"][by] = st["by"].get(by, 0.0) + bnd * per_fwd
    # Edge cases: fewer points than k, and a scene far from the origin.
    st["err"] = max(st["err"], check_knn(knn_ops, cloud(2, 10), queries(2, 50), 16))
    offset = torch.tensor([100.0, -50.0, 200.0], device=dev)
    far_ref = (torch.randn(1, 400, 3, generator=gen, device=dev) * 0.1 + offset).contiguous()
    far_q = (torch.randn(1, 50, 3, generator=gen, device=dev) * 0.1 + offset).contiguous()
    st["err"] = max(st["err"], check_knn(knn_ops, far_ref, far_q, 8))
    log(f"K1 knn checks passed: max abs distance error {st['err']:.3e} (rtol {KNN_RTOL}, atol {KNN_ATOL})")

    st = stats["corr"]
    c = 128
    for lvl, p in enumerate(LEVEL_POINTS):
        xyz, q = cloud(s, p), queries(s, N_QUERIES)
        _, idx = knn_ops.knn_plain(xyz, q, 16)
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            fvec = torch.randn(s, p, c, generator=gen, device=dev).to(dt)
            targets = torch.randn(s, N_QUERIES, c, generator=gen, device=dev).to(dt)
            idx_t = idx.clone()
            if lvl == 0 and dt_name == "float32":
                idx_t[:, :, -1] = -1  # padding index gives 0
            got = corr_ops.corr_select_cuda(fvec, targets, idx_t)
            want = corr_ops.corr_select_plain(fvec, targets, idx_t)
            err = float((got - want).abs().max())
            if err > CORR_TOL[dt_name]:
                raise AssertionError(f"corr level {lvl} {dt_name}: max err {err:.3e} > {CORR_TOL[dt_name]}")
            st["err"] = max(st["err"], err)
            if dt_name != "bfloat16":
                continue  # the path streams bf16; time that
            ms = device_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
            host = wrapper_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
            plain = device_ms(lambda: corr_ops.corr_select_plain(fvec, targets, idx), reps=20)
            rows = sum(int(torch.unique(idx[b]).numel()) for b in range(s))
            nbytes = rows * c * 2 + targets.numel() * 2 + idx.numel() * 8 + idx.numel() * 4
            bnd, by = bound(nbytes, 2.0 * idx.numel() * c)
            per_fwd = 3 * ITERS
            log(f"K2 corr level{lvl}: fvec=[{s},{p},{c}] bf16 idx=[{s},{N_QUERIES},16] kernel_ms={ms:.5f} "
                f"wrapper_ms={host:.5f} plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}, {rows} distinct rows) "
                f"launches/forward={per_fwd}")
            st["ms"] += ms * per_fwd
            st["plain_ms"] += plain * per_fwd
            st["bound_ms"] += bnd * per_fwd
            st["by"][by] = st["by"].get(by, 0.0) + bnd * per_fwd
    log(f"K2 corr checks passed: max abs error {st['err']:.3e} (tol {CORR_TOL})")
    return stats


def to_device(scene, dev):
    import torch

    return [torch.as_tensor(a, device=dev) for a in scene]


def phase_main_path(torch, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops):
    """Phase 3: 3 flagship-width bf16 requests; returns launch totals."""
    dev = torch.device("cuda")
    before = torch.cuda.memory_allocated()
    model = MVTracker(compute_dtype="bfloat16", device=dev).eval()
    model.load_state_dict(random_state_dict(model, seed=0))
    scenes = [to_device(make_scene(np.random.default_rng(seed), V, T, H, W, N_QUERIES), dev) for seed in range(3)]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    log(f"allocated before the model {before / 2**20:.1f} MiB; with weights and 3 scenes {resident / 2**20:.1f} MiB")
    torch.cuda.reset_peak_memory_stats()
    knn_ops.knn_cuda.launches = 0
    corr_ops.corr_select_cuda.launches = 0
    times = []
    for seed, scene in enumerate(scenes):
        k1, k2 = knn_ops.knn_cuda.launches, corr_ops.corr_select_cuda.launches
        t0 = time.perf_counter()
        out = model(*scene, iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        traj, vis = out["traj"], out["vis"]
        if traj.shape != (T, N_QUERIES, 3) or vis.shape != (T, N_QUERIES):
            raise AssertionError(f"bad output shapes {tuple(traj.shape)}, {tuple(vis.shape)}")
        if not (bool(torch.isfinite(traj).all()) and bool(torch.isfinite(vis).all())):
            raise AssertionError("non-finite outputs")
        d1 = knn_ops.knn_cuda.launches - k1
        d2 = corr_ops.corr_select_cuda.launches - k2
        if (d1, d2) != (K1_PER_FWD, K2_PER_FWD):
            raise AssertionError(f"request {seed}: {d1} kNN and {d2} corr launches, want {K1_PER_FWD} and {K2_PER_FWD}")
        log(f"request {seed}: {times[-1]:.2f} ms, kNN launches {d1}, corr launches {d2}")
    launches = {"knn": knn_ops.knn_cuda.launches, "corr": corr_ops.corr_select_cuda.launches}
    log(f"main path: {V} views x {T} frames x {H}x{W}, {N_QUERIES} queries, bf16, iters {ITERS}: "
        f"ms per request {[round(x, 2) for x in times]}, median {sorted(times)[1]:.2f}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
        f"({(torch.cuda.max_memory_allocated() - resident) / 2**20:.1f} MiB above the resident weights and scenes)")
    return launches


def phase_end_to_end(torch, MVTracker, random_state_dict, make_scene):
    """Phase 4: fp32 forward through the kernels vs the plain CPU path."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = MVTracker(device="cuda").eval()
    sd = random_state_dict(model, seed=1)
    for name in sd:
        if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
            sd[name] = sd[name] * FLOW_HEAD_GAIN
    model.load_state_dict(sd)
    scene = make_scene(np.random.default_rng(3), 2, 18, 96, 96, 48)
    out_gpu = model(*to_device(scene, torch.device("cuda")), iters=ITERS)
    cpu_model = copy.deepcopy(model).cpu()
    out_cpu = cpu_model(*to_device(scene, torch.device("cpu")), iters=ITERS)
    gaps = {}
    for key, (tmax, tmed) in (("traj", (E2E_TRAJ_MAX, E2E_TRAJ_MEDIAN)), ("vis", (E2E_VIS_MAX, E2E_VIS_MEDIAN))):
        gap = (out_gpu[key].cpu() - out_cpu[key]).abs()
        gaps[key] = (float(gap.max()), float(gap.median()))
        log(f"end to end fp32 (2 views x 18 frames x 96x96, 48 queries), kernel path vs plain CPU path: "
            f"{key} max gap {gaps[key][0]:.3e} (limit {tmax}), median {gaps[key][1]:.3e} (limit {tmed})")
        if not (gaps[key][0] <= tmax and gaps[key][1] <= tmed):
            raise AssertionError(f"end-to-end {key} gap too large")
    moved = (out_cpu["traj"] - torch.as_tensor(scene[2][None, :, 1:])).abs()[out_cpu["vis"] > 0]
    log(f"end to end: tracks moved by median {float(moved.median()):.3e} from their queries")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.ops import _cuda
    from mvtracker_torch.ops import corr as corr_ops
    from mvtracker_torch.ops import knn as knn_ops
    from mvtracker_torch.scene import make_scene

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _cuda.build_all()
    log(f"built kernels {list(_cuda.SOURCES)} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = phase_kernels(torch, knn_ops, corr_ops, gen)
    launches = phase_main_path(torch, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops)
    phase_end_to_end(torch, MVTracker, random_state_dict, make_scene)

    meta = {
        "knn": ("knn", "mvtracker_torch/csrc/knn.cu", "mvtracker_tpu/ops/knn.py:483"),
        "corr": ("corr_select", "mvtracker_torch/csrc/corr.cu", "mvtracker_tpu/ops/corr_pallas.py:66"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        st = stats[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": st["err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": max(st["by"], key=st["by"].get),
            "library_ms": None,
        })
    log("per-forward sums over the path shapes (ms, plain_ms, bound_ms); launches over the 3 requests")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
