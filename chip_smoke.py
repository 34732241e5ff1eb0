#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mvtracker_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. print the card's name and power limit, build the CUDA kernels from
   `mvtracker_torch/csrc/` with nvcc;
2. each kernel against its plain PyTorch version, on the card, at every
   shape the paths below give it (4 views x 24 frames x 256^2 with 256
   queries; 5 views x 18 frames x 704x1280 for the large cloud), plus a
   k > N and a far-from-origin kNN case; per
   shape the kernel's device time (launches replayed from a CUDA graph), its
   time called from Python through the wrapper, the plain version's device
   time and the bound; for the correlation kernels, which sum in a fixed
   order, also that two runs on one input give the same bits;
3. the serving path: the flagship MVTracker in bf16 with seeded random
   weights answers 3 requests (scenes of seeds 0, 1, 2), with launch
   counters showing every kNN and correlation went through the kernels;
4. the fp32 forward through the kernels against the plain CPU path, same
   weights and scene, once for each kNN backend (fused, tiled, exact);
5. the training path: the same flagship model in bf16 with the update
   transformer rematerialised takes 3 train steps through `Trainer.fit` on
   one scene of the serving shape, with launch counters showing every kNN,
   correlation and correlation backward went through the kernels;
6. the fp32 train step (loss and every gradient leaf) through the kernels
   against the plain CPU path, same weights and scene;
7. the large-cloud serving path: the same flagship bf16 model answers 2
   requests of 5 views x 18 frames x 704x1280 (720p cropped to a multiple
   of 32), whose level-0 cloud of 281600 points is past the dispatcher's
   switch, so the tiled kNN kernel serves it; one request again through the
   fused kernel, which must give the same tracks;
8. the direct kNN entries: a neighbourhood query on that scene's level-0
   cloud through `knn(..., backend="exact")` and `backend="tiled"`;
9. a JSON line for the kernels, then the result line.

Needs CUDA; exits non-zero without it. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
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
# Per train step: the same forward, and one backward launch for every
# correlation launch. Both inputs of every correlation carry gradient, in
# the first iteration of the first window too: the cloud features come from
# the encoder and the track features start as rows gathered from them. The
# rematerialised transformer re-runs neither the kNN nor the correlation.
K3_PER_STEP = K2_PER_FWD
TRAIN_STEPS = 3

# Large-cloud request: 5 cameras at 720p, cropped to 704 rows (a multiple of
# 32, so every pyramid level halves exactly), 2 windows. Level 0 has 5 * 176
# * 320 = 281600 points, past `knn.FUSED_MAX_POINTS` (262144): the dispatcher
# gives it, and the query features' lookup, to the tiled kernel. Levels 1 to
# 3 (70400, 17600, 4400 points) stay with the fused kernel, one call each.
LARGE_V, LARGE_T, LARGE_H, LARGE_W = 5, 18, 704, 1280
LARGE_POINTS = LARGE_V * (LARGE_H // 4) * (LARGE_W // 4)
LARGE_WINDOWS = 2
LARGE_REQUESTS = 2
K4_PER_LARGE = 1 + LARGE_WINDOWS * ITERS  # feat_init + level 0
K1_PER_LARGE = LARGE_WINDOWS * ITERS * 3  # levels 1, 2, 3
K2_PER_LARGE = LARGE_WINDOWS * ITERS * 4
# Direct entry: every 64th point of one frame's level-0 cloud asks for its 16
# nearest neighbours in that cloud (a neighbourhood query, as an
# initialisation from a fused cloud makes).
DIRECT_STRIDE, DIRECT_K = 64, 16
PLAIN_LARGE_ELEMS = 1 << 27  # distance-matrix elements per chunk of the plain versions on a large cloud
# The large request through the tiled kernel against the same request through
# the fused one: both evaluate the same d^2, so without ties the same tracks.
LARGE_SAME_ATOL = 1e-3

# Tolerances of the kernel-vs-plain checks.
KNN_RTOL = 1e-5  # both compute d^2 directly in fp32; only rounding differs
KNN_ATOL = 1e-6
CORR_TOL = {"float32": 1e-4, "bfloat16": 1e-3}  # fp32 sums of 128 products, other order
# Correlation backward: fp32 sums of N(0,1) products in another order than the
# plain version's, values up to a few tens. With a bf16 cloud, d_fvec is rounded
# once to bf16 on each side: nearly equal fp32 sums may round to neighbouring
# bf16 values, one step of at most 2^-7 of the value.
CORR_BWD_ATOL = 1e-4
CORR_BWD_BF16_RTOL = 2.0**-7
# fp32 forward through the kernels vs the plain CPU path (TF32 off).
E2E_TRAJ_MAX, E2E_TRAJ_MEDIAN = 2e-4, 1e-5
E2E_VIS_MAX, E2E_VIS_MEDIAN = 5e-4, 1e-5
# fp32 train step through the kernels vs the plain CPU path (TF32 off):
# relative gap of the loss; per gradient leaf max |gap| over the leaf's
# largest entry, and the relative L2 gap. The encoder's conv weights sit
# behind instance norms that amplify fp32 rounding (cuDNN and the CPU's
# convolutions sum in other orders), so they get their own limit; a conv
# bias in front of an instance norm has a zero gradient and both sides
# return rounding noise, held in absolute size against the step's gradient
# norm.
E2E_LOSS_RTOL = 1e-5
# Readings on an H100: loss 1.3e-7; other leaves 3.6e-4; encoder conv weights
# 6.8e-2 in one channel of `fnet.layer3.0.conv1.weight`, 6.1e-3 in relative
# L2; dead biases 2.0e-9 of the gradient norm.
E2E_GRAD_RTOL, E2E_ENC_GRAD_RTOL, E2E_ENC_GRAD_L2 = 1e-3, 2e-1, 2e-2
E2E_DEAD_BIAS_ATOL = 1e-7
# Gain on the flow head's random weights for phases 4 and 6, so that tracks move
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


def check_knn(knn_ops, ref, query, k, kernel=None, max_elems=1 << 24):
    """Kernel (`knn_cuda` unless given) vs plain on one input; returns the
    max abs distance error."""
    import torch

    d_k, i_k = (kernel or knn_ops.knn_cuda)(ref, query, k)
    n = ref.shape[1]
    d_p, i_p = knn_ops.knn_plain(ref, query, k + 1 if k < n else k, max_elems=max_elems)
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


def check_knn_exact(knn_ops, ref, query, k, max_elems=1 << 24):
    """The exact kernel vs its plain version: the indices must agree one for
    one (ties to the lower index); returns the max abs distance error."""
    import torch

    d_k, i_k = knn_ops.knn_exact_cuda(ref, query, k)
    d_p, i_p = knn_ops.knn_exact_plain(ref, query, k, max_elems=max_elems)
    torch.cuda.synchronize()
    if not torch.equal(i_k, i_p):
        raise AssertionError(f"exact knn: {int((i_k != i_p).sum())} indices differ from the stable sort's")
    real = min(k, ref.shape[1])  # ranks past the cloud hold the fill on both sides
    err = (d_k - d_p).abs()[..., :real]
    if not bool((err <= KNN_ATOL + KNN_RTOL * d_p[..., :real]).all()):
        raise AssertionError(f"exact knn distances differ: max err {err.max().item():.3e}")
    if not bool((d_k[..., real:] > 1e8).all()):
        raise AssertionError("exact knn k > N fill contract broken")
    return float(err.max())


def knn_bound(b, n, m, k):
    """Least time for a kNN call: its bytes, or 9 fp32 operations per (query,
    point) pair (3 subtractions, 3 products, 2 sums, 1 compare)."""
    nbytes = (b * n * 3 + b * m * 3) * 4 + b * m * k * (4 + 8)
    return bound(nbytes, 9.0 * b * m * n)


def add_row(st, ms, plain, bnd, by, times):
    st["ms"] += ms * times
    st["plain_ms"] += plain * times
    st["bound_ms"] += bnd * times
    st["by"][by] = st["by"].get(by, 0.0) + bnd * times


def phase_kernels(torch, knn_ops, corr_ops, gen):
    """Phase 2: kernel vs plain at the path shapes; returns per-kernel rows."""
    dev = torch.device("cuda")
    stats = {key: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0, "by": {}}
             for key in ("knn", "corr", "corr_bwd", "knn_tiled", "knn_exact")}

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
        bnd, by = knn_bound(b, n, m, k)
        log(f"K1 knn {label}: B={b} N={n} M={m} k={k} kernel_ms={ms:.5f} wrapper_ms={host:.5f} "
            f"plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}) launches/forward={per_fwd}")
        add_row(st, ms, plain, bnd, by, per_fwd)
    # Edge cases: fewer points than k, and a scene far from the origin.
    st["err"] = max(st["err"], check_knn(knn_ops, cloud(2, 10), queries(2, 50), 16))
    offset = torch.tensor([100.0, -50.0, 200.0], device=dev)
    far_ref = (torch.randn(1, 400, 3, generator=gen, device=dev) * 0.1 + offset).contiguous()
    far_q = (torch.randn(1, 50, 3, generator=gen, device=dev) * 0.1 + offset).contiguous()
    st["err"] = max(st["err"], check_knn(knn_ops, far_ref, far_q, 8))
    log(f"K1 knn checks passed: max abs distance error {st['err']:.3e} (rtol {KNN_RTOL}, atol {KNN_ATOL})")

    # K4, the tiled kNN, at the shapes the large-cloud request gives it, with
    # the fused kernel's time on the same input beside it.
    st = stats["knn_tiled"]
    big = PLAIN_LARGE_ELEMS
    # The third shape is not on the request's path: the direct entry's call
    # with few queries (phase 8), where the cloud is really split.
    for label, b, k, per_req in (("feat_init", LARGE_T, 1, 1), ("level0", s, 16, LARGE_WINDOWS * ITERS),
                                 ("direct, few queries", 1, DIRECT_K, 0)):
        n, m = LARGE_POINTS, N_QUERIES
        ref, query = cloud(b, n), queries(b, m)
        st["err"] = max(st["err"], check_knn(knn_ops, ref, query, k, knn_ops.knn_tiled_cuda, max_elems=big))
        ms = device_ms(lambda: knn_ops.knn_tiled_cuda(ref, query, k), reps=10)
        host = wrapper_ms(lambda: knn_ops.knn_tiled_cuda(ref, query, k), reps=10)
        fused = device_ms(lambda: knn_ops.knn_cuda(ref, query, k), reps=10)
        # Tens of ms of large PyTorch kernels: timed as called, no graph.
        plain = wrapper_ms(lambda: knn_ops.knn_plain(ref, query, k, max_elems=big), reps=2, warmup=1)
        bnd, by = knn_bound(b, n, m, k)
        resident = knn_ops.tiled_resident_blocks(0, k == 1)
        splits, span = knn_ops.tiled_plan(b, n, m, resident)
        log(f"K4 knn_tiled {label}: B={b} N={n} M={m} k={k} resident_blocks={resident} splits={splits} span={span} "
            f"kernel_ms={ms:.5f} "
            f"wrapper_ms={host:.5f} fused_kernel_ms={fused:.5f} plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}) "
            f"launches/request={per_req}")
        add_row(st, ms, plain, bnd, by, per_req)
    # Edge cases: few queries and many spans, a cloud that ends inside a
    # tile, fewer points than k.
    for b, n, m, k in ((1, 50000, 37, 16), (2, 2049, 9, 20), (2, 10, 50, 16)):
        st["err"] = max(st["err"], check_knn(knn_ops, cloud(b, n), queries(b, m), k, knn_ops.knn_tiled_cuda))
    log(f"K4 knn_tiled checks passed: max abs distance error {st['err']:.3e} (rtol {KNN_RTOL}, atol {KNN_ATOL})")

    # K5, the exact kNN, at the shape of the direct entry, on a cloud where a
    # third of the points are copies of others and half the queries sit on one.
    st = stats["knn_exact"]
    n, m, k = LARGE_POINTS, LARGE_POINTS // DIRECT_STRIDE, DIRECT_K
    ref = cloud(1, n)
    copies = torch.randint(0, n, (n // 3,), generator=gen, device=dev)
    ref[:, torch.randperm(n, generator=gen, device=dev)[: n // 3]] = ref[:, copies]
    query = queries(1, m)
    query[:, : m // 2] = ref[:, copies[: m // 2]]
    st["err"] = max(st["err"], check_knn_exact(knn_ops, ref, query, k, max_elems=big))
    d_exact = knn_ops.knn_exact_cuda(ref, query, k)[0]
    ties = int((d_exact[..., 1:] == d_exact[..., :-1]).sum())
    if ties == 0:
        raise AssertionError("the exact-kNN check input holds no ties")
    ms = device_ms(lambda: knn_ops.knn_exact_cuda(ref, query, k), reps=5)
    host = wrapper_ms(lambda: knn_ops.knn_exact_cuda(ref, query, k), reps=5)
    fused = device_ms(lambda: knn_ops.knn_cuda(ref, query, k), reps=5)
    plain = wrapper_ms(lambda: knn_ops.knn_exact_plain(ref, query, k, max_elems=big), reps=2, warmup=1)
    bnd, by = knn_bound(1, n, m, k)
    log(f"K5 knn_exact direct: B=1 N={n} M={m} k={k} ({ties} tied neighbour pairs) kernel_ms={ms:.5f} "
        f"wrapper_ms={host:.5f} fused_kernel_ms={fused:.5f} plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}) "
        f"launches/call=1")
    add_row(st, ms, plain, bnd, by, 1)
    for b, n, m, k in ((2, 4099, 33, 1), (2, 700, 17, 32), (2, 6, 11, 8)):
        small = torch.round(cloud(b, n) * 2)  # a lattice: most distances tie
        st["err"] = max(st["err"], check_knn_exact(knn_ops, small, torch.round(queries(b, m) * 2), k))
    log(f"K5 knn_exact checks passed: indices equal the stable sort's; max abs distance error {st['err']:.3e}")

    st = stats["corr"]
    c = 128
    level_idx = []
    for lvl, p in enumerate(LEVEL_POINTS):
        xyz, q = cloud(s, p), queries(s, N_QUERIES)
        _, idx = knn_ops.knn_plain(xyz, q, 16)
        level_idx.append(idx)
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            fvec = torch.randn(s, p, c, generator=gen, device=dev).to(dt)
            # The path's track features are fp32 in both models; with a bf16
            # cloud the kernel rounds them to bf16 as they load.
            targets = torch.randn(s, N_QUERIES, c, generator=gen, device=dev)
            idx_t = idx.clone()
            if lvl == 0 and dt_name == "float32":
                idx_t[:, :, -1] = -1  # padding index gives 0
            got = corr_ops.corr_select_cuda(fvec, targets, idx_t)
            want = corr_ops.corr_select_plain(fvec, targets, idx_t)
            err = float((got - want).abs().max())
            if err > CORR_TOL[dt_name]:
                raise AssertionError(f"corr level {lvl} {dt_name}: max err {err:.3e} > {CORR_TOL[dt_name]}")
            if not (torch.equal(corr_ops.corr_select_cuda(fvec, targets, idx_t), got)
                    and torch.equal(corr_ops.corr_select_cuda(fvec, targets.to(dt), idx_t), got)):
                raise AssertionError(f"corr level {lvl} {dt_name}: a second run, or targets cast first, differ")
            st["err"] = max(st["err"], err)
            if dt_name != "bfloat16":
                continue  # the path streams a bf16 cloud; time that
            ms = device_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
            host = wrapper_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
            plain = device_ms(lambda: corr_ops.corr_select_plain(fvec, targets, idx), reps=20)
            rows = sum(int(torch.unique(idx[b]).numel()) for b in range(s))
            # Bytes: the distinct rows (bf16), the targets at the fp32 width the
            # kernel reads them, the int64 indices and the fp32 output.
            nbytes = rows * c * 2 + targets.numel() * 4 + idx.numel() * 8 + idx.numel() * 4
            bnd, by = bound(nbytes, 2.0 * idx.numel() * c)
            per_fwd = 3 * ITERS
            log(f"K2 corr level{lvl}: fvec=[{s},{p},{c}] bf16 targets fp32 idx=[{s},{N_QUERIES},16] "
                f"kernel_ms={ms:.5f} wrapper_ms={host:.5f} plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}, {rows} "
                f"distinct rows, targets counted at fp32) launches/forward={per_fwd}")
            add_row(st, ms, plain, bnd, by, per_fwd)
    log(f"K2 corr checks passed: max abs error {st['err']:.3e} (tol {CORR_TOL}); a second run and targets cast "
        f"first give the same bits")

    # K3, the correlation backward, at the shapes a train step gives it: the
    # uncast residuals (bf16 cloud, fp32 track features) and an fp32 gradient.
    st = stats["corr_bwd"]
    for lvl, (p, idx) in enumerate(zip(LEVEL_POINTS, level_idx)):
        targets = torch.randn(s, N_QUERIES, c, generator=gen, device=dev)
        g = torch.randn(s, N_QUERIES, 16, generator=gen, device=dev)
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            fvec = torch.randn(s, p, c, generator=gen, device=dev).to(dt)
            idx_t = idx.clone()
            if lvl == 0 and dt_name == "float32":
                idx_t[:, :, -1] = -1  # padding index adds nothing
                idx_t[:, :, -2] = p  # nor does one past the cloud
            d_fvec, d_targets = corr_ops.corr_select_backward_cuda(fvec, targets, idx_t, g)
            again_fvec, again_targets = corr_ops.corr_select_backward_cuda(fvec, targets, idx_t, g)
            want_fvec, want_targets = corr_ops.corr_select_backward_plain(fvec, targets, idx_t, g)
            torch.cuda.synchronize()
            if d_fvec.dtype != dt or d_targets.dtype != torch.float32:
                raise AssertionError(f"corr backward level {lvl}: gradient dtypes {d_fvec.dtype}, {d_targets.dtype}")
            err_t = float((d_targets - want_targets).abs().max())
            gap_f = (d_fvec.float() - want_fvec.float()).abs()
            if dt_name == "float32":
                err_f = float(gap_f.max())
                ok = err_f <= CORR_BWD_ATOL
                st["err"] = max(st["err"], err_f)
            else:  # one bf16 rounding step apart at most
                err_f = float(gap_f.max())
                ok = bool((gap_f <= CORR_BWD_BF16_RTOL * want_fvec.float().abs() + CORR_BWD_ATOL).all())
            if not (ok and err_t <= CORR_BWD_ATOL):
                raise AssertionError(f"corr backward level {lvl} {dt_name}: d_fvec err {err_f:.3e}, d_targets err {err_t:.3e}")
            st["err"] = max(st["err"], err_t)
            # Both gradients are summed in a fixed order.
            if not (torch.equal(again_fvec, d_fvec) and torch.equal(again_targets, d_targets)):
                raise AssertionError(f"corr backward level {lvl} {dt_name}: two runs on one input differ")
            log(f"K3 corr_bwd level{lvl} {dt_name}: d_targets max err {err_t:.3e}, d_fvec max err {err_f:.3e} "
                f"(values up to {float(want_fvec.float().abs().max()):.1f}), two runs give the same bits")
            if dt_name != "bfloat16":
                continue  # the path's residuals are a bf16 cloud and fp32 targets; time that
            ms = device_ms(lambda: corr_ops.corr_select_backward_cuda(fvec, targets, idx, g), reps=50)
            host = wrapper_ms(lambda: corr_ops.corr_select_backward_cuda(fvec, targets, idx, g), reps=50)
            plain = device_ms(lambda: corr_ops.corr_select_backward_plain(fvec, targets, idx, g), reps=10)
            rows = sum(int(torch.unique(idx[b]).numel()) for b in range(s))
            nbytes = (rows * c * 2 + g.numel() * 4 + idx.numel() * 8 + targets.numel() * 4
                      + fvec.numel() * 2 + targets.numel() * 4)  # reads, then the dense d_fvec and d_targets
            bnd, by = bound(nbytes, 4.0 * idx.numel() * c)
            per_step = 3 * ITERS
            log(f"K3 corr_bwd level{lvl}: fvec=[{s},{p},{c}] bf16 targets fp32 g=[{s},{N_QUERIES},16] "
                f"function_ms={ms:.5f} wrapper_ms={host:.5f} "
                f"plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}, {rows} distinct rows) launches/step={per_step}")
            add_row(st, ms, plain, bnd, by, per_step)
    log(f"K3 corr_bwd checks passed: max abs error {st['err']:.3e} in fp32 (tol {CORR_BWD_ATOL}; a bf16 d_fvec "
        f"within one bf16 step); two runs on one input give the same bits")
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


def phase_end_to_end(torch, MVTracker, random_state_dict, make_scene, knn_ops):
    """Phase 4: fp32 forward through the kernels vs the plain CPU path, once
    for each kNN backend."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = MVTracker(device="cuda").eval()
    sd = random_state_dict(model, seed=1)
    for name in sd:
        if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
            sd[name] = sd[name] * FLOW_HEAD_GAIN
    model.load_state_dict(sd)
    scene = make_scene(np.random.default_rng(3), 2, 18, 96, 96, 48)
    cpu_model = copy.deepcopy(model).cpu()
    out_cpu = cpu_model(*to_device(scene, torch.device("cpu")), iters=ITERS)
    counters = {"fused": knn_ops.knn_cuda, "tiled": knn_ops.knn_tiled_cuda, "exact": knn_ops.knn_exact_cuda}
    for backend, counter in counters.items():
        model.knn_backend = backend
        before = {name: fn.launches for name, fn in counters.items()}
        out_gpu = model(*to_device(scene, torch.device("cuda")), iters=ITERS)
        made = {name: fn.launches - before[name] for name, fn in counters.items()}
        if not (made[backend] > 0 and sum(made.values()) == made[backend]):
            raise AssertionError(f"knn_backend={backend}: kNN launches {made}")
        for key, (tmax, tmed) in (("traj", (E2E_TRAJ_MAX, E2E_TRAJ_MEDIAN)), ("vis", (E2E_VIS_MAX, E2E_VIS_MEDIAN))):
            gap = (out_gpu[key].cpu() - out_cpu[key]).abs()
            log(f"end to end fp32 (2 views x 18 frames x 96x96, 48 queries), kernel path with the {backend} kNN "
                f"({made[backend]} launches) vs plain CPU path: {key} max gap {float(gap.max()):.3e} (limit {tmax}), "
                f"median {float(gap.median()):.3e} (limit {tmed})")
            if not (float(gap.max()) <= tmax and float(gap.median()) <= tmed):
                raise AssertionError(f"end-to-end {key} gap too large with the {backend} kNN")
    moved = (out_cpu["traj"] - torch.as_tensor(scene[2][None, :, 1:])).abs()[out_cpu["vis"] > 0]
    log(f"end to end: tracks moved by median {float(moved.median()):.3e} from their queries")


def leaf_kind(name: str) -> str:
    """How a gradient leaf is held in phase 6: "dead" for a conv bias in
    front of an instance norm, "encoder" for the encoder's other conv
    weights, "plain" for the rest."""
    if not name.startswith("fnet.") or name.startswith(("fnet.conv2.weight", "fnet.conv3.")):
        return "plain"
    return "dead" if name.endswith(".bias") else "encoder"


def phase_train_path(torch, smi, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops):
    """Phase 5: 3 flagship-width bf16 train steps through `Trainer.fit`;
    returns the launch totals."""
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import TrainConfig, Trainer

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = MVTracker(compute_dtype="bfloat16", remat=True, remat_encoder=False, device=dev)
    model.load_state_dict(random_state_dict(model, seed=0))
    rng = np.random.default_rng(0)
    scene = make_scene(rng, V, T, H, W, N_QUERIES)
    batch = {
        "rgbs": scene[0][None], "depths": scene[1][None], "query_points": scene[2][None],
        "intrs": scene[3][None], "extrs": scene[4][None],
        "traj_gt": rng.normal(size=(1, T, N_QUERIES, 3)).astype(np.float32),
        "vis_gt": np.ones((1, T, N_QUERIES), np.float32),
        "valid": np.ones((1, T, N_QUERIES), np.float32),
    }
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def same_batch():
        while True:
            yield batch

    with tempfile.TemporaryDirectory() as exp_dir:
        cfg = TrainConfig(train_iters=ITERS, adaptive_iters=False, exp_dir=exp_dir)
        trainer = Trainer(model, cfg)
        state = step_lib.init_state(model, trainer.optimizer)
        start = {name: p.detach().cpu().clone() for name, p in model.named_parameters()}
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        steps = []

        def counters():
            return (knn_ops.knn_cuda.launches, corr_ops.corr_select_cuda.launches,
                    corr_ops.corr_select_backward_cuda.launches)

        def on_step(step, metrics):
            # Called by the trainer after every step: what the step launched
            # and how long it took since the last call, device work included.
            torch.cuda.synchronize()
            now = time.perf_counter()
            made = tuple(n - was for was, n in zip(last["counts"], counters()))
            steps.append(((now - last["time"]) * 1e3, made, {k: float(v) for k, v in metrics.items()}))
            last.update(time=time.perf_counter(), counts=counters())

        knn_ops.knn_cuda.launches = 0
        corr_ops.corr_select_cuda.launches = 0
        corr_ops.corr_select_backward_cuda.launches = 0
        last = {"time": time.perf_counter(), "counts": counters()}
        state = trainer.fit(same_batch(), state=state, max_steps=TRAIN_STEPS, on_step=on_step)
        launches = {"knn": knn_ops.knn_cuda.launches, "corr": corr_ops.corr_select_cuda.launches,
                    "corr_bwd": corr_ops.corr_select_backward_cuda.launches}
        peak = torch.cuda.max_memory_allocated()

    if state.step != TRAIN_STEPS or len(steps) != TRAIN_STEPS:
        raise AssertionError(f"the trainer took {state.step} steps, want {TRAIN_STEPS}")
    want = (K1_PER_FWD, K2_PER_FWD, K3_PER_STEP)
    for i, (ms, counts, metrics) in enumerate(steps):
        if counts != want:
            raise AssertionError(f"train step {i}: (kNN, corr, corr backward) launches {counts}, want {want}")
        if not all(np.isfinite(v) for v in metrics.values()) or not metrics["grad_norm"] > 0:
            raise AssertionError(f"train step {i}: metrics {metrics}")
        log(f"train step {i}: {ms:.2f} ms, loss {metrics['loss']:.6f} (xyz {metrics['xyz_loss']:.6f}, vis "
            f"{metrics['vis_loss']:.6f}), grad_norm {metrics['grad_norm']:.4f}, reproj_dev {metrics['reproj_dev']:.3e}, "
            f"launches kNN/corr/corr_bwd {counts} [{smi}]")
    moved = [name for name, p in model.named_parameters() if not torch.equal(p.detach().cpu(), start[name])]
    if len(moved) != len(start):
        raise AssertionError(f"only {len(moved)} of {len(start)} parameter tensors changed")
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        raise AssertionError("non-finite parameters after the train steps")
    warm = [ms for ms, _, _ in steps[1:]]
    log(f"training path: 1 scene of {V} views x {T} frames x {H}x{W}, {N_QUERIES} queries, bf16, iters {ITERS}, "
        f"remat=True remat_encoder=False: first step {steps[0][0]:.2f} ms, later steps "
        f"{[round(x, 2) for x in warm]} ms [{smi}]")
    log(f"training memory: resident {(resident - before) / 2**20:.1f} MiB (weights, AdamW state, batch), "
        f"max_memory_allocated {peak / 2**20:.1f} MiB, per step {(peak - resident) / 2**20:.1f} MiB above "
        f"the resident set [{smi}]")
    return launches


def phase_train_end_to_end(torch, MVTracker, random_state_dict, make_scene, corr_ops):
    """Phase 6: fp32 train step (loss and gradients) through the kernels vs
    the plain CPU path."""
    from mvtracker_torch.training import step as step_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = MVTracker(device="cuda")
    sd = random_state_dict(model, seed=1)
    for name in sd:
        if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
            sd[name] = sd[name] * FLOW_HEAD_GAIN
    model.load_state_dict(sd)
    rng = np.random.default_rng(3)
    t, n = 18, 48
    arrays = make_scene(rng, 2, t, 96, 96, n)
    scene = dict(zip(("rgbs", "depths", "query_points", "intrs", "extrs"), arrays))
    scene["traj_gt"] = (arrays[2][None, :, 1:] + rng.normal(size=(t, n, 3)) * 0.1).astype(np.float32)
    scene["vis_gt"] = (rng.random((t, n)) > 0.3).astype(np.float32)
    scene["valid"] = np.ones((t, n), np.float32)
    cpu_model = copy.deepcopy(model).cpu()

    results = {}
    for tag, m in (("gpu", model), ("cpu", cpu_model)):
        before = corr_ops.corr_select_backward_cuda.launches
        total, parts = step_lib.scene_loss(m, scene, ITERS, 0.8, 0.1)
        total.backward()
        used = corr_ops.corr_select_backward_cuda.launches - before
        if (tag == "gpu") != (used > 0):
            raise AssertionError(f"{tag} path made {used} correlation backward launches")
        results[tag] = (float(total.detach()), {k: float(v.detach()) for k, v in parts.items()},
                        {name: p.grad.detach().cpu() for name, p in m.named_parameters()})
    (loss_g, parts_g, grads_g), (loss_c, parts_c, grads_c) = results["gpu"], results["cpu"]
    loss_gap = abs(loss_g - loss_c) / abs(loss_c)
    log(f"train step end to end fp32 (2 views x 18 frames x 96x96, 48 queries), kernel path vs plain CPU path: "
        f"loss {loss_g:.7f} vs {loss_c:.7f}, relative gap {loss_gap:.3e} (limit {E2E_LOSS_RTOL}); "
        f"xyz {parts_g['xyz_loss']:.7f} vs {parts_c['xyz_loss']:.7f}, vis {parts_g['vis_loss']:.7f} vs {parts_c['vis_loss']:.7f}")
    if not loss_gap <= E2E_LOSS_RTOL:
        raise AssertionError("end-to-end loss gap too large")
    grad_norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads_c.values())))
    worst = {"plain": (0.0, ""), "encoder": (0.0, ""), "encoder_l2": (0.0, ""), "dead": (0.0, "")}
    for name, want in grads_c.items():
        gap = (grads_g[name] - want).abs()
        kind = leaf_kind(name)
        if kind == "dead":
            worst["dead"] = max(worst["dead"], (float(gap.max()) / grad_norm, name))
            continue
        if not float(want.abs().max()) > 0:
            raise AssertionError(f"gradient leaf {name} is all zero")
        worst[kind] = max(worst[kind], (float(gap.max() / want.abs().max()), name))
        if kind == "encoder":
            worst["encoder_l2"] = max(worst["encoder_l2"], (float(gap.norm() / want.norm()), name))
    log(f"train step end to end: {len(grads_c)} gradient leaves, gradient norm {grad_norm:.4f}; worst max-gap over "
        f"the leaf's largest entry {worst['plain'][0]:.3e} at {worst['plain'][1]} (limit {E2E_GRAD_RTOL}); encoder conv "
        f"weights {worst['encoder'][0]:.3e} at {worst['encoder'][1]} (limit {E2E_ENC_GRAD_RTOL}), their worst relative "
        f"L2 gap {worst['encoder_l2'][0]:.3e} at {worst['encoder_l2'][1]} (limit {E2E_ENC_GRAD_L2}); zero-gradient "
        f"conv biases {worst['dead'][0]:.3e} of the gradient norm (limit {E2E_DEAD_BIAS_ATOL})")
    if not (worst["plain"][0] <= E2E_GRAD_RTOL and worst["encoder"][0] <= E2E_ENC_GRAD_RTOL
            and worst["encoder_l2"][0] <= E2E_ENC_GRAD_L2 and worst["dead"][0] <= E2E_DEAD_BIAS_ATOL):
        raise AssertionError("end-to-end gradient gap too large")


def phase_large_cloud(torch, smi, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops):
    """Phase 7: the large-cloud serving path; returns (launch totals, the
    level-0 cloud of the last scene's first frame for phase 8)."""
    from mvtracker_torch.utils import geometry as geo

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    model = MVTracker(compute_dtype="bfloat16", device=dev).eval()
    model.load_state_dict(random_state_dict(model, seed=0))
    counters = {"knn": knn_ops.knn_cuda, "knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda,
                "corr": corr_ops.corr_select_cuda}
    want = {"knn": K1_PER_LARGE, "knn_tiled": K4_PER_LARGE, "knn_exact": 0, "corr": K2_PER_LARGE}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for seed in range(10, 10 + LARGE_REQUESTS):
        scene = to_device(make_scene(np.random.default_rng(seed), LARGE_V, LARGE_T, LARGE_H, LARGE_W, N_QUERIES), dev)
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(*scene, iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        traj, vis = out["traj"], out["vis"]
        if traj.shape != (LARGE_T, N_QUERIES, 3) or vis.shape != (LARGE_T, N_QUERIES):
            raise AssertionError(f"bad output shapes {tuple(traj.shape)}, {tuple(vis.shape)}")
        if not (bool(torch.isfinite(traj).all()) and bool(torch.isfinite(vis).all())):
            raise AssertionError("non-finite outputs")
        made = {name: fn.launches - before[name] for name, fn in counters.items()}
        if made != want:
            raise AssertionError(f"large-cloud request {seed}: launches {made}, want {want}")
        log(f"large-cloud request {seed}: {times[-1]:.2f} ms, launches {made} [{smi}]")
    launches = {name: fn.launches for name, fn in counters.items() if want[name]}
    peak = torch.cuda.max_memory_allocated()

    # The last request again with every kNN through the fused kernel: the two
    # kernels evaluate the same d^2, so the tracks must come out the same.
    model.knn_backend = "fused"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused = model(*scene, iters=ITERS)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3
    gaps = {key: float((out[key] - fused[key]).abs().max()) for key in ("traj", "vis")}
    log(f"large-cloud path: {LARGE_V} views x {LARGE_T} frames x {LARGE_H}x{LARGE_W}, level-0 cloud {LARGE_POINTS} "
        f"points, {N_QUERIES} queries, bf16, iters {ITERS}: ms per request {[round(x, 2) for x in times]}; the same "
        f"request through the fused kNN {fused_ms:.2f} ms, max gap traj {gaps['traj']:.3e} vis {gaps['vis']:.3e} "
        f"(limit {LARGE_SAME_ATOL}); max_memory_allocated {peak / 2**20:.1f} MiB [{smi}]")
    if not max(gaps.values()) <= LARGE_SAME_ATOL:
        raise AssertionError("the tiled and the fused kNN give different tracks")

    rgbs, depths, _, intrs, extrs = scene
    one = slice(0, 1)  # the first frame of every view
    xyz, _ = geo.init_pointcloud_from_rgbd(
        depths[None, :, one, ::4, ::4, None], depths[None, :, one, ::4, ::4], intrs[None, :, one], extrs[None, :, one],
        stride=4, level=0,
    )
    return launches, xyz.reshape(1, LARGE_POINTS, 3).contiguous()


def phase_direct_knn(torch, smi, knn_ops, cloud):
    """Phase 8: the kNN entries called directly on a level-0 cloud of the
    large scene; returns the launch totals."""
    query = cloud[:, ::DIRECT_STRIDE].contiguous()
    own = torch.arange(0, cloud.shape[1], DIRECT_STRIDE, device=cloud.device)
    counters = {"knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda, "knn": knn_ops.knn_cuda}
    for fn in counters.values():
        fn.launches = 0
    results, times = {}, {}
    few = query[:, :N_QUERIES].contiguous()  # a tracker's worth of queries: the tiled kernel splits the cloud
    for backend, q in (("exact", query), ("tiled", query), ("auto", few)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[backend] = knn_ops.knn(cloud, q, DIRECT_K, backend=backend)
        torch.cuda.synchronize()
        times[backend] = (time.perf_counter() - t0) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    if launches != {"knn_tiled": 2, "knn_exact": 1, "knn": 0}:  # `auto` takes the tiled kernel at this size
        raise AssertionError(f"direct kNN entries: launches {launches}")
    d_exact, i_exact = results["exact"]
    if i_exact.shape != (1, query.shape[1], DIRECT_K) or not bool(torch.isfinite(d_exact).all()):
        raise AssertionError("direct kNN entries: bad output")
    # Every query is a point of the cloud: its nearest neighbour is itself, at
    # the floor distance sqrt(1e-12), and the distances ascend.
    if not (torch.equal(i_exact[0, :, 0], own) and bool((d_exact[..., 0] == 1e-6).all())
            and bool((d_exact[..., 1:] >= d_exact[..., :-1]).all())):
        raise AssertionError("direct kNN entries: a point is not its own nearest neighbour")
    if not (torch.equal(results["tiled"][0], d_exact) and torch.equal(results["auto"][0], d_exact[:, :N_QUERIES])):
        raise AssertionError("direct kNN entries: tiled and exact distances differ")
    log(f"direct kNN entries: cloud [1, {cloud.shape[1]}, 3], k={DIRECT_K}, exact and tiled with {query.shape[1]} "
        f"queries, auto with {few.shape[1]}: ms per call (host clock, first call of each) "
        f"{ {k: round(v, 2) for k, v in times.items()} }; exact and tiled agree, every point is its own nearest "
        f"neighbour [{smi}]")
    return {name: count for name, count in launches.items() if count}


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
    serving = phase_main_path(torch, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops)
    phase_end_to_end(torch, MVTracker, random_state_dict, make_scene, knn_ops)
    training = phase_train_path(torch, smi, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops)
    phase_train_end_to_end(torch, MVTracker, random_state_dict, make_scene, corr_ops)
    large, cloud = phase_large_cloud(torch, smi, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops)
    direct = phase_direct_knn(torch, smi, knn_ops, cloud)

    # Each path was driven with the counts at 0 just before it; every kernel
    # of a path must have been launched in that path's run.
    paths = {"serving": serving, "training": training, "large_cloud": large, "direct_knn": direct}
    for path, counts in paths.items():
        idle = [key for key, count in counts.items() if count == 0]
        if idle:
            raise AssertionError(f"the {path} path launched no {idle} kernel")
    for key in ("knn", "corr", "corr_bwd", "knn_tiled", "knn_exact"):
        if not any(counts.get(key, 0) for counts in paths.values()):
            raise AssertionError(f"no path launched the {key} kernel")

    meta = {
        "knn": ("knn", "mvtracker_torch/csrc/knn.cu", "mvtracker_tpu/ops/knn.py:483"),
        "corr": ("corr_select", "mvtracker_torch/csrc/corr.cu", "mvtracker_tpu/ops/corr_pallas.py:66"),
        "corr_bwd": ("corr_select_backward", "mvtracker_torch/csrc/corr_bwd.cu", "mvtracker_tpu/ops/corr_pallas.py:133"),
        "knn_tiled": ("knn_tiled", "mvtracker_torch/csrc/knn_tiled.cu", "mvtracker_tpu/ops/knn.py:345"),
        "knn_exact": ("knn_exact", "mvtracker_torch/csrc/knn_exact.cu", "mvtracker_tpu/ops/knn.py:207"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        st = stats[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(counts.get(key, 0) for counts in paths.values()),
            "launches_by_path": {path: counts[key] for path, counts in paths.items() if key in counts},
            "max_abs_err": st["err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": max(st["by"], key=st["by"].get),
            "library_ms": None,
        })
    log("ms, plain_ms, bound_ms: sums over the path shapes of one flagship forward (knn, corr_select), of one "
        "train step's backward (corr_select_backward), of one large-cloud request (knn_tiled) or of one direct call "
        f"(knn_exact); launches: the 3 requests of the serving path, the {TRAIN_STEPS} steps of the training path, "
        f"the {LARGE_REQUESTS} requests of the large-cloud path and the 3 calls of the direct path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
