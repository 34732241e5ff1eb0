#!/usr/bin/env python3
"""Where the time of the port's flagship train step goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_train_step.py [--steps 3] [--top 25] [--compare-remat]
    python3 scripts/profile_torch_train_step.py --ablations [--warm 3] [--reps 5] [--out_json out.json]

Builds `mvtracker_torch`'s flagship MVTracker (bf16, seeded random weights,
`remat=True, remat_encoder=False`, the configuration the JAX package's
benchmark trains) and takes train steps on one scene of 4 views x 24 frames
x 256^2 with 256 queries and 4 iterations (the batch of `chip_smoke.py`'s
training phase): one warm-up step, `--steps` timed ones, the last under
`torch.profiler`. Prints the card, the step times, the device-busy share
(union of the profiled step's kernel intervals over its wall time, and over
the median unprofiled step's, since the profiler slows the host), the host
and device time of the spans `mvtracker::train.forward`, `::train.backward`
and `::train.optimizer` that the train step records, the peak memory, and the
top kernels by device time. The kernels are built before the first step, so
that step's time is the framework's warm-up, not `nvcc`. With `--compare-remat` it then times the same
steps with `remat=False` and prints both peaks.

With `--ablations` it measures the step by ablation instead, the variants of
the JAX package's `scripts/profile_train_step.py`, each from the same seeded
weights on the same batch:

  full              remat=True (the update transformer and the encoder)
  fwd_loss_only     the forward and the loss, no gradient
  no_remat          remat off (the build of `--compare-remat`); running out
                    of device memory is reported as such
  remat_no_encoder  remat=True, remat_encoder=False (the bench's step)
  no_corr_bwd       the cloud features and the track features detached on
                    their way into the correlation: no correlation backward
  no_enc_bwd        the encoder's feature maps detached: no encoder backward

The two last patch `ops/corr.py::corr_sample` and
`MVTracker.compute_fmaps` inside this script, in a context that restores
them. Each variant is timed by the JAX scripts' statistic (the lowest of
`--rounds` means of `--reps` steps after `--warm`; 2, 5 and 3 as there) and
reports its first step's loss, the encoder's gradient norm in that step, the
kernels' launches and the correlation calls a step, and the peak memory,
with the card's name and power limit. `--device cpu` (the tests) computes everything but the times
and the memory; `--small` runs `bench_torch.py`'s narrow widths.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402
from scripts import timing_torch  # noqa: E402
from scripts.profile_torch_forward import busy_us, span_rows  # noqa: E402

V, T, H, W, N_QUERIES, ITERS = 4, 24, 256, 256, 256, 4
VARIANTS = {
    "full": {"remat": True},
    "fwd_loss_only": {"remat": True},
    "no_remat": {"remat": False},
    "remat_no_encoder": {"remat": True, "remat_encoder": False},
    "no_corr_bwd": {"remat": True},
    "no_enc_bwd": {"remat": True},
}
GAMMA, VIS_WEIGHT = 0.8, 0.1  # the train step's defaults


def make_batch(torch, make_scene, dev, shape=(V, T, H, W, N_QUERIES)):
    v, t, h, w, n = shape
    rng = np.random.default_rng(0)
    scene = make_scene(rng, v, t, h, w, n)
    batch = {
        "rgbs": scene[0][None], "depths": scene[1][None], "query_points": scene[2][None],
        "intrs": scene[3][None], "extrs": scene[4][None],
        "traj_gt": rng.normal(size=(1, t, n, 3)).astype(np.float32),
        "vis_gt": np.ones((1, t, n), np.float32),
        "valid": np.ones((1, t, n), np.float32),
    }
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


@contextlib.contextmanager
def ablated(variant: str):
    """Within the block, the patch of `variant` (none for most)."""
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.ops import corr as corr_ops

    if variant == "no_corr_bwd":
        original = corr_ops.corr_sample

        def corr_no_grad(cloud_xyz, cloud_fvec, targets, coords, idx, **kw):
            return original(cloud_xyz, cloud_fvec.detach(), targets.detach(), coords, idx, **kw)

        corr_ops.corr_sample = corr_no_grad
        try:
            yield
        finally:
            corr_ops.corr_sample = original
    elif variant == "no_enc_bwd":
        original = MVTracker.compute_fmaps
        MVTracker.compute_fmaps = lambda self, rgbs: original(self, rgbs).detach()
        try:
            yield
        finally:
            MVTracker.compute_fmaps = original
    else:
        yield


class EncoderGradient:
    """An optimizer that records the encoder's gradient norm at its first
    update, then updates as the optimizer it wraps."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.norm = None

    def init(self, params):
        return self.optimizer.init(params)

    def update(self, params, grads, opt_state):
        from mvtracker_torch.training.step import global_norm

        if self.norm is None:
            self.norm = float(global_norm([g for name, g in grads.items() if name.startswith("fnet.")]))
        self.optimizer.update(params, grads, opt_state)


def run_variant(variant: str, widths: dict, batch: dict, device, warm: int, reps: int, rounds: int = 2,
                iters: int = ITERS) -> dict:
    """One variant from seeded weights: its time a step, first loss,
    encoder gradient norm, launches and calls a step, peak memory."""
    import torch

    from mvtracker_torch.training import step as step_lib

    model = bench_torch.build_model(widths, device, **VARIANTS[variant])
    optimizer = EncoderGradient(step_lib.make_optimizer())
    state = step_lib.init_state(model, optimizer)
    train_step = step_lib.make_train_step(model, optimizer, iters=iters, gamma=GAMMA, vis_weight=VIS_WEIGHT)
    scene = {k: v[0] for k, v in batch.items()}
    losses = []

    def one_step():
        if variant == "fwd_loss_only":
            with torch.no_grad():
                total, _ = step_lib.scene_loss(model, scene, iters, GAMMA, VIS_WEIGHT)
            losses.append(total)
        else:
            _, metrics = train_step(state, batch)
            losses.append(metrics["loss"])

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with ablated(variant), timing_torch.counted() as counts:
        ms = timing_torch.lower_mean_ms(one_step, device, reps, warm, rounds)
    steps = warm + rounds * reps if on_card else 1
    return {"ms": ms, "loss": float(losses[0]), "encoder_grad_norm": optimizer.norm,
            **timing_torch.per_call(counts, steps),
            "peak_mib_above_resident": (torch.cuda.max_memory_allocated() - resident) / 2**20 if on_card else None}


def ablations(args) -> dict:
    import torch

    from mvtracker_torch.device import resolve_device
    from mvtracker_torch.ops import _cuda
    from mvtracker_torch.scene import make_scene

    device = resolve_device(args.device)
    if device.type == "cuda":
        _cuda.build_all()
    shape, widths = bench_torch.configs(args.small)["headline"]
    batch = make_batch(torch, make_scene, device, shape)
    results = {}
    for variant in VARIANTS:
        try:
            results[variant] = run_variant(variant, widths, batch, device, args.warm, args.reps, args.rounds)
        except torch.cuda.OutOfMemoryError as e:
            if variant != "no_remat":
                raise
            results[variant] = {"failed": "OutOfMemoryError", "message": str(e).splitlines()[0]}
            torch.cuda.empty_cache()
        row = results[variant]
        print(f"{variant:<16} " + (f"failed: {row['failed']}" if "failed" in row else
                                   f"{'not measured on the CPU' if row['ms'] is None else f'{row['ms']:8.2f} ms'}, "
                                   f"loss {row['loss']:.6f}, encoder grad norm {row['encoder_grad_norm']}, "
                                   f"a step: launches {row['launches']}, calls {row['calls']}, peak "
                                   f"{row['peak_mib_above_resident']} MiB"), flush=True)
    report = {"variants": results, "config": {"shape": list(shape), "iters": ITERS, "small": args.small},
              **timing_torch.card(device)}
    print(f"[{report['device']}, {report['power_limit']}]")
    return report


def profile(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.device import resolve_device
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.ops import _cuda
    from mvtracker_torch.scene import make_scene
    from mvtracker_torch.training import step as step_lib

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the profile needs an NVIDIA GPU; --ablations runs on the CPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    _cuda.build_all()
    batch = make_batch(torch, make_scene, dev)

    def build(remat: bool):
        model = MVTracker(compute_dtype="bfloat16", remat=remat, remat_encoder=False, device=dev)
        model.load_state_dict(random_state_dict(model, seed=0))
        optimizer = step_lib.make_optimizer()
        return step_lib.init_state(model, optimizer), step_lib.make_train_step(model, optimizer, iters=ITERS)

    def steps(n):
        out = []
        times = timing_torch.host_ms(lambda: out.append(train_step(state, batch)[1]), dev, n)
        return out[-1] if out else None, times

    state, train_step = build(remat=True)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, first = steps(1)  # warm-up
    metrics, times = steps(args.steps - 1)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        metrics, profiled = steps(1)
    wall_ms = profiled[0]
    print(f"remat=True remat_encoder=False: first step {first[0]:.2f} ms, step ms {[round(x, 2) for x in times]}, "
          f"profiled step {wall_ms:.2f} ms, loss {float(metrics['loss']):.6f}, grad_norm {float(metrics['grad_norm']):.4f}")
    print(f"memory: resident {resident / 2**20:.1f} MiB (weights, AdamW state, batch), peak {peak / 2**20:.1f} MiB, "
          f"per step {(peak - resident) / 2**20:.1f} MiB [{smi}]")

    kernels = [e for e in prof.events() if e.device_type.name == "CUDA" and not e.name.startswith("mvtracker::")]
    dev_total_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    busy_ms = busy_us(kernels) / 1e3
    plain_ms = float(np.median(times)) if times else float("nan")
    print(f"profiled step: wall {wall_ms:.2f} ms, {len(kernels)} device kernels, kernel time "
          f"{dev_total_us / 1e3:.2f} ms, device busy {busy_ms:.2f} ms; busy share {busy_ms / wall_ms:.3f} of the "
          f"profiled step, {busy_ms / plain_ms:.3f} of the median unprofiled step ({plain_ms:.2f} ms) [{smi}]")
    # A span's host entry carries the device time of the kernels launched
    # inside it on its own thread. The backward's kernels are launched by the
    # autograd engine's thread, so its device time is what the forward and
    # the optimizer leave of the step's kernel time.
    host = span_rows(prof, "mvtracker::train.")
    for key, (_, host_ms, device_ms) in host.items():
        print(f"{key}: host {host_ms:.2f} ms, device {device_ms:.2f} ms")
    rest_ms = dev_total_us / 1e3 - sum(device_ms for _, _, device_ms in host.values())
    print(f"mvtracker::train.backward device time, as the step's kernel time outside the forward and optimizer "
          f"spans: {rest_ms:.2f} ms")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=args.top, max_name_column_width=60))
    report = {"first_ms": first[0], "step_ms": times, "profiled_ms": wall_ms, "peak_mib": peak / 2**20,
              "resident_mib": resident / 2**20, "kernels": len(kernels), "busy_ms": busy_ms}

    if args.compare_remat:
        del state, train_step, prof, kernels
        torch.cuda.empty_cache()
        state, train_step = build(remat=False)
        torch.cuda.synchronize()
        resident2 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, first2 = steps(1)
        _, times2 = steps(max(args.steps - 1, 1))
        peak2 = torch.cuda.max_memory_allocated()
        print(f"remat=False: first step {first2[0]:.2f} ms, step ms {[round(x, 2) for x in times2]}; peak "
              f"{peak2 / 2**20:.1f} MiB, per step {(peak2 - resident2) / 2**20:.1f} MiB, against "
              f"{(peak - resident) / 2**20:.1f} MiB with remat=True [{smi}]")
        report["no_remat"] = {"first_ms": first2[0], "step_ms": times2, "peak_mib": peak2 / 2**20}
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--compare-remat", action="store_true")
    ap.add_argument("--ablations", action="store_true")
    ap.add_argument("--small", action="store_true", help="with --ablations: bench_torch.py's narrow widths")
    ap.add_argument("--warm", type=int, default=3, help="with --ablations: untimed steps a variant")
    ap.add_argument("--reps", type=int, default=5, help="with --ablations: steps in each timed run")
    ap.add_argument("--rounds", type=int, default=2, help="with --ablations: timed runs, the fastest kept")
    ap.add_argument("--out_json", default=None)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    report = ablations(args) if args.ablations else profile(args)
    if args.out_json:
        import json

        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
