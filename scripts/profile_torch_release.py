#!/usr/bin/env python3
"""Where the released checkpoint's outputs on the GPU part from the JAX
package's, and what the fp32 encoder costs.

    python3 scripts/profile_torch_release.py [--release PATH] [--skip-cpu]

Needs CUDA. Prints, for the release protocol of `release/README.md` (fp32,
TF32 off), the gap of every scene's traj and vis to the JAX package's
golden outputs (`mvtracker_torch/evaluation/golden/`), as median / 90th
percentile / max of |gap|, for:

1. the kernel path on the card, run twice (the same bits?);
2. the card with the plain kNN and correlation in place of K1 and K2 (do
   the kernels move the tracks?);
3. the plain path on the CPU (skipped with --skip-cpu);

then the protocol metrics of each. Then the forks: on the CPU, the gap a
1e-6 move of every query and an rgb offset of 1e-3 cause on held-out scenes
0 and 5, at the protocol's setting and (scene 0) at the predictor's
defaults. Last, the medium encoder on 4 views x 12 frames of 384x512 on the
card: its feature maps against the CPU's, its time (CUDA events) and its
peak memory, in fp32 with TF32 off or on, with cuDNN off, and in bf16.
"""

from __future__ import annotations

import argparse
import copy
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
PROTOCOL = [
    "--model_size", "medium", "--vis_geom", "--vis_head_hidden", "128", "--fp32",
    "--views", "4", "--res", "128", "--iters", "3", "--grid", "0", "--interp", "128",
    "--texture_detail", "1.0", "--texture_noise", "1.0",
]
KEY = "iters3_grid0_interp128"


def stats(a, b) -> str:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return f"{np.median(d):.2e}/{np.quantile(d, 0.9):.2e}/{d.max():.2e}"


def run_protocol(torch, ec, release, device):
    with torch.no_grad():
        return ec.run(ec.build_parser().parse_args(PROTOCOL + ["--params_msgpack", release, "--device", device]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--release", default=str(ROOT / "release" / "mvtracker_medium_synth.msgpack"),
                        help="the release checkpoint (flax msgpack)")
    parser.add_argument("--skip-cpu", action="store_true", help="leave out the CPU runs")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_release: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mvtracker_torch.cli import eval_checkpoint as ec
    from mvtracker_torch.convert import load_release
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.ops import corr as corr_ops
    from mvtracker_torch.ops import knn as knn_ops
    from mvtracker_torch.presets import build_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    golden = np.load(ROOT / "mvtracker_torch" / "evaluation" / "golden" / "release_protocol.npz")

    runs = {"kernels": "cuda", "kernels again": "cuda", "plain kNN and correlation on the card": "cuda"}
    if not args.skip_cpu:
        runs["plain path on the CPU"] = "cpu"
    outputs = {}
    real_knn, real_corr = knn_ops.knn, corr_ops.corr_select
    for name, device in runs.items():
        if name.startswith("plain kNN"):
            knn_ops.knn = lambda ref, q, k, backend="auto": knn_ops.knn_plain(ref.float().contiguous(),
                                                                               q.float().contiguous(), k)
            corr_ops.corr_select = corr_ops.corr_select_plain
        t0 = time.perf_counter()
        result = run_protocol(torch, ec, args.release, device)
        knn_ops.knn, corr_ops.corr_select = real_knn, real_corr
        outputs[name] = result.outputs[KEY]
        r = result.rows[KEY]
        sweep = {t: v["average_jaccard"] for t, v in r["calib_threshold_sweep"].items()}
        print(f"protocol, {name}: {time.perf_counter() - t0:.1f} s; threshold {r['calibrated_threshold']}, held-out AJ "
              f"{r['heldout_calibrated']['average_jaccard']} OA {r['heldout_calibrated']['occlusion_accuracy']} ATE "
              f"{r['heldout_calibrated']['ate_visible']}; calibration AJ {sweep} [{smi}]", flush=True)
    for split in ("calib", "heldout"):
        for i, seq in enumerate(golden[f"{split}_seq_names"]):
            seq = str(seq)
            parts = []
            for name, out in outputs.items():
                traj, vis = out[split][seq]
                parts.append(f"{name}: traj {stats(traj, golden[f'{split}_traj'][i])} vis "
                             f"{stats(vis, golden[f'{split}_vis'][i])}")
            k_traj = outputs["kernels"][split][seq][0]
            parts.append(f"kernels vs kernels again: traj {stats(k_traj, outputs['kernels again'][split][seq][0])}")
            parts.append("kernels vs plain on the card: traj "
                         f"{stats(k_traj, outputs['plain kNN and correlation on the card'][split][seq][0])}")
            print(f"{split} {seq} vs golden (median/p90/max): " + "; ".join(parts), flush=True)

    model = load_release(args.release, build_model("medium", vis_geom=True, vis_head_hidden=128,
                                              compute_dtype="float32", device="cuda")).eval()
    cpu_model = copy.deepcopy(model).cpu()
    if not args.skip_cpu:
        from mvtracker_torch.datasets.loader import SyntheticSceneDataset

        ds = SyntheticSceneDataset(n_scenes=6, seed=777, randomize=True, cache=True, n_views=4, n_frames=12,
                                   height=128, width=128, n_tracks=32, texture_detail=1.0, texture_noise=1.0)
        for idx, interp in ((0, (128, 128)), (5, (128, 128)), (0, (384, 512))):
            dp = ds[idx]
            base = [np.asarray(a, np.float32) for a in (dp.video, dp.videodepth, dp.query_points_3d, dp.intrs,
                                                         dp.extrs)]
            grid = 0 if interp == (128, 128) else 5
            iters = 3 if interp == (128, 128) else 6
            pred = EvaluationPredictor(cpu_model, interp_shape=interp, grid_size=grid, n_iters=iters, device="cpu")
            with torch.no_grad():
                ref = pred(*base)
                for label, moved in (
                    ("queries + 1e-6", base[:2] + [base[2] + np.float32([0, 1e-6, 1e-6, 1e-6])] + base[3:]),
                    ("rgb + 1e-3", [base[0] + np.float32(1e-3)] + base[1:]),
                ):
                    out = pred(*moved)
                    print(f"fork control on the CPU, {dp.seq_name} at {interp[0]}x{interp[1]}, {label}: traj "
                          f"{stats(out['traj'], ref['traj'])} vis {stats(out['vis'], ref['vis'])}", flush=True)

    x = torch.rand(4, 12, 384, 512, 3, generator=torch.Generator().manual_seed(0)) * 255
    with torch.no_grad():
        want = cpu_model.compute_fmaps(x) if not args.skip_cpu else None
    for dtype, tf32, cudnn in (("float32", False, True), ("float32", True, True), ("float32", False, False),
                               ("bfloat16", False, True)):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.enabled = cudnn
        enc = build_model("medium", vis_geom=True, vis_head_hidden=128, compute_dtype=dtype, device="cuda").eval()
        enc.load_state_dict(model.state_dict())
        xc = x.cuda()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            for _ in range(2):
                enc.compute_fmaps(xc)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fmaps = enc.compute_fmaps(xc)
            end.record()
        torch.cuda.synchronize()
        gap = "" if want is None else (
            f", max gap to the CPU's over its largest entry {float((fmaps.float().cpu() - want).abs().max() / want.abs().max()):.2e}")
        print(f"encoder {dtype} TF32 {'on' if tf32 else 'off'} cuDNN {'on' if cudnn else 'off'}: "
              f"{start.elapsed_time(end):.2f} ms, peak {(torch.cuda.max_memory_allocated() - base_mem) / 2**20:.1f} MiB "
              f"above the weights and input{gap} [{smi}]", flush=True)
        del enc, fmaps
    torch.backends.cudnn.enabled = True
    return 0


if __name__ == "__main__":
    sys.exit(main())
