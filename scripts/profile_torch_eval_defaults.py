#!/usr/bin/env python3
"""Where the medium model's kernel path on the GPU parts from the plain CPU
path at the predictor's defaults (384x512 resize, 5x5 support points per
view, 6 iterations), fp32 with TF32 off.

    python3 scripts/profile_torch_eval_defaults.py [--release PATH]

Needs CUDA. Weights: `chip_smoke.py`'s seeded ones (seed 0, flow head
scaled by its FLOW_HEAD_GAIN), or the release checkpoint with --release.
On held-out scene 0 of the release protocol, prints the gap (median / 90th
percentile / max of |gap|) of traj and vis to the plain CPU path for:

1. the kernel path on the card, twice (the same bits?);
2. the card with the plain kNN and correlation in place of K1 and K2;
3. the card with cuDNN off (PyTorch's own CUDA convolutions);
4. the CPU with every query moved by 1e-6, and with the depth scaled by
   1 + 1e-6 (how far rounding alone carries);
5. ties: the share of exactly equal neighbour distances in the model's kNN
   calls, the CPU's `torch.topk` kNN against its exact kNN (lowest index
   among ties), and the card against the CPU with the exact kNN on both
   sides (K5 on the card);

then the stages: the encoder's feature maps of the resized input and the
support points, card against CPU, relative to the largest entry.
"""

from __future__ import annotations

import argparse
import copy
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def stats(a, b) -> str:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return f"{np.median(d):.2e}/{np.quantile(d, 0.9):.2e}/{d.max():.2e}"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--release", default=None, help="release checkpoint (flax msgpack); default seeded weights")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_eval_defaults: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from mvtracker_torch.cli import eval_checkpoint as ec
    from mvtracker_torch.convert import load_release, random_state_dict
    from mvtracker_torch.datasets.loader import SyntheticSceneDataset
    from mvtracker_torch.device import fp32_precision
    from mvtracker_torch.evaluation.evaluator import to_host
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor, build_support_grid_points
    from mvtracker_torch.ops import corr as corr_ops
    from mvtracker_torch.ops import knn as knn_ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    model = ec.build(ec.build_parser().parse_args(chip_smoke.PROTOCOL_ARGV))
    if args.release:
        load_release(args.release, model)
    else:
        sd = random_state_dict(model, seed=0)
        for name in sd:
            if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
                sd[name] = sd[name] * chip_smoke.FLOW_HEAD_GAIN
        model.load_state_dict(sd)
    cpu_model = copy.deepcopy(model).cpu()
    dp = SyntheticSceneDataset(n_scenes=1, seed=777, randomize=True, cache=True, n_views=4, n_frames=12, height=128,
                               width=128, n_tracks=32, texture_detail=1.0, texture_noise=1.0)[0]
    base = chip_smoke.request_args(dp)
    cpu = EvaluationPredictor(cpu_model, device="cpu")
    card = EvaluationPredictor(model)

    def run(pred, inputs):
        with torch.no_grad():
            out = pred(*inputs)
        return to_host(out["traj"]), to_host(out["vis"])

    def show(label, got, want):
        print(f"{label}: traj {stats(got[0], want[0])} vis {stats(got[1], want[1])} [{smi}]", flush=True)

    with fp32_precision(exact=True):
        ref = run(cpu, base)
        kernels = run(card, base)
        show("card kernels vs CPU", kernels, ref)
        show("card kernels again vs card kernels", run(card, base), kernels)
        real_knn, real_corr = knn_ops.knn, corr_ops.corr_select
        knn_ops.knn = lambda r, q, k, backend="auto": knn_ops.knn_plain(r.float().contiguous(), q.float().contiguous(), k)
        corr_ops.corr_select = corr_ops.corr_select_plain
        plain = run(card, base)
        knn_ops.knn, corr_ops.corr_select = real_knn, real_corr
        show("card plain kNN and correlation vs CPU", plain, ref)
        show("card plain kNN and correlation vs card kernels", plain, kernels)
        torch.backends.cudnn.enabled = False
        show("card kernels, cuDNN off, vs CPU", run(card, base), ref)
        torch.backends.cudnn.enabled = True
        show("CPU, queries + 1e-6, vs CPU", run(cpu, base[:2] + [base[2] + np.float32([0, 1e-6, 1e-6, 1e-6])] + base[3:]),
             ref)
        show("CPU, depth x (1 + 1e-6), vs CPU", run(cpu, [base[0], base[1] * np.float32(1 + 1e-6)] + base[2:]), ref)

        calls = []

        def spy(r, q, k, backend="auto"):
            d2 = ((q[:, :, None, :].float() - r[:, None, :, :].float()) ** 2).sum(-1)
            v = torch.topk(d2, min(k + 1, r.shape[1]), dim=-1, largest=False)[0]
            calls.append((r.shape[1], k, int((v[..., 1:] == v[..., :-1]).sum()), v[..., 1:].numel()))
            return real_knn(r, q, k, backend)

        knn_ops.knn = spy
        run(cpu, base)
        knn_ops.knn = real_knn
        shares = {f"N={n} k={k}": f"{t}/{e}" for n, k, t, e in sorted(set(calls))}
        print(f"equal neighbouring distances among the k+1 nearest, per kNN call shape: {shares}", flush=True)
        cpu_model.knn_backend = model.knn_backend = "exact"
        exact_ref = run(cpu, base)
        show("CPU exact kNN vs CPU topk kNN", exact_ref, ref)
        show("card exact kNN (K5) vs CPU exact kNN", run(card, base), exact_ref)
        cpu_model.knn_backend = model.knn_backend = "auto"

        rgbs, depths, intrs = cpu._resize(*(cpu._to_device(x) for x in (base[0], base[1], base[3])))
        extrs = cpu._to_device(base[4])
        with torch.no_grad():
            want = cpu_model.compute_fmaps(rgbs)
            got = model.compute_fmaps(rgbs.cuda()).cpu()
        scale = float(want.abs().max())
        d = (got - want).abs() / scale
        print(f"encoder feature maps {tuple(want.shape)}, card vs CPU over the largest entry ({scale:.3e}): "
              f"median {float(d.median()):.2e} max {float(d.max()):.2e}", flush=True)
        want = build_support_grid_points(depths, intrs, extrs, 5)
        got = build_support_grid_points(depths.cuda(), intrs.cuda(), extrs.cuda(), 5).cpu()
        print(f"support points {tuple(want.shape)}, card vs CPU: max {float((got - want).abs().max()):.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
