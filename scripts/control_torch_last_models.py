"""CPU controls for the card-versus-CPU limits of `chip_smoke.py` phase 13
(VGGT and the splatting renderer).

Each control runs the plain CPU path twice and reports how far the outputs
move under a change that rounding stands for (the card sums in other
orders than the CPU):

- VGGT at full width cut to 4 frame + 4 global and 2 DINOv2 blocks, S = 2
  frames at 518^2, weights seeded on the CPU by `init_weights_`: the images
  moved by 1e-6, and the model run with one intra-op thread instead of all
  (other summation orders in the matmuls and convolutions); per output the
  max |gap| over the largest |value| and the median |gap| over the median
  |value|, as phase 13 reads them;
- the flagship MVTracker (fp32, the exact kNN, seeded weights with the
  flow head x5) on phase 13's generic scene (`render_scene` seed 80, 4 x 24
  x 256^2, the frames rounded to uint8 as the PNGs hold them; 256 uniform
  queries at frame 0 and 64 k-means at frame 12): every query moved by
  1e-6; median / p90 / max of |gap| in traj and vis;
- the gaussian renderer at phase 13's size (32768 gaussians, 128^2: the
  frame over `RENDER_SHRINK`, chunk 1024) on a seeded cloud: the chunk of
  1024 against 512 (another order of the per-pixel sums), rgb / alpha /
  depth max |gap| and each gradient leaf's max |gap| over its largest
  |value|;
- the same renderer on the state phase 13's Dynamic 3DGS fit reaches at
  t=0 (the fit of frame 0 alone at phase 13's iterations, made on the card
  where there is one), every slot rendered and the free ones at opacity
  logit -1e9 as `train_segment` renders them, against view 0's image and
  foreground mask: the chunk of 1024 against 512 for the fit's L1 loss and
  for the squared loss phase 13 checks with; rgb / alpha / depth max |gap|,
  each gradient leaf's max |gap| over its largest |value|, and the pixels
  whose residual changes sign. The frame is rendered at phase 13's 128^2.

Prints one JSON line per control. `--size tiny` runs the same at a small
size in seconds; `--parts` picks some of vggt, generic, render and render_fit.

    python scripts/control_torch_last_models.py             # full size, minutes of CPU
    python scripts/control_torch_last_models.py --size tiny
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rel_gap(a, b) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    w = np.abs(np.asarray(b, np.float64))
    return {"max_rel": float(d.max() / max(w.max(), 1e-30)),
            "median_rel": float(np.median(d) / max(np.median(w), 1e-30))}


def control_vggt(torch, size):
    from mvtracker_torch.models import vggt

    if size == "tiny":
        cfg, hw = vggt.tiny_config(patch_embed="dinov2"), (56, 56)
    else:
        cfg, hw = dataclasses.replace(vggt.VGGTConfig(), depth=4, vit_depth=2), (518, 518)
    model = vggt.init_weights_(vggt.VGGT(cfg, device="cpu"), seed=1).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(1, 2, *hw, 3)).astype(np.float32))
    keys = ("pose_enc", "extrinsics", "intrinsics", "depth", "depth_conf", "world_points", "world_points_conf")
    threads = torch.get_num_threads()
    with torch.no_grad():
        t0 = time.perf_counter()
        base = model(x)
        seconds = time.perf_counter() - t0
        moved = model(x + 1e-6)
        torch.set_num_threads(1)
        try:
            one = model(x)
        finally:
            torch.set_num_threads(threads)
    return {"control": "vggt", "size": size, "cpu_s": round(seconds, 1),
            "images+1e-6": {k: rel_gap(moved[k], base[k]) for k in keys},
            "one_thread": {k: rel_gap(one[k], base[k]) for k in keys}}


def gap(a, b) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return {"median": float(np.median(d)), "p90": float(np.quantile(d, 0.9)), "max": float(d.max())}


def control_generic(torch, size):
    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.datasets import synthetic
    from mvtracker_torch.evaluation.query_sampling import SamplingSpec, sample_queries_from_depth
    from mvtracker_torch.models.mvtracker import MVTracker

    v, t, h, w, n_uniform, n_kmeans = (4, 24, 256, 256, 256, 64) if size == "full" else (2, 8, 64, 64, 16, 8)
    dp = synthetic.render_scene(seed=80, n_views=v, n_frames=t, height=h, width=w, n_tracks=256)
    video = dp.video.astype(np.uint8).astype(np.float32)
    queries = sample_queries_from_depth(dp.videodepth, dp.intrs, dp.extrs,
                                        [SamplingSpec(frame=0, count=n_uniform),
                                         SamplingSpec(frame=t // 2, count=n_kmeans, method="kmeans")])
    model = MVTracker(device="cpu").eval()
    sd = random_state_dict(model, seed=1)
    for name in sd:
        if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
            sd[name] = sd[name] * 5.0
    model.load_state_dict(sd)
    model.knn_backend = "exact"
    outs = []
    with torch.no_grad():
        for q in (queries, queries + np.float32(1e-6) * (np.arange(4) > 0)):
            args = [torch.from_numpy(np.asarray(a, np.float32)) for a in (video, dp.videodepth, q, dp.intrs, dp.extrs)]
            t0 = time.perf_counter()
            outs.append(model(*args, iters=4))
            seconds = time.perf_counter() - t0
    return {"control": "generic", "size": size, "cpu_s": round(seconds, 1), "queries+1e-6": {
        k: gap(outs[1][k], outs[0][k]) for k in ("traj", "vis")}}


def control_render(torch, size):
    import chip_smoke as smoke
    from mvtracker_torch.ops import gsplat

    shrink = smoke.RENDER_SHRINK
    n, w, h = (32768, smoke.W // shrink, smoke.H // shrink) if size == "full" else (2048, 64, 64)
    rng = np.random.default_rng(0)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n)], -1)
    inputs = [means, rng.normal(size=(n, 4)), rng.uniform(-4.5, -3.0, (n, 3)), rng.normal(0, 2, n),
              rng.uniform(size=(n, 6))]
    inputs = [torch.from_numpy(a.astype(np.float32)) for a in inputs]
    f = 0.8 * w
    intr = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    w2c = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]])
    target = torch.from_numpy(rng.uniform(size=(h, w, 4)).astype(np.float32))
    outs = []
    for chunk in (1024, 512):
        leaves = [a.clone().requires_grad_(True) for a in inputs]
        out = gsplat.render_gaussians(*leaves, intr, w2c, (w, h), chunk=chunk)
        loss = (out.rgb[..., :4] - target).square().mean() + out.depth.mean() + out.alpha.mean()
        outs.append((out, torch.autograd.grad(loss, leaves)))
    (a, ga), (b, gb) = outs
    return {"control": "render", "size": size, "chunk 1024 vs 512": {
        **{k: float((getattr(a, k) - getattr(b, k)).detach().abs().max()) for k in ("rgb", "alpha", "depth")},
        "grads_max_rel": [rel_gap(x, y)["max_rel"] for x, y in zip(ga, gb)]}}


def control_render_fit(torch, size):
    import chip_smoke as smoke
    from mvtracker_torch.datasets import synthetic
    from mvtracker_torch.models import dynamic3dgs as d3
    from mvtracker_torch.ops import gsplat

    if size == "full":
        v, h, w = smoke.V, smoke.H, smoke.W
        cfg = d3.D3DGSConfig(iters_first=smoke.D3_ITERS_FIRST, segment_iters=smoke.D3_SEGMENT,
                             densify_start=smoke.D3_DENSIFY_START)
    else:
        v, h, w = 2, 64, 64
        cfg = d3.D3DGSConfig(capacity=2048, iters_first=4, segment_iters=2, densify_start=2)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dp = synthetic.render_scene(seed=smoke.GENERIC_SEED, n_views=v, n_frames=smoke.T, height=h, width=w,
                                n_tracks=smoke.N_QUERIES)
    xyz, rgb, is_fg = smoke.frame_cloud(torch, dp, 0, 1, dev)
    video01 = (dp.video[:, :1] / 255.0).astype(np.float32)
    seg = (dp.segmentation[:, :1] > 1).astype(np.float32)
    fitted = d3.fit_scene(video01, seg, dp.intrs[:, 0], dp.extrs[:, 0], xyz, rgb, is_fg, cfg, seed=0, device=dev)
    inputs, target = smoke.fit_render_inputs(fitted, video01, seg)
    # The render at phase 13's size: the frame over RENDER_SHRINK at full size.
    shrink = smoke.RENDER_SHRINK if size == "full" else 1
    target = torch.from_numpy(target[::shrink, ::shrink])
    intr, w2c = torch.from_numpy(dp.intrs[0, 0]).clone(), torch.from_numpy(dp.extrs[0, 0])
    intr[:2] /= shrink
    runs = []
    t0 = time.perf_counter()
    for chunk in (1024, 512):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
        out = gsplat.render_gaussians(*leaves, intr, w2c, (w // shrink, h // shrink), chunk=chunk)
        resid = out.rgb[..., :4] - target
        rest = out.depth.mean() + out.alpha.mean()
        l1 = torch.autograd.grad(gsplat.abs_(resid).mean() + rest, leaves, retain_graph=True)
        sq = torch.autograd.grad(resid.square().mean() + rest, leaves)
        runs.append((out, resid.detach() >= 0, l1, sq))
    (out_a, sign_a, l1_a, sq_a), (out_b, sign_b, l1_b, sq_b) = runs
    return {"control": "render_fit", "size": size, "fit_device": dev.type, "cpu_s": round(time.perf_counter() - t0, 1),
            "active": int(fitted["active"].sum()), "capacity": cfg.capacity, "render": [w // shrink, h // shrink],
            "chunk 1024 vs 512": {
                **{k: float((getattr(out_a, k) - getattr(out_b, k)).detach().abs().max())
                   for k in ("rgb", "alpha", "depth")},
                "l1_grads_max_rel": [rel_gap(x, y)["max_rel"] for x, y in zip(l1_a, l1_b)],
                "square_grads_max_rel": [rel_gap(x, y)["max_rel"] for x, y in zip(sq_a, sq_b)],
                "residual_sign_flips": int((sign_a != sign_b).sum())}}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", choices=("full", "tiny"), default="full")
    parser.add_argument("--parts", default="vggt,generic,render,render_fit")
    args = parser.parse_args(argv)
    import torch

    for part in args.parts.split(","):
        result = {"vggt": control_vggt, "generic": control_generic, "render": control_render,
                  "render_fit": control_render_fit}[part](torch, args.size)
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
