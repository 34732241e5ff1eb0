"""Demo CLI: track query points through a multi-view RGB-D clip on the GPU.

    python -m mvtracker_torch.cli.demo --sample sample.npz --out out.npz --mp4 out.mp4
    python -m mvtracker_torch.cli.demo --synthetic  # a procedurally generated scene

The counterpart of the repo's `demo.py` (the JAX package's demo), with its
arguments and outputs plus `--device` (default cuda; `--device cpu` runs the
plain PyTorch path):
- the sample NPZ holds the reference demo samples' keys: rgbs [V,T,3,H,W]
  or [V,T,H,W,3], depths, intrs, extrs, query_points [N,4];
- `--max_frames` cuts the clip and drops the queries that start past the cut;
- `--depth_source est|fusion` replaces the sensor depth by the first
  `--depth_est` file, or blends them (`utils/depth_fusion.fuse_depths`);
- `--chunk_frames` tracks a long video in boundary-chained segments of one
  shape (`EvaluationPredictor`);
- `--ckpt_dir` loads the flagship `MVTracker` from the newest
  `<dir>/checkpoints/step_<n>.pt` that `Trainer` wrote; without one the
  model gets seeded random weights (`convert.random_state_dict(model, 0)`)
  and a warning, where the JAX demo takes its own PRNGKey(0) init;
- the output NPZ holds the reference's keys: traj_e [T,N,3], vis_e [T,N],
  query_points [N,4]; `--mp4` renders the track mosaic (`viz/mp4.py`: an mp4
  or GIF where imageio can write one, else an .npz frame stack).
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np


def load_sample(path: str):
    data = np.load(path, allow_pickle=True)
    rgbs = np.asarray(data["rgbs"], np.float32)
    depths = np.asarray(data["depths"], np.float32)
    if rgbs.ndim == 5 and rgbs.shape[2] == 3:  # [V,T,3,H,W] -> channels-last
        rgbs = rgbs.transpose(0, 1, 3, 4, 2)
    if depths.ndim == 5:
        depths = depths[:, :, 0] if depths.shape[2] == 1 else depths.squeeze(2)
    intrs = np.asarray(data["intrs"], np.float32)
    extrs = np.asarray(data["extrs"], np.float32)
    if intrs.ndim == 3:  # [V,3,3] -> broadcast over T
        intrs = np.repeat(intrs[:, None], rgbs.shape[1], axis=1)
    if extrs.ndim == 3:
        extrs = np.repeat(extrs[:, None], rgbs.shape[1], axis=1)
    query = np.asarray(data["query_points"], np.float32)
    if rgbs.max() <= 1.0 + 1e-6:
        rgbs = rgbs * 255.0
    return rgbs, depths, query, intrs, extrs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sample", default=None, help="input NPZ")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--out", default="demo_out.npz")
    parser.add_argument("--mp4", default=None)
    parser.add_argument("--ckpt_dir", default=None, help="experiment dir with checkpoints")
    parser.add_argument("--iters", type=int, default=6)
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--chunk_frames", type=int, default=None,
                        help="track long videos in fixed segments of this many frames with boundary-position chaining "
                             "(one segment shape; bounds memory like the reference's --batch_size_frames chunking)")
    parser.add_argument("--grid_size", type=int, default=0, help="support grid size")
    parser.add_argument("--depth_source", default="gt", choices=["gt", "est", "fusion"],
                        help="gt: sensor depth; est: first --depth_est replaces it; fusion: residual-weighted blend of "
                             "sensor + all estimates")
    parser.add_argument("--depth_est", nargs="*", default=[],
                        help="NPZ files with estimated depth (key 'depth' [V,T,H,W], optional 'conf') from any external "
                             "estimator (DUSt3R/VGGT/...)")
    parser.add_argument("--device", default="cuda", help="device of the model (cuda, or cpu)")
    return parser


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch

    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.evaluation.evaluator import to_host
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import TrainConfig, Trainer

    if args.synthetic or args.sample is None:
        from mvtracker_torch.datasets.synthetic import render_scene

        sc = render_scene(seed=0, n_views=2, n_frames=12, height=128, width=128, n_tracks=64)
        rgbs, depths = sc.video, sc.videodepth
        query, intrs, extrs = sc.query_points_3d, sc.intrs, sc.extrs
    else:
        rgbs, depths, query, intrs, extrs = load_sample(args.sample)

    if args.max_frames:
        rgbs, depths = rgbs[:, : args.max_frames], depths[:, : args.max_frames]
        intrs, extrs = intrs[:, : args.max_frames], extrs[:, : args.max_frames]
        # Queries starting beyond the cut clip have no frame where their
        # stored xyz is valid: drop them rather than track phantoms.
        keep = query[:, 0] < rgbs.shape[1]
        if not keep.all():
            logging.warning("dropping %d queries starting beyond --max_frames", (~keep).sum())
            query = query[keep]

    if args.depth_source != "gt":
        estimates = []
        for path in args.depth_est:
            with np.load(path) as z:
                d = np.asarray(z["depth"], np.float32)[:, : rgbs.shape[1]]
                c = np.asarray(z["conf"], np.float32)[:, : rgbs.shape[1]] if "conf" in z else None
            estimates.append((d, c))
        if not estimates:
            parser.error(f"--depth_source {args.depth_source} needs --depth_est files")
        if args.depth_source == "est":
            depths = estimates[0][0]
            logging.info("replaced sensor depth with %s", args.depth_est[0])
        else:
            from mvtracker_torch.utils.depth_fusion import fuse_depths

            depths, fused_conf = fuse_depths(depths, estimates, rgbs)
            logging.info("fused sensor depth with %d estimate(s); mean conf %.2f", len(estimates),
                         float(fused_conf.mean()))

    model = MVTracker(device=args.device)
    latest = 0
    if args.ckpt_dir:
        trainer = Trainer(model, TrainConfig(exp_dir=args.ckpt_dir, tensorboard=False, watchdog_timeout_s=0))
        _, latest = trainer.restore_latest(step_lib.init_state(model, trainer.optimizer))
        if latest:
            logging.info("loaded checkpoint step %d", latest)
    if not latest:
        logging.warning("no checkpoint: using seeded random weights (demo plumbing only)")
        model.load_state_dict(random_state_dict(model, seed=0))
    model.eval()

    predictor = EvaluationPredictor(model, interp_shape=None, grid_size=args.grid_size, n_iters=args.iters,
                                    chunk_frames=args.chunk_frames)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = predictor(rgbs, depths, query, intrs, extrs)
    traj, vis = to_host(out["traj"]), to_host(out["vis"])
    dt = time.perf_counter() - t0
    logging.info("tracked %d points over %d frames in %.2fs (%.0f point-frames/s)", query.shape[0], rgbs.shape[1], dt,
                 query.shape[0] * rgbs.shape[1] / dt)

    np.savez(args.out, traj_e=traj, vis_e=vis, query_points=query)
    logging.info("wrote %s", args.out)

    if args.mp4:
        from mvtracker_torch.viz.mp4 import render_multiview_mosaic, save_video

        frames = render_multiview_mosaic(np.asarray(rgbs).astype(np.uint8), traj, intrs, extrs, visibility=vis > 0.5)
        written = save_video(frames, args.mp4)
        logging.info("wrote %s", written)
    return {"traj_e": traj, "vis_e": vis, "query_points": query}


if __name__ == "__main__":
    main()
