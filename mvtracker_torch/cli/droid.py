"""DROID data-factory CLI: ``python -m mvtracker_torch.cli.droid``,
counterpart of ``python -m mvtracker_tpu.cli.droid``.

Replaces the reference's shell orchestrators
(`run_pipeline_cluster_huggingface_*.sh`, `process_episodes.sh`): batch
episode processing with a worker pool, failure logs, and skip-if-exists
idempotency — as a proper CLI instead of 2k lines of bash.

    # Process all episodes under a root:
    python -m mvtracker_torch.cli.droid process --episodes_root X --out Y -j 8

    # Render tracks from a processed episode onto its videos:
    python -m mvtracker_torch.cli.droid render --episode_out Y/ep0 \
        --video path/to/rgb_video_or_dir --camera 100 --out overlay.gif

    # Wrist-camera refinement and full-episode tracking on the GPU
    # (`--device cpu` runs the plain PyTorch path):
    python -m mvtracker_torch.cli.droid refine --episode Y/ep0 --write
    python -m mvtracker_torch.cli.droid track --episode Y/ep0 --out pred.npz

`track` and `refine` compute on `--device` (default cuda, which raises
without a GPU); the other commands are host numpy. Video files are read and
written through `datasets/image_io.py` (imageio where it is installed).
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os

import torch


def cmd_process(args):
    from mvtracker_torch.droid.pipeline import process_episodes_batch

    episodes = sorted(
        d
        for d in glob.glob(os.path.join(args.episodes_root, "*"))
        if os.path.isdir(d) and os.path.exists(os.path.join(d, "trajectory.h5"))
    )
    if args.max_episodes:
        episodes = episodes[: args.max_episodes]
    logging.info("processing %d episodes with %d workers", len(episodes), args.jobs)
    results = process_episodes_batch(
        episodes,
        args.out,
        num_workers=args.jobs,
        num_track_points=args.num_track_points,
        max_frames=args.max_frames,
    )
    print(json.dumps(results))


def cmd_render(args):
    import numpy as np

    from mvtracker_torch.datasets import image_io
    from mvtracker_torch.droid.transforms import (
        estimate_zed_intrinsics,
        project_tracks_to_2d,
    )
    from mvtracker_torch.viz.mp4 import render_tracks_on_video, save_video

    if os.path.isdir(args.video):
        files = sorted(os.listdir(args.video))
        video = np.stack(
            [image_io.read_image(os.path.join(args.video, f))[..., :3] for f in files]
        )
    else:
        video = image_io.read_video(args.video)[..., :3]

    tracks = np.load(os.path.join(args.episode_out, "tracks.npz"))
    key = f"tracks_2d_{args.camera}"
    if key in tracks:
        tracks_2d = tracks[key]
    else:
        extr = np.load(os.path.join(args.episode_out, "extrinsics.npz"))
        pose = extr[f"external_{args.camera}"] if f"external_{args.camera}" in extr else extr["wrist"]
        if args.intrinsics:
            k = np.asarray(json.loads(args.intrinsics))
        else:
            # Reference fallback (`render_tracks_from_mp4.py:567-596`):
            # estimate ZED intrinsics from the actual video dimensions.
            h_v, w_v = video.shape[1:3]
            k = estimate_zed_intrinsics(w_v, h_v)
            logging.info(
                "no intrinsics given; estimated ZED K from %dx%d video "
                "(fx=%.1f)", w_v, h_v, k[0, 0],
            )
        tracks_2d = project_tracks_to_2d(
            tracks["tracks_3d"], k, pose, video.shape[2], video.shape[1]
        )
    t = min(len(video), len(tracks_2d))
    frames = render_tracks_on_video(
        video[:t], np.nan_to_num(tracks_2d[:t], nan=-1e4)
    )
    out = save_video(frames, args.out)
    logging.info("wrote %s", out)


def cmd_reproject(args):
    from mvtracker_torch.droid.reproject import reproject_episode

    out = reproject_episode(
        args.episode,
        args.out,
        max_frames=args.max_frames,
        stride=args.stride,
        splat_size=args.splat_size,
        write_depth_video=not args.no_depth_video,
        overlay_tracks=args.overlay_tracks,
    )
    print(json.dumps(out))


def cmd_refine(args):
    from mvtracker_torch.droid.refine import refine_episode_wrist_z

    out = refine_episode_wrist_z(
        args.episode,
        n_frames=args.n_frames,
        z_range=(args.z_min, args.z_max),
        voxel=args.voxel,
        max_corr_dist=args.max_corr_dist,
        write=args.write,
        device=args.device,
    )
    print(json.dumps(out))


def prepare_track(args):
    """The parts of one `track` request: (episode Datapoint, queries [N, 4],
    EvaluationPredictor around the flagship `MVTracker` on `--device`).

    Queries: ``--queries gripper`` uses the episode's FK contact-surface
    tracks' start positions; ``--queries depth`` samples from confident
    depth via the evaluator's cylinder-crop+kmeans sampler, optionally
    restricted by precomputed SAM masks (``masks.npz`` with per-camera
    boolean arrays, reference `object_detection.py` output).

    The weights come from `--checkpoint` (a flax msgpack params file, loaded
    strictly), else from `convert.random_state_dict` with seed 0.
    """
    import numpy as np

    from mvtracker_torch.convert import load_release, random_state_dict
    from mvtracker_torch.datasets.droid import load_droid_episode
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.models.mvtracker import MVTracker

    dp = load_droid_episode(args.episode, max_frames=args.max_frames)
    logging.info(
        "episode %s: %d cams x %d frames %sx%s",
        dp.seq_name, dp.video.shape[0], dp.video.shape[1],
        dp.video.shape[2], dp.video.shape[3],
    )

    if args.queries == "gripper":
        queries = dp.query_points_3d
    else:
        from mvtracker_torch.evaluation.query_sampling import (
            SamplingSpec,
            sample_queries_from_depth,
        )

        conf = None
        mask_path = os.path.join(args.episode, "masks.npz")
        if os.path.exists(mask_path):
            with np.load(mask_path) as z:
                # Per-camera masks [T, H, W] or [H, W]; mask-guided queries
                # sample only masked pixels (conf-threshold mechanism).
                masks = []
                for vi in range(dp.video.shape[0]):
                    key = sorted(z.files)[vi % len(z.files)]
                    m = np.asarray(z[key], np.float32)
                    if m.ndim == 2:
                        m = np.broadcast_to(m, dp.videodepth.shape[1:])
                    masks.append(m)
                conf = np.stack(masks)
            logging.info("mask-guided query sampling from %s", mask_path)
        queries = sample_queries_from_depth(
            dp.videodepth, dp.intrs, dp.extrs,
            [SamplingSpec(frame=0, count=args.num_queries)],
            depth_conf=conf, conf_threshold=0.5,
        )

    model = MVTracker(compute_dtype=args.dtype, device=args.device)
    if args.checkpoint:
        load_release(args.checkpoint, model)
    else:
        logging.warning("no checkpoint: random init (plumbing validation only)")
        model.load_state_dict(random_state_dict(model, seed=0))
    model.eval()

    pred = EvaluationPredictor(
        model,
        interp_shape=tuple(args.interp_shape) if args.interp_shape else None,
        grid_size=args.grid_size, n_iters=args.iters,
        chunk_frames=args.chunk_frames or None,
    )
    return dp, queries, pred


def cmd_track(args):
    """Full-episode 3D tracking (BASELINE config 3): cameras + decoded depth
    video + (optionally mask-guided) query points -> iterative refinement
    (`prepare_track`). Writes `--out` (traj, vis, queries) and, with
    `--overlay`, the track mosaic; returns the prediction dict."""
    import numpy as np

    from mvtracker_torch.evaluation.evaluator import to_host

    dp, queries, pred = prepare_track(args)
    with torch.no_grad():
        out = pred(dp.video, dp.videodepth, queries, dp.intrs, dp.extrs)
    traj, vis = to_host(out["traj"]), to_host(out["vis"])
    np.savez_compressed(args.out, traj=traj, vis=vis, queries=np.asarray(queries))
    logging.info("wrote %s (traj %s)", args.out, traj.shape)

    if args.overlay:
        from mvtracker_torch.viz.mp4 import render_multiview_mosaic, save_video

        frames = render_multiview_mosaic(
            dp.video.astype(np.uint8), traj, dp.intrs, dp.extrs, visibility=vis > 0.5,
        )
        written = save_video(frames, args.overlay)
        logging.info("wrote %s", written)
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("process")
    p.add_argument("--episodes_root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("-j", "--jobs", type=int, default=8)
    p.add_argument("--num_track_points", type=int, default=24)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--max_episodes", type=int, default=None)
    p.set_defaults(fn=cmd_process)

    r = sub.add_parser("render")
    r.add_argument("--episode_out", required=True)
    r.add_argument("--video", required=True)
    r.add_argument("--camera", default="100")
    r.add_argument("--out", default="overlay.gif")
    r.add_argument("--intrinsics", default=None, help="JSON 3x3 K (if no cached 2D tracks)")
    r.add_argument("--width", type=int, default=320)
    r.add_argument("--height", type=int, default=240)
    r.set_defaults(fn=cmd_render)

    rp = sub.add_parser(
        "reproject",
        help="fused-cloud reprojection + validation renders (the factory's "
        "visual-QA loop: reference reproject_depth_into_videos.py / "
        "render_episode_validation.py)",
    )
    rp.add_argument("--episode", required=True, help="processed episode dir")
    rp.add_argument("--out", required=True, help="output directory")
    rp.add_argument("--max_frames", type=int, default=None)
    rp.add_argument("--stride", type=int, default=2, help="cloud subsampling")
    rp.add_argument("--splat_size", type=int, default=3)
    rp.add_argument("--no_depth_video", action="store_true")
    rp.add_argument(
        "--overlay_tracks", action="store_true",
        help="also write <cam>_validation.mp4 with gripper tracks drawn on "
        "the reprojection",
    )
    rp.set_defaults(fn=cmd_reproject)

    rf = sub.add_parser(
        "refine",
        help="wrist-camera z-offset refinement via ICP against the external "
        "cameras (reference conversions/droid/utils/optimization.py "
        "optimize_wrist_camera_icp_z_only)",
    )
    rf.add_argument("--episode", required=True, help="processed episode dir")
    rf.add_argument("--n_frames", type=int, default=6)
    rf.add_argument("--z_min", type=float, default=-0.05)
    rf.add_argument("--z_max", type=float, default=0.05)
    rf.add_argument("--voxel", type=float, default=0.01)
    rf.add_argument("--max_corr_dist", type=float, default=0.05)
    rf.add_argument(
        "--write", action="store_true",
        help="apply the offset to extrinsics.npz wrist poses + quality.json",
    )
    rf.add_argument("--device", default="cuda", help="device of the search (cuda, or cpu)")
    rf.set_defaults(fn=cmd_refine)

    tk = sub.add_parser("track")
    tk.add_argument("--episode", required=True, help="processed episode dir")
    tk.add_argument("--out", default="tracks_pred.npz")
    tk.add_argument("--overlay", default=None, help="optional overlay video path")
    tk.add_argument("--queries", choices=["gripper", "depth"], default="gripper")
    tk.add_argument("--num_queries", type=int, default=256)
    tk.add_argument("--checkpoint", default=None)
    tk.add_argument("--iters", type=int, default=6)
    tk.add_argument("--grid_size", type=int, default=5)
    tk.add_argument("--interp_shape", type=int, nargs=2, default=None)
    tk.add_argument("--max_frames", type=int, default=None)
    tk.add_argument(
        "--chunk_frames", type=int, default=120,
        help="temporal segment length for long episodes (boundary-chained, "
        "one reused compiled graph); 0 tracks the episode as one graph",
    )
    tk.add_argument("--dtype", default="bfloat16")
    tk.add_argument("--device", default="cuda", help="device of the model (cuda, or cpu)")
    tk.set_defaults(fn=cmd_track)
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
