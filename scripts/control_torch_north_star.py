"""CPU controls for the card-versus-CPU limits of `chip_smoke.py` phase 16
(c), the DROID north star, and for the tolerances of the CPU parity tests of
the demo and the north-star and fine-tuning scripts.

`--phase16` (the default): phase 16's north-star episode built the same way
(`NORTH_EPISODE`), the medium model with its flags and phase 16's seeded
weights written through the port's encoder (or `--release`), fp32, exact
kNN, the world scale of the whole episode; the plain CPU path on the first
`NORTH_PLAIN_FRAMES` frames twice, the second time with every query moved
by up to 1e-6 (the card sums in other orders than the CPU; this is how far
rounding moves the outputs): median / p90 / max of |gap| in traj and vis.

`--tests`: the same control at the CPU tests' sizes (the port only), beside
the port-against-JAX readings the tests hold to their limits:
`tests/test_torch_demo.py` (the flagship on the demo's synthetic scene, the
JAX demo's weights), `tests/test_torch_scripts_droid.py` (the north star's
medians and the fine-tune's two losses on the tiny episode). Needs the JAX
package.

Prints one JSON line per control.

    python scripts/control_torch_north_star.py            # phase 16's size: about 2 minutes to build, minutes of CPU
    python scripts/control_torch_north_star.py --tests    # about 2 minutes
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def gap_stats(a, b) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return {"median": float(np.median(d)), "p90": float(np.quantile(d, 0.9)), "max": float(d.max())}


def moved(queries, seed=1):
    """Every query's xyz moved by up to 1e-6."""
    shift = np.random.default_rng(seed).uniform(-1e-6, 1e-6, queries.shape) * [0, 1, 1, 1]
    return (queries + shift).astype(np.float32)


def north_star_request(root, weights, frames, **episode):
    """The north star's model predictor on the CPU, (traj, vis) for the
    episode's first `frames` frames with the queries as they are and moved."""
    import torch

    import eval_droid_track_error_torch as north_star
    from mvtracker_torch.evaluation.evaluator import to_host

    argv = ["--root", root, "--episodes", "1", "--frames", str(episode["n_frames"]), "--width",
            str(episode["width"]), "--height", str(episode["height"]), "--external_cams",
            str(episode["n_external_cams"]), "--track_points", str(episode["num_track_points"]),
            "--params_msgpack", weights, "--device", "cpu"]
    if not episode.get("include_wrist", True):
        argv.append("--no_wrist")
    args = north_star.build_parser().parse_args(argv)
    scenes = north_star.build_scenes(args)
    scale = north_star.world_scale(args, scenes)
    model = north_star.load_model(args, torch.device("cpu"))
    model.knn_backend = "exact"
    pred = north_star.model_predictor(args, model, scale)
    dp = scenes[0]
    outs = []
    with torch.no_grad():
        for q in (dp.query_points_3d, moved(dp.query_points_3d)):
            res = pred(dp.video[:, :frames], dp.videodepth[:, :frames], q, dp.intrs[:, :frames],
                       dp.extrs[:, :frames])
            outs.append((to_host(res["traj"]), to_host(res["vis"])))
    return outs


def control_phase16(release):
    import chip_smoke
    from mvtracker_torch import convert
    from mvtracker_torch.droid.synth_episode import build_episode
    from mvtracker_torch.presets import build_model

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        build_episode(tmp, **chip_smoke.NORTH_EPISODE)
        build_s = time.perf_counter() - t0
        weights = release
        if weights is None:  # phase 16's seeded weights, through the encoder
            seeded = build_model("medium", vis_geom=True, vis_head_hidden=128, device="cpu")
            weights = os.path.join(tmp, "medium_seeded.msgpack")
            convert.save_flax_msgpack(convert.convert_reference_state_dict(convert.random_state_dict(seeded, 0)),
                                      weights)
        t0 = time.perf_counter()
        outs = north_star_request(tmp, weights, chip_smoke.NORTH_PLAIN_FRAMES, **chip_smoke.NORTH_EPISODE)
    return {"control": "north_star", "weights": "release" if release else "seeded",
            "frames": chip_smoke.NORTH_PLAIN_FRAMES, "traj": gap_stats(outs[0][0], outs[1][0]),
            "vis": gap_stats(outs[0][1], outs[1][1]), "build_seconds": round(build_s, 1),
            "seconds": round(time.perf_counter() - t0, 1)}


def control_tests():
    """The tests' controls (the port, inputs moved) and port-vs-JAX readings."""
    import torch

    torch.set_num_threads(1)
    from tests.test_torch_demo import DEMO_ARGS, jax_demo_params, save_port_checkpoint
    from tests.test_torch_scripts_droid import EPISODE, RELEASE
    from mvtracker_torch import convert
    from mvtracker_torch.droid.synth_episode import build_episode

    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        # The demo: the port with the queries moved, and the port against JAX.
        import demo as j_demo
        import mvtracker_tpu
        from mvtracker_torch.cli import demo as t_demo
        from mvtracker_torch.evaluation.evaluator import to_host
        from mvtracker_torch.evaluation.predictor import EvaluationPredictor
        from mvtracker_torch.models.mvtracker import MVTracker

        mvtracker_tpu.enable_compilation_cache = lambda path=None: None
        params = jax_demo_params()
        save_port_checkpoint(os.path.join(tmp, "exp"), convert.params_from_flax(params))
        with contextlib.redirect_stdout(io.StringIO()):
            got = t_demo.main(DEMO_ARGS + ["--out", os.path.join(tmp, "t.npz"), "--ckpt_dir",
                                           os.path.join(tmp, "exp"), "--device", "cpu"])
            j_demo.main(DEMO_ARGS + ["--out", os.path.join(tmp, "j.npz")])
        want = np.load(os.path.join(tmp, "j.npz"))
        from mvtracker_torch.datasets.synthetic import render_scene

        sc = render_scene(seed=0, n_views=2, n_frames=12, height=128, width=128, n_tracks=64)
        q = sc.query_points_3d[sc.query_points_3d[:, 0] < 8]
        model = MVTracker(device="cpu")
        model.load_state_dict(convert.params_from_flax(params))
        pred = EvaluationPredictor(model.eval(), interp_shape=None, grid_size=0, n_iters=1)
        with torch.no_grad():
            a = pred(sc.video[:, :8], sc.videodepth[:, :8], q, sc.intrs[:, :8], sc.extrs[:, :8])
            b = pred(sc.video[:, :8], sc.videodepth[:, :8], moved(q), sc.intrs[:, :8], sc.extrs[:, :8])
        lines.append({"control": "demo", "traj": gap_stats(to_host(a["traj"]), to_host(b["traj"])),
                      "vis": gap_stats(to_host(a["vis"]), to_host(b["vis"])),
                      "port_vs_jax": {"traj": gap_stats(got["traj_e"], want["traj_e"]),
                                      "vis": gap_stats(got["vis_e"], want["vis_e"])}})

        # The north star on the tests' tiny episode: its 3D errors with the
        # queries moved, and the two scripts' medians.
        root = os.path.join(tmp, "droid")
        build_episode(root, **EPISODE)
        outs = north_star_request(root, RELEASE, EPISODE["n_frames"], **EPISODE)
        lines.append({"control": "north_star_tiny", "traj": gap_stats(outs[0][0], outs[1][0]),
                      "vis": gap_stats(outs[0][1], outs[1][1]), "port_vs_jax": north_star_scripts(root, tmp)})
        lines.append({"control": "finetune_tiny", **finetune_losses(root, tmp)})
        lines.append({"control": "summaries", **summary_gaps(tmp)})
    return lines


def summary_gaps(tmp) -> dict:
    """The largest |port - JAX| over the metrics of `train_synthetic`'s
    held-out summary and `eval_reference_benchmark`'s, on the tests' inputs
    (the small preset's JAX init weights, no step)."""
    import jax
    import pytest

    from mvtracker_tpu.datasets import synthetic
    from mvtracker_tpu.presets import build_model
    from mvtracker_torch import convert
    from tests.test_kubric_loader import write_kubric_scene
    from tests.test_torch_scripts import benchmark_args, keep_jax_config, run_jax_script, run_port_script

    sc = synthetic.render_scene(seed=3, n_views=2, n_frames=6, height=32, width=32, n_tracks=8)
    model = build_model("small")
    params = jax.tree.map(np.asarray, jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), sc.video.astype(np.float32), sc.videodepth.astype(np.float32),
        sc.query_points_3d.astype(np.float32), sc.intrs.astype(np.float32), sc.extrs.astype(np.float32),
        iters=1))())
    root = Path(tmp) / "bench"
    write_kubric_scene(sc, str(root / "kubric-multiview" / "scene_000"))
    convert.save_flax_msgpack(params, str(root / "w.msgpack"))
    argv = ["--steps", "0", "--train_scenes", "1", "--eval_scenes", "1", "--views", "2", "--res", "32", "--frames",
            "6", "--n_tracks", "8", "--workers", "1", "--warm_start", str(root / "w.msgpack")]
    got = {}
    for who in ("t", "j"):
        os.makedirs(os.path.join(tmp, f"bench_{who}"))
        syn = argv + ["--exp_dir", os.path.join(tmp, f"syn_{who}"), "--out_json", os.path.join(tmp, f"syn_{who}.json")]
        bench = benchmark_args(root, "msgpack", Path(tmp) / f"bench_{who}")
        if who == "t":
            run_port_script("train_synthetic", syn)
            run_port_script("eval_reference_benchmark", bench)
        else:
            with pytest.MonkeyPatch.context() as mp:
                keep_jax_config(mp)
                run_jax_script(mp, "train_synthetic", syn)
                run_jax_script(mp, "eval_reference_benchmark", bench)
        with open(os.path.join(tmp, f"syn_{who}.json")) as f:
            syn_out = json.load(f)["ours"]
        with open(os.path.join(tmp, f"bench_{who}", "summary.json")) as f:
            bench_out = json.load(f)["summary"]
        got[who] = {("syn", k): v for k, v in syn_out.items()}
        got[who].update({("bench", g, k): v for g, vals in bench_out.items() if isinstance(vals, dict)
                         for k, v in vals.items()})
    gaps = [abs(v - got["j"][k]) for k, v in got["t"].items()
            if "fps" not in k and isinstance(v, float) and np.isfinite(v)]
    return {"metrics": len(gaps), "max": max(gaps)}


def north_star_scripts(root, tmp) -> dict:
    """|port - JAX| of the north star's three 3D errors on the tiny episode."""
    import pytest

    from tests.test_torch_scripts import keep_jax_config, run_jax_script, run_port_script
    from tests.test_torch_scripts_droid import NORTH_STAR_ARGS

    base = NORTH_STAR_ARGS + ["--root", root]
    got, _ = run_port_script("eval_droid_track_error", base + ["--out_json", os.path.join(tmp, "t.json")])
    with pytest.MonkeyPatch.context() as mp:
        keep_jax_config(mp)
        run_jax_script(mp, "eval_droid_track_error", base + ["--out_json", os.path.join(tmp, "j.json")])
    with open(os.path.join(tmp, "j.json")) as f:
        want = json.load(f)
    gaps = {k: abs(got["ours"][k] - want["ours"][k])
            for k in ("median_3d_track_error_m", "mean_3d_track_error_m", "p90_3d_track_error_m")}
    summary = [abs(v - want["ours"]["summary_all_any"][k]) for k, v in got["ours"]["summary_all_any"].items()
               if np.isfinite(v)]
    return {**gaps, "summary_max": max(summary)}


def finetune_losses(root, tmp) -> dict:
    """The fine-tune's two losses: the port with 1 and with 4 intra-op
    threads (another summation order: the control), and JAX's."""
    import pytest
    import torch

    from mvtracker_torch.training import train as t_train
    from mvtracker_tpu.evaluation import predictor as j_predictor
    from mvtracker_tpu.models.copycat import CopyCatPredictor
    from mvtracker_tpu.training import train as j_train
    from tests.test_torch_scripts import keep_jax_config, run_jax_script, run_port_script
    from tests.test_torch_scripts_droid import RELEASE, record_losses

    losses = {}
    with pytest.MonkeyPatch.context() as mp:
        keep_jax_config(mp)
        mp.setattr(j_predictor, "EvaluationPredictor", lambda *a, **kw: CopyCatPredictor())
        for who, threads in (("port_1", 1), ("port_4", 4), ("jax", 1)):
            torch.set_num_threads(threads)
            losses[who] = []
            record_losses(mp, j_train.Trainer if who == "jax" else t_train.Trainer, losses[who])
            exp = os.path.join(tmp, f"ft_{who}")
            shutil.copytree(os.path.join(root, "processed", "episode_000"),
                            os.path.join(exp, "monitor_episodes", "processed", "episode_500"))
            argv = ["--episodes_root", os.path.join(root, "processed"), "--eval_episodes", "1", "--steps", "2",
                    "--workers", "1", "--eval_every", "0", "--save_every", "2", "--warm_start", RELEASE,
                    "--exp_dir", exp]
            if who == "jax":
                run_jax_script(mp, "train_droid_ft", argv)
            else:
                run_port_script("train_droid_ft", argv)
            mp.undo()
            keep_jax_config(mp)
            mp.setattr(j_predictor, "EvaluationPredictor", lambda *a, **kw: CopyCatPredictor())
    torch.set_num_threads(1)
    rel = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a, b)]  # noqa: E731
    return {"losses": losses, "control_rel": rel(losses["port_4"], losses["port_1"]),
            "port_vs_jax_rel": rel(losses["port_1"], losses["jax"])}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tests", action="store_true", help="the CPU tests' controls instead of phase 16's")
    parser.add_argument("--release", default=None, help="phase 16 with the release weights (flax msgpack)")
    args = parser.parse_args(argv)
    lines = control_tests() if args.tests else [control_phase16(args.release)]
    for line in lines:
        print(json.dumps(line))
    return lines


if __name__ == "__main__":
    main()
