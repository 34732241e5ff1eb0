"""Port parity of the demo (`mvtracker_torch/cli/demo.py`) against the JAX
package's `demo.py` on the CPU: the synthetic scene tracked by the flagship
`MVTracker` (fp32, both packages' default) with the same weights, the JAX
side's own PRNGKey(0) init given to the port as a `step_1.pt` checkpoint;
the sample loader, the depth sources and the mosaic; the device rule."""

import os

import numpy as np
import pytest
import torch

import demo as j_demo
from mvtracker_torch import convert
from mvtracker_torch.cli import demo as t_demo
from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.training import step as step_lib
from mvtracker_torch.training.train import TrainConfig, Trainer

# The forward parity tests' limits (tests/test_torch_mvtracker.py), over 3
# times the larger reading of `scripts/control_torch_north_star.py --tests`
# (CPU, the flagship at fp32, 8 frames, 1 iteration): port against JAX traj
# max 9.54e-7, vis max 2.21e-5; the control (the queries moved by up to 1e-6)
# traj max 1.01e-6, vis max 5.96e-8.
DEMO_TRAJ_ATOL = 1e-4
DEMO_VIS_ATOL = 1e-4
DEMO_ARGS = ["--synthetic", "--max_frames", "8", "--iters", "1"]


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_cache_kept(monkeypatch):
    """The JAX demo points JAX's compilation cache at the repo; the suite's
    own cache (tests/conftest.py) stays in force."""
    import mvtracker_tpu

    monkeypatch.setattr(mvtracker_tpu, "enable_compilation_cache", lambda path=None: None)


def jax_demo_params():
    """The JAX demo's random init: PRNGKey(0), `iters=1`, on the first
    frames of the synthetic scene (the values do not depend on the input)."""
    import jax
    import jax.numpy as jnp

    from mvtracker_tpu.datasets.synthetic import render_scene
    from mvtracker_tpu.models.mvtracker import MVTracker as JaxMVTracker

    sc = render_scene(seed=0, n_views=2, n_frames=12, height=128, width=128, n_tracks=64)
    q = sc.query_points_3d[sc.query_points_3d[:, 0] < 8].copy()
    q[:, 0] = np.minimum(q[:, 0], 7)
    model = JaxMVTracker()
    return jax.jit(lambda k, *a: model.init(k, *a, iters=1))(
        jax.random.PRNGKey(0), jnp.asarray(sc.video[:, :8]), jnp.asarray(sc.videodepth[:, :8]), jnp.asarray(q),
        jnp.asarray(sc.intrs[:, :8]), jnp.asarray(sc.extrs[:, :8]))


def save_port_checkpoint(exp_dir, state_dict, step=1):
    model = MVTracker(device="cpu")
    model.load_state_dict(state_dict)
    trainer = Trainer(model, TrainConfig(exp_dir=str(exp_dir), tensorboard=False, watchdog_timeout_s=0))
    trainer.save(step_lib.init_state(model, trainer.optimizer), step)


def test_demo_matches_jax(tmp_path, jax_cache_kept):
    params = jax_demo_params()
    save_port_checkpoint(tmp_path / "exp", convert.params_from_flax(params))
    j_demo.main(DEMO_ARGS + ["--out", str(tmp_path / "j.npz")])
    got = t_demo.main(DEMO_ARGS + ["--out", str(tmp_path / "t.npz"), "--ckpt_dir", str(tmp_path / "exp"),
                                   "--device", "cpu"])
    want = np.load(tmp_path / "j.npz")
    saved = np.load(tmp_path / "t.npz")
    assert sorted(saved.files) == sorted(want.files) == ["query_points", "traj_e", "vis_e"]
    for key in saved.files:
        np.testing.assert_array_equal(saved[key], got[key])
    np.testing.assert_array_equal(saved["query_points"], want["query_points"])
    assert saved["traj_e"].shape == want["traj_e"].shape == (8, len(want["query_points"]), 3)
    np.testing.assert_allclose(saved["traj_e"], want["traj_e"], atol=DEMO_TRAJ_ATOL, rtol=0)
    np.testing.assert_allclose(saved["vis_e"], want["vis_e"], atol=DEMO_VIS_ATOL, rtol=0)


def write_sample(path, channels_first):
    """A small sample in the reference demo's NPZ layout: rgb in 0..1,
    per-view intrinsics and extrinsics, a query past frame 3."""
    from mvtracker_torch.datasets.synthetic import render_scene

    sc = render_scene(seed=4, n_views=2, n_frames=5, height=32, width=32, n_tracks=6)
    rgbs = sc.video / 255.0
    if channels_first:
        rgbs = rgbs.transpose(0, 1, 4, 2, 3)
    query = sc.query_points_3d.copy()
    query[0, 0] = 4
    np.savez(path, rgbs=rgbs, depths=sc.videodepth[:, :, None], intrs=sc.intrs[:, 0], extrs=sc.extrs[:, 0],
             query_points=query)
    return sc


@pytest.mark.parametrize("channels_first", [True, False])
def test_load_sample_matches_jax(tmp_path, channels_first):
    write_sample(tmp_path / "s.npz", channels_first)
    for got, want in zip(t_demo.load_sample(str(tmp_path / "s.npz")), j_demo.load_sample(str(tmp_path / "s.npz"))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["gt", "est", "fusion"])
def test_demo_sample_depth_sources_and_mosaic(tmp_path, source):
    """The sample path with `--max_frames` (the query past the cut dropped),
    each depth source and the mosaic, with seeded weights (no `--ckpt_dir`)."""
    sc = write_sample(tmp_path / "s.npz", channels_first=True)
    est = sc.videodepth * 1.02
    np.savez(tmp_path / "est.npz", depth=est, conf=np.full_like(est, 0.5))
    base = ["--sample", str(tmp_path / "s.npz"), "--max_frames", "4", "--iters", "1", "--device", "cpu"]
    extra = [] if source == "gt" else ["--depth_source", source, "--depth_est", str(tmp_path / "est.npz")]
    got = t_demo.main(base + extra + ["--out", str(tmp_path / "out.npz"), "--mp4", str(tmp_path / "tracks.mp4")])
    assert len(got["query_points"]) == len(sc.query_points_3d) - 1
    assert got["traj_e"].shape == (4, len(got["query_points"]), 3) and np.isfinite(got["traj_e"]).all()
    assert [f for f in os.listdir(tmp_path) if f.startswith("tracks")]
    if source != "gt":
        # The model saw the chosen depth: it moves the tracks off the sensor depth's.
        sensor = t_demo.main(base + ["--out", str(tmp_path / "gt.npz")])
        assert not np.array_equal(sensor["traj_e"], got["traj_e"])


def test_demo_needs_its_device(tmp_path):
    """`--device` is cuda by default, which raises where there is no GPU
    instead of falling back to the CPU; an estimate-less depth source is
    refused."""
    write_sample(tmp_path / "s.npz", channels_first=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_demo.main(["--sample", str(tmp_path / "s.npz"), "--out", str(tmp_path / "x.npz")])
    with pytest.raises(SystemExit):
        t_demo.main(["--sample", str(tmp_path / "s.npz"), "--depth_source", "est", "--device", "cpu"])
