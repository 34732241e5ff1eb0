"""Port parity of the visualizers (`mvtracker_torch/viz/`) against the JAX
package's, on the same seeded inputs: the drawn frames are compared exactly,
and the files `save_video` writes byte for byte."""

import os

import numpy as np
import pytest

from mvtracker_torch.datasets import image_io
from mvtracker_torch.viz import mp4 as t_mp4
from mvtracker_torch.viz import rerun_viz as t_rr
from mvtracker_tpu.datasets import synthetic as j_synth
from mvtracker_tpu.viz import mp4 as j_mp4


@pytest.mark.parametrize("n", [1, 7, 64])
def test_rainbow_colors_match_jax(n):
    np.testing.assert_array_equal(t_mp4.rainbow_colors(n), j_mp4.rainbow_colors(n))


@pytest.mark.parametrize("kind", ["plain", "visibility", "valid", "wild"])
def test_render_tracks_matches_jax(rng, kind):
    t, h, w, n = 5, 40, 48, 6
    video = rng.integers(0, 255, (t, h, w, 3)).astype(np.float32)
    traj = rng.uniform(-5, 52, (t, n, 2))
    kw = {}
    if kind == "visibility":
        kw["visibility"] = rng.uniform(size=(t, n)) > 0.4
    elif kind == "valid":
        kw["valid"] = rng.uniform(size=(t, n)) > 0.3
        kw["trail_length"], kw["point_radius"] = 3, 2
    elif kind == "wild":  # NaN, inf and far-off projections, as the reprojection hands them over
        traj[1, 0] = np.nan
        traj[2, 1] = [np.inf, -np.inf]
        traj[3, 2] = [1e8, -3e7]
    np.testing.assert_array_equal(t_mp4.render_tracks_on_video(video, traj, **kw),
                                  j_mp4.render_tracks_on_video(video, traj, **kw))


def test_mosaic_matches_jax():
    sc = j_synth.render_scene(seed=2, n_views=3, n_frames=3, height=24, width=32, n_tracks=6)
    for cols in (1, 2, 3):
        kw = dict(visibility=sc.visibility.any(axis=0), max_cols=cols)
        got = t_mp4.render_multiview_mosaic(sc.video.astype(np.uint8), sc.trajectory_3d, sc.intrs, sc.extrs, **kw)
        want = j_mp4.render_multiview_mosaic(sc.video.astype(np.uint8), sc.trajectory_3d, sc.intrs, sc.extrs, **kw)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["behind", "nan"])
def test_mosaic_culls_like_jax(case):
    v, t, h, w, n = 1, 3, 32, 40, 2
    video = np.zeros((v, t, h, w, 3), np.uint8)
    intrs = np.tile(np.array([[40.0, 0, 20], [0, 40, 16], [0, 0, 1]]), (v, t, 1, 1))
    extrs = np.tile(np.eye(4)[:3], (v, t, 1, 1))
    traj = np.zeros((t, n, 3), np.float32)
    if case == "behind":
        traj[:, 0] = [0.0, 0.0, 2.0]
        traj[:, 1] = [0.1, 0.1, -2.0]
    else:
        traj[:] = np.nan
    got = t_mp4.render_multiview_mosaic(video, traj, intrs, extrs)
    np.testing.assert_array_equal(got, j_mp4.render_multiview_mosaic(video, traj, intrs, extrs))
    assert got.any() == (case == "behind")


def test_save_video_writes_what_jax_writes(tmp_path, rng):
    """Here imageio has no ffmpeg plugin: both fall back to the same GIF."""
    frames = rng.integers(0, 255, size=(3, 16, 16, 3)).astype(np.uint8)
    got = t_mp4.save_video(frames, str(tmp_path / "t.mp4"), fps=8)
    want = j_mp4.save_video(frames, str(tmp_path / "j.mp4"), fps=8)
    assert os.path.splitext(got)[1] == os.path.splitext(want)[1]
    assert open(got, "rb").read() == open(want, "rb").read()


def test_save_video_without_imageio_writes_npz(tmp_path, rng, monkeypatch):
    """Where imageio is absent (the GPU host) the frames go to an .npz, as
    the JAX package's fall back."""

    def absent(path, what):
        raise ImportError(f"{path}: {what} needs imageio, which is not installed here")

    monkeypatch.setattr(image_io, "_imageio", absent)
    frames = rng.integers(0, 255, size=(2, 8, 8, 3)).astype(np.uint8)
    path = t_mp4.save_video(frames, str(tmp_path / "clip.mp4"))
    assert path == str(tmp_path / "clip.mp4.npz")
    np.testing.assert_array_equal(np.load(path)["frames"], frames)
    with pytest.raises(ImportError, match="clip.mp4: video needs imageio"):
        image_io.read_video(str(tmp_path / "clip.mp4"))


def test_log_video_to_tensorboard(tmp_path):
    from torch.utils.tensorboard import SummaryWriter

    frames = np.zeros((3, 16, 16, 3), np.uint8)
    w = SummaryWriter(str(tmp_path))
    t_mp4.log_video_to_tensorboard(w, "eval/video", frames, step=1)
    w.close()
    assert any(f.startswith("events") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("fn", ["log_pointclouds", "log_tracks"])
def test_rerun_reports_its_missing_dependency(tmp_path, monkeypatch, fn):
    import builtins

    real = builtins.__import__

    def no_rerun(name, *args, **kwargs):
        if name == "rerun":
            raise ImportError("No module named 'rerun'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_rerun)
    args = {"log_pointclouds": (np.zeros((1, 1, 4, 4, 3)), np.ones((1, 1, 4, 4)), np.tile(np.eye(3), (1, 1, 1, 1)),
                                np.tile(np.eye(4)[:3], (1, 1, 1, 1))),
            "log_tracks": (np.zeros((2, 3, 3)),)}[fn]
    with pytest.raises(ImportError, match="rerun-sdk is not installed"):
        getattr(t_rr, fn)(str(tmp_path / "x.rrd"), *args)
