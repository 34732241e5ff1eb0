"""Port parity of the DROID episode path on the CPU: the synthetic episode
(`droid/synth_episode.py`), its loader (`datasets/droid.py`), the wrist
refinement (`droid/refine.py`), the reprojection (`droid/reproject.py`) and
`cli.droid` (`render`, `reproject`, `refine`, `track`) against the JAX
package's, on the same files. Host numpy is compared exactly; the tracker's
outputs within the forward parity tests' tolerance."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mvtracker_torch.cli import droid as t_cli
from mvtracker_torch.datasets import droid as t_droid
from mvtracker_torch.datasets import image_io
from mvtracker_torch.droid import depth_video as t_dv
from mvtracker_torch.droid import refine as t_refine
from mvtracker_torch.droid import reproject as t_rp
from mvtracker_torch.droid import synth_episode as t_se
from mvtracker_tpu.cli import droid as j_cli
from mvtracker_tpu.datasets import droid as j_droid
from mvtracker_tpu.droid import refine as j_refine
from mvtracker_tpu.droid import reproject as j_rp
from mvtracker_tpu.droid import synth_episode as j_se
from tests.test_droid_refine import Z_TRUE, refine_episode  # noqa: F401  (fixture)
from tests.test_torch_mvtracker import TRAJ_ATOL, VIS_ATOL

EPISODE = dict(seed=0, n_frames=6, n_external_cams=2, width=64, height=48, num_track_points=4)


def assert_same_datapoint(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, (f.name, x.dtype, y.dtype, x.shape, y.shape)
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    """The same synthetic episode built by the port and by the JAX package."""
    root = tmp_path_factory.mktemp("droid_episode")
    built = {"t": t_se.build_episode(str(root / "t"), **EPISODE), "j": j_se.build_episode(str(root / "j"), **EPISODE)}
    return root, built


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_synthetic_episode_matches_jax(episodes):
    """Raw episode, FK outputs and rendered recordings: the same files with
    the same contents (the depth videos decoded, their codecs differ)."""
    root, built = episodes
    assert _files(root / "t") == _files(root / "j")
    for rel in _files(root / "t"):
        a, b = root / "t" / rel, root / "j" / rel
        if rel.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), rel
        elif rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files), rel
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{rel}:{k}")
        elif rel.endswith(".mkv"):
            np.testing.assert_array_equal(t_dv.read_depth_video(str(a)), t_dv.read_depth_video(str(b)), err_msg=rel)
    # Idempotent, as the JAX package's: a second call returns the directory.
    assert t_se.build_episode(str(root / "t"), **EPISODE) == built["t"]


@pytest.mark.parametrize("max_frames,cams", [(None, None), (4, None), (None, ["200", "100"])])
def test_load_droid_episode_matches_jax(episodes, max_frames, cams):
    _, built = episodes
    ep = built["j"]
    assert t_droid.episode_camera_ids(ep) == j_droid.episode_camera_ids(ep)
    assert_same_datapoint(t_droid.load_droid_episode(ep, max_frames, cams),
                          j_droid.load_droid_episode(ep, max_frames, cams))


def test_other_recording_layouts(episodes, tmp_path):
    """rgb_*.png frames (the port's PNG reader) and depth.npz load as the JAX
    package loads them; an rgb.mp4 goes through imageio only."""
    _, built = episodes
    ep = str(tmp_path / "ep")
    shutil.copytree(built["j"], ep)
    cam = os.path.join(ep, "recordings", "100")
    rgb = np.load(os.path.join(cam, "rgb.npz"))["rgb"]
    os.remove(os.path.join(cam, "rgb.npz"))
    for i, frame in enumerate(rgb):
        image_io.write_png(os.path.join(cam, f"rgb_{i:05d}.png"), frame)
    depth = t_dv.read_depth_video(os.path.join(cam, "depth.mkv"))
    os.remove(os.path.join(cam, "depth.mkv"))
    np.savez_compressed(os.path.join(cam, "depth.npz"), depth=depth)
    assert_same_datapoint(t_droid.load_droid_episode(ep), j_droid.load_droid_episode(ep))
    for f in os.listdir(cam):
        if f.startswith("rgb_"):
            os.remove(os.path.join(cam, f))
    with open(os.path.join(cam, "rgb.mp4"), "wb") as f:
        f.write(b"\0\0\0\x18ftypmp42")
    assert t_droid.episode_camera_ids(ep) == j_droid.episode_camera_ids(ep)
    with pytest.raises(Exception):
        t_droid.load_droid_episode(ep)


def test_datasets_match_jax(episodes):
    _, built = episodes
    processed = os.path.dirname(built["j"])
    for kw in ({}, {"max_frames": 3}):
        a, b = t_droid.DroidEpisodeDataset(processed, **kw), j_droid.DroidEpisodeDataset(processed, **kw)
        assert len(a) == len(b) == 1
        assert_same_datapoint(a[0], b[0])
    for scale in ("auto", 2.0, 1.0):
        a = t_droid.DroidTrainDataset(processed, world_scale=scale)[0]
        b = j_droid.DroidTrainDataset(processed, world_scale=scale)[0]
        assert_same_datapoint(a, b)
    dp = t_droid.load_droid_episode(built["j"])
    assert_same_datapoint(t_droid.scale_datapoint_world(dp, 3.7), j_droid.scale_datapoint_world(dp, 3.7))
    with pytest.raises(FileNotFoundError):
        t_droid.DroidEpisodeDataset(os.path.dirname(processed) + "/raw")


def test_training_batch_matches_jax(episodes):
    """DROID Datapoints through the port's collate are the JAX package's batch."""
    from mvtracker_torch.datasets.datapoint import collate as t_collate
    from mvtracker_tpu.datasets.datapoint import collate as j_collate

    _, built = episodes
    a = t_collate([t_droid.DroidTrainDataset(os.path.dirname(built["j"]))[0]])
    b = j_collate([j_droid.DroidTrainDataset(os.path.dirname(built["j"]))[0]])
    assert sorted(a) == sorted(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# The search's numerics (kNN distances, normals' eigenvectors) round
# differently in JAX and PyTorch. On the refine fixture (3 cm injected, 96^2
# analytic renders) the two offsets land 2.8e-6 m apart with equal fitness;
# the limit is the golden-section search's own tolerance, 1e-5 m.
REFINE_Z_ATOL = 1e-5
REFINE_FIT_ATOL = 1e-3


def test_refine_matches_jax(refine_episode, tmp_path):  # noqa: F811
    eps = {}
    for name in ("t", "j"):
        eps[name] = str(tmp_path / name)
        shutil.copytree(refine_episode, eps[name])
    # The JAX test's settings: the analytic scene sits meters from its cameras.
    kw = dict(n_frames=3, voxel=0.02, max_corr_dist=0.1, wrist_depth_range=(0.5, 10.0),
              ext_depth_range=(0.5, 10.0), write=True)
    got = t_refine.refine_episode_wrist_z(eps["t"], device="cpu", **kw)
    want = j_refine.refine_episode_wrist_z(eps["j"], **kw)
    assert got["status"] == want["status"] == "ok" and got["frames_used"] == want["frames_used"]
    assert abs(got["wrist_z_offset_m"] - want["wrist_z_offset_m"]) <= REFINE_Z_ATOL
    assert abs(got["fitness"] - want["fitness"]) <= REFINE_FIT_ATOL
    assert abs(got["wrist_z_offset_m"] - Z_TRUE) < 1e-3
    wt, wj = (np.load(os.path.join(eps[n], "extrinsics.npz"))["wrist"] for n in ("t", "j"))
    np.testing.assert_allclose(wt, wj, atol=REFINE_Z_ATOL, rtol=0)
    dp = t_droid.load_droid_episode(refine_episode)
    cam_ids = t_droid.episode_camera_ids(refine_episode)
    kw = dict(n_frames=3, voxel=0.02, wrist_depth_range=(0.5, 10.0), ext_depth_range=(0.5, 10.0))
    a = t_refine.collect_refinement_frames(dp, cam_ids, "wrist0", **kw)
    b = j_refine.collect_refinement_frames(dp, cam_ids, "wrist0", **kw)
    assert len(a) == len(b) == 3
    for fa, fb in zip(a, b):
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    pts = np.random.default_rng(0).normal(size=(500, 3))
    np.testing.assert_array_equal(t_refine.voxel_downsample(pts, 0.3), j_refine.voxel_downsample(pts, 0.3))


def test_refine_without_wrist_reports(episodes, tmp_path):
    _, built = episodes
    ep = str(tmp_path / "ep")
    shutil.copytree(built["j"], ep)
    meta_path = os.path.join(ep, "metadata.json")
    meta = json.load(open(meta_path))
    meta["wrist_cam_serial"] = "999"
    json.dump(meta, open(meta_path, "w"))
    assert t_refine.refine_episode_wrist_z(ep, device="cpu")["status"] == "no_wrist_or_external"


def test_reproject_render_and_fuse_match_jax(episodes, rng):
    _, built = episodes
    dp = t_droid.load_droid_episode(built["j"])
    clamps = t_rp._camera_clamps(["100", "101", "200"], "200")
    assert clamps == j_rp._camera_clamps(["100", "101", "200"], "200")
    for stride in (1, 2):
        pts, cols = t_rp.fuse_frame_cloud(dp.video[:, 1], dp.videodepth[:, 1], dp.intrs[:, 1], dp.extrs[:, 1],
                                          clamps, stride=stride)
        want = j_rp.fuse_frame_cloud(dp.video[:, 1], dp.videodepth[:, 1], dp.intrs[:, 1], dp.extrs[:, 1],
                                     clamps, stride=stride)
        np.testing.assert_array_equal(pts, want[0])
        np.testing.assert_array_equal(cols, want[1])
        for vi in range(3):
            for splat in (1, 3, 5):
                a = t_rp.render_pointcloud_to_view(pts, cols, dp.intrs[vi, 1], dp.extrs[vi, 1], 48, 64, 0.01, splat)
                b = j_rp.render_pointcloud_to_view(pts, cols, dp.intrs[vi, 1], dp.extrs[vi, 1], 48, 64, 0.01, splat)
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
    empty = np.zeros((0, 3))
    for fn in (t_rp.render_pointcloud_to_view, j_rp.render_pointcloud_to_view):
        rgb, dep = fn(empty, empty, dp.intrs[0, 0], dp.extrs[0, 0], 48, 64)
        assert not rgb.any() and not dep.any()


def test_reproject_cli_matches_jax(episodes, tmp_path):
    """`cli.droid reproject --overlay_tracks`: the same cameras and kinds of
    output; the depth videos (the port's FFV1, the JAX package's OpenCV)
    decode to the same millimetres; overlays go where imageio can write."""
    _, built = episodes
    outs = {}
    for name, cli in (("t", t_cli), ("j", j_cli)):
        out = str(tmp_path / name)
        cli.main(["reproject", "--episode", built["j"], "--out", out, "--overlay_tracks", "--max_frames", "4"])
        outs[name] = out
    assert sorted(os.listdir(outs["t"])) == sorted(os.listdir(outs["j"]))
    for f in os.listdir(outs["t"]):
        a, b = os.path.join(outs["t"], f), os.path.join(outs["j"], f)
        if f.endswith(".mkv"):
            np.testing.assert_array_equal(t_dv.read_depth_video(a), t_dv.read_depth_video(b), err_msg=f)
        elif f.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b))
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), f


def test_render_cli_matches_jax(tmp_path):
    """`cli.droid render` without cached 2D tracks estimates ZED intrinsics:
    the same overlay as the JAX package's, frames read with the port's PNG
    reader."""
    ep = tmp_path / "ep"
    ep.mkdir()
    rng = np.random.default_rng(0)
    np.savez(ep / "tracks.npz", tracks_3d=rng.uniform(-0.2, 0.2, size=(4, 3, 3)) + [0, 0, 0.8])
    pose = np.eye(4)
    pose[2, 3] = -0.2
    np.savez(ep / "extrinsics.npz", external_7=pose)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(4):
        image_io.write_png(frames / f"{i:03d}.png", rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    for name, cli in (("t", t_cli), ("j", j_cli)):
        cli.main(["render", "--episode_out", str(ep), "--video", str(frames), "--camera", "7",
                  "--out", str(tmp_path / f"{name}.gif")])
    assert (tmp_path / "t.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()


@pytest.fixture(scope="module")
def flax_checkpoint(episodes):
    """The flagship's parameters as JAX's `cmd_track` initialises them
    (PRNGKey(0) on its dummy input), in a flax msgpack both CLIs read."""
    import flax.serialization
    import jax

    from mvtracker_tpu.models.mvtracker import MVTracker

    root, built = episodes
    dp = j_droid.load_droid_episode(built["j"])
    v = dp.video.shape[0]
    model = MVTracker(compute_dtype="float32")
    dummy = (np.zeros((v, 2, 64, 64, 3), np.float32), np.ones((v, 2, 64, 64), np.float32),
             np.zeros((4, 4), np.float32), dp.intrs[:, :2], dp.extrs[:, :2])
    params = jax.jit(lambda k: model.init(k, *dummy, iters=1))(jax.random.PRNGKey(0))
    path = str(root / "flagship.msgpack")
    with open(path, "wb") as f:
        f.write(flax.serialization.to_bytes(params))
    return path


@pytest.mark.parametrize("queries", ["gripper", "depth"])
def test_track_cli_matches_jax(episodes, flax_checkpoint, tmp_path, queries):
    """`cli.droid track` with the same flax weights: both query modes (the
    depth queries mask-guided), chunked into two boundary-chained segments,
    and the overlay."""
    root, built = episodes
    ep = str(tmp_path / "ep")
    shutil.copytree(built["j"], ep)
    if queries == "depth":
        mask = np.zeros((48, 64), np.float32)
        mask[:, :32] = 1.0
        np.savez_compressed(os.path.join(ep, "masks.npz"), cam100=mask)
    args = ["track", "--episode", ep, "--queries", queries, "--num_queries", "12", "--iters", "2", "--grid_size", "2",
            "--interp_shape", "64", "64", "--chunk_frames", "4", "--dtype", "float32", "--checkpoint",
            flax_checkpoint]
    t_cli.main(args + ["--out", str(tmp_path / "t.npz"), "--overlay", str(tmp_path / "t.mp4"), "--device", "cpu"])
    j_cli.main(args + ["--out", str(tmp_path / "j.npz"), "--overlay", str(tmp_path / "j.mp4")])
    got, want = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    # The depth sampler's unprojection rounds differently in JAX (its own
    # parity test holds it to 1e-6).
    np.testing.assert_allclose(got["queries"], want["queries"], atol=1e-6, rtol=0)
    assert got["traj"].shape == want["traj"].shape == (6, got["queries"].shape[0], 3)
    np.testing.assert_allclose(got["traj"], want["traj"], atol=TRAJ_ATOL, rtol=0)
    np.testing.assert_allclose(got["vis"], want["vis"], atol=VIS_ATOL, rtol=0)
    written = sorted(f for f in os.listdir(tmp_path) if f.startswith(("t.", "j.")) and not f.endswith(".npz"))
    assert written == ["j.gif", "t.gif"]
    if queries == "depth":
        # Every view samples under the one mask: each query lies in the left
        # half of the view it was drawn from.
        x = got["queries"][:, 1:]
        dp = t_droid.load_droid_episode(ep)
        cam = np.einsum("vij,nj->vni", dp.extrs[:, 0, :, :3], x) + dp.extrs[:, 0, None, :, 3]
        u = np.einsum("vij,vnj->vni", dp.intrs[:, 0], cam)[..., 0] / cam[..., 2]
        assert ((u < 32 + 1.0) & (cam[..., 2] > 0)).any(axis=0).all()


def test_track_needs_its_device(episodes, tmp_path):
    """The CLI's models run on `--device`, cuda by default, which raises
    where there is no GPU instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, built = episodes
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(["track", "--episode", built["j"], "--out", str(tmp_path / "x.npz")])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(["refine", "--episode", built["j"]])


def test_process_cli_matches_jax(tmp_path):
    from tests.test_droid import make_episode

    raw = tmp_path / "raw"
    raw.mkdir()
    make_episode(raw, t=8)
    outs = {}
    for name, cli in (("t", t_cli), ("j", j_cli)):
        cli.main(["process", "--episodes_root", str(raw), "--out", str(tmp_path / name), "-j", "1",
                  "--num_track_points", "5"])
        outs[name] = tmp_path / name / "episode_000"
    for f in ("tracks.npz", "extrinsics.npz"):
        a, b = np.load(outs["t"] / f), np.load(outs["j"] / f)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert json.load(open(outs["t"] / "quality.json")) == json.load(open(outs["j"] / "quality.json"))
