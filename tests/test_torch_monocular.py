"""Port parity on the CPU for the monocular family: `pick_best_view`, the
multi-view adapter's selection and lift, the NCC template tracker, the hub
wrappers (mocked predictors), `MonocularProxyDataset` and the TAP-Vid
loader, each against the JAX package on the same inputs (exact, or 1e-6
for lifted floats)."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.datasets import tapvid as t_tapvid
from mvtracker_torch.datasets.loader import MonocularProxyDataset
from mvtracker_torch.models import hub_baselines as t_hub
from mvtracker_torch.models import monocular as t_mono
from mvtracker_tpu.datasets import loader as j_loader
from mvtracker_tpu.datasets import synthetic as j_synth
from mvtracker_tpu.datasets import tapvid as j_tapvid
from mvtracker_tpu.models import monocular as j_mono
from tests.test_hub_baselines import _mock_loader_offline, _mock_loader_online

# Lifted world points. The slice's limit is 1e-6, but the JAX adapter's own
# output moves further when its inputs move by one float32 ulp: the pixel a
# query projects to comes out of a 3-vector product whose summation order
# differs between XLA and PyTorch by an ulp (3.8e-6 px here), and a depth
# edge turns that into world units. Control (`test_lift_control`): the JAX
# adapter with every query coordinate one ulp up moves by 1.2e-5 (one ulp
# down: 1.2e-5); the port's gap on the same scene is 1.2e-5. Held to about
# twice the control.
LIFT_ATOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    """The JAX adapter tests' scene."""
    return j_synth.render_scene(seed=5, n_views=3, n_frames=5, height=48, width=64, n_tracks=10)


def scene_args(dp):
    return [np.asarray(a, np.float32) for a in (dp.video, dp.videodepth, dp.query_points_3d, dp.intrs, dp.extrs)]


def test_pick_best_view_matches_jax(scene):
    _, depths, query, intrs, extrs = scene_args(scene)
    # A query behind every camera and one at no depth fall back to view 0.
    query = np.concatenate([query, [[1, 0.0, 0.0, -40.0], [2, 1e3, 1e3, 1e3]]]).astype(np.float32)
    want_view, want_pix = j_mono.pick_best_view(*(jnp.asarray(a) for a in (query, depths, intrs, extrs)))
    view, pix = t_mono.pick_best_view(*(torch.from_numpy(a) for a in (query, depths, intrs, extrs)))
    np.testing.assert_array_equal(view.numpy(), np.asarray(want_view))
    np.testing.assert_allclose(pix.numpy(), np.asarray(want_pix), atol=1e-4)  # pixels, values up to 1e3
    assert view[-2:].tolist() == [0, 0]
    assert len(set(view.tolist())) > 1  # the queries spread over several views


def test_adapter_lift_matches_jax(scene):
    """Identity 2D tracker (each query stays on its pixel): selection and
    lift through depth alone, against JAX's."""
    args = scene_args(scene)

    def identity(rgbs, queries):
        t, m = rgbs.shape[0], queries.shape[0]
        if torch.is_tensor(queries):
            return queries[None, :, 1:].expand(t, m, 2), torch.ones(t, m)
        return jnp.broadcast_to(queries[None, :, 1:], (t, m, 2)), jnp.ones((t, m))

    want = j_mono.MonocularToMultiViewAdapter(identity)(*(jnp.asarray(a) for a in args))
    got = t_mono.MonocularToMultiViewAdapter(identity, device="cpu")(*args)
    np.testing.assert_allclose(got["traj"].numpy(), np.asarray(want["traj"]), atol=LIFT_ATOL)
    np.testing.assert_array_equal(got["vis"].numpy(), np.asarray(want["vis"]))
    np.testing.assert_array_equal(got["occluded"].numpy(), np.asarray(want["occluded"]))
    assert t_mono.MonocularToMultiViewAdapter.jit_compatible is False


def test_lift_control(scene):
    """The control behind LIFT_ATOL: the JAX adapter against itself with the
    queries one ulp up, identity 2D tracker."""
    args = scene_args(scene)

    def identity(rgbs, queries):
        t, m = rgbs.shape[0], queries.shape[0]
        return jnp.broadcast_to(queries[None, :, 1:], (t, m, 2)), jnp.ones((t, m))

    adapter = j_mono.MonocularToMultiViewAdapter(identity)
    want = np.asarray(adapter(*(jnp.asarray(a) for a in args))["traj"])
    args[2][:, 1:] = np.nextafter(args[2][:, 1:], np.float32(np.inf))
    moved = np.abs(np.asarray(adapter(*(jnp.asarray(a) for a in args))["traj"]) - want).max()
    assert 1e-6 < moved < LIFT_ATOL / 2, moved


@pytest.mark.parametrize("patch,search,queries", [
    (5, 4, [[0.0, 30.0, 20.0], [1.0, 40.0, 25.0]]),  # the JAX test's case
    (7, 12, None),  # the defaults; random queries, a rounded half and edge clamps among them
])
def test_ncc_tracker_matches_jax(scene, patch, search, queries):
    video = np.asarray(scene.video[0], np.float32)
    if queries is None:
        rng = np.random.default_rng(0)
        queries = np.stack([rng.integers(0, 4, 12), rng.uniform(0, 63, 12), rng.uniform(0, 47, 12)], -1)
        queries[:3, 1:] = [[10.5, 11.5], [0.0, 47.0], [63.0, 0.0]]
    queries = np.asarray(queries, np.float32)
    want_tracks, want_vis = j_mono.SimpleNNTracker2D(patch, search)(video, queries)
    tracks, vis = t_mono.SimpleNNTracker2D(patch, search)(torch.from_numpy(video), torch.from_numpy(queries))
    np.testing.assert_array_equal(tracks.numpy(), want_tracks)
    np.testing.assert_array_equal(vis.numpy(), want_vis)
    assert (tracks[1:] != tracks[:1]).any()  # the search moves some track


def test_adapter_with_ncc_matches_jax(scene):
    args = scene_args(scene)
    want = j_mono.MonocularToMultiViewAdapter(j_mono.SimpleNNTracker2D(5, 4))(*(jnp.asarray(a) for a in args))
    got = t_mono.MonocularToMultiViewAdapter(t_mono.SimpleNNTracker2D(5, 4), device="cpu")(*args)
    np.testing.assert_allclose(got["traj"].numpy(), np.asarray(want["traj"]), atol=LIFT_ATOL)
    np.testing.assert_array_equal(got["vis"].numpy(), np.asarray(want["vis"]))


def test_hub_wrappers_contract_and_registry(scene):
    """The two CoTracker wrappers with the JAX tests' mocked predictors, on
    the adapter's device, and the registry's failure modes."""
    off = t_hub.CoTrackerOfflineWrapper(grid_size=3, hub_loader=_mock_loader_offline, device="cpu")
    rgbs = np.zeros((5, 16, 16, 3), np.float32)
    queries = np.array([[0, 4.0, 5.0], [1, 8.0, 2.0]], np.float32)
    tracks, vis = off(rgbs, queries)
    assert torch.is_tensor(tracks) and tracks.shape == (5, 2, 2) and vis.shape == (5, 2)  # support grid dropped
    np.testing.assert_allclose(tracks[3, 0].numpy(), [4.0, 5.0])
    on = t_hub.CoTrackerOnlineWrapper(hub_loader=_mock_loader_online, device="cpu")
    tracks, vis = on(np.zeros((8, 16, 16, 3), np.float32), np.array([[0, 3.0, 3.0]], np.float32))
    assert tracks.shape == (8, 1, 2)
    np.testing.assert_allclose(tracks[:, 0, 0].numpy(), 3.0)

    from mvtracker_tpu.models.hub_baselines import CoTrackerOfflineWrapper as JaxOffline

    args = scene_args(scene)
    want = j_mono.MonocularToMultiViewAdapter(JaxOffline(grid_size=2, hub_loader=_mock_loader_offline))(*args)
    got = t_mono.MonocularToMultiViewAdapter(
        t_hub.CoTrackerOfflineWrapper(grid_size=2, hub_loader=_mock_loader_offline, device="cpu"), device="cpu"
    )(*args)
    np.testing.assert_allclose(got["traj"].numpy(), np.asarray(want["traj"]), atol=LIFT_ATOL)

    assert set(t_hub._HUB_WRAPPERS) == {"cotracker3_offline", "cotracker3_online", "cotracker2_offline",
                                        "cotracker2_online"}
    assert isinstance(t_hub.load_monocular_hub_tracker("cotracker3_offline", hub_loader=_mock_loader_offline,
                                                       device="cpu"), t_hub.CoTrackerOfflineWrapper)
    with pytest.raises(NotImplementedError, match="vendored repo"):
        t_hub.load_monocular_hub_tracker("delta", device="cpu")
    with pytest.raises(KeyError):
        t_hub.load_monocular_hub_tracker("not_a_tracker", device="cpu")


def test_hub_loader_refuses_uncached_repo(tmp_path, monkeypatch):
    """Nothing cached: the default loader raises at once and never reaches
    torch.hub.load (which would go to the network)."""
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "hub"))

    def no_network(*args, **kwargs):
        raise AssertionError("torch.hub.load was called")

    monkeypatch.setattr(torch.hub, "load", no_network)
    with pytest.raises(RuntimeError, match="not cached"):
        t_hub.CoTrackerOfflineWrapper(device="cpu")


def assert_same_datapoint(got, want):
    for field in ("video", "videodepth", "intrs", "extrs", "trajectory", "visibility", "trajectory_3d",
                  "query_points_3d", "valid"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.seq_name == want.seq_name


@pytest.mark.parametrize("view", [None, 1])
def test_monocular_proxy_dataset_matches_jax(view):
    base = [j_synth.render_scene(seed=s, n_views=3, n_frames=5, height=32, width=32, n_tracks=12) for s in (0, 1, 2)]
    base[1].visibility[:, :, 0] = False  # never visible: query at frame 0
    got_ds, want_ds = MonocularProxyDataset(base, view=view), j_loader.MonocularProxyDataset(base, view=view)
    assert len(got_ds) == len(want_ds) == 3
    for i in range(3):
        assert_same_datapoint(got_ds[i], want_ds[i])


def write_tapvid(path, encoded=False, t=6, h=24, w=32, n=5):
    rng = np.random.default_rng(0)
    video = rng.integers(0, 255, size=(t, h, w, 3)).astype(np.uint8)
    points = rng.uniform(0.1, 0.9, size=(n, t, 2)).astype(np.float32)
    occluded = rng.uniform(size=(n, t)) < 0.4
    occluded[:, 0] = False
    occluded[2, :3] = True  # first visible at t=3
    if encoded:
        import imageio.v3 as iio

        video = [iio.imwrite("<bytes>", frame, extension=".png") for frame in video]
    with open(path, "wb") as f:
        pickle.dump({"seq_b": {"video": video, "points": points, "occluded": occluded},
                     "seq_a": {"video": video, "points": points[::-1].copy(), "occluded": occluded}}, f)
    return video


@pytest.mark.parametrize("query_mode", ["first", "strided"])
@pytest.mark.parametrize("encoded", [False, True])
def test_tapvid_matches_jax(tmp_path, query_mode, encoded):
    path = tmp_path / "tapvid.pkl"
    write_tapvid(path, encoded)
    depth_root = tmp_path / "depth"
    depth_root.mkdir()
    for name in ("seq_a", "seq_b"):
        np.save(depth_root / f"{name}.npy", np.random.default_rng(1).uniform(1, 3, (6, 24, 32)).astype(np.float32))
    for root in (None, str(depth_root)):
        got_ds = t_tapvid.TapVidDataset(str(path), query_mode=query_mode, depth_root=root)
        want_ds = j_tapvid.TapVidDataset(str(path), query_mode=query_mode, depth_root=root)
        assert got_ds.names == want_ds.names == ["seq_a", "seq_b"]
        for i in range(len(got_ds)):
            assert_same_datapoint(got_ds[i], want_ds[i])


def test_tapvid_query_sampling_matches_jax():
    rng = np.random.default_rng(2)
    occ = rng.random((7, 11)) < 0.5
    occ[3] = True  # never visible: dropped in "first" mode
    pts = rng.normal(size=(7, 11, 2)).astype(np.float32)
    frames = np.zeros((11, 4, 4, 3), np.float32)
    for fn, kw in ((t_tapvid.sample_queries_first, {}), (t_tapvid.sample_queries_strided, {"query_stride": 3})):
        got = fn(occ, pts, frames, **kw)
        want = getattr(j_tapvid, fn.__name__)(occ, pts, frames, **kw)
        assert set(got) == set(want)
        for key in got:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_tapvid_jpeg_frames_need_imageio(tmp_path, monkeypatch):
    """A JPEG frame goes through image_io, which raises naming it where
    imageio is missing (as on the GPU host)."""
    import builtins

    jpeg = b"\xff\xd8\xff\xe0" + bytes(16)
    real_import = builtins.__import__

    def no_imageio(name, *args, **kwargs):
        if name.startswith("imageio"):
            raise ImportError("no imageio")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    with pytest.raises(ImportError, match="frame 0: JPEG needs imageio"):
        t_tapvid.TapVidDataset._decode_video([jpeg])
