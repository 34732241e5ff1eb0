"""Port parity on the CPU for the generic-scene loader
(`mvtracker_torch/datasets/generic_scene.py`) and depth query sampling
(`mvtracker_torch/evaluation/query_sampling.py`), on the fixture of the
JAX test (`tests/test_query_sampling.py`), written with more views than 10
so the numeric sort of the view directories counts."""

import os

import imageio.v3 as iio
import numpy as np
import pytest

from mvtracker_torch.datasets import generic_scene as t_gen
from mvtracker_torch.datasets.image_io import write_png
from mvtracker_torch.evaluation import query_sampling as t_qs
from mvtracker_tpu.datasets import generic_scene as j_gen
from mvtracker_tpu.datasets import synthetic
from mvtracker_tpu.evaluation import query_sampling as j_qs

N_VIEWS = 11  # view_10 sorts after view_9 only numerically


@pytest.fixture(scope="module")
def scene():
    return synthetic.render_scene(seed=13, n_views=N_VIEWS, n_frames=3, height=48, width=64, n_tracks=8)


def write_scene(root, scene, mm_png_views=()):
    """The generic layout: cameras.npz, view_<i>/rgb/*.png, depth as .npy
    (or 16-bit millimetre PNG for `mm_png_views`), a confidence for every
    view."""
    sp = root / "scene0"
    os.makedirs(sp)
    np.savez(sp / "cameras.npz", intrinsics=scene.intrs[:, 0], extrinsics=scene.extrs[:, 0])
    conf = np.random.default_rng(0).uniform(size=scene.videodepth.shape).astype(np.float32)
    for vi in range(scene.video.shape[0]):
        vp = sp / f"view_{vi}"
        for sub in ("rgb", "depth", "depth_conf"):
            os.makedirs(vp / sub)
        for ti in range(scene.video.shape[1]):
            write_png(vp / "rgb" / f"{ti:04d}.png", scene.video[vi, ti].astype(np.uint8))
            if vi in mm_png_views:
                write_png(vp / "depth" / f"{ti:04d}.png", np.round(scene.videodepth[vi, ti] * 1000).astype(np.uint16))
            else:
                np.save(vp / "depth" / f"{ti:04d}.npy", scene.videodepth[vi, ti])
            np.save(vp / "depth_conf" / f"{ti:04d}.npy", conf[vi, ti])
    os.makedirs(root / "not_a_scene")
    return root


@pytest.mark.parametrize("normalize", [False, True])
def test_generic_scene_dataset_equals_jax(tmp_path, scene, normalize):
    root = write_scene(tmp_path / "generic", scene, mm_png_views=(3,))
    assert iio.imread(root / "scene0" / "view_3" / "depth" / "0000.png").dtype == np.uint16
    want_ds = j_gen.GenericSceneDataset(str(root), normalize_scene=normalize)
    got_ds = t_gen.GenericSceneDataset(str(root), normalize_scene=normalize)
    assert got_ds.seq_names == want_ds.seq_names == ["scene0"]
    want, got = want_ds[0], got_ds[0]
    np.testing.assert_array_equal(got.video, want.video)
    np.testing.assert_array_equal(got.video, scene.video.astype(np.uint8).astype(np.float32))
    np.testing.assert_array_equal(got.videodepthconf, want.videodepthconf)
    np.testing.assert_array_equal(got.intrs, want.intrs)
    if normalize:
        np.testing.assert_allclose(got.videodepth, want.videodepth, rtol=1e-5)
        np.testing.assert_allclose(got.extrs, want.extrs, atol=1e-5)
        assert not np.allclose(got.extrs, scene.extrs)
    else:
        np.testing.assert_array_equal(got.videodepth, want.videodepth)
        np.testing.assert_array_equal(got.extrs, want.extrs)
        np.testing.assert_array_equal(got.extrs, scene.extrs)  # view_10 paired with camera row 10
        np.testing.assert_allclose(got.videodepth[3], scene.videodepth[3], atol=5e-4)  # millimetre PNG
    assert got.trajectory_3d is None  # unlabeled


def test_view_subset_and_max_frames(tmp_path, scene):
    root = write_scene(tmp_path / "generic", scene)
    got = t_gen.GenericSceneDataset(str(root), view_subset=[10, 2], max_frames=2)[0]
    want = j_gen.GenericSceneDataset(str(root), view_subset=[10, 2], max_frames=2)[0]
    np.testing.assert_array_equal(got.video, want.video)
    np.testing.assert_array_equal(got.extrs, scene.extrs[[10, 2], :2])


def test_scene_normalization_and_camera_alignment(scene):
    got = t_gen.estimate_scene_normalization(scene.videodepth, scene.intrs, scene.extrs)
    want = j_gen.estimate_scene_normalization(scene.videodepth, scene.intrs, scene.extrs)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    # Estimated cameras: the ground truth's under a known similarity.
    gt = scene.extrs[:, 0].astype(np.float64)
    s, ang = 0.7, 0.4
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    tr = np.array([0.3, -0.2, 0.5])
    # x_est = (R^T (x_gt - t)) / s, so an estimated camera is E_gt applied after the inverse map.
    est = np.empty_like(gt)
    for vi in range(len(gt)):
        rot, tv = gt[vi, :, :3], gt[vi, :, 3]
        est[vi, :, :3] = rot @ r
        est[vi, :, 3] = (rot @ tr + tv) / s
    got = t_gen.align_estimated_cameras_to_gt(est, gt)
    want = j_gen.align_estimated_cameras_to_gt(est, gt)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-9)
    np.testing.assert_allclose(got[0], s, rtol=1e-6)
    np.testing.assert_allclose(got[1], r, atol=1e-6)
    np.testing.assert_allclose(got[2], tr, atol=1e-6)


def test_uniform_sampling_equals_jax(scene):
    """The cylinder crop and the uniform draw (JAX's generator): the same
    points in the same order."""
    conf = np.random.default_rng(1).uniform(size=scene.videodepth.shape).astype(np.float32)
    specs = [t_qs.SamplingSpec(frame=0, count=40, radius=1.2, zmin=0.2, zmax=2.0, center_xy=(0.1, -0.1)),
             t_qs.SamplingSpec(frame=2, count=10_000)]
    jspecs = [j_qs.SamplingSpec(**vars(s)) for s in specs]
    got = t_qs.sample_queries_from_depth(scene.videodepth, scene.intrs, scene.extrs, specs, depth_conf=conf,
                                         conf_threshold=0.3, stride=4, seed=5)
    want = j_qs.sample_queries_from_depth(scene.videodepth, scene.intrs, scene.extrs, jspecs, depth_conf=conf,
                                          conf_threshold=0.3, stride=4, seed=5)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    first = got[got[:, 0] == 0]
    assert len(first) == 40
    assert (np.hypot(first[:, 1] - 0.1, first[:, 2] + 0.1) < 1.2).all()
    assert ((first[:, 3] >= 0.2) & (first[:, 3] <= 2.0)).all()
    empty = [t_qs.SamplingSpec(frame=1, zmin=50.0)]
    assert t_qs.sample_queries_from_depth(scene.videodepth, scene.intrs, scene.extrs, empty).shape == (0, 4)


def test_kmeans_sampling_against_sklearn(scene):
    """The numpy k-means: the count asked for, centres inside the crop, and
    inertia within 5 percent of scikit-learn's on the same points."""
    from sklearn.cluster import KMeans

    spec = t_qs.SamplingSpec(frame=1, count=24, radius=1.5, method="kmeans")
    q = t_qs.sample_queries_from_depth(scene.videodepth, scene.intrs, scene.extrs, [spec], stride=2, seed=3)
    assert q.shape == (24, 4) and (q[:, 0] == 1).all()
    assert (np.hypot(q[:, 1], q[:, 2]) < 1.5).all()
    pts = t_qs.sample_queries_from_depth(scene.videodepth, scene.intrs, scene.extrs,
                                         [t_qs.SamplingSpec(frame=1, count=10**6, radius=1.5)], stride=2)[:, 1:]
    assert len(pts) > 200
    _, inertia = t_qs.kmeans(pts, 24, seed=3)
    ref = KMeans(n_clusters=24, n_init="auto", random_state=3).fit(pts)
    assert inertia <= 1.05 * ref.inertia_, (inertia, ref.inertia_)
    small = pts[:5]
    np.testing.assert_array_equal(t_qs.kmeans_sample(small, 10), small)


def test_generic_scene_queries_feed_the_tracker(tmp_path, scene):
    """The JAX test's chain (`tests/test_query_sampling.py::
    test_generic_scene_dataset`, then sampling): a scene loaded from disk
    gives queries in the tracker's [(t, x, y, z)] layout."""
    dp = t_gen.GenericSceneDataset(str(write_scene(tmp_path / "generic", scene)))[0]
    q = t_qs.sample_queries_from_depth(dp.videodepth, dp.intrs, dp.extrs,
                                       [t_qs.SamplingSpec(frame=0, count=32),
                                        t_qs.SamplingSpec(frame=2, count=16, method="kmeans")])
    assert q.shape == (48, 4) and set(np.unique(q[:, 0])) == {0.0, 2.0} and np.isfinite(q).all()
