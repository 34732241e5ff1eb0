"""The port's dataset modules against the JAX package's on the CPU: the
Kubric, Panoptic Studio and DexYCB loaders on fixtures written as
`tests/test_kubric_loader.py` and `tests/test_real_world_datasets.py`
write them (imageio), every `from_name` option of the Kubric grammar, and
the loader's on-disk scene cache and `compress_batch_for_transfer`. Every
comparison is exact: the port reads the same files into the same arrays
and makes the same track-sampling draws (`-noise2cm` included).

The writers of `chip_smoke.py` (the port's own `image_io`, no imageio) are
held here too: the port's loaders read their files back as the rendered
scene."""

import os
import shutil

import numpy as np
import pytest

import chip_smoke
from mvtracker_torch.datasets import kubric as t_kubric
from mvtracker_torch.datasets import loader as t_loader
from mvtracker_torch.datasets import real_world as t_rw
from mvtracker_torch.datasets import synthetic as t_synth
from mvtracker_tpu.datasets import kubric as j_kubric
from mvtracker_tpu.datasets import loader as j_loader
from mvtracker_tpu.datasets import real_world as j_rw
from mvtracker_tpu.datasets import synthetic as j_synth
from tests.test_kubric_loader import write_kubric_scene
from tests.test_torch_augmentations import assert_same_datapoint
from tests.test_real_world_datasets import write_dexycb_scene, write_panoptic_scene

KUBRIC_NAMES = [
    "kubric-multiview-v3", "kubric-multiview-v3-views0_2", "kubric-multiview-v3-novelviews1_3",
    "kubric-multiview-v3-noise2cm", "kubric-multiview-v3-views2_3-duster", "kubric-multiview-v3-views1_3-dustercleaned",
    "kubric-multiview-v3-training", "kubric-multiview-v3-overfit-on-training", "kubric-multiview-v3-training-single",
    "kubric-multiview-v3-2dpt", "kubric-multiview-v3-cached", "kubric-multiview-v3-views0_1_3-noise1.5cm-single",
]
KUBRIC_ATTRS = ("view_subset", "novel_view_subset", "depth_noise_cm", "depth_source", "split", "mode_2d", "scenes",
                "seed", "num_tracks")


def assert_same_dataset(got, want):
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        assert_same_datapoint(got[i], want[i])


@pytest.fixture(scope="module")
def kubric_root(tmp_path_factory):
    """Two evaluation scenes under flat/, two training scenes under
    split/train/, with the estimated-depth files of the -duster names."""
    root = tmp_path_factory.mktemp("kubric")
    for i, name in enumerate(("flat/scene_000", "flat/scene_001", "split/train/train_a", "split/train/train_b")):
        scene = j_synth.render_scene(seed=5 + i, n_views=4, n_frames=3, height=32, width=40, n_tracks=10)
        path = root / name
        write_kubric_scene(scene, str(path))
        for vi in range(4):
            d = np.full((3, 32, 40), float(vi + 1), np.float32)
            np.save(path / f"view_{vi}" / "duster_depth.npy", d)
            np.save(path / f"view_{vi}" / "duster_depth_cleaned.npy", d + 0.5)
    return root


@pytest.mark.parametrize("name", KUBRIC_NAMES)
def test_kubric_names_equal_the_jax_packages(kubric_root, name):
    root = str(kubric_root / ("split" if "training" in name else "flat"))
    got = t_kubric.KubricMultiViewDataset.from_name(name, root)
    want = j_kubric.KubricMultiViewDataset.from_name(name, root)
    for attr in KUBRIC_ATTRS:
        assert getattr(got, attr) == getattr(want, attr), attr
    assert_same_dataset(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(num_tracks=4), dict(num_tracks=64), dict(num_tracks=6, dynamic_ratio=0.5), dict(view_sample_count=2, seed=3),
    dict(max_frames=2, num_tracks=5), dict(sanity_check_projection=True),
], ids=["subsample", "top_up", "dynamic_ratio", "view_sample_count", "max_frames", "sanity_check"])
def test_kubric_options_equal_the_jax_packages(kubric_root, kwargs):
    root = str(kubric_root / "flat")
    assert_same_dataset(t_kubric.KubricMultiViewDataset(root, **kwargs), j_kubric.KubricMultiViewDataset(root, **kwargs))


def test_kubric_scene_loading_and_conversions(kubric_root):
    path = str(kubric_root / "flat" / "scene_001")
    got, want = t_kubric.load_scene(path), j_kubric.load_scene(path)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    q = np.random.default_rng(0).normal(size=(5, 4))
    np.testing.assert_array_equal(t_kubric.quaternion_to_rotation_matrix(q), j_kubric.quaternion_to_rotation_matrix(q))
    depth = np.random.default_rng(1).uniform(1, 5, (2, 6, 8)).astype(np.float32)
    np.testing.assert_array_equal(t_kubric.depth_euclidean_to_z(depth, 32.0, 35.0),
                                  j_kubric.depth_euclidean_to_z(depth, 32.0, 35.0))


def test_kubric_dispatch_and_invalid_depth(kubric_root, tmp_path):
    """`dataset_from_name` routes the grammar to the Kubric loader under
    <root>/kubric-multiview, and depths beyond 1000 load as 0."""
    link = tmp_path / "kubric-multiview"
    shutil.copytree(kubric_root / "flat" / "scene_000", link / "scene_000")
    tiff = link / "scene_000" / "view_2" / "depth_00001.tiff"
    from mvtracker_torch.datasets import image_io

    far = image_io.read_image(tiff)
    far[:5] = 5000.0
    image_io.write_tiff(tiff, far)
    got = t_rw.dataset_from_name("kubric-multiview-v3-views0_2-noise1cm", str(tmp_path))
    want = j_rw.dataset_from_name("kubric-multiview-v3-views0_2-noise1cm", str(tmp_path))
    assert isinstance(got, t_kubric.KubricMultiViewDataset) and got.view_subset == [0, 2]
    assert_same_dataset(got, want)
    assert (t_kubric.load_scene(str(link / "scene_000"))["videodepth"][2, 1, :5] == 0).all()


@pytest.fixture(scope="module")
def real_scene():
    return j_synth.render_scene(seed=11, n_views=3, n_frames=3, height=32, width=40, n_tracks=12)


def write_panoptic_cameras(scene, path, ids):
    """A Panoptic scene whose views are the camera ids `ids`: the view
    directories and depth files named by id, the annotation rows at the
    ids."""
    write_panoptic_scene(scene, str(path))
    for vi, cam in sorted(enumerate(ids), reverse=True):
        shutil.move(path / "ims" / str(vi), path / "ims" / f"tmp{cam}")
        shutil.move(path / "dynamic3dgs_depth" / f"depths_{vi:02d}.npy",
                    path / "dynamic3dgs_depth" / f"tmp_{cam:02d}.npy")
    for cam in ids:
        shutil.move(path / "ims" / f"tmp{cam}", path / "ims" / str(cam))
        shutil.move(path / "dynamic3dgs_depth" / f"tmp_{cam:02d}.npy",
                    path / "dynamic3dgs_depth" / f"depths_{cam:02d}.npy")
    ann = dict(np.load(path / "tapvid3d_annotations.npz"))
    for k in ("trajectories_pixelspace", "per_view_visibilities", "extrinsics", "intrinsics"):
        rows = np.zeros((max(ids) + 1,) + ann[k].shape[1:], ann[k].dtype)
        rows[list(ids)] = ann[k]
        ann[k] = rows
    np.savez(path / "tapvid3d_annotations.npz", **ann)


@pytest.mark.parametrize("views,traj", [(None, 8), ([7, 1], 5), (None, 100)])
def test_panoptic_equals_the_jax_packages(real_scene, tmp_path, views, traj):
    root = tmp_path / "panoptic"
    write_panoptic_cameras(real_scene, root / "seq_a", (1, 7, 14))
    write_panoptic_scene(real_scene, str(root / "seq_b"))
    if views is not None:
        shutil.rmtree(root / "seq_b")
    kw = dict(views_to_return=views, traj_per_sample=traj)
    assert_same_dataset(t_rw.PanopticStudioMultiViewDataset(str(root), **kw),
                        j_rw.PanopticStudioMultiViewDataset(str(root), **kw))


@pytest.mark.parametrize("views,traj", [(None, 8), ([2, 0], 12)])
def test_dexycb_equals_the_jax_packages(real_scene, tmp_path, views, traj):
    root = tmp_path / "dexycb"
    write_dexycb_scene(real_scene, str(root / "seq0"))
    write_dexycb_scene(real_scene, str(root / "seq1"))
    kw = dict(views_to_return=views, traj_per_sample=traj, seed=4)
    assert_same_dataset(t_rw.DexYCBMultiViewDataset(str(root), **kw), j_rw.DexYCBMultiViewDataset(str(root), **kw))


def test_real_world_names_equal_the_jax_packages(real_scene, tmp_path):
    write_panoptic_scene(real_scene, str(tmp_path / "panoptic-multiview" / "seq0"))
    write_dexycb_scene(real_scene, str(tmp_path / "dex-ycb-multiview" / "seq0"))
    for name in ("panoptic-multiview", "panoptic-multiview-views0_2", "dexycb-multiview-views1_2"):
        got, want = t_rw.dataset_from_name(name, str(tmp_path)), j_rw.dataset_from_name(name, str(tmp_path))
        assert got.views_to_return == want.views_to_return
        assert_same_dataset(got, want)
    with pytest.raises(ValueError, match="unknown dataset name"):
        t_rw.dataset_from_name("tapvid-davis", str(tmp_path))


def test_chip_smoke_writers_round_trip(tmp_path):
    """The fixture writers of the card run, on the port's image_io: the
    loaders give back the rendered scene (RGB exactly, depth within its
    float32 / 16-bit millimetre round trip)."""
    scene = t_synth.render_scene(seed=2, n_views=4, n_frames=3, height=32, width=40, n_tracks=12)
    chip_smoke.write_kubric_scene(scene, tmp_path / "kubric" / "scene_0")
    dp = t_kubric.KubricMultiViewDataset(str(tmp_path / "kubric"), num_tracks=12)[0]
    np.testing.assert_array_equal(dp.video, scene.video.astype(np.uint8).astype(np.float32))
    np.testing.assert_allclose(dp.videodepth, scene.videodepth, rtol=2e-6, atol=0)
    np.testing.assert_allclose(dp.extrs, scene.extrs, atol=1e-5)
    np.testing.assert_allclose(dp.intrs, scene.intrs, rtol=1e-5)
    chip_smoke.write_panoptic_scene(scene, tmp_path / "pan" / "seq", cameras=(1, 7, 14, 20))
    dp = t_rw.PanopticStudioMultiViewDataset(str(tmp_path / "pan"), traj_per_sample=12)[0]
    np.testing.assert_array_equal(dp.video, scene.video.astype(np.uint8).astype(np.float32))
    np.testing.assert_array_equal(dp.videodepth, scene.videodepth)
    chip_smoke.write_dexycb_scene(scene, tmp_path / "dex" / "seq")
    dp = t_rw.DexYCBMultiViewDataset(str(tmp_path / "dex"), traj_per_sample=12)[0]
    np.testing.assert_array_equal(dp.video, scene.video.astype(np.uint8).astype(np.float32))
    np.testing.assert_allclose(dp.videodepth, scene.videodepth, atol=5.1e-4)


def test_disk_cache_and_compression_equal_the_jax_packages(tmp_path, monkeypatch):
    """The disk cache writes scene_<seed>.npz atomically, a second dataset
    reads it without rendering, the two packages read each other's files,
    and a truncated file is rendered again; `compress_batch_for_transfer`
    gives the JAX function's arrays."""
    kw = dict(n_scenes=2, seed=1, randomize=True, n_views=2, n_frames=4, height=32, width=32, n_tracks=8)
    first = t_loader.SyntheticSceneDataset(disk_cache_dir=str(tmp_path / "port"), **kw)
    rendered = [first[i] for i in range(2)]
    assert sorted(os.listdir(tmp_path / "port")) == ["scene_100003.npz", "scene_100004.npz"]

    def no_render(**_):
        raise AssertionError("rendered a cached scene")

    monkeypatch.setattr(t_synth, "render_scene", no_render)
    again = t_loader.SyntheticSceneDataset(disk_cache_dir=str(tmp_path / "port"), **kw)
    for i in range(2):
        assert_same_datapoint(again[i], rendered[i])
        assert_same_datapoint(again[i], j_loader.SyntheticSceneDataset(disk_cache_dir=str(tmp_path / "port"), **kw)[i])
    j_loader.SyntheticSceneDataset(disk_cache_dir=str(tmp_path / "jax"), **kw)[0]
    assert_same_datapoint(t_loader.SyntheticSceneDataset(disk_cache_dir=str(tmp_path / "jax"), **kw)[0], rendered[0])
    monkeypatch.undo()
    path = tmp_path / "port" / "scene_100004.npz"
    path.write_bytes(path.read_bytes()[:100])
    assert_same_datapoint(t_loader.SyntheticSceneDataset(disk_cache_dir=str(tmp_path / "port"), **kw)[1], rendered[1])
    assert path.stat().st_size > 100

    batch = t_loader.PrefetchLoader(first, batch_size=2, shuffle=False, num_workers=1)._load_batch([0, 1])
    got, want = t_loader.compress_batch_for_transfer(batch), j_loader.compress_batch_for_transfer(batch)
    assert set(got) == set(want) and got["rgbs"].dtype == np.uint8 and got["depths"].dtype == np.float16
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert t_loader.compress_batch_for_transfer(got)["rgbs"] is got["rgbs"]
