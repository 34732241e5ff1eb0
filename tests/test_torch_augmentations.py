"""The port's train-time augmentations (`mvtracker_torch/datasets/
augmentations.py`) against the JAX package's on the CPU, on the scene of
`tests/test_augmentations.py` and the same `np.random.default_rng(seed)`.

- With both packages' native libraries switched off, every function and the
  default stack run numpy only and must agree exactly, field by field, and
  leave their generators in the same state.
- With the native libraries on, the photometric jitter and blur and
  `aug_depth`'s blur run in the two packages' builds of
  `native/datapath.cpp`, which round apart by a few ulps
  (`tests/test_torch_native.py`): video held to 2e-3 on 0..255, depth to
  1e-5; every other field exactly.
- `scaled_crop_augment` resizes with the port's numpy `resize_linear` and
  `resize_nearest` where the JAX package calls `cv2.resize`: video within
  1e-3 on 0..255 (measured 3.1e-5, float32 rounding of the weights), every
  other field exactly; the resizes themselves against `cv2.resize` at the
  same tolerance (nearest exactly).
"""

import dataclasses

import cv2
import numpy as np
import pytest

from mvtracker_torch import native as t_native
from mvtracker_torch.datasets import augmentations as t_aug
from mvtracker_torch.datasets import synthetic as t_synth
from mvtracker_torch.datasets.loader import SyntheticSceneDataset
from mvtracker_tpu import native as j_native
from mvtracker_tpu.datasets import augmentations as j_aug
from mvtracker_tpu.datasets import synthetic as j_synth
from mvtracker_tpu.datasets.loader import SyntheticSceneDataset as JaxSyntheticSceneDataset

SCENE = dict(seed=9, n_views=2, n_frames=4, height=48, width=64, n_tracks=8)
NATIVE_ATOL = {"video": 2e-3, "videodepth": 1e-5}
RESIZE_ATOL = 1e-3

CASES = {
    "photometric": lambda m, dp, rng: m.photometric_augment(dp, rng, hue=0.1, blur_prob=1.0),
    "photometric_shared": lambda m, dp, rng: m.photometric_augment(dp, rng, frame_shared=True, hue=0.15,
                                                                   blur_prob=1.0),
    "photometric_global": lambda m, dp, rng: m.photometric_augment(dp, rng, per_view=False, blur_prob=0.5),
    "eraser": lambda m, dp, rng: m.eraser_augment(dp, rng, prob=1.0),
    "replace": lambda m, dp, rng: m.replace_augment(dp, rng, prob=1.0),
    "depth_eraser_replace": lambda m, dp, rng: m.depth_eraser_replace_augment(dp, rng, 1.0, 1.0),
    "crop": lambda m, dp, rng: m.crop_augment(dp, rng, 32, 48),
    "depth_corruption": lambda m, dp, rng: m.depth_corruption_augment(dp, rng, erase_prob=1.0, patch_aug_prob=1.0),
    "scene_transform": lambda m, dp, rng: m.scene_transform_augment(dp, rng),
    "scene_transform_no_rotation": lambda m, dp, rng: m.scene_transform_augment(dp, rng, rotate=False),
    "camera_noise": lambda m, dp, rng: m.camera_noise_augment(dp, rng),
    "default_stack": lambda m, dp, rng: m.default_train_augmentations(dp, rng),
    "default_stack_no_occluders": lambda m, dp, rng: m.default_train_augmentations(dp, rng, occluders=False),
}
# The cases whose values pass through the native library.
THROUGH_NATIVE = {"photometric", "photometric_shared", "photometric_global", "depth_corruption", "default_stack",
                  "default_stack_no_occluders"}


@pytest.fixture(scope="module")
def scenes():
    return t_synth.render_scene(**SCENE), j_synth.render_scene(**SCENE)


def assert_same_datapoint(got, want, atol=None):
    atol = atol or {}
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, f.name
            if f.name in atol:
                np.testing.assert_allclose(g, w, atol=atol[f.name], rtol=0, err_msg=f.name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("native_on", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_augmentation_equals_the_jax_packages(scenes, case, native_on, monkeypatch):
    t_dp, j_dp = scenes
    if not native_on:
        monkeypatch.setattr(t_native, "_load", lambda: None)
        monkeypatch.setattr(j_native, "_load", lambda: None)
    else:
        assert t_native.available() and j_native.available()
    seed = sorted(CASES).index(case)
    g_t, g_j = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = CASES[case](t_aug, t_dp, g_t), CASES[case](j_aug, j_dp, g_j)
    assert_same_datapoint(got, want, NATIVE_ATOL if native_on and case in THROUGH_NATIVE else None)
    assert g_t.random() == g_j.random()


def test_scaled_crop_equals_the_jax_packages_cv2(scenes):
    t_dp, j_dp = scenes
    for seed in range(3):
        got = t_aug.scaled_crop_augment(t_dp, np.random.default_rng(seed), 40, 56)
        want = j_aug.scaled_crop_augment(j_dp, np.random.default_rng(seed), 40, 56)
        assert_same_datapoint(got, want, {"video": RESIZE_ATOL})


@pytest.mark.parametrize("src,dst", [((48, 64), (60, 80)), ((48, 64), (36, 50)), ((70, 90), (83, 101)),
                                     ((306, 306), (330, 300)), ((45, 53), (45, 53)), ((5, 7), (16, 3))])
def test_resizes_equal_cv2(src, dst):
    rng = np.random.default_rng(sum(src + dst))
    rgb = rng.uniform(0, 255, src + (3,)).astype(np.float32)
    depth = rng.uniform(0, 5, src).astype(np.float32)
    (h, w) = dst
    np.testing.assert_allclose(t_aug.resize_linear(rgb, h, w), cv2.resize(rgb, (w, h), interpolation=cv2.INTER_LINEAR),
                               atol=RESIZE_ATOL, rtol=0)
    np.testing.assert_allclose(t_aug.resize_linear(depth, h, w),
                               cv2.resize(depth, (w, h), interpolation=cv2.INTER_LINEAR), atol=RESIZE_ATOL, rtol=0)
    np.testing.assert_array_equal(t_aug.resize_nearest(depth, h, w),
                                  cv2.resize(depth, (w, h), interpolation=cv2.INTER_NEAREST))


def test_augmented_dataset_equals_the_jax_packages(monkeypatch):
    """`SyntheticSceneDataset(augment=True)` draws its augmentations from a
    fresh unseeded generator on every touch; with that generator seeded the
    same in both packages (and the native libraries off) the scenes are the
    JAX package's, and two touches of one index differ."""
    real = np.random.default_rng
    draws = iter(range(100, 200))
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: real(next(draws) if seed is None else seed))
    monkeypatch.setattr(t_native, "_load", lambda: None)
    monkeypatch.setattr(j_native, "_load", lambda: None)
    kw = dict(n_scenes=2, randomize=True, augment=True, n_views=2, n_frames=4, height=32, width=40, n_tracks=8)
    ds_t, ds_j = SyntheticSceneDataset(**kw), JaxSyntheticSceneDataset(**kw)
    first = ds_t[1]
    draws = iter(range(100, 200))
    assert_same_datapoint(first, ds_j[1])
    second = ds_t[1]
    assert second.video.shape == first.video.shape and not np.array_equal(second.video, first.video)
