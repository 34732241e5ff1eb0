"""Port parity of `mvtracker_torch/utils/depth_fusion.py` against the JAX
package's: numpy on both sides, compared exactly."""

import numpy as np
import pytest

from mvtracker_torch.utils import depth_fusion as t_df
from mvtracker_tpu.utils import depth_fusion as j_df
from tests.test_depth_fusion import _scene


def test_static_prefix_matches_jax(rng):
    _, rgbs = _scene(rng)
    for x in (rgbs, np.zeros((1, 20, 8, 8, 3), np.float32), rgbs[:, :1], rgbs[0], np.zeros((2, 0, 4, 4, 3))):
        for kw in ({}, {"diff_threshold": 0.0, "max_frames": 3}):
            assert t_df.detect_static_prefix_frames(x, **kw) == j_df.detect_static_prefix_frames(x, **kw)


@pytest.mark.parametrize("frames", [[0, 1, 2], []])
def test_per_view_scale_matches_jax(rng, frames):
    gt, _ = _scene(rng)
    pred = gt / 2.5 + rng.normal(0, 0.01, gt.shape).astype(np.float32)
    pred[1, :, :20] = 0.0  # most of view 1 invalid
    got, want = t_df.estimate_per_view_scale(pred, gt, frames), j_df.estimate_per_view_scale(pred, gt, frames)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["two_estimates", "nonfinite", "no_estimates", "no_rgbs", "holes"])
def test_fuse_depths_matches_jax(rng, case):
    gt, rgbs = _scene(rng)
    sensor = gt.copy()
    sensor[:, :, :4] = 0.0  # sensor holes
    est_a = gt * 0.8 + rng.normal(0, 0.02, gt.shape).astype(np.float32)
    est_b = gt * 1.3 + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    conf_b = rng.uniform(0.1, 1.0, gt.shape).astype(np.float32)
    estimates = [(est_a, None), (est_b, conf_b)]
    if case == "nonfinite":
        est_a[0, 2, 5:9, 5:9] = np.nan
        est_b[1, 4, :3] = np.inf
    elif case == "no_estimates":
        estimates = []
    elif case == "holes":
        sensor[:] = 0.0
    rgb_arg = None if case == "no_rgbs" else rgbs
    got = t_df.fuse_depths(sensor, estimates, rgb_arg)
    want = j_df.fuse_depths(sensor, estimates, rgb_arg)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(got[0]).all()


@pytest.mark.parametrize("k", [0, 1, 3, 5])
def test_box_smoothing_matches_jax(rng, k):
    d = rng.uniform(0.5, 3.0, (2, 3, 10, 12)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, d.shape).astype(np.float32)
    np.testing.assert_array_equal(t_df._box_smooth_weighted(d, w, k), j_df._box_smooth_weighted(d, w, k))
