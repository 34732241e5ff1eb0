"""Port parity: geometry and embeddings of `mvtracker_torch` against
`mvtracker_tpu.utils` on the same numpy inputs (CPU, fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.utils import embeddings as t_emb
from mvtracker_torch.utils import geometry as t_geo
from mvtracker_tpu.utils import embeddings as j_emb
from mvtracker_tpu.utils import geometry as j_geo

# fp32 element-wise math in both; only the order of a few sums differs.
ATOL = 1e-5


def _cams(rng, *lead):
    intrs = np.zeros((*lead, 3, 3), np.float32)
    intrs[..., 0, 0] = rng.uniform(40, 80, size=lead)
    intrs[..., 1, 1] = rng.uniform(40, 80, size=lead)
    intrs[..., 0, 2] = 16.0
    intrs[..., 1, 2] = 12.0
    intrs[..., 2, 2] = 1.0
    extrs = np.zeros((*lead, 3, 4), np.float32)
    for i in np.ndindex(*lead):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        extrs[i][:, :3] = q
        extrs[i][:, 3] = rng.normal(size=3)
    return intrs, extrs


def test_inverses_and_grid(rng):
    intrs, extrs = _cams(rng, 2, 3)
    np.testing.assert_allclose(
        t_geo.invert_intrinsics(torch.from_numpy(intrs)).numpy(),
        np.asarray(j_geo.invert_intrinsics(jnp.asarray(intrs))), atol=ATOL,
    )
    np.testing.assert_allclose(
        t_geo.invert_extrinsics(torch.from_numpy(extrs)).numpy(),
        np.asarray(j_geo.invert_extrinsics(jnp.asarray(extrs))), atol=ATOL,
    )
    x = rng.normal(size=(4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_geo.to_homogeneous(torch.from_numpy(x)).numpy(), np.asarray(j_geo.to_homogeneous(jnp.asarray(x)))
    )
    np.testing.assert_array_equal(t_geo.pixel_grid(5, 7, 4).numpy(), np.asarray(j_geo.pixel_grid(5, 7, 4)))
    d = rng.normal(size=(2, 8, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        t_geo.nearest_downsample_2x(torch.from_numpy(d)).numpy(),
        np.asarray(j_geo.nearest_downsample_2x(jnp.asarray(d))),
    )


def test_unproject_depth_to_world(rng):
    intrs, extrs = _cams(rng, 3)
    depths = rng.uniform(1, 4, size=(3, 6, 8)).astype(np.float32)
    want = j_geo.unproject_depth_to_world(
        jnp.asarray(depths), j_geo.invert_intrinsics(jnp.asarray(intrs)),
        j_geo.invert_extrinsics(jnp.asarray(extrs)), stride=4,
    )
    got = t_geo.unproject_depth_to_world(
        torch.from_numpy(depths), t_geo.invert_intrinsics(torch.from_numpy(intrs)),
        t_geo.invert_extrinsics(torch.from_numpy(extrs)), stride=4,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_init_pointcloud_from_rgbd(rng, level):
    b, v, s, h, w, c = 1, 2, 3, 8, 12, 5
    fmaps = rng.normal(size=(b, v, s, h, w, c)).astype(np.float32)
    depths = rng.uniform(1, 4, size=(b, v, s, h, w)).astype(np.float32)
    intrs, extrs = _cams(rng, b, v, s)
    args = (fmaps, depths, intrs, extrs)
    jx, jf = j_geo.init_pointcloud_from_rgbd(*map(jnp.asarray, args), stride=4, level=level)
    tx, tf = t_geo.init_pointcloud_from_rgbd(*map(torch.from_numpy, args), stride=4, level=level)
    assert tuple(tx.shape) == jx.shape and tuple(tf.shape) == jf.shape
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL)


def test_sincos_embeddings(rng):
    pos = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_emb.sincos_1d(64, torch.from_numpy(pos[:, 0])).numpy(),
        np.asarray(j_emb.sincos_1d(64, jnp.asarray(pos[:, 0]))), atol=ATOL,
    )
    # The tracker's own width: 582 = d_in 581 rounded up to a multiple of 6.
    np.testing.assert_allclose(
        t_emb.sincos_3d(582, torch.from_numpy(pos)).numpy(),
        np.asarray(j_emb.sincos_3d(582, jnp.asarray(pos))), atol=ATOL,
    )


def test_coord_embedding_3d(rng):
    # Flows of a window: |x| < 1, so sin/cos arguments stay below ~1000
    # where fp32 keeps 1e-4 absolute accuracy.
    xyz = (rng.normal(size=(4, 6, 3)) * 0.3).astype(np.float32)
    got = t_emb.coord_embedding_3d(torch.from_numpy(xyz), 64)
    want = j_emb.coord_embedding_3d(jnp.asarray(xyz), 64)
    assert tuple(got.shape) == want.shape == (4, 6, 195)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(got[..., -3:].numpy(), xyz)  # coords appended
