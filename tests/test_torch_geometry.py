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


def test_projection_round_trip_functions(rng):
    v, t, n = 2, 3, 11
    intrs, extrs = _cams(rng, v, t)
    world = rng.normal(size=(v, t, n, 3)).astype(np.float32)
    world[..., 2] += 4.0
    j_pix, j_z = j_geo.world_to_pixel_xy_and_camera_z(*map(jnp.asarray, (world, intrs, extrs)))
    t_pix, t_z = t_geo.world_to_pixel_xy_and_camera_z(*map(torch.from_numpy, (world, intrs, extrs)))
    assert tuple(t_pix.shape) == j_pix.shape == (v, t, n, 2) and tuple(t_z.shape) == j_z.shape == (v, t, n, 1)
    np.testing.assert_allclose(t_pix.numpy(), np.asarray(j_pix), rtol=1e-5, atol=1e-3)  # pixels, up to ~1e3
    np.testing.assert_allclose(t_z.numpy(), np.asarray(j_z), atol=ATOL)
    j_back = j_geo.pixel_xy_and_camera_z_to_world(
        j_pix, j_z, j_geo.invert_intrinsics(jnp.asarray(intrs)), j_geo.invert_extrinsics(jnp.asarray(extrs))
    )
    t_back = t_geo.pixel_xy_and_camera_z_to_world(
        torch.from_numpy(np.array(j_pix)), torch.from_numpy(np.array(j_z)),
        t_geo.invert_intrinsics(torch.from_numpy(intrs)), t_geo.invert_extrinsics(torch.from_numpy(extrs)),
    )
    np.testing.assert_allclose(t_back.numpy(), np.asarray(j_back), atol=1e-4)
    np.testing.assert_allclose(t_back.numpy(), world, atol=1e-3)


def test_reprojection_roundtrip_dev(rng, monkeypatch):
    v, t, n = 3, 4, 9
    intrs, extrs = _cams(rng, v, t)
    world = (rng.normal(size=(t, n, 3)) * 2).astype(np.float32)
    want = float(j_geo.reprojection_roundtrip_dev(*map(jnp.asarray, (world, intrs, extrs))))
    got = t_geo.reprojection_roundtrip_dev(*map(torch.from_numpy, (world, intrs, extrs)))
    # With true inverses both are fp32 rounding error: same size, not same bits.
    assert got.shape == () and 0 < float(got) < 1e-4 and 0 < want < 1e-4

    # A wrong inverse on both sides, another one for every (view, frame),
    # makes the deviation large and deterministic, so the value itself can be
    # held: it depends on the mask, the max and the view axis.
    # View 0 is off by the most.
    scale = np.array([0.05, 0.01, 0.004]).reshape(v, 1, 1, 1)
    wrong = (1.0 + scale * rng.uniform(0.5, 1.0, size=(v, t, 1, 1))).astype(np.float32)
    j_inv, t_inv = j_geo.invert_extrinsics, t_geo.invert_extrinsics
    monkeypatch.setattr(j_geo, "invert_extrinsics", lambda e: j_inv(e * jnp.asarray(wrong)))
    monkeypatch.setattr(t_geo, "invert_extrinsics", lambda e: t_inv(e * torch.from_numpy(wrong)))

    def both(points):
        w = float(j_geo.reprojection_roundtrip_dev(*map(jnp.asarray, (points, intrs, extrs))))
        g = float(t_geo.reprojection_roundtrip_dev(*map(torch.from_numpy, (points, intrs, extrs))))
        np.testing.assert_allclose(g, w, rtol=1e-4)
        return g

    # By hand in float64: back = A'^-1 (A x), A' = wrong * A, over all views.
    sq = np.concatenate([extrs.astype(np.float64), np.broadcast_to([0.0, 0, 0, 1], (v, t, 1, 4))], axis=-2)
    sq_wrong = np.concatenate([(extrs * wrong).astype(np.float64), np.broadcast_to([0.0, 0, 0, 1], (v, t, 1, 4))], axis=-2)

    def by_hand(points, keep):
        hom = np.concatenate([points.astype(np.float64), np.ones((t, n, 1))], axis=-1)
        cam = np.einsum("vtij,tnj->vtni", sq, hom)
        back = np.einsum("vtij,vtnj->vtni", np.linalg.inv(sq_wrong), cam)[..., :3]
        dev = np.abs(back - points[None]).max(-1)
        return float(np.where(keep(cam[..., 2]), dev, 0.0).max())

    plain = both(world)
    assert plain > 0.03
    np.testing.assert_allclose(plain, by_hand(world, lambda z: np.abs(z) > 1e-3), rtol=1e-4)

    # A far point on a camera plane (z = 0 in view 0 at frame 0, so left out
    # there) whose deviation would otherwise be the largest by far.
    r, tr = extrs[0, 0, :, :3], extrs[0, 0, :, 3]
    masked = world.copy()
    masked[0, 0] = r.T @ (np.array([300.0, -200.0, 0.0], np.float32) - tr)
    unmasked_view0 = by_hand(masked, lambda z: np.ones_like(z, bool))
    got_masked = both(masked)
    np.testing.assert_allclose(got_masked, by_hand(masked, lambda z: np.abs(z) > 1e-3), rtol=1e-4)
    assert got_masked < 0.5 * unmasked_view0  # view 0 held the largest deviation and was left out
    # Just off the plane it counts again.
    masked[0, 0] = r.T @ (np.array([300.0, -200.0, 0.01], np.float32) - tr)
    np.testing.assert_allclose(both(masked), unmasked_view0, rtol=1e-3)


def test_bilinear_sample2d(rng):
    b, h, w, c, n = 3, 7, 9, 4, 25
    im = rng.normal(size=(b, h, w, c)).astype(np.float32)
    # In range, on the border, outside on every side, and exactly integral.
    x = rng.uniform(-2.5, w + 1.5, size=(b, n)).astype(np.float32)
    y = rng.uniform(-2.5, h + 1.5, size=(b, n)).astype(np.float32)
    x[:, 0], y[:, 0] = 3.0, 2.0
    x[:, 1], y[:, 1] = w - 1, h - 1
    want = j_geo.bilinear_sample2d(*map(jnp.asarray, (im, x, y)))
    got = t_geo.bilinear_sample2d(*map(torch.from_numpy, (im, x, y)))
    assert tuple(got.shape) == want.shape == (b, n, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got[:, 0].numpy(), im[:, 2, 3], atol=ATOL)


@pytest.mark.parametrize("dim", [None, (1, 2), 0])
def test_reduce_masked_mean(rng, dim):
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    mask = (rng.random((3, 4, 5)) > 0.4).astype(np.float32)
    mask[1] = 0  # an empty mask gives 0, not NaN
    want = j_geo.reduce_masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=dim)
    got = t_geo.reduce_masked_mean(torch.from_numpy(x), torch.from_numpy(mask), dim=dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if dim == (1, 2):
        assert float(got[1]) == 0.0
