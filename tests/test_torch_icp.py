"""Port parity: ICP and the wrist-camera z-offset search
(`mvtracker_torch/ops/icp.py`) against `mvtracker_tpu/ops/icp.py` on the
cases of `tests/test_icp.py`, on the CPU (the plain kNN in place of K1).

Normals are defined up to sign by the eigenvectors (both sides turn them to
z >= 0, which leaves points with a normal in the xy plane to rounding), so
they are compared up to sign; the point-to-plane equations do not depend on
the sign, so R, t and the fitness compare directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.ops import icp as t_icp
from mvtracker_tpu.ops import icp as j_icp
from tests.test_icp import _rot, _surface_cloud

# fp32 both sides; 30 iterations of 6x6 solves converge to the same pose:
# R and t to 1e-5 absolute (the recovery bounds of the JAX tests are 1e-3 m
# and 0.1 degree), the fitness to one inlier in 2000.
POSE_ATOL, FIT_ATOL = 1e-5, 5e-4
# The z-offset search ends at golden-section precision (refine_tol 1e-5);
# both sides must land inside one such interval of each other.
Z_ATOL = 2e-5


def test_estimate_normals_match_jax_up_to_sign():
    cloud = _surface_cloud(np.random.default_rng(0))
    got = t_icp.estimate_normals(torch.from_numpy(cloud)).numpy()
    want = np.asarray(j_icp.estimate_normals(jnp.asarray(cloud)))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.abs((got * want).sum(-1)), 1.0, atol=1e-3)
    assert (got[:, 2] >= 0).all()


@pytest.mark.parametrize("point_to_plane", [True, False])
def test_icp_matches_jax(point_to_plane):
    seed, axis, deg, t_true = (0, [0.3, 1.0, 0.2], 2.0, [0.01, -0.015, 0.008]) if point_to_plane else \
        (1, [1.0, 0.0, 0.5], 1.5, [-0.012, 0.02, -0.005])
    target = _surface_cloud(np.random.default_rng(seed))
    r_true, t_true = _rot(axis, deg), np.asarray(t_true)
    source = ((target - t_true) @ r_true).astype(np.float32)
    r, t, fit = t_icp.icp(torch.from_numpy(source), torch.from_numpy(target), max_corr_dist=0.05, iters=30,
                          point_to_plane=point_to_plane)
    jr, jt, jfit = j_icp.icp(source, target, max_corr_dist=0.05, iters=30, point_to_plane=point_to_plane)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(float(fit), float(jfit), rtol=0, atol=FIT_ATOL)
    aligned = source @ r.numpy().T + t.numpy()
    assert float(fit) > 0.95 and np.abs(aligned - target).max() < 1e-3  # the JAX tests' recovery bounds


def _wrist_frames(rng, world, z_true):
    """tests/test_icp.py's three wrist views with a bias of z_true along the
    camera's z axis."""
    frames = []
    for k in range(3):
        c = np.array([0.1 * k - 0.1, 0.05, 0.6 + 0.05 * k])
        fwd, up = np.array([0.0, 0.0, -1.0]), np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        c2w[:3, 3] = c
        local = (world - c) @ c2w[:3, :3]
        keep = local[:, 2] > 0.15
        local = local[keep][rng.permutation(keep.sum())[:1500]]
        local[:, 2] -= z_true
        frames.append({"wrist_points_local": local.astype(np.float32), "wrist_cam_to_world": c2w.astype(np.float32),
                       "external_points_world": world[rng.permutation(len(world))[:2000]]})
    return frames


def test_wrist_z_offset_matches_jax():
    rng = np.random.default_rng(2)
    world = _surface_cloud(rng)
    frames = _wrist_frames(rng, world, 0.023)
    z, fit = t_icp.optimize_wrist_z_offset_multi_frame(frames, device="cpu")
    jz, jfit = j_icp.optimize_wrist_z_offset_multi_frame(frames)
    assert abs(z - jz) < Z_ATOL and abs(fit - jfit) < FIT_ATOL
    assert abs(z - 0.023) < 1e-3 and fit > 0.8  # the JAX test's bounds


def test_single_frame_wrapper_matches_jax():
    world = _surface_cloud(np.random.default_rng(4))
    c2w = np.eye(4)
    c2w[:3, 3] = [0.0, 0.0, 0.7]
    c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
    local = (world - c2w[:3, 3]) @ c2w[:3, :3]
    local = local[local[:, 2] > 0.15].astype(np.float32)
    z, fit = t_icp.optimize_wrist_z_offset(local, c2w.astype(np.float32), world, n_grid=11, device="cpu")
    jz, jfit = j_icp.optimize_wrist_z_offset(local, c2w.astype(np.float32), world, n_grid=11)
    assert abs(z - jz) < Z_ATOL and abs(fit - jfit) < FIT_ATOL and abs(z) < 2e-3


def test_z_offset_fitness_with_icp_matches_jax():
    """The reference's objective (ICP after the shift), 3 candidates."""
    rng = np.random.default_rng(5)
    world = _surface_cloud(rng)
    frame = _wrist_frames(rng, world, 0.01)[0]
    normals = np.array(j_icp.estimate_normals(jnp.asarray(frame["external_points_world"])))
    zs = np.array([-0.02, 0.0, 0.02], np.float32)
    args = (zs, frame["wrist_points_local"], frame["wrist_cam_to_world"], frame["external_points_world"], normals)
    got = t_icp.z_offset_fitness(*map(torch.from_numpy, args), icp_iters=5)
    want = j_icp.z_offset_fitness(*map(jnp.asarray, args), icp_iters=5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=FIT_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-3, atol=1e-6)


def test_apply_z_offset_to_extrinsics_matches_jax():
    extrs = np.random.default_rng(3).normal(size=(2, 5, 3, 4)).astype(np.float32)
    got = t_icp.apply_z_offset_to_extrinsics(torch.from_numpy(extrs), 0.04)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_icp.apply_z_offset_to_extrinsics(extrs, 0.04)))
