"""Port parity: Gauss-Newton camera refinement
(`mvtracker_torch/ops/bundle_adjust.py`) against
`mvtracker_tpu/ops/bundle_adjust.py` on the cases of
`tests/test_bundle_adjust.py`, and the point-sharded solver on 4 gloo CPU
processes against JAX's on a 4-device mesh and the port's dense solver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mvtracker_torch.ops import bundle_adjust as t_ba
from mvtracker_tpu.ops import bundle_adjust as j_ba
from tests import torch_dist
from tests.test_bundle_adjust import make_ba_problem, perturb_extrinsics

# fp32 on both sides. Camera-only refinement is well posed: extrinsics and
# points are held to 1e-4 absolute (the problem's scale is 1 to 3 units).
ATOL = 1e-4
# Joint refinement is not: cameras and points have a similarity gauge (7
# directions the data does not fix), damped only by 1e-4, and the reduced
# camera system cancels most of its digits in fp32. JAX's and the port's
# single steps then differ as much as either differs from the same step in
# fp64 (readings, max abs over the twists of a step of scale 0.122, at
# damping 1 / 10: port 1.26e-2 / 4.4e-4, JAX 9.5e-3 / 3.8e-4 from fp64; the
# point updates at damping 10: port 3.7e-4, JAX 1.85e-4), and converged
# solutions differ along the gauge by up to 1.0 in raw extrinsics. So a
# joint step is compared at damping 10, its distance from fp64 held to 3
# times JAX's (read: 1.16 and 2.0 times), and joint solutions by what the
# gauge leaves unchanged: the reprojected pixels (measured 4.6e-5 px apart
# after 20 iterations) and the residual.
JOINT_DAMPING, JOINT_STEP_RTOL, JOINT_FP64_RATIO = 10.0, 1e-2, 3.0
PIXEL_ATOL = 1e-3


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def test_se3_exp_matches_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(16, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-7  # below the small-angle switch
    xi[4:8, 3:] *= 3.0
    np.testing.assert_allclose(t_ba.se3_exp(torch.from_numpy(xi)).numpy(), np.asarray(j_ba.se3_exp(jnp.asarray(xi))),
                               rtol=0, atol=2e-6)


def _perturbed_problem(seed):
    rng = np.random.default_rng(seed)
    intrs, extrs, points, obs, weights = make_ba_problem(rng)
    extrs = perturb_extrinsics(extrs, rng)
    points = points + rng.normal(size=points.shape).astype(np.float32) * 0.02
    weights = weights * rng.uniform(0.5, 2.0, size=weights.shape).astype(np.float32)
    return intrs, extrs, points, obs, weights


def test_gauss_newton_step_cameras_only_matches_jax():
    args = _perturbed_problem(1)
    got = t_ba.gauss_newton_step(*_t(*args), eliminate_points=False)
    want = j_ba.gauss_newton_step(*map(jnp.asarray, args), eliminate_points=False)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * max(np.abs(w).max(), 1e-3))


def test_gauss_newton_step_joint_matches_jax():
    args = _perturbed_problem(1)
    got = t_ba.gauss_newton_step(*_t(*args), damping=JOINT_DAMPING)
    want = [np.asarray(w) for w in j_ba.gauss_newton_step(*map(jnp.asarray, args), damping=JOINT_DAMPING)]
    exact = t_ba.gauss_newton_step(*[torch.from_numpy(np.asarray(a, np.float64)) for a in args], damping=JOINT_DAMPING)
    for g, w, x in zip(got[:2], want[:2], exact[:2]):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=JOINT_STEP_RTOL * scale)
        assert np.abs(g.double().numpy() - x.numpy()).max() <= JOINT_FP64_RATIO * np.abs(w - x.numpy()).max()
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


def _pixels(intrs, extrs, points):
    v, p = extrs.shape[0], points.shape[0]
    r, _, _ = t_ba._project_residuals(*_t(intrs, extrs, points, np.zeros((v, p, 2)), np.ones((v, p))))
    return r.numpy()


@pytest.mark.parametrize("refine_points", [False, True])
def test_refine_cameras_matches_jax(refine_points):
    """The cases of tests/test_bundle_adjust.py: cameras alone from exact
    points, and cameras with noisy points."""
    rng = np.random.default_rng(0)
    intrs, extrs_gt, points, obs, weights = make_ba_problem(rng)
    if refine_points:
        extrs0 = perturb_extrinsics(extrs_gt, rng, rot_deg=1.0, trans=0.02)
        points = points + rng.normal(size=points.shape).astype(np.float32) * 0.02
        iterations = 20
    else:
        extrs0 = perturb_extrinsics(extrs_gt, rng)
        iterations = 15
    args = (intrs, extrs0, points, obs, weights)
    e, p, msr = t_ba.refine_cameras(*_t(*args), iterations=iterations, refine_points=refine_points)
    je, jp, jmsr = j_ba.refine_cameras(*map(jnp.asarray, args), iterations=iterations, refine_points=refine_points)
    if refine_points:
        np.testing.assert_allclose(_pixels(intrs, e.numpy(), p.numpy()), _pixels(intrs, np.asarray(je), np.asarray(jp)),
                                   rtol=0, atol=PIXEL_ATOL)
    else:
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(p.numpy(), points)
        np.testing.assert_allclose(e.numpy(), extrs_gt, atol=5e-3)  # the JAX test's recovery bound
    np.testing.assert_allclose(float(msr), float(jmsr), rtol=0, atol=1e-6)
    assert float(msr) < 1e-4


def test_refine_cameras_sharded_matches_jax_and_dense(tmp_path):
    """4 point shards: every rank takes the same camera steps, and the
    solution reprojects as JAX's sharded solver's and the port's dense one's."""
    rng = np.random.default_rng(0)
    intrs, extrs_gt, points, obs, weights = make_ba_problem(rng, p=256)
    extrs0 = perturb_extrinsics(extrs_gt, rng, rot_deg=1.0, trans=0.02)
    got = torch_dist.spawn(torch_dist.refine_sharded, 4, tmp_path, intrs, extrs0, points, obs, weights, 10)

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("pt",))
    f = shard_map(
        lambda pts, o, w: j_ba.refine_cameras_sharded(jnp.asarray(intrs), jnp.asarray(extrs0), pts, o, w, "pt",
                                                      iterations=10),
        mesh=mesh, in_specs=(P("pt"), P(None, "pt"), P(None, "pt")), out_specs=(P(None, None), P("pt")),
        check_vma=False,
    )
    je, jp = f(jnp.asarray(points), jnp.asarray(obs), jnp.asarray(weights))
    de, dp, _ = t_ba.refine_cameras(*_t(intrs, extrs0, points, obs, weights), iterations=10)
    for e, _ in got:
        np.testing.assert_array_equal(e, got[0][0])
    extrs_sh, points_sh = got[0][0], np.concatenate([p for _, p in got])
    pix = _pixels(intrs, extrs_sh, points_sh)
    np.testing.assert_allclose(pix, _pixels(intrs, np.asarray(je), np.asarray(jp)), rtol=0, atol=PIXEL_ATOL)
    np.testing.assert_allclose(pix, _pixels(intrs, de.numpy(), dp.numpy()), rtol=0, atol=PIXEL_ATOL)
    r, _, _ = t_ba._project_residuals(*_t(intrs, extrs_sh, points_sh, obs, weights))
    r0, _, _ = t_ba._project_residuals(*_t(intrs, extrs0, points, obs, weights))
    assert float((r**2).mean()) < float((r0**2).mean()) * 1e-4  # the JAX test's bar


def test_weights_are_linear_not_squared():
    """A weight-2 observation acts as two weight-1 duplicates (the JAX test)."""
    rng = np.random.default_rng(0)
    intrs, extrs, points, obs, weights = make_ba_problem(rng)
    obs = obs + rng.normal(size=obs.shape).astype(np.float32) * 2.0
    weights = np.where(weights > 0, 1.0, 0.0).astype(np.float32)
    half = points.shape[0] // 2
    w2 = weights.copy()
    w2[:, :half] *= 2.0
    d_w, _, _ = t_ba.gauss_newton_step(*_t(intrs, extrs, points, obs, w2), eliminate_points=False)
    dup = (np.concatenate([points, points[:half]]), np.concatenate([obs, obs[:, :half]], axis=1),
           np.concatenate([weights, weights[:, :half]], axis=1))
    d_dup, _, _ = t_ba.gauss_newton_step(*_t(intrs, extrs, *dup), eliminate_points=False)
    np.testing.assert_allclose(d_w.numpy(), d_dup.numpy(), rtol=1e-4, atol=1e-6)
