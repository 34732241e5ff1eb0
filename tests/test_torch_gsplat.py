"""Port parity on the CPU for the gaussian splatting renderer
(`mvtracker_torch/ops/gsplat.py`) and the numpy utilities the splatting
baselines share (`mvtracker_torch/utils/misc.py`): seeded numpy inputs
through the JAX function and its port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.ops import gsplat as t_gs
from mvtracker_torch.utils import misc as t_misc
from mvtracker_tpu.ops import gsplat as j_gs
from mvtracker_tpu.utils import misc as j_misc

ELEMENTWISE_ATOL = 1e-6  # rotation helpers, projection, influence
RENDER_ATOL = 1e-5  # rgb, alpha, depth; ssim
GRAD_RTOL = 1e-4  # max |gap| of a gradient leaf over its max |value|


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def scene(n=40, w=32, h=24, seed=0):
    """n gaussians in front of a pinhole camera, some behind it or off
    screen, with random rotations, anisotropic scales, opacities and 5
    attribute channels; several at one depth (ties in the depth sort)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n), rng.uniform(-1.0, 2.0, n)], -1)
    means[:6, 2] = 0.5
    means[6, 2] = -5.0  # behind the camera
    means[7, 0] = 30.0  # off screen
    g = {
        "means3d": means.astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "log_scales": rng.uniform(-3.0, -1.0, (n, 3)).astype(np.float32),
        "logit_opacities": rng.normal(0.0, 2.0, n).astype(np.float32),
        "colors": rng.uniform(size=(n, 5)).astype(np.float32),
    }
    f = 30.0
    intr = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]], np.float32)
    c, s = np.cos(0.2), np.sin(0.2)
    w2c = np.array([[c, 0, s, 0.1], [0, 1, 0, -0.05], [-s, 0, c, 3.0]], np.float32)
    return g, intr, w2c, (w, h)


def test_misc_utilities_equal():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(200, 3))
    np.testing.assert_array_equal(t_misc.farthest_point_sampling(pts, 17, seed=3),
                                  j_misc.farthest_point_sampling(pts, 17, seed=3))
    pred, gt = rng.normal(size=(5, 9, 3)), rng.normal(size=(5, 9, 3))
    vis = rng.random((5, 9)) > 0.3
    assert t_misc.trajectory_errors(pred, gt, vis) == j_misc.trajectory_errors(pred, gt, vis)
    assert t_misc.trajectory_errors(pred, gt) == j_misc.trajectory_errors(pred, gt)


def test_depth_ztest_visibility_exact():
    """Points at, in front of and behind the depth surface, behind the
    camera, off the image (clipped) and at z=0 (nan_to_num)."""
    rng = np.random.default_rng(2)
    v, tt, h, w, n = 3, 4, 20, 24, 64
    depths = rng.uniform(1.0, 3.0, (v, tt, h, w)).astype(np.float32)
    depths[:, :, :3] = 0.0  # missing depth
    intrs = np.tile(np.array([[20.0, 0, 12], [0, 20.0, 10], [0, 0, 1]], np.float32), (v, 1, 1))
    extrs = np.zeros((v, 3, 4), np.float32)
    for vi in range(v):
        extrs[vi, :, :3] = np.eye(3)
        extrs[vi, 0, 3] = 0.1 * vi
    tracks = rng.normal(0.0, 0.6, (tt, n, 3)).astype(np.float32)
    tracks[..., 2] = rng.uniform(-0.5, 3.5, (tt, n))
    # Half the points placed on view 0's depth surface, a few mm behind it.
    px = rng.integers(0, w, (tt, n // 2))
    py = rng.integers(0, h, (tt, n // 2))
    z = depths[0, np.arange(tt)[:, None], py, px] + rng.uniform(-0.01, 0.03, (tt, n // 2))
    tracks[:, : n // 2] = np.stack([(px - 12) * z / 20.0, (py - 10) * z / 20.0, z], -1)
    tracks[0, -1] = [1.0, 1.0, 0.0]
    tracks[1, -1] = [50.0, -50.0, 1.0]
    want = j_misc.depth_ztest_visibility(tracks, depths, intrs, extrs, 0.02)
    got = t_misc.depth_ztest_visibility(tracks, depths, intrs, extrs, 0.02)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


def test_rotation_helpers():
    rng = np.random.default_rng(3)
    q, q2 = rng.normal(size=(50, 4)).astype(np.float32), rng.normal(size=(50, 4)).astype(np.float32)
    c6 = rng.normal(size=(7, 5, 6)).astype(np.float32)
    ls = rng.uniform(-3.0, 0.5, (5, 3)).astype(np.float32)
    pairs = [
        (t_gs.quat_to_rotmat(t(q)), j_gs.quat_to_rotmat(jnp.asarray(q))),
        (t_gs.quat_multiply(t(q), t(q2)), j_gs.quat_multiply(jnp.asarray(q), jnp.asarray(q2))),
        (t_gs.cont6d_to_rotmat(t(c6)), j_gs.cont6d_to_rotmat(jnp.asarray(c6))),
        (t_gs.rotmat_to_cont6d(t_gs.cont6d_to_rotmat(t(c6))),
         j_gs.rotmat_to_cont6d(j_gs.cont6d_to_rotmat(jnp.asarray(c6)))),
        (t_gs.build_cov3d(t(ls), t(q[:5])), j_gs.build_cov3d(jnp.asarray(ls), jnp.asarray(q[:5]))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ELEMENTWISE_ATOL, rtol=ELEMENTWISE_ATOL)


def test_project_gaussians():
    g, intr, w2c, wh = scene()
    cov = j_gs.build_cov3d(jnp.asarray(g["log_scales"]), jnp.asarray(g["quats"]))
    opac = jax.nn.sigmoid(jnp.asarray(g["logit_opacities"]))
    want = j_gs.project_gaussians(jnp.asarray(g["means3d"]), cov, opac, jnp.asarray(intr), jnp.asarray(w2c), wh)
    got = t_gs.project_gaussians(t(g["means3d"]), t(np.asarray(cov)), t(np.asarray(opac)), t(intr), t(w2c), wh)
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        np.testing.assert_allclose(np.where(np.isinf(a), 0, a), np.where(np.isinf(b), 0, b),
                                   atol=ELEMENTWISE_ATOL, rtol=ELEMENTWISE_ATOL, err_msg=name)
    assert np.isinf(np.asarray(want.depths)).sum() >= 2  # the culled ones


@pytest.mark.parametrize("chunk", [8, 16, 0])  # 0: unchunked (render_reference)
def test_render_gaussians(chunk):
    g, intr, w2c, wh = scene()
    bg = np.array([0.1, 0.2, 0.3, 0.4, 0.5], np.float32)
    jx = {k: jnp.asarray(v) for k, v in g.items()}
    tx = {k: t(v) for k, v in g.items()}
    if chunk:
        want = j_gs.render_gaussians(**jx, intr=jnp.asarray(intr), w2c=jnp.asarray(w2c), img_wh=wh,
                                     bg=jnp.asarray(bg), chunk=chunk)
        got = t_gs.render_gaussians(**tx, intr=t(intr), w2c=t(w2c), img_wh=wh, bg=t(bg), chunk=chunk)
    else:
        want = j_gs.render_reference(*jx.values(), jnp.asarray(intr), jnp.asarray(w2c), wh, bg=jnp.asarray(bg))
        got = t_gs.render_reference(*tx.values(), t(intr), t(w2c), wh, bg=t(bg))
    for name in ("rgb", "alpha", "depth", "radii", "means2d"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=RENDER_ATOL,
                                   err_msg=name)
    assert float(np.asarray(want.alpha).max()) > 0.5


def test_render_gradients_every_input():
    """The gradient of a loss of rgb, alpha and depth for every input,
    `means2d_offset` (the densification statistic) included."""
    g, intr, w2c, wh = scene(n=24, seed=4)
    rng = np.random.default_rng(5)
    targets = [rng.uniform(size=(wh[1], wh[0], 5)).astype(np.float32),
               rng.uniform(size=(wh[1], wh[0])).astype(np.float32)]
    names = ["means3d", "quats", "log_scales", "logit_opacities", "colors"]
    inputs = [g[k] for k in names] + [np.zeros((24, 2), np.float32)]

    def j_loss(*args):
        out = j_gs.render_gaussians(*args[:5], jnp.asarray(intr), jnp.asarray(w2c), wh, chunk=8,
                                    means2d_offset=args[5])
        return (jnp.mean((out.rgb - targets[0]) ** 2) + jnp.mean(jnp.abs(out.alpha - targets[1]))
                + 0.1 * jnp.mean(out.depth))

    want = jax.grad(j_loss, argnums=tuple(range(6)))(*[jnp.asarray(x) for x in inputs])
    leaves = [t(x).requires_grad_(True) for x in inputs]
    out = t_gs.render_gaussians(*leaves[:5], t(intr), t(w2c), wh, chunk=8, means2d_offset=leaves[5])
    loss = (torch.mean((out.rgb - t(targets[0])) ** 2) + torch.mean(torch.abs(out.alpha - t(targets[1])))
            + 0.1 * torch.mean(out.depth))
    got = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(names + ["means2d_offset"], got, want):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        rel = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert rel <= GRAD_RTOL, f"{name}: relative gap {rel}"


def test_checkpointed_chunks_keep_the_gradient():
    """The chunked renderer recomputes each chunk in the backward; its
    gradients equal the unchunked renderer's (one chunk, nothing to
    recompute)."""
    g, intr, w2c, wh = scene(n=24, seed=6)
    grads = []
    for chunk in (4, 24):
        leaves = {k: t(v).requires_grad_(True) for k, v in g.items()}
        out = t_gs.render_gaussians(**leaves, intr=t(intr), w2c=t(w2c), img_wh=wh, chunk=chunk)
        grads.append(torch.autograd.grad(out.rgb.square().mean() + out.depth.mean(), list(leaves.values())))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-4)


def test_ssim():
    rng = np.random.default_rng(7)
    a = rng.uniform(size=(30, 26, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (a, a)):
        np.testing.assert_allclose(float(t_gs.ssim(t(x), t(y))), float(j_gs.ssim(jnp.asarray(x), jnp.asarray(y))),
                                   atol=RENDER_ATOL)


def test_gaussian_influence():
    rng = np.random.default_rng(8)
    args = [rng.normal(size=(9, 3)), rng.normal(size=(6, 3)), rng.normal(size=(6, 4)),
            rng.uniform(-1.5, 0.0, (6, 3)), rng.normal(size=(6,))]
    args = [a.astype(np.float32) for a in args]
    np.testing.assert_allclose(t_gs.gaussian_influence(*map(t, args)).numpy(),
                               np.asarray(j_gs.gaussian_influence(*map(jnp.asarray, args))), atol=ELEMENTWISE_ATOL)
