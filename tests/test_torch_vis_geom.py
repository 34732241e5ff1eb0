"""Port parity: the visibility head's two options, `vis_geom_features` (the
per-view depth z-test features of the final coords) and `vis_head_hidden`
(one exact-GELU hidden layer), against the JAX module's, alone and inside
the whole forward, in fp32 and bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.models import mvtracker as t_mvt
from mvtracker_tpu.models.mvtracker import MVTracker as JaxMVTracker
from tests.test_model import make_scene
from tests.test_torch_modules import carried_weights
from tests.test_torch_mvtracker import BF16_TRAJ_ATOL, BF16_VIS_ATOL, CFG, TRAJ_ATOL, VIS_ATOL

HIDDEN = 16
# fp32 on both sides. The projection's einsums sum in another order (about
# 1e-6 in the clearance), and tanh(c / tau) multiplies that by up to
# 1 / 0.05: measured 2.3e-5 at one of 1680 entries, the rest below 1e-6.
FEAT_ATOL = 1e-4
# The head on those features: the one feature gap above reaches the logits
# (measured 1.1e-5 in fp32). With bf16 track features both sides round the
# z-test features to bf16 before the concatenation.
HEAD_ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _geom_case(seed=0, v=3, s=4, h=20, w=28, n=60):
    """Depths, cameras and points with every way a view can fail to see a
    point: outside the image, behind the camera, over a depth-0 pixel."""
    rng = np.random.default_rng(seed)
    depths = rng.uniform(1.0, 4.0, size=(v, s, h, w)).astype(np.float32)
    depths[0, :, :, : w // 2] = 0.0  # view 0 has no depth on its left half
    intrs = np.zeros((v, s, 3, 3), np.float32)
    intrs[..., 0, 0] = intrs[..., 1, 1] = 25.0
    intrs[..., 0, 2], intrs[..., 1, 2], intrs[..., 2, 2] = w / 2, h / 2, 1.0
    extrs = np.zeros((v, s, 3, 4), np.float32)
    for vi in range(v):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        extrs[vi, :, :, :3] = q * np.sign(np.linalg.det(q))
        extrs[vi, :, :, 3] = (0.0, 0.0, 3.0)
    coords = (rng.normal(size=(s, n, 3)) * np.r_[[0.5] * (n // 2) + [4.0] * (n - n // 2)][None, :, None])
    return depths, intrs, extrs, coords.astype(np.float32)


def _unseen_counts(depths, intrs, extrs, coords):
    """(point-views outside the image, point-views behind the camera)."""
    pix, z = t_mvt.geo.world_to_pixel_xy_and_camera_z(
        torch.from_numpy(coords)[None].expand(depths.shape[0], *coords.shape),
        torch.from_numpy(intrs),
        torch.from_numpy(extrs),
    )
    h, w = depths.shape[-2:]
    x, y = pix[..., 0], pix[..., 1]
    outside = (x < 0) | (x > w - 1) | (y < 0) | (y > h - 1)
    return int(outside.sum()), int((z[..., 0] <= 1e-3).sum())


def test_vis_geom_features_match_jax():
    depths, intrs, extrs, coords = _geom_case()
    outside, behind = _unseen_counts(depths, intrs, extrs, coords)
    assert outside > 0 and behind > 0
    model = t_mvt.MVTracker(**CFG, vis_geom_features=True, device="cpu")
    got = model._vis_geom_features(tuple(map(torch.from_numpy, (depths, intrs, extrs))), torch.from_numpy(coords))
    want = JaxMVTracker(**CFG, vis_geom_features=True)._vis_geom_features(
        tuple(map(jnp.asarray, (depths, intrs, extrs))), jnp.asarray(coords)
    )
    assert got.shape == want.shape == (coords.shape[0], coords.shape[1], 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FEAT_ATOL)
    frac = got[..., -1].numpy()
    # Some points are seen by no view (features at their fill), some by all.
    assert (frac == -1).any() and (frac == 1).any()
    assert (got[..., 0].numpy()[frac == -1] == -1).all() and (got[..., 1].numpy()[frac == -1] == 0).all()


def test_vis_geom_depth_zero_is_not_valid():
    """A point seen only through view 0's depth-0 half counts no valid view."""
    depths, intrs, extrs, coords = _geom_case(v=1)
    model = t_mvt.MVTracker(**CFG, vis_geom_features=True, device="cpu")
    geom = tuple(map(torch.from_numpy, (depths, intrs, extrs)))
    pix, z = t_mvt.geo.world_to_pixel_xy_and_camera_z(torch.from_numpy(coords)[None], *geom[1:])
    left = (pix[0, ..., 0] >= 0) & (pix[0, ..., 0] < depths.shape[-1] // 2 - 1) & (pix[0, ..., 1] >= 0)
    left &= (pix[0, ..., 1] <= depths.shape[-2] - 1) & (z[0, ..., 0] > 1e-3)
    assert left.any()
    feats = model._vis_geom_features(geom, torch.from_numpy(coords))
    assert (feats[..., -1][left] == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vis_head_matches_jax(dtype):
    depths, intrs, extrs, coords = _geom_case(seed=1)
    s, n = coords.shape[:2]
    cfg = dict(CFG, vis_geom_features=True, vis_head_hidden=HIDDEN, compute_dtype=dtype)
    model = t_mvt.MVTracker(**cfg, device="cpu")
    rng = np.random.default_rng(2)
    for p in (model.vis_hidden.weight, model.vis_hidden.bias, model.vis_predictor[0].weight, model.vis_predictor[0].bias):
        p.data = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 0.3)
    params = {"params": {
        "vis_hidden": {"kernel": model.vis_hidden.weight.detach().numpy().T, "bias": model.vis_hidden.bias.detach().numpy()},
        "vis_predictor": {"kernel": model.vis_predictor[0].weight.detach().numpy().T,
                          "bias": model.vis_predictor[0].bias.detach().numpy()},
    }}
    ffeats = rng.normal(size=(s, n, CFG["fmaps_dim"])).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = JaxMVTracker(**cfg).apply(
        params, jnp.asarray(ffeats, jdt), tuple(map(jnp.asarray, (depths, intrs, extrs))), jnp.asarray(coords),
        method=JaxMVTracker._vis_logits,
    )
    with torch.no_grad():
        got = model._vis_logits(
            torch.from_numpy(ffeats).to(tdt), tuple(map(torch.from_numpy, (depths, intrs, extrs))), torch.from_numpy(coords)
        )
    assert got.shape == want.shape == (s, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=HEAD_ATOL)
    # The exact GELU is what matches, not the tanh approximation.
    x = torch.cat([torch.from_numpy(ffeats).to(tdt).float(), model._vis_geom_features(
        tuple(map(torch.from_numpy, (depths, intrs, extrs))), torch.from_numpy(coords)).to(tdt).float()], dim=-1)
    with torch.no_grad():
        approx = model.vis_predictor(torch.nn.functional.gelu(model.vis_hidden(x), approximate="tanh"))[..., 0]
    tanh_gap = np.abs(approx.numpy() - np.asarray(want, np.float32)).max()
    assert tanh_gap > 5 * HEAD_ATOL  # measured 3.7e-4


def _setup(compute_dtype):
    cfg = dict(CFG, vis_geom_features=True, vis_head_hidden=HIDDEN)
    scene = [np.asarray(a) for a in make_scene(np.random.default_rng(0), v=2, t=9, h=96, w=96, n=6)]
    model = t_mvt.MVTracker(**cfg, compute_dtype=compute_dtype, device="cpu").eval()
    sd, params = carried_weights(model, seed=0)
    model.load_state_dict(sd)
    params = jax.tree.map(np.asarray, params)
    params["params"]["vis_hidden"] = {"kernel": sd["vis_hidden.weight"].numpy().T, "bias": sd["vis_hidden.bias"].numpy()}
    return cfg, scene, model, jax.tree.map(jnp.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_vis_options_matches_jax(dtype):
    """The whole forward with both options, two chained windows: each window
    z-tests its own frames of the full-resolution depth."""
    cfg, scene, model, params = _setup(dtype)
    jax_kw = {"corr_backend": "pallas_interpret"} if dtype == "bfloat16" else {}
    want = JaxMVTracker(**cfg, compute_dtype=dtype, **jax_kw).apply(params, *scene, iters=2)
    got = model(*scene, iters=2)
    if dtype == "float32":
        np.testing.assert_allclose(got["traj"].numpy(), np.asarray(want["traj"]), atol=TRAJ_ATOL)
        np.testing.assert_allclose(got["vis"].numpy(), np.asarray(want["vis"]), atol=VIS_ATOL)
    else:
        for key, (max_tol, median_tol) in (("traj", BF16_TRAJ_ATOL), ("vis", BF16_VIS_ATOL)):
            gap = np.abs(got[key].numpy() - np.asarray(want[key]))
            assert gap.max() <= max_tol and np.median(gap) <= median_tol, (key, gap.max(), np.median(gap))
