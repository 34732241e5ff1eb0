"""Port parity for the other tracker families on the CPU: the triplane
`MultiViewSpaTracker`, `MVTracker` with the LoFTR support memory, and the
learned 2D tracker `CoTracker2D` with its `LearnedTracker2D` wrapper, each
against the JAX package's module on the same scene and weights (the JAX
model's initial parameters with random biases and norm parameters and a
scaled-up flow head, mapped by `params_from_flax`). Forward outputs with
`is_train` (the per-window predictions too), and every gradient leaf of
the tracking loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.convert import params_from_flax
from mvtracker_torch.models import mvtracker as t_mvt
from mvtracker_torch.models.cotracker2d import CoTracker2D, LearnedTracker2D
from mvtracker_torch.models.spatracker import MultiViewSpaTracker
from mvtracker_torch.training import step as t_step
from mvtracker_tpu.models import cotracker2d as j_cot
from mvtracker_tpu.models.mvtracker import MVTracker as JaxMVTracker
from mvtracker_tpu.models.spatracker import MultiViewSpaTracker as JaxSpaTracker
from mvtracker_tpu.training import step as j_step
from tests.test_model import make_scene
from tests.test_torch_step import (
    DEAD_BIAS_ATOL,
    ENC_GRAD_L2,
    ENC_GRAD_RTOL,
    is_dead_bias,
    is_noisy_encoder_weight,
    rel_gaps,
)

BASE = dict(sliding_window_len=4, stride=4, fmaps_dim=16, num_heads=2, hidden_size=32, space_depth=1, time_depth=1,
            num_virtual_tracks=4, corr_n_levels=2)
SPAT = dict(BASE, triplane_res=16, corr_patch_radius=1, support_memory_tokens=6)
COT = dict(BASE, corr_patch_radius=2)
MEM = dict(BASE, corr_neighbors=4, support_memory_tokens=8)
ITERS, GAMMA, VIS_WEIGHT = 2, 0.8, 0.1
# Gain on the flow head's initial weights, so that tracks move by about a
# tenth of a unit (the JAX initialisation's std 1e-3 leaves them in place).
FLOW_HEAD_GAIN = 10.0
# fp32 both sides (the stated limits of the slice): traj 1e-5, vis 1e-4.
# Readings: SpaTracker traj 3e-7, vis 1e-6; CoTracker2D traj 1e-7, vis 3e-6.
TRAJ_ATOL, VIS_ATOL = 1e-5, 1e-4
# The query features: bilinear samples of planes that are sums of thousands
# of deposits (SpaTracker) or of the encoder's feature maps (CoTracker2D),
# values up to about 2; readings 8e-6 and 3e-5.
FEAT_ATOL = 1e-4
# Gradient leaves, max |gap| over the leaf's largest entry; the encoder's
# ill-conditioned conv weights and dead biases keep the limits of
# `tests/test_torch_step.py`, whose control names their size.
GRAD_RTOL = 1e-4
LOSS_RTOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    """One intra-op thread while this file runs (several worker processes
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_params(jax_model, scene, seed):
    """The JAX model's initial parameters with N(0, 0.1) added to every bias
    and norm scale, N(0, 1) to the support-memory bank, and the flow head
    scaled by FLOW_HEAD_GAIN. The bank starts as one value repeated: its
    tokens stay equal through every layer, so the last cross layer's query
    and key projections get no gradient at all (both sides return rounding
    noise of 1e-12 there); distinct tokens give them one."""
    params = jax_model.init(jax.random.PRNGKey(seed), *scene, iters=1)
    rng = np.random.default_rng(seed + 1)

    def bump(path, x):
        name, x = jax.tree_util.keystr(path), np.asarray(x)
        if "'bias'" in name or "'scale'" in name:
            x = x + rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        if "flow_head" in name and "'kernel'" in name:
            x = x * FLOW_HEAD_GAIN
        if "support_memory" in name:
            x = x + rng.normal(0.0, 1.0, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(bump, params)


def port_model(cls, cfg, params, **kw):
    model = cls(**cfg, device="cpu", **kw).eval()
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def scene_3d(seed, v=2, t=6, n=5):
    return [np.array(a) for a in make_scene(np.random.default_rng(seed), v=v, t=t, h=32, w=32, n=n)]


def scene_2d(seed, t=6, n=5):
    """One view; queries (t, x, y, 0) inside the image."""
    rng = np.random.default_rng(seed)
    rgbs, depths, query, intrs, extrs = scene_3d(seed, v=1, t=t, n=n)
    query[:, 1:3] = rng.uniform(4, 28, (n, 2))
    query[:, 3] = 0
    return [rgbs, depths, query, intrs, extrs]


def assert_forward_matches(got, want, query):
    for key, tol in (("traj", TRAJ_ATOL), ("vis", VIS_ATOL), ("feat_init", FEAT_ATOL)):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), atol=tol, err_msg=key)
    traj = np.asarray(want["traj"])
    assert np.median(np.abs(traj - query[None, :, 1:]).max(-1)) > 1e-2  # the updates are large enough to matter
    g, w = got["train_data"], want["train_data"]
    cp, wcp = g["coord_predictions"].detach().numpy(), np.asarray(w["coord_predictions"])
    n_exec = cp.shape[0]  # the port stacks the windows that run; JAX masks its extra ones
    assert bool(np.asarray(w["window_valid"])[:n_exec].all()) and not np.asarray(w["window_valid"])[n_exec:].any()
    np.testing.assert_allclose(cp, wcp[:n_exec], atol=TRAJ_ATOL)
    np.testing.assert_allclose(g["vis_predictions"].detach().numpy(), np.asarray(w["vis_predictions"])[:n_exec],
                               atol=VIS_ATOL * 10)  # logits, before the sigmoid
    np.testing.assert_array_equal(g["window_active"].numpy(), np.asarray(w["window_active"])[:n_exec])


@pytest.fixture(scope="module")
def spatracker():
    scene = scene_3d(0)
    params = seeded_params(JaxSpaTracker(**SPAT), scene, seed=0)
    return scene, params, port_model(MultiViewSpaTracker, SPAT, params)


def test_spatracker_input_width():
    """The update transformer's input at the config's width (4 levels,
    radius 3, 128 channels): (64+1)*3 + 3*4*49 + 128 + 2 = 913, as JAX."""
    model = MultiViewSpaTracker(device="cpu", space_depth=1, time_depth=1)
    assert model.updateformer_input_dim == JaxSpaTracker().updateformer_input_dim == 913
    assert model.support_memory_tokens == 100 and model.updateformer.support_memory.shape == (1, 100, 384)
    assert model.triplane_res == 64 and model.corr_patch_radius == 3


def test_spatracker_forward_matches_jax(spatracker):
    scene, params, model = spatracker
    want = JaxSpaTracker(**SPAT).apply(params, *scene, iters=ITERS, is_train=True)
    got = model(*scene, iters=ITERS, is_train=True)
    assert got["traj"].shape == (6, 5, 3) and got["vis"].shape == (6, 5)
    assert_forward_matches(got, want, scene[2])


def test_spatracker_single_view(spatracker):
    """V=1 is the monocular SpaTracker configuration."""
    _, params, model = spatracker
    scene = scene_3d(1, v=1, t=4, n=4)
    want = JaxSpaTracker(**SPAT).apply(params, *scene, iters=1)
    got = model(*scene, iters=1)
    np.testing.assert_allclose(got["traj"].numpy(), np.asarray(want["traj"]), atol=TRAJ_ATOL)
    np.testing.assert_allclose(got["vis"].numpy(), np.asarray(want["vis"]), atol=VIS_ATOL)


def test_spatracker_runs_no_knn(spatracker, monkeypatch):
    """The triplane path has no kNN and no neighbour correlation."""
    scene, _, model = spatracker

    def refuse(*args, **kwargs):
        raise AssertionError("the triplane path called a kNN or a neighbour correlation")

    monkeypatch.setattr(t_mvt.knn_ops, "knn", refuse)
    monkeypatch.setattr(t_mvt.corr_ops, "corr_sample", refuse)
    out = model(*scene, iters=1)
    assert torch.isfinite(out["traj"]).all()


def gt_scene(scene, seed):
    """`scene` as the loss's dict, with noisy ground truth around the queries."""
    rng = np.random.default_rng(seed)
    rgbs, depths, query, intrs, extrs = scene
    t, n = rgbs.shape[1], query.shape[0]
    return dict(rgbs=rgbs, depths=depths, query_points=query, intrs=intrs, extrs=extrs,
                traj_gt=(query[None, :, 1:] + rng.normal(size=(t, n, 3)) * 0.1).astype(np.float32),
                vis_gt=(rng.random((t, n)) > 0.3).astype(np.float32),
                valid=(rng.random((t, n)) > 0.1).astype(np.float32))


def assert_loss_and_grads_match(jax_model, model, params, scene):
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, sc: j_step.scene_loss(jax_model, p, sc, ITERS, GAMMA, VIS_WEIGHT), has_aux=True
    ))
    (total, _), want_flax = value_and_grad(params, {k: jnp.asarray(v) for k, v in scene.items()})
    model.zero_grad(set_to_none=True)
    got_total, _ = t_step.scene_loss(model, scene, ITERS, GAMMA, VIS_WEIGHT)
    got_total.backward()
    np.testing.assert_allclose(float(got_total.detach()), float(total), rtol=LOSS_RTOL)
    got = {name: p.grad for name, p in model.named_parameters()}
    want = params_from_flax(jax.tree.map(np.asarray, want_flax))
    assert set(got) == set(want)
    for name, (rel, l2, absolute) in rel_gaps(got, want).items():
        if is_dead_bias(name):
            assert absolute <= DEAD_BIAS_ATOL, (name, absolute)
        elif is_noisy_encoder_weight(name):
            assert rel <= ENC_GRAD_RTOL and l2 <= ENC_GRAD_L2, (name, rel, l2)
        else:
            assert rel <= GRAD_RTOL, (name, rel)
    # The memory bank and its LoFTR layers get gradient.
    assert float(want["updateformer.support_memory"].abs().max()) > 0
    assert float(want["updateformer.gnn.layers.5.mlp.2.weight"].abs().max()) > 0


def test_spatracker_loss_gradients_match_jax(spatracker):
    scene, params, model = spatracker
    assert_loss_and_grads_match(JaxSpaTracker(**SPAT), model, params, gt_scene(scene, 7))


def test_mvtracker_support_memory_matches_jax():
    """`MVTracker(support_memory_tokens=)` constructs and runs, as JAX."""
    scene = scene_3d(2)
    params = seeded_params(JaxMVTracker(**MEM), scene, seed=2)
    assert params["params"]["updateformer"]["support_memory"].shape == (1, 8, 32)
    model = port_model(t_mvt.MVTracker, MEM, params)
    want = JaxMVTracker(**MEM).apply(params, *scene, iters=ITERS, is_train=True)
    got = model(*scene, iters=ITERS, is_train=True)
    assert_forward_matches(got, want, scene[2])


def test_take_frames_maps_any_tree():
    frames = torch.tensor([2, 0])
    tree = {"a": torch.arange(12).reshape(3, 4), "b": [(torch.arange(3), None)]}
    out = t_mvt.take_frames(tree, frames)
    assert out["a"].tolist() == [[8, 9, 10, 11], [0, 1, 2, 3]]
    assert out["b"][0][0].tolist() == [2, 0] and out["b"][0][1] is None and isinstance(out["b"][0], tuple)


@pytest.fixture(scope="module")
def cotracker():
    scene = scene_2d(3)
    params = seeded_params(j_cot.CoTracker2D(**COT), scene, seed=3)
    return scene, params, port_model(CoTracker2D, COT, params)


def test_cotracker2d_forward_matches_jax(cotracker):
    scene, params, model = cotracker
    want = j_cot.CoTracker2D(**COT).apply(params, *scene, iters=ITERS, is_train=True)
    got = model(*scene, iters=ITERS, is_train=True)
    assert model.updateformer_input_dim == j_cot.CoTracker2D(**COT).updateformer_input_dim
    assert_forward_matches(got, want, scene[2])


def test_cotracker2d_loss_gradients_match_jax(cotracker):
    scene, params, model = cotracker
    sc = gt_scene(scene, 8)
    sc["traj_gt"][..., 2] = 0.0  # z is supervised to 0
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, s: j_step.scene_loss(j_cot.CoTracker2D(**COT), p, s, ITERS, GAMMA, VIS_WEIGHT), has_aux=True
    ))
    (total, _), want_flax = value_and_grad(params, {k: jnp.asarray(v) for k, v in sc.items()})
    model.zero_grad(set_to_none=True)
    got_total, _ = t_step.scene_loss(model, sc, ITERS, GAMMA, VIS_WEIGHT)
    got_total.backward()
    np.testing.assert_allclose(float(got_total.detach()), float(total), rtol=LOSS_RTOL)
    want = params_from_flax(jax.tree.map(np.asarray, want_flax))
    for name, (rel, l2, absolute) in rel_gaps({n: p.grad for n, p in model.named_parameters()}, want).items():
        if is_dead_bias(name):
            assert absolute <= DEAD_BIAS_ATOL, (name, absolute)
        elif is_noisy_encoder_weight(name):
            assert rel <= ENC_GRAD_RTOL and l2 <= ENC_GRAD_L2, (name, rel, l2)
        else:
            assert rel <= GRAD_RTOL, (name, rel)


def test_learned_tracker2d_matches_jax(cotracker):
    """The adapter's 2D contract: tracks [T, M, 2] and visibility [T, M]."""
    _, params, model = cotracker
    rng = np.random.default_rng(4)
    rgbs = rng.uniform(0, 255, (6, 32, 32, 3)).astype(np.float32)
    queries = np.stack([rng.integers(0, 3, 5), rng.uniform(4, 28, 5), rng.uniform(4, 28, 5)], -1).astype(np.float32)
    want_tracks, want_vis = j_cot.LearnedTracker2D(j_cot.CoTracker2D(**COT), params, n_iters=2)(rgbs, queries)
    tracks, vis = LearnedTracker2D(model, n_iters=2)(rgbs, queries)
    assert tracks.shape == (6, 5, 2) and vis.shape == (6, 5)
    np.testing.assert_allclose(tracks.numpy(), np.asarray(want_tracks), atol=TRAJ_ATOL)
    np.testing.assert_allclose(vis.numpy(), np.asarray(want_vis), atol=VIS_ATOL)


def test_checkpoint_2d_msgpack_matches_jax(cotracker, tmp_path):
    """`cotracker2d` with `checkpoint_2d` pointing at a flax msgpack file
    (the JAX package's format for it) tracks as the JAX model with those
    params."""
    import flax.serialization

    from mvtracker_torch import config as t_config

    _, params, _ = cotracker
    path = tmp_path / "cotracker2d.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(jax.tree.map(np.asarray, params["params"])))
    mc = t_config.ModelConfig(name="cotracker2d", checkpoint_2d=str(path), **COT)
    adapter = t_config.build_model(mc, device="cpu")
    rng = np.random.default_rng(5)
    rgbs = rng.uniform(0, 255, (6, 32, 32, 3)).astype(np.float32)
    queries = np.stack([rng.integers(0, 3, 4), rng.uniform(4, 28, 4), rng.uniform(4, 28, 4)], -1).astype(np.float32)
    want_tracks, want_vis = j_cot.LearnedTracker2D(j_cot.CoTracker2D(**COT), params, n_iters=4)(rgbs, queries)
    tracks, vis = adapter.tracker_2d(rgbs, queries)
    np.testing.assert_allclose(tracks.numpy(), np.asarray(want_tracks), atol=TRAJ_ATOL)
    np.testing.assert_allclose(vis.numpy(), np.asarray(want_vis), atol=VIS_ATOL)
