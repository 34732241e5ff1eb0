"""Port parity: the `MVTracker` options of `mvtracker_torch` against the JAX
module's on the CPU, same scene and weights (the port's seeded weights with
random affine parameters and a scaled flow head, carried to flax by the JAX
package's converter).

- per-level neighbour counts (`corr_neighbors_per_level`, the presets'
  corr_k0), kNN reuse, the invalid-depth filter, the global-match and
  constant-velocity window inits, scene normalization, the kNN statistics,
  and the round-4 evaluation recipe (corr_k0, global match, velocity, reuse)
  all at once: fp32 forwards;
- corr_k0, kNN reuse and scene normalization: the loss and every gradient
  leaf of `scene_loss`, at the tolerances of `tests/test_torch_step.py`.

Readings (max |port - JAX| over all entries, fp32) without global match:
traj 2.4e-7 to 6.9e-6, vis 1.2e-6 to 3.3e-6 (scene normalization and kNN
reuse at the top); the limits leave room for summation order. Global match
has its own limits (`GLOBAL_MATCH_ATOL`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.evaluation import predictor as t_pred
from mvtracker_torch.models import mvtracker as t_mvt
from mvtracker_tpu.evaluation import predictor as j_pred
from mvtracker_tpu.models import mvtracker as j_mvt
from mvtracker_tpu.training import step as j_step
from tests.test_model import make_scene
from tests.test_torch_modules import carried_weights
from tests.test_torch_mvtracker import CFG
from tests.test_torch_step import (
    GAMMA,
    ITERS,
    LOSS_RTOL,
    VIS_WEIGHT,
    Pair,
    assert_fp32_grads_match,
    scene_dict,
)

TRAJ_ATOL, TRAJ_RTOL = 1e-5, 1e-5
VIS_ATOL = 1e-5
# The global-match init places a track almost on one cloud point (softmax
# logits up to 131 at temperature 10 under these weights), where the kNN
# and the offsets that follow are most sensitive: the init itself agrees
# with the JAX formula to 3.0e-6 (`test_global_match_init_matches_jax`),
# and the forward then differs everywhere by a little. Readings with global
# match (max / median / p90 of |gap|): traj 1.4e-3 / 9.3e-6 / 6.9e-5, vis
# 2.1e-3 / 1.2e-5 / 1.5e-4; with the round-4 recipe traj 2.6e-3 / 1.5e-5,
# vis 1.2e-3 / 2.0e-5. Control, the JAX model alone with rgb + 1e-3: traj
# max 5.0e-3 (8.0e-3 with the recipe), vis max 1.1e-2. A fault of the init
# (the query frame not kept, the temperature or the level wrong) moves
# tracks by tenths. Limits on max and median.
GLOBAL_MATCH_ATOL = {"max": 5e-3, "median": 5e-5}


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    """One intra-op thread while this file runs (several test processes
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scene(seed=0, t=9):
    """2 views x t frames x 96^2, 6 queries (levels of 1152, 288, 72, 18
    points: level 0 searched alone, the others in one padded call, the last
    with fewer points than some k)."""
    return [np.array(a) for a in make_scene(np.random.default_rng(seed), v=2, t=t, h=96, w=96, n=6)]


# The parity tests' model (`tests/test_torch_mvtracker.py`) with one space
# and one time block: the JAX side compiles its graph once per case.
OPT_CFG = dict(CFG, space_depth=1, time_depth=1)


def pair(opts, seed=0, cfg=OPT_CFG, **port_opts):
    """(port model, JAX model, flax params) with the same weights."""
    model = t_mvt.MVTracker(**cfg, **opts, **port_opts, device="cpu").eval()
    sd, params = carried_weights(model, seed=seed)
    model.load_state_dict(sd)
    return model, j_mvt.MVTracker(**cfg, **opts), params


def assert_outputs_match(got, want, traj_atol=TRAJ_ATOL, vis_atol=VIS_ATOL):
    # rtol: scene normalization maps tracks back by 1 / scale (about 24 on
    # these scenes), to values up to 11.
    np.testing.assert_allclose(got["traj"].numpy(), np.asarray(want["traj"]), rtol=TRAJ_RTOL, atol=traj_atol)
    np.testing.assert_allclose(got["vis"].numpy(), np.asarray(want["vis"]), rtol=0, atol=vis_atol)


CORR_K0 = dict(corr_neighbors_per_level=(24, 8, 12, 20))
ROUND4 = dict(corr_neighbors_per_level=(24, 20, 20, 20), global_match_init=True, chain_velocity=1.0,
              corr_knn_reuse=True)


@pytest.mark.parametrize("name,opts,iters", [
    # level 0 alone at k=24, levels 1-3 in one call at k=20 keeping their
    # prefixes of 8, 12 and 20 (the 18-point level wraps its ranks)
    ("corr_k0", CORR_K0, 2),
    # one search per window reused by 3 iterations
    ("knn_reuse", dict(corr_knn_reuse=True), 3),
    ("global_match", dict(global_match_init=True), 2),
    ("chain_velocity", dict(chain_velocity=1.0), 2),
    ("normalize_scene", dict(normalize_scene_in_fwd_pass=True), 2),
    ("round4_recipe", ROUND4, 3),
])
def test_option_forward_matches_jax(name, opts, iters):
    model, jm, params = pair(opts)
    sc = scene()
    want = jm.apply(params, *sc, iters=iters)
    got = model(*sc, iters=iters)
    moved = np.abs(np.asarray(want["traj"]) - sc[2][None, :, 1:]).max(-1)[np.asarray(want["vis"]) > 0]
    assert np.median(moved) > 1e-2  # the updates are large enough to matter
    if opts.get("global_match_init"):
        for key in ("traj", "vis"):
            gap = np.abs(got[key].numpy() - np.asarray(want[key]))
            assert gap.max() <= GLOBAL_MATCH_ATOL["max"] and np.median(gap) <= GLOBAL_MATCH_ATOL["median"], (
                key, gap.max(), np.median(gap))
    else:
        assert_outputs_match(got, want)
    np.testing.assert_allclose(got["feat_init"].numpy(), np.asarray(want["feat_init"]), rtol=0, atol=1e-4)


def test_options_change_the_tracks():
    """Each option moves the outputs away from the reference behaviour on a
    scene of three windows, so the parity cases above test something."""
    sc = scene(1, t=12)
    base, _, _ = pair({})
    ref = base(*sc, iters=2)["traj"]
    for opts in (CORR_K0, dict(corr_knn_reuse=True), dict(global_match_init=True), dict(chain_velocity=1.0),
                 dict(normalize_scene_in_fwd_pass=True)):
        model, _, _ = pair(opts)
        assert float((model(*sc, iters=2)["traj"] - ref).abs().max()) > 1e-4, opts


def test_corr_k0_widens_the_input():
    model, jm, _ = pair(CORR_K0)
    assert [model.corr_k(lvl) for lvl in range(4)] == [24, 8, 12, 20]
    want = (64 + 1) * 3 + (24 + 8 + 12 + 20) * 4 + 32 + 2
    assert model.updateformer_input_dim == jm.updateformer_input_dim == want
    assert model.updateformer.input_transform.weight.shape == (64, want)
    with pytest.raises(ValueError, match="corr_neighbors_per_level"):
        t_mvt.MVTracker(**OPT_CFG, corr_neighbors_per_level=(8, 4), device="cpu")


def test_knn_reuse_is_the_exact_search_at_one_iteration():
    """With one iteration the reused search is the iteration's own: the
    outputs equal the model without reuse, bit for bit."""
    sc = scene()
    exact, _, _ = pair({})
    reuse, _, _ = pair(dict(corr_knn_reuse=True))
    a, b = exact(*sc, iters=1), reuse(*sc, iters=1)
    assert torch.equal(a["traj"], b["traj"]) and torch.equal(a["vis"], b["vis"])


def test_knn_reuse_searches_once_per_window(monkeypatch):
    calls = []
    real = t_mvt.knn_ops.knn

    def spy(ref, query, k, backend="auto"):
        calls.append(k)
        return real(ref, query, k, backend=backend)

    monkeypatch.setattr(t_mvt.knn_ops, "knn", spy)
    model, _, _ = pair(dict(corr_knn_reuse=True))
    model(*scene(), iters=3)
    assert len(calls) == 1 + 2 * 2  # feat_init, then 2 windows x (level 0, levels 1-3), whatever the iterations


def holed_scene(all_invalid_frame):
    """Depth holes in every third row; with `all_invalid_frame` frame 3 has
    no valid depth in any view (a sensor dropout)."""
    sc = scene()
    sc[1][:, :, ::3, :] = 0.0
    if all_invalid_frame:
        sc[1][:, 3] = 0.0
    return sc


def test_filter_invalid_depth_matches_jax():
    """Depth holes and a frame with no valid depth (JAX test
    `test_corr_filter_all_invalid_frame`): invalid points at the sentinel,
    sentinel picks to rank 0, indices clamped into the level. The port
    searches with the exact kNN: in the empty frame every distance ties,
    and the JAX search (`lax.top_k`) and the exact kNN both take the lowest
    indices, as they do among the padding of the batched small levels."""
    model, jm, params = pair(dict(corr_filter_invalid_depth=True), knn_backend="exact")
    sc = holed_scene(all_invalid_frame=True)
    want = jm.apply(params, *sc, iters=2)
    got = model(*sc, iters=2)
    assert np.isfinite(got["traj"].numpy()).all() and np.isfinite(got["vis"].numpy()).all()
    assert_outputs_match(got, want)


def test_filter_invalid_depth_changes_tracks_on_holes():
    sc = holed_scene(all_invalid_frame=False)
    on, _, _ = pair(dict(corr_filter_invalid_depth=True))
    off, _, _ = pair({})
    assert float((off(*sc, iters=2)["traj"] - on(*sc, iters=2)["traj"]).abs().max()) > 1e-4


def test_filter_invalid_depth_is_a_no_op_on_full_depth():
    sc = scene()
    off, _, _ = pair({})
    on, _, _ = pair(dict(corr_filter_invalid_depth=True))
    assert torch.equal(off(*sc, iters=2)["traj"], on(*sc, iters=2)["traj"])


def test_filter_invalid_depth_knn_picks():
    """`_corr_knn` on a window with holes and an empty frame: no returned
    distance is a sentinel's, every index lies in its level, and an index
    that fell back points at the query's nearest valid neighbour."""
    model, _, _ = pair(dict(corr_filter_invalid_depth=True))
    sc = holed_scene(all_invalid_frame=True)
    rgbs, depths, query, intrs, extrs = (torch.as_tensor(a) for a in sc)
    fmaps = model.compute_fmaps(rgbs)
    context = model._build_context(fmaps, depths[:, :, ::4, ::4], intrs, extrs)
    context_w = [tuple(a[:6] for a in level) for level in context]  # valid is kept with the filter on
    coords = query[None, :, 1:].expand(6, -1, -1).contiguous()
    dists, idx = model._corr_knn(context_w, coords)
    for lvl, (xyz, _, valid) in enumerate(context_w):
        assert bool((idx[lvl] >= 0).all()) and bool((idx[lvl] < xyz.shape[1]).all())
        real = valid.any(-1)  # frames with a valid point
        assert bool((dists[lvl][real] < 1e8).all())
        picked = torch.gather(valid, 1, idx[lvl].reshape(6, -1)).reshape(idx[lvl].shape)
        assert bool(picked[real].all())  # a valid point, or the fall-back to one
    assert not bool(context_w[0][2][3].any())  # frame 3 has none


def test_global_match_keeps_the_query_frame():
    """The matched init leaves each track at its query on the query's own
    frame and moves it elsewhere; the init takes no gradient."""
    model, _, _ = pair(dict(global_match_init=True))
    sc = scene()
    rgbs, depths, query, intrs, extrs = (torch.as_tensor(a) for a in sc)
    fmaps = model.compute_fmaps(rgbs)
    context = model._build_context(fmaps, depths[:, :, ::4, ::4], intrs, extrs)
    qt, qxyz = query[:, 0].long(), query[:, 1:]
    feat = model._feat_init(context, qt, qxyz).requires_grad_()
    frame_idx = torch.arange(6)
    init = model._global_match([tuple(a[:6] for a in level[:2]) + (None,) for level in context], feat, qxyz, qt,
                               frame_idx)
    at_query = frame_idx[:, None] == qt[None, :]
    assert torch.equal(init[at_query], qxyz[None].expand(6, -1, -1)[at_query])
    assert float((init[~at_query] - qxyz[None].expand(6, -1, -1)[~at_query]).abs().max()) > 1e-3
    assert not init.requires_grad


@pytest.mark.parametrize("level,temp", [(1, 10.0), (0, 3.0)])
def test_global_match_init_matches_jax(level, temp):
    """`_global_match` against the JAX module's formula (einsum, softmax,
    einsum in fp32) on the same features and clouds."""
    model, _, _ = pair(dict(global_match_init=True, global_match_level=level, global_match_temp=temp))
    rgbs, depths, query, intrs, extrs = (torch.as_tensor(a) for a in scene())
    with torch.no_grad():
        context = model._build_context(model.compute_fmaps(rgbs), depths[:, :, ::4, ::4], intrs, extrs)
        qt, qxyz = query[:, 0].long(), query[:, 1:]
        feat = model._feat_init(context, qt, qxyz)
        window = [tuple(a[3:9] for a in lvl[:2]) + (None,) for lvl in context]
        frame_idx = torch.arange(3, 9)
        got = model._global_match(window, feat, qxyz, qt, frame_idx)
    xyz_m, fvec_m = (jnp.asarray(a.numpy()) for a in window[level][:2])
    f = jnp.asarray(feat.numpy())
    corr = jnp.einsum("nc,spc->snp", f, fvec_m) / jnp.sqrt(float(f.shape[-1]))
    match = jnp.einsum("snp,spd->snd", jax.nn.softmax(corr * temp, axis=-1), xyz_m)
    at_query = frame_idx.numpy()[:, None] == qt.numpy()[None, :]
    want = np.where(at_query[..., None], qxyz.numpy()[None], np.asarray(match))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_chain_velocity_leaves_single_window_scenes_alone():
    sc = scene(t=6)
    base, _, _ = pair({})
    vel, _, _ = pair(dict(chain_velocity=1.0))
    assert torch.equal(base(*sc, iters=1)["traj"], vel(*sc, iters=1)["traj"])
    sc = scene(t=9)
    a, b = base(*sc, iters=1)["traj"], vel(*sc, iters=1)["traj"]
    assert torch.equal(a[:3], b[:3]) and float((a[6:] - b[6:]).abs().max()) > 0


def test_scene_transform_matches_jax():
    sc = scene()
    rgbs, depths, query, intrs, extrs = sc
    want = j_mvt.compute_scene_normalization(jnp.asarray(depths), jnp.asarray(extrs), jnp.asarray(intrs))
    got = t_mvt.compute_scene_normalization(torch.as_tensor(depths), torch.as_tensor(extrs), torch.as_tensor(intrs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    pts = np.random.default_rng(3).normal(size=(4, 5, 3)).astype(np.float32)
    fwd = t_mvt.apply_scene_transform(*got, torch.as_tensor(pts))
    np.testing.assert_allclose(fwd.numpy(), np.asarray(j_mvt.apply_scene_transform(*want, jnp.asarray(pts))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_mvt.invert_scene_transform(*got, fwd).numpy(), pts, rtol=0, atol=1e-5)
    # The reference's clamp: every depth below 24 counts as 24.
    raised = t_mvt.compute_scene_normalization(torch.full_like(torch.as_tensor(depths), 24.0),
                                               torch.as_tensor(extrs), torch.as_tensor(intrs))
    assert float(raised[0]) == float(got[0])


def test_collect_stats_matches_jax():
    """The kNN statistics: the same rows in the same order as the JAX
    package's `consume_stats` table (one per window, iteration, level and
    rank), the same mean distances; outputs unchanged by collecting."""
    opts = dict(collect_stats=True)
    model, jm, params = pair(dict(opts, corr_neighbors_per_level=(24, 8, 12, 20)))
    sc = scene()
    want_out, variables = jm.apply(params, *sc, iters=2, mutable=["intermediates"])
    got = model(*sc, iters=2)
    assert_outputs_match(got, want_out)
    want = j_mvt.consume_stats(variables["intermediates"])
    rows = t_mvt.consume_stats(got["knn_stats"])
    assert len(rows) == len(want) == 2 * 2 * (24 + 8 + 12 + 20)
    assert [(r["window"], r["iteration"], r["level"], r["k"]) for r in rows] == list(
        zip(want["window"], want["iteration"], want["level"], want["k"]))
    np.testing.assert_allclose([r["mean_dist"] for r in rows], want["mean_dist"].to_numpy(), rtol=1e-5, atol=1e-6)
    assert "knn_stats" not in pair({})[0](*sc, iters=1)


def test_predictor_consumes_the_model_stats():
    """`EvaluationPredictor(consume_model_stats=True)`: after a call,
    `last_model_stats` holds the rows of the JAX predictor's table (queries
    and a support grid through one forward)."""
    model, jm, params = pair(dict(collect_stats=True))
    sc = scene()
    kw = dict(interp_shape=None, grid_size=2, n_iters=2)
    jp = j_pred.EvaluationPredictor(jm, params, consume_model_stats=True, **kw)
    jp(*sc)
    tp = t_pred.EvaluationPredictor(model, consume_model_stats=True, device="cpu", **kw)
    assert tp.last_model_stats is None
    tp(*sc)
    want, rows = jp.last_model_stats, tp.last_model_stats
    assert len(rows) == len(want) > 0
    assert [(r["window"], r["iteration"], r["level"], r["k"]) for r in rows] == list(
        zip(want["window"], want["iteration"], want["level"], want["k"]))
    np.testing.assert_allclose([r["mean_dist"] for r in rows], want["mean_dist"].to_numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Train step: loss and gradients with the options on
# ---------------------------------------------------------------------------

# 2 levels (1152 and 288 points at 96^2): level 0 searched alone at k=12,
# level 1 at k=8; one space and one time block.
STEP_CFG = dict(OPT_CFG, corr_n_levels=2, corr_neighbors=8)
# corr_k0, kNN reuse and scene normalization at once (one JAX compile).
# Readings, worst gradient leaf outside the encoder over its largest entry:
# 2.2e-5 (the same model without options 4.2e-5, corr_k0 alone 7.1e-5);
# loss relative gap below 2e-7.
STEP_OPTS = dict(corr_neighbors_per_level=(12, 8), corr_knn_reuse=True, normalize_scene_in_fwd_pass=True)


class OptionPair(Pair):
    """`Pair` of `tests/test_torch_step.py` with options on both models."""

    def __init__(self, opts):
        self.model = t_mvt.MVTracker(**STEP_CFG, **opts, device="cpu")
        sd, self.params = carried_weights(self.model, seed=0)
        self.model.load_state_dict(sd)
        jm = j_mvt.MVTracker(**STEP_CFG, **opts, corr_backend="pallas_interpret")
        self._jax = jax.jit(jax.value_and_grad(
            lambda p, sc: j_step.scene_loss(jm, p, sc, ITERS, GAMMA, VIS_WEIGHT), has_aux=True
        ))


def test_train_step_loss_and_gradients_match_jax():
    """Loss, its parts and every gradient leaf of `scene_loss` with corr_k0,
    kNN reuse and scene normalization on, against `jax.value_and_grad` of
    the JAX one on the scene of `tests/test_torch_step.py` (queries in both
    windows), fp32, at that file's tolerances. `reproj_dev` is rounding
    error on both sides and is held as there."""
    pair_ = OptionPair(STEP_OPTS)
    sc = scene_dict(0)
    total_j, parts_j, grads_j = pair_.jax_grads(sc)
    total_t, parts_t, grads_t = pair_.port_grads(sc)
    np.testing.assert_allclose(total_t, total_j, rtol=LOSS_RTOL)
    for key in ("xyz_loss", "vis_loss"):
        np.testing.assert_allclose(parts_t[key], parts_j[key], rtol=LOSS_RTOL, err_msg=key)
    assert 0 <= parts_t["reproj_dev"] < 1e-4 and 0 <= parts_j["reproj_dev"] < 1e-4
    assert_fp32_grads_match(grads_t, grads_j)
