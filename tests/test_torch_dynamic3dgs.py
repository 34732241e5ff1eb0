"""Port parity on the CPU for the Dynamic 3D Gaussians baseline
(`mvtracker_torch/models/dynamic3dgs.py`), on the JAX tests' fixture
(`tests/test_dynamic3dgs.py`): every stage against the JAX function on the
same state, the random draws (views, split offsets) passed in from JAX, and
the whole fit held to the JAX test's property with the port's own
generator."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.evaluation.cached import CachedPredictionPredictor
from mvtracker_torch.models import dynamic3dgs as t_d3
from mvtracker_torch.ops import gsplat as t_gs
from mvtracker_tpu.models import dynamic3dgs as j_d3
from tests.test_dynamic3dgs import _tiny_cfg, _toy_scene

VALUE_ATOL = 1e-6  # init, refs, advance, densify values
STATE_RTOL = 1e-4  # after a train segment: max |gap| of a leaf over its max |value|


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def log_scales64(xyz, k=4):
    """The initial log-scales from float64 distances (the mean squared
    distance to the k - 1 nearest other points)."""
    x = np.asarray(xyz, np.float64)
    d2 = np.sort(((x[:, None] - x[None]) ** 2).sum(-1), -1)[:, 1:min(k, len(x))]
    return np.log(np.sqrt(np.clip(d2.mean(-1), 1e-7, None)))


def rounding_limit(jax_value, exact):
    """Twice the JAX kNN's own rounding (`knn_xla` expands |q - r|^2; the
    port's plain kNN sums squared differences), measured against float64
    on the same fixture; at least VALUE_ATOL."""
    return max(2 * float(np.abs(np.asarray(jax_value, np.float64) - exact).max()), VALUE_ATOL)


def port_cfg(jcfg):
    return t_d3.D3DGSConfig(**dataclasses.asdict(jcfg))


def to_t(tup, cls):
    def conv(x):
        return {k: conv(v) for k, v in x.items()} if isinstance(x, dict) else torch.from_numpy(np.array(x))

    return cls(*(conv(x) for x in tup))


def assert_tuple_close(got, want, atol=VALUE_ATOL, skip=()):
    for name in want._fields:
        if name in skip:
            continue
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=atol, err_msg=name)


def init_both(sc, jcfg, n_views=2):
    jstate, jr = j_d3.init_from_pointcloud(sc["xyz"], sc["rgb"], sc["is_fg"], n_views, jcfg, sc["extrs"])
    tstate, tr = t_d3.init_from_pointcloud(sc["xyz"], sc["rgb"], sc["is_fg"], n_views, port_cfg(jcfg), sc["extrs"],
                                           device="cpu")
    return jstate, jr, tstate, tr


@pytest.mark.parametrize("capacity", [256, 64])  # 64: the 0.6 budget subsamples the 64 points
def test_init_from_pointcloud(capacity):
    """Each side with its own kNN; the fixture's distances have no ties.
    The log-scales are held to the JAX kNN's own rounding."""
    jstate, jr, tstate, tr = init_both(_toy_scene(), _tiny_cfg(capacity=capacity))
    assert tr == jr
    assert_tuple_close(tstate, jstate, skip=("log_scales",))
    n = min(64, int(capacity * 0.6))
    assert int(tstate.active.sum()) == n
    exact = log_scales64(np.asarray(jstate.means3d)[:n])
    got, want = tstate.log_scales.numpy(), np.asarray(jstate.log_scales)
    np.testing.assert_array_equal(got[n:], want[n:])
    np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=rounding_limit(want[:n, 0], exact))


def test_adam_update():
    rng = np.random.default_rng(0)
    jstate, _, tstate, _ = init_both(_toy_scene(), _tiny_cfg())
    lrs = j_d3._lrs(_tiny_cfg(), 0.3, freeze_shape=False)
    jopt, topt = j_d3._adam_init(jstate), t_d3._adam_init(tstate)
    for _ in range(3):
        g = {k: rng.normal(size=np.shape(getattr(jstate, k))).astype(np.float32) for k in j_d3._TRAINED}
        ju, jopt = j_d3._adam_update({k: jnp.asarray(v) for k, v in g.items()}, jopt, lrs)
        tu, topt = t_d3._adam_update({k: torch.from_numpy(v) for k, v in g.items()}, topt, lrs)
    for k in j_d3._TRAINED:
        for a, b in ((tu[k], ju[k]), (topt.mu[k], jopt.mu[k]), (topt.nu[k], jopt.nu[k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=VALUE_ATOL, rtol=VALUE_ATOL, err_msg=k)
    assert int(topt.count) == int(jopt.count) == 3


def test_rigidity_refs_and_advance():
    """Each side with its own kNN. The fixture's foreground distances have
    no ties, so the foreground rows' neighbours are equal one for one; the
    far positions of background and free slots are evenly spaced, so their
    rows tie, and are left out (their weights are 0 on both sides)."""
    jcfg = _tiny_cfg()
    jstate, _, _, _ = init_both(_toy_scene(), jcfg)
    tstate = to_t(jstate, t_d3.GaussianState)
    jrefs = j_d3.build_rigidity_refs(jstate, jcfg)
    trefs = t_d3.build_rigidity_refs(tstate, port_cfg(jcfg))
    is_fg = np.asarray(jstate.seg_colors[:, 0] > 0.5) & np.asarray(jstate.active)
    assert 0 < is_fg.sum() < len(is_fg)
    j_idx = np.asarray(jrefs.neighbor_idx)
    np.testing.assert_array_equal(trefs.neighbor_idx.numpy()[is_fg], j_idx[is_fg])
    assert is_fg[j_idx[is_fg]].all()
    means = np.asarray(jstate.means3d, np.float64)
    dist64 = np.sqrt(((means[j_idx[is_fg]] - means[is_fg][:, None]) ** 2).sum(-1))
    weight64 = np.exp(-jcfg.rigidity_tau * dist64**2)
    for name, exact in (("neighbor_dist", dist64), ("neighbor_weight", weight64)):
        want = np.asarray(getattr(jrefs, name))
        np.testing.assert_allclose(getattr(trefs, name).numpy()[is_fg], want[is_fg], rtol=0,
                                   atol=rounding_limit(want[is_fg], exact), err_msg=name)
    np.testing.assert_array_equal(trefs.neighbor_weight.numpy()[~is_fg], 0.0)
    np.testing.assert_allclose(trefs.prev_offset.numpy()[is_fg], np.asarray(jrefs.prev_offset)[is_fg],
                               atol=VALUE_ATOL, rtol=VALUE_ATOL)
    assert_tuple_close(trefs, jrefs, skip=("neighbor_idx", "neighbor_dist", "neighbor_weight", "prev_offset"))

    # advance_timestep on the same refs (JAX's) on both sides.
    rng = np.random.default_rng(1)
    moved_j = jstate._replace(means3d=jstate.means3d + jnp.asarray(rng.normal(0, 0.05, (256, 3)), jnp.float32),
                              unnorm_rotations=jnp.asarray(rng.normal(size=(256, 4)), jnp.float32))
    js, jr = j_d3.advance_timestep(moved_j, jrefs)
    ts, tr = t_d3.advance_timestep(to_t(moved_j, t_d3.GaussianState), to_t(jrefs, t_d3.RigidityRefs))
    assert_tuple_close(ts, js)
    assert_tuple_close(tr, jr)


def test_densify_with_jax_split_noise():
    """Clones and splits into a pool of free slots too small for every
    request (the last requests dropped, not wrapped), prunes by opacity, and
    zeroed moments; JAX's split draws passed in."""
    jcfg = _tiny_cfg(capacity=96)
    jstate, radius, _, _ = init_both(_toy_scene(), jcfg)
    rng = np.random.default_rng(2)
    c = jcfg.capacity
    big = np.log(0.5 * radius)
    log_scales = np.where(rng.random((c, 1)) < 0.5, -8.0, big).astype(np.float32) * np.ones((1, 3), np.float32)
    opac = rng.normal(0.0, 3.0, c).astype(np.float32)
    opac[:4] = -10.0  # pruned
    jstate = jstate._replace(log_scales=jnp.asarray(log_scales), logit_opacities=jnp.asarray(opac),
                             unnorm_rotations=jnp.asarray(rng.normal(size=(c, 4)), jnp.float32))
    jstats = j_d3.DensifyStats(grad_accum=jnp.asarray(rng.uniform(1.5e-4, 1.5e-3, c), jnp.float32),
                               denom=jnp.asarray(rng.integers(0, 3, c) + (rng.random(c) < 0.9), jnp.float32),
                               max_radius=jnp.ones((c,)))
    jopt = j_d3._adam_init(jstate)
    jopt = jopt._replace(mu={k: v + 1.0 for k, v in jopt.mu.items()}, nu={k: v + 2.0 for k, v in jopt.nu.items()})
    key = jax.random.PRNGKey(7)
    for iteration in (600, jcfg.densify_until, 3000):
        want = j_d3.densify(jstate, jopt, jstats, key, radius, jnp.asarray(iteration), jcfg)
        noise = torch.from_numpy(np.asarray(jax.random.normal(key, (2, c, 3))))
        got = t_d3.densify(to_t(jstate, t_d3.GaussianState), to_t(jopt, t_d3.AdamState),
                           to_t(jstats, t_d3.DensifyStats), radius, iteration, port_cfg(jcfg), split_noise=noise)
        assert_tuple_close(got[0], want[0])
        for part in ("mu", "nu"):
            for k in j_d3._TRAINED:
                np.testing.assert_array_equal(getattr(got[1], part)[k].numpy(), np.asarray(getattr(want[1], part)[k]))
        assert_tuple_close(got[2], want[2])
    requests = np.asarray(jstate.active) & (np.asarray(jstats.grad_accum / np.maximum(jstats.denom, 1)) >= 2e-4) & (
        np.asarray(jstats.denom) > 0)
    assert requests.sum() > (~np.asarray(jstate.active)).sum()  # some requests dropped


def views_of(sc, rng):
    v, h, w = sc["intrs"].shape[0], 32, 32
    im = rng.uniform(size=(v, h, w, 3)).astype(np.float32)
    seg = (rng.random((v, h, w)) < 0.4).astype(np.float32)
    seg3 = np.stack([seg, np.zeros_like(seg), 1 - seg], -1)
    return {"im": im, "seg": seg3, "intr": sc["intrs"], "w2c": sc["extrs"]}


@pytest.mark.parametrize("is_initial", [True, False])
def test_train_segment_with_jax_view_draws(is_initial):
    jcfg = _tiny_cfg(floor_axis=1, rigidity_tau=10.0)
    sc = _toy_scene()
    jstate, radius, _, _ = init_both(sc, jcfg)
    jrefs = j_d3.build_rigidity_refs(jstate, jcfg)
    if not is_initial:
        jstate, jrefs = j_d3.advance_timestep(jstate._replace(means3d=jstate.means3d + 0.01), jrefs)
    views = views_of(sc, np.random.default_rng(3))
    n_iters, key = 4, jax.random.PRNGKey(3)
    draws = torch.tensor([int(jax.random.randint(k, (), 0, 2)) for k in jax.random.split(key, n_iters)])
    assert len(set(draws.tolist())) == 2
    jopt, jstats = j_d3._adam_init(jstate), j_d3._zero_stats(jcfg.capacity)
    want = j_d3.train_segment(jstate, jopt, jstats, jrefs, {k: jnp.asarray(v) for k, v in views.items()}, key,
                              radius, jcfg, is_initial, (32, 32), n_iters, 64)
    got = t_d3.train_segment(to_t(jstate, t_d3.GaussianState), to_t(jopt, t_d3.AdamState),
                             to_t(jstats, t_d3.DensifyStats), to_t(jrefs, t_d3.RigidityRefs),
                             {k: torch.from_numpy(v) for k, v in views.items()}, radius, port_cfg(jcfg), is_initial,
                             (32, 32), n_iters, 64, view_draws=draws)
    limits = dict.fromkeys(j_d3.GaussianState._fields, STATE_RTOL)
    if not is_initial:
        # After `advance_timestep` the relative rotations are the identity up
        # to rounding, so the rotation term's first gradient is rounding
        # noise, which Adam (eps 1e-15) turns into whole steps of lr. JAX's
        # own spread (the same segment at chunk 32, another summation order)
        # sets the rotations' limit: twice it (1.15e-3 on this fixture).
        ctl = j_d3.train_segment(jstate, jopt, jstats, jrefs, {k: jnp.asarray(v) for k, v in views.items()}, key,
                                 radius, jcfg, is_initial, (32, 32), n_iters, 32)
        spread = np.abs(np.asarray(ctl[0].unnorm_rotations) - np.asarray(want[0].unnorm_rotations)).max()
        limits["unnorm_rotations"] = max(STATE_RTOL, 2 * spread / np.abs(np.asarray(want[0].unnorm_rotations)).max())
    for name in j_d3.GaussianState._fields:
        a, b = getattr(got[0], name).numpy(), np.asarray(getattr(want[0], name))
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b)
            continue
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert rel <= limits[name], f"{name}: relative gap {rel}, limit {limits[name]}"
    for name in j_d3.DensifyStats._fields:
        a, b = getattr(got[2], name).numpy(), np.asarray(getattr(want[2], name))
        assert np.abs(a - b).max() <= STATE_RTOL * max(np.abs(b).max(), 1e-12), name
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=STATE_RTOL)
    moved = np.abs(np.asarray(want[0].means3d) - np.asarray(jstate.means3d)).max()
    assert moved > 0


def test_extract_tracks_and_export(tmp_path):
    rng = np.random.default_rng(4)
    tt, c, n = 3, 48, 7
    fitted = {"means3d": rng.normal(size=(tt, c, 3)).astype(np.float32),
              "rotations": rng.normal(size=(tt, c, 4)).astype(np.float32),
              "log_scales": rng.uniform(-2, -0.5, (c, 3)).astype(np.float32),
              "logit_opacities": rng.normal(size=c).astype(np.float32),
              "active": rng.random(c) < 0.8}
    fitted["rotations"] /= np.linalg.norm(fitted["rotations"], axis=-1, keepdims=True)
    q = np.concatenate([rng.integers(0, tt, (n, 1)), rng.normal(size=(n, 3))], 1).astype(np.float32)
    depths = rng.uniform(0.5, 3.0, (2, tt, 16, 20)).astype(np.float32)
    intrs = np.tile(np.array([[15.0, 0, 10], [0, 15.0, 8], [0, 0, 1]], np.float32), (2, 1, 1))
    extrs = np.tile(np.concatenate([np.eye(3), [[0], [0], [2.0]]], 1).astype(np.float32), (2, 1, 1))
    want = j_d3.extract_tracks(fitted, q, depths, intrs, extrs, vis_threshold=0.5)
    got = t_d3.extract_tracks(fitted, q, depths, intrs, extrs, vis_threshold=0.5, device="cpu")
    np.testing.assert_allclose(got[0], want[0], atol=VALUE_ATOL, rtol=VALUE_ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(t_d3.extract_tracks(fitted, q, device="cpu")[1], np.ones((tt, n), bool))

    t_d3.export_cached_predictions(tmp_path / "seq0_tracks.npz", got[0], got[1])
    pred = CachedPredictionPredictor(str(tmp_path))
    pred.set_sequence("seq0")
    out = pred(np.zeros((1, tt, 2, 8, 8, 3)), None, q, None, None)
    np.testing.assert_array_equal(out["traj"], got[0].astype(np.float32))
    np.testing.assert_array_equal(out["occluded"], ~got[1])


def test_fit_scene_follows_rigid_motion():
    """The JAX test's property (`tests/test_dynamic3dgs.py::
    test_fit_scene_end_to_end_and_rigid_tracks`) on its fixture, with the
    port's generator: a foreground square moving +0.15 per frame; the
    track of a query on it must move more than 0.08 over two frames."""
    t_total, v, h, w = 3, 2, 32, 32
    sc = _toy_scene(t_total=t_total, v=v, h=h, w=w)
    cfg = port_cfg(_tiny_cfg(iters_rest=200, segment_iters=50, lr_means_scale=0.02, rigidity_tau=10.0))
    n = sc["xyz"].shape[0]
    n_fg = n // 2
    video = np.zeros((v, t_total, h, w, 3), np.float32)
    seg = np.zeros((v, t_total, h, w), np.float32)
    attrs = torch.from_numpy(np.concatenate([sc["rgb"], np.stack([sc["is_fg"], np.zeros(n), 1 - sc["is_fg"]], -1)],
                                            -1).astype(np.float32))
    first = None
    for t in range(t_total):
        xyz_t = sc["xyz"].copy()
        xyz_t[:n_fg, 0] += 0.15 * t
        first = xyz_t[:n_fg].copy() if first is None else first
        for vi in range(v):
            out = t_gs.render_gaussians(
                torch.from_numpy(xyz_t), torch.tensor([1.0, 0, 0, 0]).repeat(n, 1), torch.full((n, 3), np.log(0.05)),
                torch.full((n,), 6.0), attrs, torch.from_numpy(sc["intrs"][vi]), torch.from_numpy(sc["extrs"][vi]),
                (w, h))
            video[vi, t] = out.rgb[..., :3].numpy()
            seg[vi, t] = out.rgb[..., 3].numpy()
    # One chunk of all slots: the same render as JAX's chunk of 64, fewer ops.
    fitted = t_d3.fit_scene(video, seg, sc["intrs"], sc["extrs"], sc["xyz"], sc["rgb"], sc["is_fg"], cfg,
                            chunk=cfg.capacity, device="cpu")
    assert fitted["means3d"].shape == (t_total, cfg.capacity, 3) and np.isfinite(fitted["means3d"]).all()
    tracks, vis = t_d3.extract_tracks(fitted, np.array([[0.0, *first[0]]], np.float32), device="cpu")
    assert tracks.shape == (t_total, 1, 3) and vis.all()
    dx = tracks[-1, 0, 0] - tracks[0, 0, 0]
    assert dx > 0.08, f"the track did not follow the foreground, dx={dx}"
