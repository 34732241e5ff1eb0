"""Port parity on the CPU for the Shape-of-Motion baseline
(`mvtracker_torch/models/shape_of_motion.py`): the motion bases, the
quaternion conversion, the initialisation, track extraction and one fit
segment with JAX's draws passed in, against the JAX functions; the whole fit
held to the JAX tests' properties (`tests/test_shape_of_motion.py`) with the
port's own generator."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.models import shape_of_motion as t_som
from mvtracker_torch.ops import gsplat as t_gs
from mvtracker_tpu.models import shape_of_motion as j_som

VALUE_ATOL = 1e-6
STATE_RTOL = 1e-4  # after a fit segment: max |gap| of a leaf over its max |value|


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


def t(x):
    return torch.from_numpy(np.array(x))


def to_t(params):
    return t_som.SOMParams(*(t(x) for x in params))


def port_cfg(jcfg):
    return t_som.SOMConfig(**dataclasses.asdict(jcfg))


def clouds(seed=0, n_fg=12, n_bg=10):
    rng = np.random.default_rng(seed)
    fg = (rng.normal(size=(n_fg, 3)) * 0.2 + [0, 0, 2]).astype(np.float32)
    bg = (rng.normal(size=(n_bg, 3)) * 0.5 + [0, 0, 4]).astype(np.float32)
    return fg, rng.uniform(size=(n_fg, 3)).astype(np.float32), bg, rng.uniform(size=(n_bg, 3)).astype(np.float32)


def random_motion(p, seed):
    """The initial params with moved bases and coefficients, so the blends
    and conversions see real rotations."""
    rng = np.random.default_rng(seed)
    k, tt = np.shape(p.motion_rots)[:2]
    return p._replace(motion_rots=jnp.asarray(np.asarray(p.motion_rots) + rng.normal(0, 0.3, (k, tt, 6)), jnp.float32),
                      motion_transls=jnp.asarray(rng.normal(0, 0.2, (k, tt, 3)), jnp.float32),
                      motion_coefs=p.motion_coefs * 3.0,
                      fg_quats=jnp.asarray(rng.normal(size=np.shape(p.fg_quats)), jnp.float32))


def test_compute_transforms_and_rotmat_to_quat():
    rng = np.random.default_rng(1)
    rots = rng.normal(size=(4, 6, 6)).astype(np.float32)
    transls = rng.normal(size=(4, 6, 3)).astype(np.float32)
    coefs = rng.normal(size=(9, 4)).astype(np.float32)
    ts = np.array([0, 3, 5, 3])
    want = j_som.compute_transforms(j_som.MotionBases(jnp.asarray(rots), jnp.asarray(transls)), jnp.asarray(ts),
                                    jax.nn.softmax(jnp.asarray(coefs)))
    got = t_som.compute_transforms(t_som.MotionBases(t(rots), t(transls)), t(ts), torch.softmax(t(coefs), -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VALUE_ATOL, rtol=VALUE_ATOL)
    # Each of Shepperd's four pivots: rotations near the identity and near
    # a half-turn about x, y and z.
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[:4] = np.eye(4, dtype=np.float32) + 0.01
    r = np.asarray(jax.vmap(j_som.gsplat.quat_to_rotmat)(jnp.asarray(q)))
    np.testing.assert_allclose(t_som._rotmat_to_quat(t(r)).numpy(), np.asarray(j_som._rotmat_to_quat(jnp.asarray(r))),
                               atol=VALUE_ATOL)


def test_init_params_and_poses():
    """Each side with its own kNN; the clouds' distances have no ties. The
    log-scales are held to the JAX kNN's own rounding."""
    fg, fg_rgb, bg, bg_rgb = clouds()
    jcfg = j_som.SOMConfig(num_bases=4)
    want = j_som.init_params(fg, fg_rgb, bg, bg_rgb, 5, jcfg, seed=3)
    got = t_som.init_params(fg, fg_rgb, bg, bg_rgb, 5, port_cfg(jcfg), seed=3, device="cpu")
    scales = {"fg_log_scales": fg, "bg_log_scales": bg}
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        atol = rounding_limit(b[:, 0], log_scales64(scales[name])) if name in scales else VALUE_ATOL
        np.testing.assert_allclose(a, b, atol=atol, rtol=0 if name in scales else VALUE_ATOL, err_msg=name)
    moved = random_motion(want, 4)
    ts = np.array([0, 2, 4])
    for a, b in zip(t_som.fg_poses_at(to_t(moved), t(ts)), j_som.fg_poses_at(moved, jnp.asarray(ts))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=VALUE_ATOL, rtol=VALUE_ATOL)


@pytest.mark.parametrize("topk", [1, 8])
def test_track_points_and_extract(topk):
    fg, fg_rgb, bg, bg_rgb = clouds(seed=5, n_fg=16)
    p = random_motion(j_som.init_params(fg, fg_rgb, bg, bg_rgb, 4, j_som.SOMConfig(num_bases=3), seed=0), 6)
    rng = np.random.default_rng(7)
    q = np.concatenate([rng.integers(0, 4, (6, 1)), fg[:6] + rng.normal(0, 0.05, (6, 3))], 1).astype(np.float32)
    want = j_som.extract_tracks(p, q, 4, topk=topk)
    got = t_som.extract_tracks(to_t(p), q, 4, topk=topk)
    np.testing.assert_allclose(got[0], want[0], atol=VALUE_ATOL, rtol=VALUE_ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    depths = rng.uniform(1.5, 2.5, (2, 4, 12, 16)).astype(np.float32)
    intrs = np.tile(np.array([[10.0, 0, 8], [0, 10.0, 6], [0, 0, 1]], np.float32), (2, 1, 1))
    w2cs = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32), (2, 1, 1))
    want = j_som.extract_tracks(p, q, 4, depths, intrs, w2cs, vis_threshold=0.5, topk=topk)
    got = t_som.extract_tracks(to_t(p), q, 4, depths, intrs, w2cs, vis_threshold=0.5, topk=topk)
    np.testing.assert_array_equal(got[1], want[1])


def test_fit_segment_with_jax_draws():
    """One segment with depth, mask and track supervision, the frames,
    views and track subsets JAX draws passed in."""
    rng = np.random.default_rng(8)
    fg, fg_rgb, bg, bg_rgb = clouds(seed=9)
    tt, v, h, w = 3, 2, 20, 24
    jcfg = j_som.SOMConfig(num_bases=3, tracks_per_step=5)
    p = random_motion(j_som.init_params(fg, fg_rgb, bg, bg_rgb, tt, jcfg, seed=0), 10)
    intrs = np.tile(np.array([[25.0, 0, 11.5], [0, 25.0, 9.5], [0, 0, 1]], np.float32), (v, 1, 1))
    w2cs = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32), (v, 1, 1))
    w2cs[1, 0, 3] = 0.2
    tracks = (fg[:7, None] + rng.normal(0, 0.05, (7, tt, 3))).astype(np.float32)
    valid = rng.random((7, tt)) < 0.8
    data = {"video": rng.uniform(size=(v, tt, h, w, 3)).astype(np.float32), "intrs": intrs, "w2cs": w2cs,
            "depth": np.where(rng.random((v, tt, h, w)) < 0.8, rng.uniform(1.5, 4.5, (v, tt, h, w)),
                              0).astype(np.float32),
            "mask": (rng.random((v, tt, h, w)) < 0.3).astype(np.float32),
            "tracks3d": tracks, "tracks3d_valid": valid}
    n_iters, key = 4, jax.random.PRNGKey(2)
    draws = {"frames": [], "views": [], "tracks": []}
    for k in jax.random.split(key, n_iters):
        kf, kv, kt = jax.random.split(k, 3)
        draws["frames"].append(int(jax.random.randint(kf, (), 0, tt)))
        draws["views"].append(int(jax.random.randint(kv, (), 0, v)))
        draws["tracks"].append(np.asarray(jax.random.randint(kt, (jcfg.tracks_per_step,), 0, 7)))
    draws = {k: torch.from_numpy(np.array(x)) for k, x in draws.items()}
    want = j_som.fit_segment(p, j_som.adam_init(p), {k: jnp.asarray(x) for k, x in data.items()}, key, jcfg, (w, h),
                             n_iters, 64)
    tp = to_t(p)
    got = t_som.fit_segment(tp, t_som.adam_init(tp), t_som.scene_data(**data, device="cpu"), port_cfg(jcfg), (w, h),
                            n_iters, 64, draws=draws)
    # A quaternion's gradient along itself is zero but for rounding (the
    # rotation normalizes it), and Adam (eps 1e-15) turns rounding into steps
    # of lr; JAX's own spread (the segment at chunk 8, another summation
    # order; 1.47e-3 after 4 steps on this fixture) sets the limit of the
    # foreground quaternions: twice it.
    ctl = j_som.fit_segment(p, j_som.adam_init(p), {k: jnp.asarray(x) for k, x in data.items()}, key, jcfg, (w, h),
                            n_iters, 8)
    limits = dict.fromkeys(want[0]._fields, STATE_RTOL)
    b = np.asarray(want[0].fg_quats)
    limits["fg_quats"] = max(STATE_RTOL, 2 * np.abs(np.asarray(ctl[0].fg_quats) - b).max() / np.abs(b).max())
    for name in want[0]._fields:
        a, b = getattr(got[0], name).numpy(), np.asarray(getattr(want[0], name))
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert rel <= limits[name], f"{name}: relative gap {rel}, limit {limits[name]}"
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=STATE_RTOL)
    assert int(got[1][2]) == int(want[1][2]) == n_iters


def test_rigid_and_rotating_bases_track_exactly():
    """The JAX tests' `TestTrackPoints` properties on the port: one basis
    translating +x moves every query by it; a basis turning about z turns
    a query's offset with it."""
    t_total = 4
    rng = np.random.default_rng(0)
    fg = rng.normal(size=(32, 3)).astype(np.float32) * 0.2
    p = t_som.init_params(fg, rng.uniform(size=(32, 3)).astype(np.float32),
                          rng.normal(size=(8, 3)).astype(np.float32) + 5, rng.uniform(size=(8, 3)).astype(np.float32),
                          t_total, t_som.SOMConfig(num_bases=2), 0, device="cpu")
    transls = np.zeros((2, t_total, 3), np.float32)
    transls[0, :, 0] = 0.1 * np.arange(t_total)
    p = p._replace(motion_transls=t(transls), motion_coefs=t(np.tile([50.0, -50.0], (32, 1)).astype(np.float32)))
    q = t(fg[:3] + 0.01)
    out = t_som.track_points(p, q, torch.zeros(3, dtype=torch.long), torch.arange(t_total), topk=4).numpy()
    for i in range(3):
        np.testing.assert_allclose(out[i, :, 0] - float(q[i, 0]), 0.1 * np.arange(t_total), atol=1e-3)
        np.testing.assert_allclose(out[i, :, 1], float(q[i, 1]), atol=1e-3)

    theta = 0.3
    rot6d = np.tile([1, 0, 0, 0, 1, 0], (1, 2, 1)).astype(np.float32)
    c, s = np.cos(theta), np.sin(theta)
    rot6d[0, 1] = [c, s, 0, -s, c, 0]
    fg = np.array([[1.0, 0, 0], [0.9, 0.1, 0], [1.1, -0.1, 0]], np.float32)
    p = t_som.init_params(fg, np.full((3, 3), 0.5, np.float32), np.full((2, 3), 5.0, np.float32),
                          np.full((2, 3), 0.5, np.float32), 2, t_som.SOMConfig(num_bases=1), 0, device="cpu")
    p = p._replace(motion_rots=t(rot6d))
    out = t_som.track_points(p, t(np.array([[1.0, 0.0, 0.0]], np.float32)), torch.zeros(1, dtype=torch.long),
                             torch.arange(2), topk=2)
    np.testing.assert_allclose(out[0, 1].numpy(), [c, s, 0.0], atol=1e-2)


def test_fit_recovers_translation_with_track_supervision():
    """The JAX test's property (`tests/test_shape_of_motion.py::
    test_fit_recovers_translation_with_track_supervision`) on its fixture
    with the port's generator: the foreground translates +0.12 a frame; the
    extracted tracks must move more than 0.15 over three frames."""
    rng = np.random.default_rng(0)
    t_total, v, h, w = 4, 2, 32, 32
    n_fg, n_bg = 24, 24
    fg0 = np.stack([rng.uniform(-0.3, 0.3, n_fg), rng.uniform(-0.3, 0.3, n_fg), np.full(n_fg, 2.0)], -1).astype(
        np.float32)
    bg = np.stack([rng.uniform(-1.2, 1.2, n_bg), rng.uniform(-1.2, 1.2, n_bg), np.full(n_bg, 4.0)], -1).astype(
        np.float32)
    fg_rgb = np.tile([0.9, 0.3, 0.2], (n_fg, 1)).astype(np.float32)
    bg_rgb = np.tile([0.2, 0.3, 0.9], (n_bg, 1)).astype(np.float32)
    f = 40.0
    intrs = np.tile(np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1.0]], np.float32), (v, 1, 1))
    w2cs = np.zeros((v, 3, 4), np.float32)
    for vi in range(v):
        w2cs[vi, :3, :3] = np.eye(3)
        w2cs[vi, 0, 3] = 0.3 * vi
    video = np.zeros((v, t_total, h, w, 3), np.float32)
    mask = np.zeros((v, t_total, h, w), np.float32)
    tracks3d = np.zeros((n_fg, t_total, 3), np.float32)
    n_all = n_fg + n_bg
    attrs = torch.from_numpy(np.concatenate([np.concatenate([fg_rgb, bg_rgb]),
                                             np.concatenate([np.ones((n_fg, 1)), np.zeros((n_bg, 1))])], -1)).float()
    for ti in range(t_total):
        fg_t = fg0 + [0.12 * ti, 0, 0]
        tracks3d[:, ti] = fg_t
        xyz = torch.from_numpy(np.concatenate([fg_t, bg]).astype(np.float32))
        for vi in range(v):
            out = t_gs.render_gaussians(xyz, torch.tensor([1.0, 0, 0, 0]).repeat(n_all, 1),
                                        torch.full((n_all, 3), np.log(0.06)), torch.full((n_all,), 6.0), attrs,
                                        t(intrs[vi]), t(w2cs[vi]), (w, h))
            video[vi, ti] = out.rgb[..., :3].numpy()
            mask[vi, ti] = out.rgb[..., 3].numpy()
    cfg = t_som.SOMConfig(num_bases=3, iters=300, segment_iters=100, lr_motion_bases=5e-3, lr_means=1e-3,
                          w_track=5.0, tracks_per_step=16)
    params = t_som.fit_scene(video, intrs, w2cs, fg0, fg_rgb, bg, bg_rgb, mask=mask, tracks3d=tracks3d, cfg=cfg,
                             chunk=n_all, device="cpu")
    q = np.concatenate([np.zeros((4, 1)), tracks3d[:4, 0]], axis=1).astype(np.float32)
    tracks, vis = t_som.extract_tracks(params, q, t_total)
    assert tracks.shape == (t_total, 4, 3) and vis.all()
    moved = tracks[-1, :, 0] - tracks[0, :, 0]
    assert np.all(moved > 0.15), f"tracks did not follow the foreground: {moved}"
