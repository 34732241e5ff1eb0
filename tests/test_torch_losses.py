"""Port parity: the training losses of `mvtracker_torch.training.losses`
against `mvtracker_tpu.training.losses` on the same random `train_data`
(CPU, fp32). The port stacks only the windows that ran; the JAX package
stacks a static count and masks the rest, which the losses must not see."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.training import losses as t_losses
from mvtracker_tpu.training import losses as j_losses

# fp32 element-wise math and sums of a few hundred terms in another order.
ATOL = 2e-6

T, N, S, ITERS = 10, 7, 4, 3
HOP = S // 2


def _train_data(rng, n_wind, start0):
    """Random predictions for `n_wind` windows anchored at frame `start0`."""
    query_t = rng.integers(start0, start0 + 5, size=N)
    query_t[0] = start0
    starts = start0 + HOP * np.arange(n_wind)
    return {
        "coord_predictions": rng.normal(size=(n_wind, ITERS, S, N, 3)).astype(np.float32),
        "vis_predictions": (rng.normal(size=(n_wind, S, N)) * 3).astype(np.float32),
        "window_starts": starts.astype(np.int64),
        "window_valid": np.ones(n_wind, bool),
        "window_active": query_t[None, :] < (starts[:, None] + S),
    }, query_t.astype(np.int64)


def _gt(rng):
    traj = rng.normal(size=(T, N, 3)).astype(np.float32)
    traj[..., 2] += 3.0
    vis = (rng.random((T, N)) > 0.3).astype(np.float32)
    valid = (rng.random((T, N)) > 0.2).astype(np.float32)
    return traj, vis, valid


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def test_window_gt_and_validity(rng):
    td, query_t = _train_data(rng, 4, 1)  # the last window runs past T: clamped, not real
    traj, _, valid = _gt(rng)
    want = j_losses.window_gt(jnp.asarray(traj), jnp.asarray(td["window_starts"]), S)
    got = t_losses.window_gt(torch.from_numpy(traj), torch.from_numpy(td["window_starts"]), S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for wv in (None, np.array([True, True, False, True])):
        want = j_losses.window_validity(
            jnp.asarray(valid), jnp.asarray(query_t), jnp.asarray(td["window_starts"]), S,
            jnp.asarray(td["window_active"]), T, window_valid=None if wv is None else jnp.asarray(wv),
        )
        got = t_losses.window_validity(
            torch.from_numpy(valid), torch.from_numpy(query_t), torch.from_numpy(td["window_starts"]), S,
            torch.from_numpy(td["window_active"]), T, window_valid=None if wv is None else torch.from_numpy(wv),
        )
        assert tuple(got.shape) == want.shape == (4, S, N)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < float(got.sum()) < got.numel()


@pytest.mark.parametrize("masked", [False, True])
def test_sequence_and_ce_losses(rng, masked):
    td, query_t = _train_data(rng, 3, 0)
    traj, vis, valid = _gt(rng)
    wv = np.array([True, False, True]) if masked else None
    jv = j_losses.window_validity(
        jnp.asarray(valid), jnp.asarray(query_t), jnp.asarray(td["window_starts"]), S,
        jnp.asarray(td["window_active"]), T, window_valid=None if wv is None else jnp.asarray(wv),
    )
    tv = torch.from_numpy(np.array(jv))
    jg = j_losses.window_gt(jnp.asarray(traj), jnp.asarray(td["window_starts"]), S)
    want = j_losses.sequence_loss_3d(
        jnp.asarray(td["coord_predictions"]), jg, jv, gamma=0.7, window_valid=None if wv is None else jnp.asarray(wv)
    )
    got = t_losses.sequence_loss_3d(
        torch.from_numpy(td["coord_predictions"]), torch.from_numpy(np.array(jg)), tv, gamma=0.7,
        window_valid=None if wv is None else torch.from_numpy(wv),
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=ATOL)
    jvg = j_losses.window_gt(jnp.asarray(vis), jnp.asarray(td["window_starts"]), S)
    want = j_losses.balanced_ce_loss(jnp.asarray(td["vis_predictions"]), jvg, jv)
    got = t_losses.balanced_ce_loss(torch.from_numpy(td["vis_predictions"]), torch.from_numpy(np.array(jvg)), tv)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=ATOL)
    assert float(got) > 0.1


def test_tracking_loss_matches_jax(rng):
    td, query_t = _train_data(rng, 3, 0)
    traj, vis, valid = _gt(rng)
    want, want_parts = j_losses.tracking_loss(
        _jax(td), *map(jnp.asarray, (traj, vis, valid, query_t)), T, gamma=0.8,
        track_upscaling_factor=2.0, visibility_loss_weight=0.1,
    )
    got, got_parts = t_losses.tracking_loss(
        _torch(td), *map(torch.from_numpy, (traj, vis, valid, query_t)), T, gamma=0.8,
        track_upscaling_factor=2.0, visibility_loss_weight=0.1,
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=ATOL)
    for key in ("xyz_loss", "vis_loss"):
        np.testing.assert_allclose(float(got_parts[key]), float(want_parts[key]), rtol=1e-6, atol=ATOL)


def test_executed_windows_only_equal_the_masked_static_stack(rng):
    """Anchor after frame 0: the JAX package stacks its static window count
    and masks the window that did not run (`window_valid` false, garbage
    predictions); the port stacks the executed windows only. Same loss."""
    td_jax, query_t = _train_data(rng, 4, 3)  # static count 4, anchored at frame 3
    n_exec = 3
    td_jax["window_valid"] = np.arange(4) < n_exec
    td_jax["coord_predictions"][n_exec:] = 1e6  # what a window that never ran might hold
    td_jax["vis_predictions"][n_exec:] = -1e3
    td_port = {k: v[:n_exec] for k, v in td_jax.items()}
    traj, vis, valid = _gt(rng)
    want, want_parts = j_losses.tracking_loss(_jax(td_jax), *map(jnp.asarray, (traj, vis, valid, query_t)), T)
    got, got_parts = t_losses.tracking_loss(_torch(td_port), *map(torch.from_numpy, (traj, vis, valid, query_t)), T)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=ATOL)
    for key in ("xyz_loss", "vis_loss"):
        np.testing.assert_allclose(float(got_parts[key]), float(want_parts[key]), rtol=1e-6, atol=ATOL)
    # The port's losses honour the mask too when handed the static stack.
    same, _ = t_losses.tracking_loss(_torch(td_jax), *map(torch.from_numpy, (traj, vis, valid, query_t)), T)
    np.testing.assert_allclose(float(same), float(got), rtol=1e-6, atol=ATOL)


def test_feature_identity_loss(rng):
    from tests.test_torch_geometry import _cams

    v, t, h, w, c, n, stride = 2, 3, 6, 8, 5, 6, 4
    fmaps = rng.normal(size=(v, t, h, w, c)).astype(np.float32)
    depths = rng.uniform(2.5, 6.0, size=(v, t, h * stride, w * stride)).astype(np.float32)
    intrs, extrs = _cams(rng, v, t)
    intrs[..., 0, 2], intrs[..., 1, 2] = w * stride / 2, h * stride / 2
    extrs[..., :3] = np.eye(3, dtype=np.float32)  # cameras look down +z
    extrs[..., 3] = rng.normal(size=(v, t, 3)).astype(np.float32) * 0.1
    traj = rng.uniform(-0.3, 0.3, size=(t, n, 3)).astype(np.float32)
    traj[..., 2] += 3.0
    args = (fmaps, depths, intrs, extrs, traj)
    want = j_losses.feature_identity_loss(*map(jnp.asarray, args), stride=stride)
    tf = torch.from_numpy(fmaps).requires_grad_()
    got = t_losses.feature_identity_loss(tf, *map(torch.from_numpy, args[1:]), stride=stride)
    assert float(want) > 0.5  # some samples are visible: the loss is not the empty-mask 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-5)
    got.backward()
    assert torch.isfinite(tf.grad).all() and float(tf.grad.abs().max()) > 0
