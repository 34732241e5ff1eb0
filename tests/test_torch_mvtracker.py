"""Port parity: the whole `MVTracker` forward of `mvtracker_torch` against the
JAX package's on the same scene and weights (CPU, fp32 and bf16), the weight
converters in both directions, the options the port refuses, and the
training outputs (`is_train`, `remat`, `remat_encoder`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.convert import params_from_flax
from mvtracker_torch.models import mvtracker as t_mvt
from mvtracker_tpu.convert import convert_reference_state_dict
from mvtracker_tpu.models.mvtracker import MVTracker as JaxMVTracker
from tests.test_model import make_scene
from tests.test_torch_modules import carried_weights

# 2 views at 96x96, stride 4: pyramid levels of 1152, 288, 72 and 18 points.
# With k=20 the finest level runs alone, the three others share one padded
# kNN call, and the 18-point level has fewer points than k (rank wrap).
CFG = dict(
    sliding_window_len=6, stride=4, fmaps_dim=32, num_heads=2, hidden_size=64,
    space_depth=2, time_depth=2, num_virtual_tracks=4, corr_n_levels=4, corr_neighbors=20,
)
# Weights: seeded, with random biases and norm parameters, and the flow head
# scaled up so tracks move by a few hundredths of a unit over 2 iterations
# and the checks see the updates (`carried_weights`).
# fp32 both sides; measured gaps are ~1e-6, left room for summation order.
TRAJ_ATOL = 1e-4
VIS_ATOL = 1e-4
# bf16 both sides, the JAX model on its kernel's correlation path (targets
# streamed bf16, as on the TPU; its CPU gather path would keep them fp32).
# The two round in different places (module tests), and the forward
# amplifies that: the bf16 encoder alone moves the port's traj by 9.5e-3
# from its fp32 traj. Readings (max / median abs gap over all entries):
#   port bf16 vs JAX bf16: traj 9.2e-3 / 3.2e-4, vis 3.1e-2 / 3.4e-3;
#   control, JAX bf16 vs JAX fp32: traj 2.8e-3 / 1.9e-4, vis 1.8e-2 / 5.8e-3.
# Tracks move by a median 6.6e-2, so a forward that drops the coordinate
# updates fails; one that drops the track-feature updates moves vis by
# 0.10 / 3.6e-2 and fails too.
BF16_TRAJ_ATOL = (2e-2, 1e-3)
BF16_VIS_ATOL = (6e-2, 1e-2)


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    """One intra-op thread while this file runs. The suite runs in several
    worker processes; a PyTorch thread pool per process oversubscribes the
    cores, and the backward then runs many times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(compute_dtype):
    scene = [np.asarray(a) for a in make_scene(np.random.default_rng(0), v=2, t=9, h=96, w=96, n=6)]
    model = t_mvt.MVTracker(**CFG, compute_dtype=compute_dtype, device="cpu").eval()
    sd, params = carried_weights(model, seed=0)
    model.load_state_dict(sd)
    return scene, model, params


def test_forward_matches_jax():
    scene, model, params = _setup("float32")
    query_t = scene[2][:, 0]
    assert query_t.min() == 0 and query_t.max() >= 6  # some tracks start in the second window

    want = JaxMVTracker(**CFG).apply(params, *scene, iters=2)
    got = model(*scene, iters=2)
    assert got["traj"].shape == (9, 6, 3) and got["vis"].shape == (9, 6)
    traj, vis = np.asarray(want["traj"]), np.asarray(want["vis"])
    moved = np.abs(traj - scene[2][None, :, 1:]).max(-1)[vis > 0]
    assert np.median(moved) > 1e-2  # the updates are large enough to matter
    np.testing.assert_allclose(got["traj"].numpy(), traj, atol=TRAJ_ATOL)
    np.testing.assert_allclose(got["vis"].numpy(), vis, atol=VIS_ATOL)
    np.testing.assert_allclose(got["feat_init"].numpy(), np.asarray(want["feat_init"]), atol=1e-4)


def test_bf16_forward_matches_jax():
    scene, model, params = _setup("bfloat16")
    want = JaxMVTracker(**CFG, compute_dtype="bfloat16", corr_backend="pallas_interpret").apply(
        params, *scene, iters=2
    )
    got = model(*scene, iters=2)
    assert got["traj"].dtype == got["vis"].dtype == torch.float32
    for key, (max_tol, median_tol) in (("traj", BF16_TRAJ_ATOL), ("vis", BF16_VIS_ATOL)):
        gap = np.abs(got[key].numpy() - np.asarray(want[key]))
        assert gap.max() <= max_tol and np.median(gap) <= median_tol, (key, gap.max(), np.median(gap))


def test_weights_round_trip():
    """flax params -> params_from_flax -> port -> convert_reference_state_dict
    gives back the starting params, leaf by leaf, exactly."""
    cfg = dict(CFG, corr_n_levels=2, corr_neighbors=4)
    scene = [np.asarray(a) for a in make_scene(np.random.default_rng(1), v=1, t=4, h=16, w=16, n=2)]
    jm = JaxMVTracker(**cfg)
    shapes = jax.eval_shape(lambda k, *a: jm.init(k, *a, iters=1), jax.random.PRNGKey(0), *scene)
    rng = np.random.default_rng(2)
    flax_params = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)

    model = t_mvt.MVTracker(**cfg, device="cpu")
    model.load_state_dict(params_from_flax(flax_params), strict=True)
    back = convert_reference_state_dict({k: v.numpy() for k, v in model.state_dict().items()})

    want = jax.tree_util.tree_flatten_with_path(flax_params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_unknown_option_and_dtype_raise():
    with pytest.raises(TypeError):
        t_mvt.MVTracker(corr_backend="pallas", device="cpu")
    with pytest.raises(ValueError):
        t_mvt.MVTracker(compute_dtype="float16", device="cpu")


@pytest.mark.parametrize("backend", ["fused", "tiled", "exact"])
def test_knn_backend_reaches_every_knn_call(backend, monkeypatch):
    """`knn_backend` is handed to every kNN call of the forward (the query
    features' and each level's), and on a cloud without ties the tracks do
    not depend on it."""
    scene, model, _ = _setup("float32")
    want = model(*scene, iters=1)
    chosen = t_mvt.MVTracker(**CFG, knn_backend=backend, device="cpu").eval()
    chosen.load_state_dict(model.state_dict())
    seen = []
    real = t_mvt.knn_ops.knn

    def spy(ref, query, k, backend="auto"):
        seen.append(backend)
        return real(ref, query, k, backend=backend)

    monkeypatch.setattr(t_mvt.knn_ops, "knn", spy)
    got = chosen(*scene, iters=1)
    assert seen == [backend] * (1 + 2 * 2)  # feat_init, then 2 windows x (level 0, levels 1-3)
    assert torch.equal(got["traj"], want["traj"]) and torch.equal(got["vis"], want["vis"])
    with pytest.raises(ValueError, match="knn_backend"):
        t_mvt.MVTracker(**CFG, knn_backend="pallas", device="cpu")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is about hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mvt.MVTracker(**CFG)


def test_bf16_forward_runs_on_cpu():
    """The bf16 path (bf16 products, bf16 cloud features, bf16 correlation
    stream) gives finite outputs near the fp32 ones on a tiny scene, with
    updates large enough to matter."""
    scene = make_scene(np.random.default_rng(4), v=2, t=6, h=32, w=32, n=4)
    m32 = t_mvt.MVTracker(**CFG, device="cpu").eval()
    sd, _ = carried_weights(m32, seed=3)
    m32.load_state_dict(sd)
    m16 = t_mvt.MVTracker(**CFG, compute_dtype="bfloat16", device="cpu").eval()
    m16.load_state_dict(sd)
    o32, o16 = m32(*scene, iters=1), m16(*scene, iters=1)
    assert o16["traj"].dtype == torch.float32 and torch.isfinite(o16["traj"]).all()
    moved = (o32["traj"] - torch.as_tensor(scene[2])[None, :, 1:]).abs().amax(-1)[o32["vis"] > 0]
    assert float(moved.median()) > 1e-2
    # Readings (max abs): traj gap 5.7e-4, vis gap 1.4e-3; tracks moved by a
    # median 8.2e-2, so dropped updates fail the traj check.
    np.testing.assert_allclose(o16["traj"].numpy(), o32["traj"].numpy(), atol=2e-3)
    np.testing.assert_allclose(o16["vis"].numpy(), o32["vis"].numpy(), atol=5e-3)


def test_serving_forward_records_no_graph():
    scene, model, _ = _setup("float32")
    assert all(p.requires_grad for p in model.parameters())
    out = model(*scene, iters=1)
    assert "train_data" not in out
    assert not out["traj"].requires_grad and not out["vis"].requires_grad and out["traj"].grad_fn is None


def test_is_train_returns_train_data_like_jax():
    """`train_data` of the port against the JAX module's: the port stacks the
    executed windows (all of them here, the anchor is frame 0)."""
    scene, model, params = _setup("float32")
    want = JaxMVTracker(**CFG).apply(params, *scene, iters=2, is_train=True)["train_data"]
    out = model(*scene, iters=2, is_train=True)
    got = out["train_data"]
    assert out["traj"].requires_grad
    assert got["coord_predictions"].shape == (2, 2, 6, 6, 3) and got["vis_predictions"].shape == (2, 6, 6)
    assert bool(np.asarray(want["window_valid"]).all()) and bool(got["window_valid"].all())
    np.testing.assert_array_equal(got["window_starts"].numpy(), np.asarray(want["window_starts"]))
    np.testing.assert_array_equal(got["window_active"].numpy(), np.asarray(want["window_active"]))
    np.testing.assert_allclose(
        got["coord_predictions"].detach().numpy(), np.asarray(want["coord_predictions"]), atol=TRAJ_ATOL
    )
    # Visibility logits reach +-10 (the init), so they get a relative part too.
    np.testing.assert_allclose(
        got["vis_predictions"].detach().numpy(), np.asarray(want["vis_predictions"]), atol=VIS_ATOL, rtol=1e-5
    )
    # The serving outputs are the same with and without the graph.
    np.testing.assert_array_equal(out["traj"].detach().numpy(), model(*scene, iters=2)["traj"].numpy())


@pytest.mark.parametrize("remat_encoder", [True, False])
def test_remat_and_remat_encoder_work(remat_encoder):
    """Rematerialisation changes neither the outputs nor the gradients, and
    the checkpointed modules are the ones the flags name."""
    from unittest import mock

    import mvtracker_torch.models.mvtracker as mod

    scene, model, _ = _setup("float32")
    remat = t_mvt.MVTracker(**CFG, remat=True, remat_encoder=remat_encoder, device="cpu")
    remat.load_state_dict(model.state_dict())
    seen = []
    real = mod.checkpoint

    def spy(fn, *args, **kwargs):
        seen.append(fn)
        assert kwargs.get("use_reentrant") is False
        return real(fn, *args, **kwargs)

    grads = {}
    for name, m in (("plain", model), ("remat", remat)):
        m.zero_grad(set_to_none=True)
        with mock.patch.object(mod, "checkpoint", spy):
            out = m(*scene, iters=2, is_train=True)
        td = out["train_data"]
        (td["coord_predictions"].square().mean() + td["vis_predictions"].square().mean()).backward()
        grads[name] = (out["traj"].detach(), {k: p.grad for k, p in m.named_parameters()})
    # 2 windows x 2 iterations of the transformer, plus the encoder once.
    assert seen.count(remat.updateformer) == 4 and seen.count(remat.fnet) == int(remat_encoder)
    assert len(seen) == 4 + int(remat_encoder)
    assert torch.equal(grads["plain"][0], grads["remat"][0])
    for k, g in grads["plain"][1].items():
        assert g is not None and torch.equal(g, grads["remat"][1][k]), k
    # Serving never rematerialises: nothing is kept to recompute.
    seen.clear()
    with mock.patch.object(mod, "checkpoint", spy):
        remat(*scene, iters=1)
    assert not seen
