"""Port parity: data parallelism and the model-axis splits
(`mvtracker_torch/parallel/mesh.py`, `MVTracker(knn_mesh=)`, the sharded
train step, `PrefetchLoader`'s per-process stride, `cli.train` with
`MVTRACKER_DISTRIBUTED=1` and `cli/eval_checkpoint.py --exp_dir`), on gloo
CPU processes (`tests/torch_dist.py`) against the JAX package on its CPU
mesh (`tests/conftest.py` gives 8 devices) and against one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_scene
from mvtracker_torch.cli import eval_checkpoint as t_eval_ckpt
from mvtracker_torch.convert import opt_state_from_optax
from mvtracker_torch.datasets.loader import PrefetchLoader as TorchLoader
from mvtracker_torch.models import mvtracker as t_mvt
from mvtracker_torch.parallel import mesh as t_mesh
from mvtracker_torch.training import step as t_step
from mvtracker_tpu.datasets.loader import PrefetchLoader as JaxLoader
from mvtracker_tpu.models.mvtracker import MVTracker as JaxMVTracker
from mvtracker_tpu.parallel import mesh as j_mesh
from mvtracker_tpu.training import step as j_step
from tests import torch_dist
from tests.test_torch_modules import carried_weights
from tests.test_torch_step import ENC_GRAD_RTOL, GRAD_RTOL, LOSS_RTOL, is_dead_bias, is_noisy_encoder_weight

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]

# The sizes of tests/test_pallas_sharded.py: a level-0 cloud of 2 x 8 x 12 =
# 192 points, sharded from 64 points on.
TINY = dict(sliding_window_len=4, stride=4, fmaps_dim=16, num_heads=2, hidden_size=32, space_depth=1,
            time_depth=1, num_virtual_tracks=4, corr_n_levels=2, corr_neighbors=4)
# JAX holds its own sharded forward to its global one at 1e-5; so is the port.
FORWARD_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores; the spawned processes set their own)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The loader's stride, the mesh
# ---------------------------------------------------------------------------


class _Indexable:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("shuffle, n, count", [(True, 8, 2), (True, 11, 3), (False, 10, 4)])
def test_loader_stride_equals_jax(shuffle, n, count):
    ds = _Indexable(n)
    orders = []
    for pi in range(count):
        got = TorchLoader(ds, shuffle=shuffle, seed=5, process_index=pi, process_count=count)._order(3)
        want = JaxLoader(ds, shuffle=shuffle, seed=5, process_index=pi, process_count=count)._order(3)
        np.testing.assert_array_equal(got, want)
        orders.append(got)
    assert sorted(np.concatenate(orders).tolist()) == list(range(n))  # a partition of the epoch
    np.testing.assert_array_equal(TorchLoader(ds, shuffle=shuffle, seed=5)._order(3),
                                  JaxLoader(ds, shuffle=shuffle, seed=5)._order(3))
    with pytest.raises(ValueError, match="process_count"):
        TorchLoader(ds, process_index=0)._order(0)


def test_mesh_lays_ranks_out_as_jax(tmp_path):
    """Ranks lie on the mesh as JAX lays devices out (reshape(n_data,
    n_model)); a rank's batch is its data coordinate's slice of the scenes."""
    got = torch_dist.spawn(torch_dist.mesh_layout, 4, tmp_path, 2, 2)
    jm = j_mesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank, (shape, coords, groups, local, refused) in enumerate(got):
        assert refused == "mesh backend 'nccl' differs from the default group's 'gloo'"
        assert shape == dict(jm.shape)
        i, j = coords["data"], coords["model"]
        assert ids[i, j] == rank
        assert groups == {"data": ids[:, j].tolist(), "model": ids[i, :].tolist()}
        np.testing.assert_array_equal(local["x"], np.arange(12).reshape(4, 3)[2 * i : 2 * i + 2])
        assert local["scalar"] == 1.0


def test_mesh_and_knn_mesh_need_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        t_mesh.make_mesh(1, 1, backend="gloo")
    with pytest.raises(RuntimeError, match="process group"):
        t_mvt.MVTracker(**TINY, knn_mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# MVTracker(knn_mesh=)
# ---------------------------------------------------------------------------

# (n_model, cfg overrides, n tracks, schedule). One level each: with two,
# both clouds (192 and 48 points) are small levels that share one local kNN
# call, in JAX as in the port, and nothing is sharded. 2 x 2 with k = 4 and
# 8 tracks: M * k = 32 <= 96 points a shard (gather); 1 x 4 with k = 8 and
# 32 tracks: 256 > 48 (ring).
FORWARD_CASES = {
    "gather_2x2": (2, dict(corr_n_levels=1), 8, "gather"),
    "ring_1x4": (4, dict(corr_n_levels=1, corr_neighbors=8), 32, "ring"),
}


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_knn_mesh_forward_matches_jax(tmp_path, name):
    n_model, over, n, schedule = FORWARD_CASES[name]
    cfg = {**TINY, **over}
    scene = [np.asarray(a) for a in _make_scene(np.random.default_rng(3), 2, 6, 32, 48, n)]
    sd, params = carried_weights(t_mvt.MVTracker(**cfg, device="cpu"), seed=0)
    want = jax.jit(lambda p: JaxMVTracker(**cfg).apply(p, *map(jnp.asarray, scene), iters=1))(params)
    got = torch_dist.spawn(torch_dist.tracker_forward, 4, tmp_path, n_model, cfg,
                           {k: v.numpy() for k, v in sd.items()}, scene, 64, 1)
    for out in got:
        assert out["calls"][schedule] > 0 and sum(out["calls"].values()) == out["calls"][schedule]
        np.testing.assert_allclose(out["traj"], np.asarray(want["traj"]), atol=FORWARD_ATOL)
        np.testing.assert_allclose(out["vis"], np.asarray(want["vis"]), atol=FORWARD_ATOL)
        np.testing.assert_array_equal(out["traj"], got[0]["traj"])  # every rank the same bits


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------

STEP_CFG = dict(TINY, vis_geom_features=True, vis_head_hidden=16)
ITERS, TOTAL_STEPS = 2, 100


def _step_batch():
    rng = np.random.default_rng(7)
    b, v, t, h, w, n = 2, 2, 6, 16, 16, 8
    scenes = [_make_scene(rng, v, t, h, w, n) for _ in range(b)]
    keys = ("rgbs", "depths", "query_points", "intrs", "extrs")
    batch = {k: np.stack([s[i] for s in scenes]) for i, k in enumerate(keys)}
    batch["traj_gt"] = rng.normal(size=(b, t, n, 3)).astype(np.float32)
    batch["vis_gt"] = np.ones((b, t, n), np.float32)
    batch["valid"] = np.ones((b, t, n), np.float32)
    return batch


@pytest.fixture(scope="module")
def sharded_step(tmp_path_factory):
    """The 2 x 2 step with shard_views and shard_tracks on 4 processes, the
    same step in one process, and JAX's sharded step on a 2 x 2 mesh, all
    from the same weights and batch."""
    batch = _step_batch()
    model = t_mvt.MVTracker(**STEP_CFG, device="cpu")
    sd, params = carried_weights(model, seed=0)
    model.load_state_dict(sd)
    params = jax.tree.map(np.asarray, params)
    params["params"]["vis_hidden"] = {"kernel": sd["vis_hidden.weight"].numpy().T,
                                      "bias": sd["vis_hidden.bias"].numpy()}
    params = jax.tree.map(jnp.asarray, params)
    got = torch_dist.spawn(torch_dist.train_step, 4, tmp_path_factory.mktemp("step"), 2, STEP_CFG,
                           {k: v.numpy() for k, v in sd.items()}, batch, True, True, ITERS, TOTAL_STEPS)

    optimizer = t_step.make_optimizer(total_steps=TOTAL_STEPS)
    state = t_step.init_state(model, optimizer)
    state, metrics = t_step.make_train_step(model, optimizer, iters=ITERS)(state, batch)
    single = {"params": {k: p.detach().numpy() for k, p in model.named_parameters()},
              "mu": {k: v.numpy() for k, v in state.opt_state["mu"].items()},
              "metrics": {k: float(v) for k, v in metrics.items()}}

    jm = JaxMVTracker(**STEP_CFG)
    j_opt = j_step.make_optimizer(total_steps=TOTAL_STEPS)
    j_state = j_step.TrainState(params, j_opt.init(params), jnp.zeros((), jnp.int32))
    mesh = j_mesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    with jax.set_mesh(mesh):
        step = j_step.make_train_step(jm, j_opt, iters=ITERS, mesh=mesh, shard_views=True, shard_tracks=True)
        j_new, j_metrics = step(j_state, j_mesh.shard_batch_pytree(batch, mesh))
    from mvtracker_torch.convert import params_from_flax

    jax_out = {"params": {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray, j_new.params)).items()},
               "mu": {k: v.numpy() for k, v in opt_state_from_optax(jax.tree.map(np.asarray, j_new.opt_state))["mu"]
                      .items()},
               "metrics": {k: float(v) for k, v in j_metrics.items()}}
    return got, single, jax_out


def _assert_moments_close(got_mu, want_mu):
    """Adam's first moment after one step is 0.1 x the clipped gradient:
    held leaf by leaf at the step-parity test's gradient tolerances."""
    assert set(got_mu) == set(want_mu)
    for name, want in want_mu.items():
        if is_dead_bias(name):
            continue
        tol = ENC_GRAD_RTOL if is_noisy_encoder_weight(name) else GRAD_RTOL
        assert np.abs(got_mu[name] - want).max() <= tol * np.abs(want).max(), name


@pytest.mark.parametrize("reference", ["one_process", "jax_sharded"])
def test_sharded_step_matches(sharded_step, reference):
    got, single, jax_out = sharded_step
    want = single if reference == "one_process" else jax_out
    for out in got:
        for key in ("loss", "xyz_loss", "vis_loss"):
            np.testing.assert_allclose(out["metrics"][key], want["metrics"][key], rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["metrics"]["reproj_dev"], want["metrics"]["reproj_dev"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["metrics"]["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-4)
        _assert_moments_close(out["mu"], want["mu"])
        # JAX's own sharded-step test holds the parameters to 5e-5 (one
        # AdamW step moves each by at most about lr / 25 = 2e-5 here).
        for name, p in want["params"].items():
            np.testing.assert_allclose(out["params"][name], p, rtol=0, atol=5e-5, err_msg=name)
    for out in got[1:]:  # the ranks stay in step, to the bit
        for name, p in got[0]["params"].items():
            np.testing.assert_array_equal(out["params"][name], p, err_msg=name)


# ---------------------------------------------------------------------------
# The trainer's stop request on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stop_rank, stop_after, sync_every, want", [(1, 1, 3, 3), (0, 4, 3, 6), (1, 2, 1, 3)])
def test_stop_on_one_rank_stops_every_rank_at_the_next_sync(tmp_path, stop_rank, stop_after, sync_every, want):
    """A stop asked on one rank after a step is reduced over the world at
    the next step that synchronises (`sync_every`), so every rank stops
    after that same step; rank 0 alone writes the stop's checkpoint."""
    exp = tmp_path / "exp"
    steps = torch_dist.spawn(torch_dist.trainer_stop, 2, tmp_path, str(exp), stop_rank, stop_after, sync_every)
    assert steps == [want, want]
    assert sorted(p.name for p in (exp / "checkpoints").iterdir()) == [f"step_{want}.pt"]


# ---------------------------------------------------------------------------
# cli.train with MVTRACKER_DISTRIBUTED=1, then eval_checkpoint --exp_dir
# ---------------------------------------------------------------------------


def test_cli_train_distributed_then_eval_checkpoint(tmp_path):
    """Two gloo processes train configs/overfit.yaml (the `small` preset's
    model) for 2 steps on their own scenes; rank 0 alone writes the
    checkpoint, and `eval_checkpoint --exp_dir` evaluates it."""
    exp = tmp_path / "exp"
    data = ["data.n_views=2", "data.n_frames=8", "data.height=32", "data.width=32", "data.num_tracks=8",
            "data.num_workers=1"]
    argv = ["--config", str(ROOT / "configs/overfit.yaml"), "--device", "cpu", *data, "data.batch_size=2",
            "trainer.total_steps=2", "trainer.save_ckpt_freq=2", "trainer.tensorboard=false",
            "trainer.watchdog_timeout_s=0", f"trainer.exp_dir={exp}"]
    sums = torch_dist.spawn(torch_dist.train_cli, 2, tmp_path, argv, timeout=180)
    assert sums[0] == sums[1]  # the same parameters on both ranks
    assert sorted(p.name for p in (exp / "checkpoints").iterdir()) == ["step_2.pt"]

    args = ["--exp_dir", str(exp), "--model_size", "small", "--views", "2", "--res", "32", "--frames", "8",
            "--n_tracks", "8", "--calib_scenes", "1", "--eval_scenes", "1", "--iters", "1", "--grid", "0",
            "--thresholds", "0.5", "--device", "cpu"]
    rows = t_eval_ckpt.main(args)
    assert rows["checkpoint_step"] == 2 and np.isfinite(rows["iters1_grid0"]["heldout_calibrated"]["average_jaccard"])
    model = t_eval_ckpt.build(t_eval_ckpt.build_parser().parse_args(args))
    assert t_eval_ckpt.restore_checkpoint(model, str(exp), 0) == 2
    for name, p in model.named_parameters():
        assert float(p.detach().double().sum()) == sums[0][name], name
    with pytest.raises(FileNotFoundError, match="step 5"):
        t_eval_ckpt.restore_checkpoint(model, str(exp), 5)
