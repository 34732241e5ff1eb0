"""`Trainer.warm_start` of the port against the JAX trainer's on the CPU:
strict and non-strict loads of a flax msgpack params file (written here with
flax from seeded params in the JAX model's layout), a bf16 file, the pre-scan
update-transformer layout, the corr-width migration to
`corr_neighbors_per_level`, torch `.pth` state dicts, the strict refusal,
and `TrainConfig.warm_start_ckpt` in `fit`.

The corr-width migration copies each old neighbour rank's columns of the
input projection to its new place and zeroes the added ranks' columns, so
on the same features the projection gives what it gave
(`test_migrated_projection_computes_the_uniform_projection`). The whole
forward does not give the uniform model's tracks: the position and time
embeddings added to the input are sin/cos of frequencies set by the input
width, so every column sees other values once the width changes. On the
scene below the migrated model's traj is up to 8.8e-5 from the uniform
model's (tracks move by up to 0.86 there, most of it the random biases of
the flow head), in the JAX package as in the port; the migrated port model
gives the migrated JAX model's tracks to 1.2e-7.
"""

import logging

import flax.serialization
import flax.traverse_util as tru
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.convert import params_from_flax, random_state_dict
from mvtracker_torch.models import mvtracker as t_mvt
from mvtracker_torch.training import step as t_step
from mvtracker_torch.training.train import TrainConfig, Trainer
from mvtracker_tpu.models import mvtracker as j_mvt
from mvtracker_tpu.training import step as j_step
from mvtracker_tpu.training import train as j_train
from mvtracker_tpu.convert import convert_reference_state_dict
from tests.test_model import make_scene
from tests.test_torch_modules import with_random_affine

# `tests/test_training.py::tiny_model`
TINY = dict(sliding_window_len=4, fmaps_dim=16, num_heads=2, hidden_size=32, space_depth=1, time_depth=1,
            num_virtual_tracks=4, corr_n_levels=2, corr_neighbors=4)
SCENE = [np.array(a) for a in make_scene(np.random.default_rng(0), v=2, t=6, h=32, w=32, n=6)]


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_params(cfg=TINY, seed=0):
    """Seeded flax params of the JAX model (numpy): the port's seeded
    weights with random affine parameters (`tests/test_torch_modules.py`),
    in the JAX layout by the JAX package's own converter. The JAX model
    builds this tree too (`test_params_are_the_jax_models_tree`)."""
    sd = with_random_affine(random_state_dict(t_mvt.MVTracker(**cfg, device="cpu"), seed=seed), seed + 1)
    return convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})


def test_params_are_the_jax_models_tree():
    want = jax.eval_shape(lambda k: j_mvt.MVTracker(**TINY).init(k, *SCENE, iters=1), jax.random.PRNGKey(0))
    got = jax_params()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(g.shape == w.shape for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


def write(path, tree):
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    return str(path)


def port(cfg=TINY, **kw):
    model = t_mvt.MVTracker(**cfg, **kw, device="cpu").eval()
    trainer = Trainer(model, TrainConfig(exp_dir="unused"))
    return model, trainer, t_step.init_state(model, trainer.optimizer)


def test_warm_start_strict_from_msgpack(tmp_path, caplog):
    params = jax_params()
    path = write(tmp_path / "w.msgpack", params)
    model, trainer, state = port()
    with caplog.at_level(logging.INFO):
        trainer.warm_start(state, path, strict=True)
    assert any("warm-start strict: all" in r.getMessage() for r in caplog.records)
    want = params_from_flax(params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_warm_start_nonstrict_loads_what_intersects(tmp_path, caplog):
    """A wider model takes the leaves of matching shape and keeps the rest,
    with a warning per skipped leaf (the JAX trainer's fallback)."""
    params = jax_params()
    path = write(tmp_path / "w.msgpack", params)
    model, trainer, state = port(dict(TINY, hidden_size=64))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        trainer.warm_start(state, path)
    after = model.state_dict()
    want = params_from_flax(params)
    assert torch.equal(after["fnet.conv1.weight"], want["fnet.conv1.weight"])
    assert torch.equal(after["updateformer.input_transform.weight"], before["updateformer.input_transform.weight"])
    messages = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("warm-start: skipping updateformer.input_transform.weight") for m in messages)
    assert any(m.startswith("warm-start non-strict:") for m in messages)


def test_warm_start_strict_raises_on_mismatch(tmp_path):
    path = write(tmp_path / "w.msgpack", jax_params())
    model, trainer, state = port(dict(TINY, fmaps_dim=32))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="strict warm-start from .* leaves skipped .* left at init"):
        trainer.warm_start(state, path, strict=True)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())  # nothing was loaded


def test_warm_start_strict_names_a_leaf_it_cannot_place(tmp_path):
    """A leaf of the file that the port's layout does not read (here a
    support-memory module the port lacks) is skipped like a misshapen one."""
    params = jax_params()
    params["params"]["support_gnn"] = {"kernel": np.ones((3, 3), np.float32)}
    path = write(tmp_path / "w.msgpack", params)
    model, trainer, state = port()
    with pytest.raises(ValueError, match="support_gnn/kernel"):
        trainer.warm_start(state, path, strict=True)
    trainer.warm_start(state, path)  # non-strict: loads the rest
    assert torch.equal(model.state_dict()["fnet.conv1.weight"], params_from_flax(params)["fnet.conv1.weight"])


def test_warm_start_from_bf16_msgpack(tmp_path):
    """A bf16 file (the release format) lands in the fp32 parameters with
    exactly the bf16 values, as the JAX trainer restores it."""
    params = jax_params()
    bf16 = jax.tree.map(lambda x: np.asarray(x).astype(jnp.bfloat16), params)
    path = write(tmp_path / "w_bf16.msgpack", bf16)
    model, trainer, state = port()
    trainer.warm_start(state, path, strict=True)
    want = params_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), bf16))
    full = params_from_flax(params)
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, want[k]), k
        torch.testing.assert_close(v, full[k], rtol=8e-3, atol=8e-3)


def test_warm_start_migrates_prescan_layout(tmp_path, caplog):
    """A file from before the JAX package scanned the update transformer
    (time_i / sv2p_i / svirt_i / sp2v_i) loads every leaf."""
    params = jax_params(dict(TINY, space_depth=2, time_depth=2))
    flat = tru.flatten_dict(params, sep="/")
    old = {}
    for k, v in flat.items():
        if "/updateformer/layers/" in k:
            head, rest = k.split("/updateformer/layers/", 1)
            block, tail = rest.split("/", 1)
            for i in range(v.shape[0]):
                old[f"{head}/updateformer/{block}_{i}/{tail}"] = v[i]
        else:
            old[k] = v
    path = write(tmp_path / "old.msgpack", tru.unflatten_dict(old, sep="/"))
    model, trainer, state = port(dict(TINY, space_depth=2, time_depth=2))
    with caplog.at_level(logging.INFO):
        trainer.warm_start(state, path, strict=True)
    assert any("migrated 2 unrolled updateformer blocks" in r.getMessage() for r in caplog.records)
    for k, v in params_from_flax(params).items():
        assert torch.equal(model.state_dict()[k], v), k


def test_warm_start_migrates_corr_width(tmp_path, caplog):
    """Uniform k=4 into per-level (8, 4), strictly: old ranks' columns at
    their new places, added ranks zero, every other leaf verbatim; the
    JAX trainer's migration of the same file gives the same projection."""
    params = jax_params()
    path = write(tmp_path / "w.msgpack", params)
    new_cfg = dict(TINY, corr_neighbors_per_level=(8, 4))
    model, trainer, state = port(new_cfg)
    with caplog.at_level(logging.INFO):
        trainer.warm_start(state, path, strict=True)
    assert any("migrated input_transform 245 -> 261 columns" in r.getMessage() for r in caplog.records)
    w_old = params["params"]["updateformer"]["input_transform"]["kernel"].T
    w_new = model.updateformer.input_transform.weight.detach().numpy()
    fe, f = (64 + 1) * 3, 4
    np.testing.assert_array_equal(w_new[:, :fe], w_old[:, :fe])
    np.testing.assert_array_equal(w_new[:, fe : fe + 4 * f], w_old[:, fe : fe + 4 * f])
    assert (w_new[:, fe + 4 * f : fe + 8 * f] == 0).all()
    np.testing.assert_array_equal(w_new[:, fe + 8 * f :], w_old[:, fe + 4 * f :])
    old_sd = params_from_flax(params)
    for k, v in model.state_dict().items():
        if k != "updateformer.input_transform.weight":
            assert torch.equal(v, old_sd[k]), k

    jm = j_mvt.MVTracker(**new_cfg)
    jt = j_train.Trainer(jm, j_train.TrainConfig(exp_dir=str(tmp_path / "jax")))
    j_state = j_step.TrainState(jax_params(new_cfg, seed=7), None, 0)
    j_state = jt.warm_start(j_state, path, strict=True)
    np.testing.assert_array_equal(np.asarray(j_state.params["params"]["updateformer"]["input_transform"]["kernel"]).T,
                                  w_new)


# The medium preset's layout (3 levels of k=12) narrowed, and corr_k0=24.
UNIFORM = dict(sliding_window_len=8, fmaps_dim=32, num_heads=2, hidden_size=64, space_depth=1, time_depth=1,
               num_virtual_tracks=4, corr_n_levels=3, corr_neighbors=12)
K0 = dict(corr_neighbors_per_level=(24, 12, 12))


def migrated_pair(tmp_path):
    """(uniform port model, corr_k0 port model warm-started from its `.pth`,
    the uniform JAX params)."""
    params = jax_params(UNIFORM)
    # The flow head scaled by 5, as in the card's checks (at 30 the random
    # model turns chaotic over 3 iterations).
    for name in ("flow_head_0", "flow_head_1", "flow_head_2"):
        params["params"]["updateformer"][name]["kernel"] = params["params"]["updateformer"][name]["kernel"] * 5
    uniform, _, _ = port(UNIFORM, knn_backend="exact")
    uniform.load_state_dict(params_from_flax(params))
    path = tmp_path / "uniform.pth"
    torch.save(uniform.state_dict(), path)
    migrated, trainer, state = port(dict(UNIFORM, **K0), knn_backend="exact")
    trainer.warm_start(state, str(path), strict=True)
    return uniform, migrated, params


def test_migrated_projection_computes_the_uniform_projection(tmp_path):
    """On the same features, the migrated input projection gives the uniform
    one's output, whatever the added ranks hold: the column order is right.
    The features are the models' own: the migrated model's first 12 level-0
    ranks (exact kNN) are the uniform model's."""
    uniform, migrated, _ = migrated_pair(tmp_path)
    rgbs, depths, query, intrs, extrs = (torch.as_tensor(a) for a in make_scene(
        np.random.default_rng(1), v=2, t=8, h=64, w=64, n=6))
    with torch.no_grad():
        context = uniform._build_context(uniform.compute_fmaps(rgbs), depths[:, :, ::4, ::4], intrs, extrs)
        window = [tuple(None if a is None else a[:8] for a in lvl) for lvl in context]
        coords = query[None, :, 1:].expand(8, -1, -1).contiguous()
        ffeats = torch.randn(8, 6, 32, generator=torch.Generator().manual_seed(0))
        c_old = uniform._corr_features(window, coords, ffeats)
        c_new = migrated._corr_features(window, coords, ffeats)
        f = uniform.corr_feat_width
        # The same neighbours; the correlation's sums over 12 and 24 ranks
        # may round apart.
        np.testing.assert_allclose(c_new[..., : 12 * f].numpy(), c_old[..., : 12 * f].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(c_new[..., 24 * f :].numpy(), c_old[..., 12 * f :].numpy(), rtol=0, atol=1e-6)
        flow = torch.randn(8, 6, 195, generator=torch.Generator().manual_seed(1))
        tail = torch.randn(8, 6, 34, generator=torch.Generator().manual_seed(2))
        y_old = uniform.updateformer.input_transform(torch.cat([flow, c_old, tail], -1))
        y_new = migrated.updateformer.input_transform(torch.cat([flow, c_new, tail], -1))
    assert float((c_new[..., 12 * f : 24 * f] - c_new[..., : 12 * f]).abs().max()) > 1e-3  # added ranks differ
    torch.testing.assert_close(y_new, y_old, rtol=0, atol=1e-5)


def test_migrated_model_matches_the_jax_migrated_model(tmp_path):
    """The warm-started corr_k0 model through the port and through the JAX
    package (its trainer's migration of the same weights, as msgpack): the
    same tracks to fp32 rounding. Both differ from the uniform model's by
    the embeddings' change (see the module docstring)."""
    uniform, migrated, params = migrated_pair(tmp_path)
    path = write(tmp_path / "uniform.msgpack", params)
    jm = j_mvt.MVTracker(**UNIFORM, **K0)
    jt = j_train.Trainer(jm, j_train.TrainConfig(exp_dir=str(tmp_path / "jax")))
    j_state = jt.warm_start(j_step.TrainState(jax_params(dict(UNIFORM, **K0), seed=7), None, 0), path, strict=True)
    sc = [np.array(a) for a in make_scene(np.random.default_rng(1), v=2, t=12, h=64, w=64, n=16)]
    want = jm.apply(j_state.params, *sc, iters=3)
    got = migrated(*sc, iters=3)
    np.testing.assert_allclose(got["traj"].numpy(), np.asarray(want["traj"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["vis"].numpy(), np.asarray(want["vis"]), rtol=0, atol=1e-5)
    base = uniform(*sc, iters=3)
    active = base["vis"] > 0
    moved = float((base["traj"] - torch.as_tensor(sc[2])[None, :, 1:]).abs()[active].max())
    gap = float((got["traj"] - base["traj"]).abs().max())
    assert moved > 1e-4 and 0 < gap < moved


def test_warm_start_from_pth(tmp_path):
    """A state dict saved with torch.save (the reference's names, which the
    port uses) and a training checkpoint holding one under "model" (the
    port's trainer writes such files) both load strictly."""
    params = jax_params()
    src, _, _ = port()
    src.load_state_dict(params_from_flax(params))
    torch.save(src.state_dict(), tmp_path / "sd.pth")
    torch.save({"model": src.state_dict(), "opt_state": {"count": 0}, "step": 7}, tmp_path / "ckpt.pt")
    for name in ("sd.pth", "ckpt.pt"):
        model, trainer, state = port()
        trainer.warm_start(state, str(tmp_path / name), strict=True)
        for k, v in src.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), (name, k)


def test_fit_warm_starts_only_without_a_checkpoint(tmp_path):
    """`TrainConfig.warm_start_ckpt` is applied by `fit` when the experiment
    has no checkpoint, and a resumed run keeps its checkpoint's weights."""
    params = jax_params()
    path = write(tmp_path / "w.msgpack", params)
    want = params_from_flax(params)
    exp = str(tmp_path / "exp")
    model = t_mvt.MVTracker(**TINY, device="cpu")
    trainer = Trainer(model, TrainConfig(exp_dir=exp, warm_start_ckpt=path))
    state = trainer.fit(iter(()), max_steps=0)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in want.items())
    with torch.no_grad():
        model.fnet.conv1.weight.add_(1.0)
    trainer.save(state, 5)
    fresh = t_mvt.MVTracker(**TINY, device="cpu")
    Trainer(fresh, TrainConfig(exp_dir=exp, warm_start_ckpt=path)).fit(iter(()), max_steps=5)
    assert torch.equal(fresh.fnet.conv1.weight, model.fnet.conv1.weight)
