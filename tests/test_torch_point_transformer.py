"""Port parity: the serialized point transformer (`use_point_transformer`) of
`mvtracker_torch` against `mvtracker_tpu/models/point_transformer.py` on the
CPU: Morton keys, the module on single clouds and batches (padded last
group, shifted and permuted blocks, points sharing a voxel), and the
tracker with the backbone on its level-0 cloud. Weights are the JAX
module's own initialization, carried by `convert.py`.

Readings (max |port - JAX|, fp32): module 9.5e-7 to 2.5e-6 on outputs up
to 7.4, tracker traj 3.7e-6 and vis 3.8e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.convert import params_from_flax, point_transformer_from_flax, random_state_dict
from mvtracker_torch.models import mvtracker as t_mvt
from mvtracker_torch.models import point_transformer as t_pt
from mvtracker_tpu.models import mvtracker as j_mvt
from mvtracker_tpu.models import point_transformer as j_pt
from tests.test_model import make_scene
from tests.test_torch_modules import carried_weights

MODULE_ATOL = 1e-5
TRAJ_ATOL = VIS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def points(seed, p, dup=0):
    """p points in a 2-unit box; the last `dup` repeat earlier ones exactly
    (same voxel, same key)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, size=(p, 3)).astype(np.float32)
    if dup:
        xyz[-dup:] = xyz[rng.integers(0, p - dup, size=dup)]
    return xyz


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1)])
def test_morton_code_matches_jax(order):
    xyz = np.stack([points(0, 500, dup=100), points(1, 500) * 50 + 7])  # two clouds, own bounds each
    want = np.stack([np.asarray(j_pt.morton_code(jnp.asarray(c), order=order)) for c in xyz])
    got = t_pt.morton_code(torch.as_tensor(xyz), order=order)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[0])) < 500  # the duplicated points tie


def jax_module(dim, depth, group, seed=0, c_in=None, p=64):
    module = j_pt.SerializedPointTransformer(dim=dim, depth=depth, num_heads=2, group_size=group)
    c_in = c_in or dim
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((p, 3)), jnp.zeros((p, c_in)))
    return module, params


@pytest.mark.parametrize("p,group,depth,dup", [
    (300, 64, 2, 0),  # last group padded; a shifted second block
    (40, 128, 1, 0),  # one group, mostly padding
    (256, 32, 3, 60),  # whole groups; a third block back in xyz order; shared voxels
])
def test_module_matches_jax(p, group, depth, dup):
    """A batch of three clouds through the port against the JAX module run
    on each cloud; the sort is stable on both sides, so points sharing a
    voxel keep their order."""
    c = 16
    module, params = jax_module(dim=32, depth=depth, group=group, c_in=c, p=p)
    port = t_pt.SerializedPointTransformer(c, dim=32, depth=depth, num_heads=2, group_size=group, device="cpu")
    port.load_state_dict(point_transformer_from_flax(params), strict=True)
    rng = np.random.default_rng(1)
    xyz = np.stack([points(s, p, dup) for s in range(3)])
    feats = rng.normal(size=(3, p, c)).astype(np.float32)
    want = np.stack([np.asarray(module.apply(params, jnp.asarray(x), jnp.asarray(f))) for x, f in zip(xyz, feats)])
    with torch.no_grad():
        got = port(torch.as_tensor(xyz), torch.as_tensor(feats))
    assert float(np.abs(want - feats).max()) > 1e-2  # the refinement is not a no-op
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MODULE_ATOL)


def test_module_is_permutation_equivariant():
    """Permuting the input points permutes the output the same way (the
    serialization is undone), as the JAX module's own test asks."""
    port = t_pt.SerializedPointTransformer(8, dim=32, depth=2, num_heads=2, group_size=32, device="cpu")
    port.load_state_dict(random_state_dict(port, seed=0))
    xyz, feats = torch.as_tensor(points(0, 128))[None], torch.randn(1, 128, 8, generator=torch.Generator().manual_seed(0))
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = port(xyz, feats), port(xyz[:, perm], feats[:, perm])
    torch.testing.assert_close(b, a[:, perm], rtol=0, atol=2e-6)


def test_padding_rows_do_not_leak():
    """With fewer points than a group, the padded block equals attention over
    the real rows alone."""
    padded = t_pt.SerializedAttentionBlock(32, num_heads=4, group_size=128, device="cpu")
    padded.load_state_dict(random_state_dict(padded, seed=0))
    tight = t_pt.SerializedAttentionBlock(32, num_heads=4, group_size=40, device="cpu")
    tight.load_state_dict(padded.state_dict())
    x = torch.randn(2, 40, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(padded(x), tight(x), rtol=0, atol=1e-5)


CFG = dict(sliding_window_len=6, stride=4, fmaps_dim=32, num_heads=2, hidden_size=64, space_depth=1,
           time_depth=1, num_virtual_tracks=4, corr_n_levels=2, corr_neighbors=8, use_point_transformer=True,
           point_transformer_depth=2)


def tracker_pair():
    """Port and JAX trackers with the point transformer: the carried weights
    of the other parity tests, and the backbone's JAX initialization."""
    sc = [np.array(a) for a in make_scene(np.random.default_rng(0), v=2, t=8, h=64, w=64, n=6)]
    model = t_mvt.MVTracker(**CFG, device="cpu").eval()
    base = {k: v for k, v in model.state_dict().items() if not k.startswith("cloud_backbone.")}
    jm = j_mvt.MVTracker(**CFG)
    init = jax.eval_shape(lambda k: jm.init(k, *sc, iters=1), jax.random.PRNGKey(0))
    assert "cloud_backbone" in init["params"]
    pt_module = j_pt.SerializedPointTransformer(dim=32, depth=2)
    pt_params = pt_module.init(jax.random.PRNGKey(3), jnp.zeros((512, 3)), jnp.zeros((512, 32)))["params"]

    class Plain(torch.nn.Module):  # the tracker without the backbone, for its carried weights
        def state_dict(self):
            return base

    sd, params = carried_weights(Plain(), seed=0)
    params = {"params": {**jax.tree.map(np.asarray, params["params"]), "cloud_backbone": pt_params}}
    model.load_state_dict(params_from_flax(params), strict=True)
    return sc, model, jm, params


def test_tracker_with_point_transformer_matches_jax():
    sc, model, jm, params = tracker_pair()
    want = jm.apply(params, *sc, iters=2)
    got = model(*sc, iters=2)
    np.testing.assert_allclose(got["traj"].numpy(), np.asarray(want["traj"]), rtol=0, atol=TRAJ_ATOL)
    np.testing.assert_allclose(got["vis"].numpy(), np.asarray(want["vis"]), rtol=0, atol=VIS_ATOL)
    np.testing.assert_allclose(got["feat_init"].numpy(), np.asarray(want["feat_init"]), rtol=0, atol=1e-4)
    # The backbone moves the tracks: the same weights without it differ.
    plain = t_mvt.MVTracker(**dict(CFG, use_point_transformer=False), device="cpu").eval()
    plain.load_state_dict({k: v for k, v in model.state_dict().items() if not k.startswith("cloud_backbone.")})
    assert float((plain(*sc, iters=2)["traj"] - got["traj"]).abs().max()) > 1e-4


def test_tracker_backbone_gets_gradient():
    sc, model, _, _ = tracker_pair()
    out = model(*sc, iters=1, is_train=True)
    out["train_data"]["coord_predictions"].abs().mean().backward()
    grads = [p.grad for name, p in model.named_parameters() if name.startswith("cloud_backbone.")]
    assert grads and all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0


def test_random_state_dict_covers_the_backbone():
    model = t_mvt.MVTracker(**CFG, compute_dtype="bfloat16", device="cpu").eval()
    sd = random_state_dict(model, seed=0)
    assert any(k.startswith("cloud_backbone.blocks.1.attn.to_q") for k in sd)
    model.load_state_dict(sd, strict=True)
    sc = make_scene(np.random.default_rng(1), v=2, t=6, h=32, w=32, n=4)
    assert bool(torch.isfinite(model(*sc, iters=1)["traj"]).all())
