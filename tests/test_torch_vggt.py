"""Port parity on the CPU for VGGT (`mvtracker_torch/models/vggt.py`) and its
weight mapping (`mvtracker_torch/convert.py`): the rotary embedding, the
resizes, the aggregator's intermediates and every output against the JAX
model at `tiny_config()` with both patch embeds, on the same weights both
ways (the JAX params mapped to the port, the port's seeded state dict
through JAX's own converter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch import convert
from mvtracker_torch.models import vggt as t_vggt
from mvtracker_tpu.convert import convert_vggt_state_dict
from mvtracker_tpu.models import vggt as j_vggt

PART_ATOL = 1e-5  # RoPE, resizes, aggregator intermediates
OUTPUT_ATOL = 1e-4  # pose encodings, cameras, depth, confidences, world points
OUTPUTS = ("pose_enc", "extrinsics", "intrinsics", "depth", "depth_conf", "world_points", "world_points_conf")


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def images(s, h, w, seed=0):
    return np.random.default_rng(seed).uniform(size=(1, s, h, w, 3)).astype(np.float32)


def test_rope_2d():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 11, 16)).astype(np.float32)
    pos = rng.integers(0, 9, (2, 11, 2))
    np.testing.assert_allclose(t_vggt.apply_rope_2d(t(x), torch.from_numpy(pos), 100.0).numpy(),
                               np.asarray(j_vggt.apply_rope_2d(jnp.asarray(x), jnp.asarray(pos), 100.0)),
                               atol=PART_ATOL)


@pytest.mark.parametrize("method,in_hw,out_hw", [("cubic", (37, 37), (37, 21)), ("cubic", (4, 4), (6, 9)),
                                                  ("linear", (7, 5), (14, 10)), ("linear", (7, 9), (3, 4)),
                                                  ("linear", (37, 21), (518, 294))])
def test_resize_matches_jax_image_resize(method, in_hw, out_hw):
    """Keys cubic (a = -0.5) and linear with half-pixel centres,
    antialiased when shrinking; an axis that keeps its size is untouched."""
    x = np.random.default_rng(1).normal(size=(2, *in_hw, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *out_hw, 3), "cubic" if method == "cubic" else "bilinear")
    got = t_vggt.resize_2d(t(x), out_hw, method, channels_last=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PART_ATOL)
    got_nchw = t_vggt.resize_2d(t(x).permute(0, 3, 1, 2), out_hw, method)
    np.testing.assert_allclose(got_nchw.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=PART_ATOL)


def perturbed(params, seed):
    """JAX's initial params with every vector leaf (biases, norms, LayerScale,
    tokens) moved, so the parity sees none at its trivial initial value."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        if x.ndim >= 2 and x.shape[-2] > 1 and x.ndim != 3:
            return jnp.asarray(x)
        return jnp.asarray(x + rng.normal(0.0, 0.05, x.shape).astype(np.float32))

    return jax.tree_util.tree_map(move, params)


CASES = {"conv": ((2, 56, 56), None), "dinov2": ((3, 84, 56), "dinov2")}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(JAX model, its params, the port's model with them, input)."""
    (s, h, w), embed = CASES[request.param]
    cfg_kw = {"patch_embed": embed} if embed else {}
    jcfg = j_vggt.tiny_config(**cfg_kw)
    x = images(s, h, w, seed=3)
    jmodel = j_vggt.VGGT(jcfg)
    params = perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    tmodel = t_vggt.VGGT(t_vggt.tiny_config(**cfg_kw), device="cpu").eval()
    tmodel.load_state_dict(convert.vggt_params_from_flax(params), strict=True)
    return jmodel, params, tmodel, x


def test_aggregator_intermediates(pair):
    jmodel, params, tmodel, x = pair
    agg = j_vggt.Aggregator(jmodel.cfg)
    want, start = jax.jit(agg.apply, static_argnums=())({"params": params["params"]["aggregator"]}, jnp.asarray(x))
    with torch.no_grad():
        got, got_start = tmodel.aggregator(t(x))
    assert start == got_start and len(got) == len(want) == jmodel.cfg.depth
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PART_ATOL, rtol=PART_ATOL)


def test_vggt_outputs(pair):
    """At patch grids other than the stored one the positional embedding is
    cubic-resized (the dinov2 case: 6 x 4 against 4 x 4)."""
    jmodel, params, tmodel, x = pair
    want = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(t(x))
    for name in OUTPUTS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=OUTPUT_ATOL, rtol=OUTPUT_ATOL,
                                   err_msg=name)
    for a, b in zip(got["pose_enc_list"], want["pose_enc_list"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OUTPUT_ATOL, rtol=OUTPUT_ATOL)


@pytest.mark.parametrize("embed", ["conv", "dinov2"])
def test_seeded_state_dict_through_jax_converter(embed):
    """The other way: the port's seeded weights as numpy, through the JAX
    package's own `convert_vggt_state_dict`, give the JAX model the port's
    outputs."""
    cfg_kw = {"patch_embed": embed}
    tmodel = t_vggt.VGGT(t_vggt.tiny_config(**cfg_kw), device="cpu").eval()
    sd = convert.random_state_dict(tmodel, seed=5)
    tmodel.load_state_dict(sd, strict=True)
    gamma = sd["aggregator.frame_blocks.0.ls1.gamma"]
    assert torch.all(gamma == 0.01) and float(sd["aggregator.camera_token"].abs().max()) < 1e-5
    x = images(2, 56, 56, seed=6)
    ref = {k: v.numpy() for k, v in sd.items()}
    want = jax.jit(j_vggt.VGGT(j_vggt.tiny_config(**cfg_kw)).apply)(convert_vggt_state_dict(ref), jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(t(x))
    for name in OUTPUTS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=OUTPUT_ATOL, rtol=OUTPUT_ATOL,
                                   err_msg=name)


def test_load_vggt_checkpoint(tmp_path):
    """A checkpoint in the facebook/VGGT-1B layout (DINOv2 blocks chunked,
    a track head, the mask token, under "model") loads strictly."""
    tmodel = t_vggt.VGGT(t_vggt.tiny_config(patch_embed="dinov2"), device="cpu")
    sd = convert.random_state_dict(tmodel, seed=7)
    ref = {}
    for k, v in sd.items():
        ref[k.replace("patch_embed.blocks.", "patch_embed.blocks.0.")] = v
    ref["aggregator.patch_embed.mask_token"] = torch.zeros(1, 64)
    ref["track_head.feature_extractor.norm.weight"] = torch.ones(3)
    torch.save({"model": ref}, tmp_path / "vggt.pt")
    loaded = convert.load_vggt_checkpoint(str(tmp_path / "vggt.pt"))
    assert set(loaded) == set(sd)
    tmodel.load_state_dict(loaded, strict=True)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k


def test_odd_patch_grid_runs():
    """At an odd patch grid (VGGT-1B's 37 x 37 at 518^2) the JAX fusion
    pyramid cannot add its 2x-upsampled level to the finer one; the port
    resizes to the finer level's size, as the reference does."""
    tmodel = t_vggt.VGGT(t_vggt.tiny_config(patch_embed="dinov2"), device="cpu").eval()
    t_vggt.init_weights_(tmodel, seed=0)
    with torch.no_grad():
        out = tmodel(t(images(2, 70, 42, seed=8)))
    assert out["depth"].shape == (1, 2, 70, 42, 1) and out["world_points"].shape == (1, 2, 70, 42, 3)
    assert all(bool(torch.isfinite(out[k]).all()) for k in OUTPUTS)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jm = j_vggt.VGGT(j_vggt.tiny_config())
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(images(1, 70, 42)))


def test_init_weights_follow_the_rules():
    tmodel = t_vggt.VGGT(t_vggt.tiny_config(patch_embed="dinov2"), device="cpu")
    t_vggt.init_weights_(tmodel, seed=1)
    sd = tmodel.state_dict()
    assert torch.all(sd["aggregator.patch_embed.blocks.0.ls2.gamma"] == 1.0)
    assert torch.all(sd["camera_head.trunk.1.ls1.gamma"] == 0.01)
    assert torch.all(sd["depth_head.projects.0.bias"] == 0.0)
    assert 0 < float(sd["aggregator.register_token"].std()) < 3e-6
    w = sd["aggregator.global_blocks.2.mlp.fc1.weight"]
    assert abs(float(w.std()) * 64**0.5 - 1.0) < 0.05 and float(w.abs().max()) <= 2.0 / 0.8796 / 8 + 1e-6
