"""Port parity: `BasicEncoder` and `EfficientUpdateFormer` of `mvtracker_torch`
against the JAX package's modules, with the same weights carried both ways
(the port's seeded weights, mapped to flax by the JAX package's own
`convert_reference_state_dict`), in fp32 and in bf16.

flax initializes biases to 0 and norm scales to 1, so the carried weights
get random biases and norm parameters (`with_random_affine`): a forward
that drops a bias or misplaces an affine parameter then fails the check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.convert import random_state_dict
from mvtracker_torch.models.encoder import bilinear_resize_align_corners, instance_norm
from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_tpu.convert import convert_reference_state_dict
from mvtracker_tpu.models import encoder as j_enc
from mvtracker_tpu.models.updateformer import EfficientUpdateFormer as JaxUpdateFormer

CFG = dict(
    sliding_window_len=6, stride=4, fmaps_dim=32, num_heads=2, hidden_size=64,
    space_depth=2, time_depth=2, num_virtual_tracks=4, corr_n_levels=2, corr_neighbors=4,
)
# fp32 on both sides; convolutions and attention sum in other orders.
FP32_ATOL = 1e-4
# The flow head's truncated-normal weights (std 1e-3) make the transformer's
# output ~1e-6; scaled up, its bf16 rounding is visible to the checks.
FLOW_HEAD_GAIN = 30.0


def with_random_affine(sd, seed, std=0.1):
    """`sd` with N(0, std) added to every bias and every norm weight."""
    rng = np.random.default_rng(seed)
    out = dict(sd)
    for name, t in sd.items():
        if name.endswith(".bias") or ("norm" in name.rsplit(".", 2)[-2] and name.endswith(".weight")):
            out[name] = t + torch.from_numpy(rng.normal(0.0, std, t.shape).astype(np.float32))
    return out


def carried_weights(model, seed):
    """Seeded weights for `model` with random affine parameters and a
    scaled-up flow head; returns (state dict, flax params for the JAX model)."""
    sd = with_random_affine(random_state_dict(model, seed=seed), seed + 1)
    for name in sd:
        if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
            sd[name] = sd[name] * FLOW_HEAD_GAIN
    params = convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})
    return sd, jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def carried():
    sd, params = carried_weights(MVTracker(**CFG, device="cpu"), seed=0)
    models = {}
    for dtype in ("float32", "bfloat16"):
        models[dtype] = MVTracker(**CFG, compute_dtype=dtype, device="cpu").eval()
        models[dtype].load_state_dict(sd)
    return models, params["params"]


def test_instance_norm_and_resize(rng):
    x = rng.normal(size=(2, 5, 6, 3)).astype(np.float32) * 3 + 1  # NHWC
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_allclose(
        instance_norm(xt).permute(0, 2, 3, 1).numpy(), np.asarray(j_enc.instance_norm(jnp.asarray(x))), atol=1e-5
    )
    got = bilinear_resize_align_corners(xt, 3, 4).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(j_enc.bilinear_resize_align_corners(jnp.asarray(x), 3, 4)), atol=1e-5)
    # align_corners=True semantics, as PyTorch's own interpolate
    want = torch.nn.functional.interpolate(xt, size=(3, 4), mode="bilinear", align_corners=True)
    np.testing.assert_allclose(got, want.permute(0, 2, 3, 1).numpy(), atol=1e-5)


def test_basic_encoder(rng, carried):
    models, params = carried
    model = models["float32"]
    x = rng.uniform(-1, 1, size=(3, 32, 48, 3)).astype(np.float32)  # NHWC
    want = j_enc.BasicEncoder(output_dim=32, stride=4).apply({"params": params["fnet"]}, jnp.asarray(x))
    got = model.fnet(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape == (3, 8, 12, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FP32_ATOL)


def test_update_former(rng, carried):
    models, params = carried
    model = models["float32"]
    d_in = model.updateformer_input_dim
    n, t = 9, 6
    x = rng.normal(size=(1, n, t, d_in)).astype(np.float32)
    mask = rng.random((1, n)) > 0.3
    mask[0, 0] = True
    jm = JaxUpdateFormer(
        space_depth=2, time_depth=2, input_dim=d_in, hidden_size=64, num_heads=2,
        output_dim=3 + 32, num_virtual_tracks=4,
    )
    want = jm.apply({"params": params["updateformer"]}, jnp.asarray(x), track_mask=jnp.asarray(mask))
    got = model.updateformer(torch.from_numpy(x), track_mask=torch.from_numpy(mask))
    assert tuple(got.shape) == want.shape == (1, n, t, 35)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FP32_ATOL)
    # Masked tracks are hidden from the virtual tokens and time attention is
    # per track, so changing masked tracks leaves the others' outputs alone.
    x2 = x.copy()
    x2[0, ~mask[0]] += 5.0
    got2 = model.updateformer(torch.from_numpy(x2), track_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got2[0, mask[0]].detach().numpy(), got[0, mask[0]].detach().numpy(), atol=1e-5)


# bf16 (flax `dtype=bf16`: bf16 operands, fp32 parameters, fp32 softmax and
# statistics) on both sides. Each side rounds in its own places (XLA fuses
# and may keep fp32 between ops; eager PyTorch rounds after every op), so
# the port's bf16 output is held to the size of the bf16 rounding itself:
# the JAX bf16 output's own distance from the JAX fp32 output, the control.
# Readings on these inputs (max abs): encoder 0.156 port-vs-JAX, control
# 0.153, on outputs up to 5.8; transformer 3.4e-4 port-vs-JAX, control
# 2.5e-4, on outputs up to 0.26. The tolerances are about twice the control.
ENC_BF16_ATOL = 0.3
UF_BF16_ATOL = 6e-4


def test_basic_encoder_bf16(rng, carried):
    models, params = carried
    x = rng.uniform(-1, 1, size=(3, 32, 48, 3)).astype(np.float32)
    enc = j_enc.BasicEncoder(output_dim=32, stride=4, dtype=jnp.bfloat16)
    want = np.asarray(enc.apply({"params": params["fnet"]}, jnp.asarray(x)))
    got = models["bfloat16"].fnet(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ENC_BF16_ATOL)
    # bf16 is engaged: the output is not the fp32 one.
    full = models["float32"].fnet(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert float((got - full).detach().abs().max()) > 1e-2


def test_update_former_bf16(rng, carried):
    models, params = carried
    d_in = models["bfloat16"].updateformer_input_dim
    x = rng.normal(size=(1, 9, 6, d_in)).astype(np.float32)
    mask = rng.random((1, 9)) > 0.3
    mask[0, 0] = True
    jm = JaxUpdateFormer(
        space_depth=2, time_depth=2, input_dim=d_in, hidden_size=64, num_heads=2,
        output_dim=3 + 32, num_virtual_tracks=4, dtype=jnp.bfloat16,
    )
    want = np.asarray(jm.apply({"params": params["updateformer"]}, jnp.asarray(x), track_mask=jnp.asarray(mask)))
    got = models["bfloat16"].updateformer(torch.from_numpy(x), track_mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=UF_BF16_ATOL)
    full = models["float32"].updateformer(torch.from_numpy(x), track_mask=torch.from_numpy(mask))
    assert float((got - full).detach().abs().max()) > 1e-5
