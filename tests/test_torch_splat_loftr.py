"""Port parity on the CPU for the building blocks of the triplane and
monocular families: the geometry and embedding utilities that had no port
yet, the splat (`ops/splat.py`), the LoFTR transformer in both attention
forms, the update transformer with its support memory, and the weight
mapping and seeded initialisation of that memory. Each takes seeded numpy
inputs through the JAX function and its port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch import convert
from mvtracker_torch.models import loftr as t_loftr
from mvtracker_torch.models.updateformer import EfficientUpdateFormer
from mvtracker_torch.ops import splat as t_splat
from mvtracker_torch.utils import embeddings as t_emb
from mvtracker_torch.utils import geometry as t_geo
from mvtracker_tpu.models import loftr as j_loftr
from mvtracker_tpu.models.updateformer import EfficientUpdateFormer as JaxUpdateFormer
from mvtracker_tpu.ops import splat as j_splat
from mvtracker_tpu.utils import embeddings as j_emb
from mvtracker_tpu.utils import geometry as j_geo

ELEMENTWISE_ATOL = 1e-6  # the utilities, `splat_points` and `softsplat`
LOFTR_ATOL = 1e-5  # LoFTR in both modes, the update transformer with memory


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# The geometry and embedding utilities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 6), (2, 3, 8, 10)])
def test_geometry_utilities(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(t_geo.avg_pool_2x2(t(x)).numpy(), np.asarray(j_geo.avg_pool_2x2(jnp.asarray(x))),
                               atol=ELEMENTWISE_ATOL)
    np.testing.assert_array_equal(t_geo.from_homogeneous(t(x)).numpy(), np.asarray(j_geo.from_homogeneous(x)))
    for factor in (1, 2, 3):
        np.testing.assert_array_equal(t_geo.nearest_downsample(t(x), factor).numpy(),
                                      np.asarray(j_geo.nearest_downsample(jnp.asarray(x), factor)))


def test_nearest_downsample_is_interpolate_nearest():
    x = np.random.default_rng(1).normal(size=(1, 2, 9, 12)).astype(np.float32)
    want = torch.nn.functional.interpolate(t(x), scale_factor=1 / 3, mode="nearest")
    np.testing.assert_array_equal(t_geo.nearest_downsample(t(x), 3).numpy(), want.numpy())


@pytest.mark.parametrize("c", [8, 16])
def test_coordinate_embeddings(c):
    rng = np.random.default_rng(2)
    xy = rng.normal(size=(3, 5, 2)).astype(np.float32)
    xyzw = rng.normal(size=(7, 4)).astype(np.float32)
    for cat in (True, False):
        np.testing.assert_allclose(t_emb.coord_embedding_2d(t(xy), c, cat).numpy(),
                                   np.asarray(j_emb.coord_embedding_2d(jnp.asarray(xy), c, cat)), atol=ELEMENTWISE_ATOL)
        np.testing.assert_allclose(t_emb.coord_embedding_4d(t(xyzw), c, cat).numpy(),
                                   np.asarray(j_emb.coord_embedding_4d(jnp.asarray(xyzw), c, cat)),
                                   atol=ELEMENTWISE_ATOL)
    np.testing.assert_allclose(t_emb.sincos_2d(c, t(xy)).numpy(), np.asarray(j_emb.sincos_2d(c, jnp.asarray(xy))),
                               atol=ELEMENTWISE_ATOL)
    assert t_emb.coord_embedding_2d(t(xy), c).shape == (3, 5, 2 + 2 * c)
    np.testing.assert_array_equal(t_emb.coord_embedding_2d(t(xy), c)[..., :2].numpy(), xy)  # prepended in 2D


@pytest.mark.parametrize("n_freqs,max_log2,log_sampling", [(4, 3.0, True), (4, 3.0, False), (6, 2.5, True)])
def test_fourier_embedding(n_freqs, max_log2, log_sampling):
    x = np.random.default_rng(3).uniform(-1, 1, size=(5, 3)).astype(np.float32)
    kw = dict(include_input=True, log_sampling=log_sampling, rescale=2.0)
    got = t_emb.fourier_embedding(t(x), n_freqs, max_log2, **kw).numpy()
    want = np.asarray(j_emb.fourier_embedding(jnp.asarray(x), n_freqs, max_log2, **kw))
    assert got.shape == want.shape == (5, 3 + 2 * n_freqs * 3)
    np.testing.assert_allclose(got, want, atol=ELEMENTWISE_ATOL)
    no_input = t_emb.fourier_embedding(t(x), n_freqs, max_log2, include_input=False).numpy()
    np.testing.assert_allclose(no_input, np.asarray(j_emb.fourier_embedding(jnp.asarray(x), n_freqs, max_log2,
                                                                            include_input=False)),
                               atol=ELEMENTWISE_ATOL)


# ---------------------------------------------------------------------------
# The splat
# ---------------------------------------------------------------------------


def splat_case(seed, b=2, p=150, c=5, h=9, w=11):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.5, max(h, w) + 0.5, size=(b, p, 2)).astype(np.float32)
    xy[0, 3] = (np.nan, 2.0)  # non-finite: deposits nothing
    xy[1, 4] = (np.inf, 1e12)
    xy[1, 5] = (-3e9, 4.0)  # far outside: clamped before the cast, dropped
    feats = rng.normal(size=(b, p, c)).astype(np.float32)
    metric = rng.normal(size=(b, p)).astype(np.float32)
    return xy, feats, metric, h, w


@pytest.mark.parametrize("seed", [0, 1])
def test_splat_points_matches_jax(seed):
    xy, feats, metric, h, w = splat_case(seed)
    got = t_splat.splat_points(t(xy), t(feats), t(metric), h, w)
    want = np.asarray(j_splat.splat_points(jnp.asarray(xy), jnp.asarray(feats), jnp.asarray(metric), h, w))
    assert got.shape == want.shape == (2, h, w, 5) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ELEMENTWISE_ATOL)


def test_splat_points_gradient_matches_jax():
    xy, feats, metric, h, w = splat_case(2)
    feats_t = t(feats).requires_grad_()
    (t_splat.splat_points(t(xy), feats_t, t(metric), h, w) ** 2).sum().backward()
    want = jax.grad(lambda f: (j_splat.splat_points(jnp.asarray(xy), f, jnp.asarray(metric), h, w) ** 2).sum())(
        jnp.asarray(feats)
    )
    np.testing.assert_allclose(feats_t.grad.numpy(), np.asarray(want), atol=1e-5)
    assert float(feats_t.grad.abs().sum()) > 0


@pytest.mark.parametrize("mode", ["sum", "avg", "soft"])
def test_softsplat_matches_jax(mode):
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 8, 10, 3)).astype(np.float32)
    flow = rng.normal(scale=2.0, size=(2, 8, 10, 2)).astype(np.float32)
    flow[0, 1, 1] = np.nan
    metric = rng.normal(size=(2, 8, 10)).astype(np.float32)
    got = t_splat.softsplat(t(img), t(flow), t(metric), mode=mode).numpy()
    want = np.asarray(j_splat.softsplat(jnp.asarray(img), jnp.asarray(flow), jnp.asarray(metric), mode=mode))
    np.testing.assert_allclose(got, want, atol=ELEMENTWISE_ATOL)
    with pytest.raises(ValueError):
        t_splat.softsplat(t(img), t(flow), mode="nope")


def test_softsplat_zero_flow_is_identity():
    img = np.random.default_rng(5).normal(size=(1, 6, 7, 2)).astype(np.float32)
    out = t_splat.softsplat(t(img), torch.zeros(1, 6, 7, 2), mode="avg")
    np.testing.assert_allclose(out.numpy(), img, atol=1e-5)


# ---------------------------------------------------------------------------
# LoFTR
# ---------------------------------------------------------------------------


def loftr_params(d_model, n_layers, seed):
    """flax params of a LocalFeatureTransformer with random norm parameters."""
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": rng.normal(0, (i + o) ** -0.5, (i, o)).astype(np.float32)}

    def norm():
        return {"scale": (1 + rng.normal(0, 0.1, d_model)).astype(np.float32),
                "bias": rng.normal(0, 0.1, d_model).astype(np.float32)}

    return {f"layer_{i}": {"q_proj": dense(d_model, d_model), "k_proj": dense(d_model, d_model),
                           "v_proj": dense(d_model, d_model), "merge": dense(d_model, d_model),
                           "mlp_0": dense(2 * d_model, 2 * d_model), "mlp_1": dense(2 * d_model, d_model),
                           "norm1": norm(), "norm2": norm()} for i in range(n_layers)}


@pytest.mark.parametrize("masked", [False, True])
def test_attention_functions_match_jax(masked):
    rng = np.random.default_rng(6)
    b, l, s, h, d = 2, 7, 11, 4, 16
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for n in (l, s, s))
    qm = rng.random((b, l)) > 0.3 if masked else None
    km = rng.random((b, s)) > 0.3 if masked else None
    tm = (lambda m: None if m is None else t(m))
    jm = (lambda m: None if m is None else jnp.asarray(m))
    for t_fn, j_fn in ((t_loftr.linear_attention, j_loftr.linear_attention),
                       (t_loftr.full_attention, j_loftr.full_attention)):
        got = t_fn(t(q), t(k), t(v), tm(qm), tm(km)).numpy()
        want = np.asarray(j_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm(qm), jm(km)))
        np.testing.assert_allclose(got, want, atol=LOFTR_ATOL, err_msg=t_fn.__name__)


@pytest.mark.parametrize("attention", ["full", "linear"])
def test_local_feature_transformer_matches_jax(attention):
    d_model, names = 32, ("self", "cross", "self", "cross")
    params = loftr_params(d_model, len(names), seed=7)
    rng = np.random.default_rng(8)
    f0 = rng.normal(size=(2, 9, d_model)).astype(np.float32)
    f1 = rng.normal(size=(2, 6, d_model)).astype(np.float32)
    m0 = rng.random((2, 9)) > 0.3
    model = t_loftr.LocalFeatureTransformer(d_model, nhead=4, layer_names=names, attention=attention)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in convert._loftr(params, "").items()},
                          strict=True)
    jax_model = j_loftr.LocalFeatureTransformer(d_model, nhead=4, layer_names=names, attention=attention)
    for mask in (None, m0):
        want0, want1 = jax_model.apply({"params": params}, f0, f1, mask0=None if mask is None else jnp.asarray(mask))
        got0, got1 = model(t(f0), t(f1), mask0=None if mask is None else t(mask))
        np.testing.assert_allclose(got0.detach().numpy(), np.asarray(want0), atol=LOFTR_ATOL)
        np.testing.assert_allclose(got1.detach().numpy(), np.asarray(want1), atol=LOFTR_ATOL)
    with pytest.raises(KeyError):
        t_loftr.LocalFeatureTransformer(d_model, layer_names=("self", "bogus"))


# ---------------------------------------------------------------------------
# The update transformer with its support memory, and its weights
# ---------------------------------------------------------------------------

UF = dict(space_depth=2, time_depth=2, input_dim=24, hidden_size=32, num_heads=2, output_dim=7, num_virtual_tracks=4,
          support_memory_tokens=10)


def uf_pair(attention, seed=9):
    """The JAX update transformer's initial params with random biases, norm
    parameters and bank, a larger flow head, and the port's with the same."""
    x = np.zeros((1, 6, 5, 24), np.float32)
    params = JaxUpdateFormer(**UF, support_memory_attention=attention).init(jax.random.PRNGKey(seed), x)
    rng = np.random.default_rng(seed)

    def bump(path, leaf):
        name, leaf = jax.tree_util.keystr(path), np.asarray(leaf)
        if "'bias'" in name or "'scale'" in name or "support_memory" in name:
            leaf = leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        if "flow_head" in name and "'kernel'" in name:
            leaf = leaf * 100.0
        return leaf

    params = jax.tree_util.tree_map_with_path(bump, params)
    model = EfficientUpdateFormer(**UF, support_memory_attention=attention)
    model.load_state_dict(convert.updateformer_from_flax(params), strict=True)
    return params, model


@pytest.mark.parametrize("attention", ["full", "linear"])
def test_update_former_with_memory_matches_jax(attention):
    params, model = uf_pair(attention)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(1, 6, 5, 24)).astype(np.float32)
    mask = rng.random((1, 6)) > 0.3
    mask[0, 0] = True
    jm = JaxUpdateFormer(**UF, support_memory_attention=attention)
    want = np.asarray(jm.apply(params, jnp.asarray(x), track_mask=jnp.asarray(mask)))
    got = model(t(x), track_mask=t(mask)).detach().numpy()
    assert got.shape == want.shape == (1, 6, 5, 7)
    np.testing.assert_allclose(got, want, atol=LOFTR_ATOL)
    # Without the memory the output moves: the check sees it.
    plain = JaxUpdateFormer(**dict(UF, support_memory_tokens=0))
    p0 = {"params": {k: v for k, v in params["params"].items() if k not in ("gnn", "support_memory")}}
    assert np.abs(np.asarray(plain.apply(p0, jnp.asarray(x), track_mask=jnp.asarray(mask))) - want).max() > 1e-4
    # Masked tracks are invisible to the active ones through the memory too.
    x2 = x.copy()
    x2[0, ~mask[0]] += 100.0
    got2 = model(t(x2), track_mask=t(mask)).detach().numpy()
    np.testing.assert_array_equal(got2[0, mask[0]], got[0, mask[0]])


def test_update_former_memory_stays_fp32_in_bf16():
    """The bf16 weight casts leave the memory head fp32: its output equals
    the fp32 head's on the same tokens."""
    model = EfficientUpdateFormer(**UF, dtype=torch.bfloat16)
    for module in model.gnn.modules():
        if hasattr(module, "compute_dtype"):
            assert module.compute_dtype is None
    assert model.support_memory.dtype == torch.float32


def test_weight_mapping_and_seeded_bank():
    """params_from_flax maps `gnn` and `support_memory` under the reference's
    names; random_state_dict gives the bank 0.1 and the LoFTR denses
    xavier-uniform."""
    params, model = uf_pair("full")
    sd = convert.updateformer_from_flax(params)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(sd["gnn.layers.0.mlp.2.weight"].numpy(),
                                  np.asarray(params["params"]["gnn"]["layer_0"]["mlp_1"]["kernel"]).T)
    np.testing.assert_array_equal(sd["support_memory"].numpy(), np.asarray(params["params"]["support_memory"]))
    from mvtracker_torch.models.spatracker import MultiViewSpaTracker

    tracker = MultiViewSpaTracker(device="cpu", fmaps_dim=16, hidden_size=32, num_heads=2, space_depth=1,
                                  time_depth=1, support_memory_tokens=5)
    seeded = convert.random_state_dict(tracker, seed=0)
    assert set(seeded) == set(tracker.state_dict())
    np.testing.assert_array_equal(seeded["updateformer.support_memory"].numpy(), np.full((1, 5, 32), 0.1, np.float32))
    w = seeded["updateformer.gnn.layers.3.q_proj.weight"].numpy()
    limit = np.sqrt(6.0 / 64)
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.8 * limit  # uniform on [-limit, limit]
    np.testing.assert_array_equal(seeded["updateformer.gnn.layers.3.norm2.weight"].numpy(), np.ones(32, np.float32))
