"""Port parity: `mvtracker_torch.evaluation.predictor` against the JAX
package's predictor, on the same scenes and weights (CPU, fp32): the resize
and support-point building blocks, then every mode of `EvaluationPredictor`
(one forward with resize and a support grid, chunked, single point, and
a host-side baseline that takes and gives numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.evaluation import predictor as t_pred
from mvtracker_torch.models import copycat as t_copycat
from mvtracker_torch.models import mvtracker as t_mvt
from mvtracker_tpu.evaluation import predictor as j_pred
from mvtracker_tpu.models import copycat as j_copycat
from mvtracker_tpu.models.mvtracker import MVTracker as JaxMVTracker
from tests.test_model import make_scene
from tests.test_torch_modules import carried_weights
from tests.test_torch_mvtracker import CFG, TRAJ_ATOL, VIS_ATOL

# Support points: the same projections and bilinear samples on both sides;
# measured gaps below 1e-6 in world units of a scene spread over a few units.
SUPPORT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tracker():
    """(port model, JAX model, its params) with the same seeded weights."""
    model = t_mvt.MVTracker(**CFG, device="cpu").eval()
    sd, params = carried_weights(model, seed=0)
    model.load_state_dict(sd)
    return model, JaxMVTracker(**CFG), params


def _scene(seed=0, t=8, h=48, w=64, n=5):
    """A scene of 2 views; without a resize the model needs h and w
    divisible by 32 (4 levels under stride 4)."""
    return [np.array(a) for a in make_scene(np.random.default_rng(seed), v=2, t=t, h=h, w=w, n=n)]


def _check(got, want, atol_traj=TRAJ_ATOL, atol_vis=VIS_ATOL):
    for key, atol in (("traj", atol_traj), ("vis", atol_vis)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol, err_msg=key)
    np.testing.assert_array_equal(got["occluded"].numpy(), np.asarray(want["occluded"]))


@pytest.mark.parametrize("size", [(40, 56), (100, 30), (48, 64)])
def test_nearest_resize_matches_jax(size):
    x = np.random.default_rng(0).normal(size=(2, 3, 48, 64)).astype(np.float32)
    got = t_pred.nearest_resize(torch.from_numpy(x), *size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_pred.nearest_resize(jnp.asarray(x), *size)))


@pytest.mark.parametrize("grid_size,n_grids", [(1, 1), (3, 1), (4, 3)])
def test_support_grid_points_match_jax(grid_size, n_grids):
    _, depths, _, intrs, extrs = _scene()
    got = t_pred.build_support_grid_points(*map(torch.from_numpy, (depths, intrs, extrs)), grid_size, n_grids)
    want = j_pred.build_support_grid_points(*map(jnp.asarray, (depths, intrs, extrs)), grid_size, n_grids)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SUPPORT_ATOL)


def test_uniform_support_points_match_jax_on_its_samples():
    """The unprojection fed with the samples `jax.random` draws inside the
    JAX function for the same key."""
    _, depths, _, intrs, extrs = _scene()
    v, t, h, w = depths.shape
    num, key = 50, jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    ts = jax.random.randint(k1, (num,), 0, t)
    xs = jax.random.uniform(k2, (num,), minval=0.0, maxval=w - 1.0)
    ys = jax.random.uniform(k3, (num,), minval=0.0, maxval=h - 1.0)
    want = j_pred.build_uniform_support_points(*map(jnp.asarray, (depths, intrs, extrs)), num, key)
    got = t_pred.build_uniform_support_points(
        *map(torch.from_numpy, (depths, intrs, extrs)),
        torch.from_numpy(np.asarray(ts, np.int64)), torch.from_numpy(np.asarray(xs)), torch.from_numpy(np.asarray(ys)),
    )
    assert got.shape == want.shape == (num * v, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SUPPORT_ATOL)


def test_uniform_support_samples_follow_the_generator():
    ts, xs, ys = t_pred.draw_uniform_support_samples(500, 8, 48, 64, torch.Generator().manual_seed(1))
    again = t_pred.draw_uniform_support_samples(500, 8, 48, 64, torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip((ts, xs, ys), again))
    assert ts.dtype == torch.int64 and int(ts.min()) == 0 and int(ts.max()) == 7
    assert 0 <= float(xs.min()) and float(xs.max()) < 63 and 0 <= float(ys.min()) and float(ys.max()) < 47


def test_fused_path_with_resize_and_grid_matches_jax(tracker):
    model, jm, params = tracker
    scene = _scene()
    kw = dict(interp_shape=(64, 96), grid_size=2, n_iters=2)
    want = j_pred.EvaluationPredictor(jm, params, **kw)(*scene)
    pred = t_pred.EvaluationPredictor(model, **kw, device="cpu")
    got = pred(*scene)
    assert got["traj"].shape == (8, 5, 3)
    _check(got, want)


@pytest.mark.parametrize("chunk_frames", [6, 2])
def test_chunked_path_matches_jax(tracker, chunk_frames):
    """Segments of `chunk_frames` frames sharing a boundary frame; with 2 the
    segments are shorter than the model's window (6)."""
    model, jm, params = tracker
    scene = _scene(seed=1, t=9, h=64, w=64)
    scene[2][1:, 0] = (1, 3, 5, 8)  # tracks start in several segments
    kw = dict(interp_shape=None, grid_size=2, n_iters=1, chunk_frames=chunk_frames)
    want = j_pred.EvaluationPredictor(jm, params, **kw)(*scene)
    got = t_pred.EvaluationPredictor(model, **kw, device="cpu")(*scene)
    _check(got, want)
    assert (got["traj"][:3, 2] == 0).all()  # before the track's start


def test_single_point_path_matches_jax(tracker):
    model, jm, params = tracker
    scene = _scene(seed=2, h=64, w=64, n=3)
    kw = dict(interp_shape=None, grid_size=2, n_iters=1, single_point=True, local_grid_size=3, local_extent=20)
    want = j_pred.EvaluationPredictor(jm, params, **kw)(*scene)
    got = t_pred.EvaluationPredictor(model, **kw, device="cpu")(*scene)
    _check(got, want)


@pytest.mark.parametrize("baseline", ["host", "device"])
def test_copycat_through_the_predictor_matches_jax(baseline):
    """The numpy CopyCat gets host arrays, the tensor one device tensors;
    both give the JAX predictor's answer on its CopyCat."""
    scene = _scene(seed=3)
    port = {"host": t_copycat.CopyCat(), "device": t_copycat.CopyCatPredictor()}[baseline]
    jax_model = {"host": j_copycat.CopyCat(), "device": j_copycat.CopyCatPredictor()}[baseline]
    kw = dict(interp_shape=(64, 96), grid_size=2)
    want = j_pred.EvaluationPredictor(jax_model, None, **kw)(*scene)
    got = t_pred.EvaluationPredictor(port, **kw, device="cpu")(*scene)
    assert torch.is_tensor(got["traj"])
    _check(got, want, 0.0, 0.0)


def _given(form, scene):
    """The scene as `form` hands it to the predictor: (the inputs, the same
    values widened to fp32 on the host)."""
    rgbs, depths, query, intrs, extrs = scene
    u8 = rgbs.astype(np.uint8)
    if form == "float64_cameras":
        noise = np.random.default_rng(0).normal(scale=1e-6, size=extrs.shape)  # not fp32-representable
        given = (u8, depths, query, intrs.astype(np.float64), extrs + noise)
    else:
        frames = {"uint8_tensor": torch.from_numpy(u8), "uint8_array": u8, "uint8_reversed_view": u8[..., ::-1]}[form]
        given = (frames, depths, query, intrs, extrs)
    return given, tuple(np.asarray(x, dtype=np.float32) for x in given)


@pytest.mark.parametrize("form", ["uint8_tensor", "uint8_array", "uint8_reversed_view", "float64_cameras"])
def test_inputs_cross_at_their_own_width(tracker, form):
    """Inputs move at the width they come in and are widened on the device:
    uint8 frames as a tensor, as an array or as a negative-stride view, and
    float64 cameras, answer bit for bit as their values widened to fp32 on
    the host (for the view: its contiguous copy), and `last_upload_bytes`
    counts them at their own width, uint8 frames at a byte a channel."""
    given, host = _given(form, _scene(seed=4))
    pred = t_pred.EvaluationPredictor(tracker[0], interp_shape=(64, 96), grid_size=2, n_iters=1, device="cpu")
    got = pred(*given)
    sent = pred.last_upload_bytes
    want = pred(*host)
    assert sent == sum(np.asarray(x).nbytes for x in given) < pred.last_upload_bytes == sum(x.nbytes for x in host)
    for key in ("traj", "vis", "occluded"):
        assert torch.equal(got[key], want[key]), key


def test_predictor_refuses_what_it_cannot_do(tracker):
    model = tracker[0]
    with pytest.raises(ValueError, match="collect_stats"):  # a model that collects no statistics
        t_pred.EvaluationPredictor(model, consume_model_stats=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_pred.EvaluationPredictor(t_copycat.CopyCatPredictor())  # the default device is the GPU
        with pytest.raises(RuntimeError, match="CUDA"):
            t_pred.EvaluationPredictor(model, device="cuda")
