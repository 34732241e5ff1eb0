"""Port parity: the train step of `mvtracker_torch.training.step` against
`mvtracker_tpu.training.step` on the CPU.

- the optimizer alone (non-finite guard, global-norm clip, AdamW, the three
  schedules and the degenerate-schedule guard) against optax, step by step;
- `scene_loss`: loss, its parts and every gradient leaf against
  `jax.value_and_grad` of the JAX `scene_loss` with the model on its
  kernel's correlation path (`corr_backend="pallas_interpret"`, so the
  `custom_vjp` backward is what is compared), in fp32 and in bf16;
- where gradient flows: the per-iteration detach, and the chain from one
  window into the previous one;
- the step itself: scenes of a batch, metrics, casts of compressed inputs.

The whole model's parameters after an AdamW step are not compared: the
first Adam update is lr * g / (|g| + eps), so a gradient entry near zero
that differs in its last bit moves a parameter by a full lr. AdamW is held
by the optimizer test and by the optimizer state at model scale instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvtracker_torch.convert import opt_state_from_optax, params_from_flax
from mvtracker_torch.models import mvtracker as t_mvt
from mvtracker_torch.training import step as t_step
from mvtracker_torch.utils import geometry as t_geo
from mvtracker_tpu.models.mvtracker import MVTracker as JaxMVTracker
from mvtracker_tpu.training import step as j_step
from tests.test_model import make_scene
from tests.test_torch_modules import carried_weights
from tests.test_torch_mvtracker import CFG

ITERS, GAMMA, VIS_WEIGHT = 2, 0.8, 0.1


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    """One intra-op thread while this file runs. The suite runs in several
    worker processes; a PyTorch thread pool per process oversubscribes the
    cores, and the backward then runs many times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
T, N = 9, 6  # 2 windows of 6 frames, hop 3

# fp32, port against JAX. Loss and parts: sums in another order.
LOSS_RTOL = 2e-6
# Gradient leaves, as max |gap| relative to the leaf's largest entry.
# Transformer, heads and the encoder's last two convs: measured <= 2.5e-5
# over the three fp32 cases of this file.
GRAD_RTOL = 1e-4
# The encoder's other conv weights are ill-conditioned under these random
# weights: instance norm over a channel of tiny variance amplifies fp32
# rounding. Control: the port against itself with the CPU convolutions
# routed through another library path (`torch.backends.mkldnn` off) moves
# `layer3.0.conv1.weight` by 2.8e-2 of its largest entry, all of it in one
# output channel (2.5e-3 in relative L2 norm), and the stem by 1.6e-3. The
# gap to JAX is the same size in the same channel: 2.8e-2 (L2 2.4e-3) on
# scene 0 and 4.6e-2 (L2 3.7e-3) with only window 1 supervised; on scene 1
# it is 2.4e-4. Held to 1e-1, about twice the largest reading, and to 1e-2
# in relative L2 norm, where one noisy channel weighs less.
ENC_GRAD_RTOL = 1e-1
ENC_GRAD_L2 = 1e-2
# A conv bias in front of an instance norm has a zero gradient; both sides
# return rounding noise there (measured up to 1.6e-6), held in absolute size.
DEAD_BIAS_ATOL = 1e-5


def scene_dict(seed, earliest=0):
    """A scene with ground truth, as numpy arrays. Query start frames lie in
    [earliest, T - 2]; the first query starts at `earliest`."""
    rng = np.random.default_rng(seed)
    rgbs, depths, query, intrs, extrs = [np.array(a) for a in make_scene(rng, v=2, t=T, h=96, w=96, n=N)]
    query[:, 0] = np.clip(query[:, 0], earliest, T - 2)
    query[0, 0] = earliest
    traj = (query[None, :, 1:] + rng.normal(size=(T, N, 3)) * 0.1).astype(np.float32)
    vis = (rng.random((T, N)) > 0.3).astype(np.float32)
    valid = (rng.random((T, N)) > 0.1).astype(np.float32)
    return dict(rgbs=rgbs, depths=depths, query_points=query, intrs=intrs, extrs=extrs,
                traj_gt=traj, vis_gt=vis, valid=valid)


class Pair:
    """The port's model and the JAX model with the same weights, and the
    jitted value-and-grad of the JAX `scene_loss` (compiled once per dtype)."""

    def __init__(self, compute_dtype):
        self.model = t_mvt.MVTracker(**CFG, compute_dtype=compute_dtype, device="cpu")
        sd, self.params = carried_weights(self.model, seed=0)
        self.model.load_state_dict(sd)
        jm = JaxMVTracker(**CFG, compute_dtype=compute_dtype, corr_backend="pallas_interpret")
        self._jax = jax.jit(jax.value_and_grad(
            lambda p, sc: j_step.scene_loss(jm, p, sc, ITERS, GAMMA, VIS_WEIGHT), has_aux=True
        ))

    def jax_grads(self, scene):
        (total, parts), grads = self._jax(self.params, {k: jnp.asarray(v) for k, v in scene.items()})
        return float(total), {k: float(v) for k, v in parts.items()}, grads

    def port_grads(self, scene, model=None):
        model = model or self.model
        model.zero_grad(set_to_none=True)
        total, parts = t_step.scene_loss(model, scene, ITERS, GAMMA, VIS_WEIGHT)
        total.backward()
        grads = {name: p.grad.clone() for name, p in model.named_parameters()}
        return float(total.detach()), {k: float(v.detach()) for k, v in parts.items()}, grads


@pytest.fixture(scope="module")
def fp32():
    return Pair("float32")


@pytest.fixture(scope="module")
def fp32_case(fp32):
    """Scene 0 through both packages in fp32: queries start in both windows."""
    scene = scene_dict(0)
    return scene, fp32.jax_grads(scene), fp32.port_grads(scene)


def rel_gaps(got, want):
    """Per leaf: (max |gap| / max |want|, ||gap|| / ||want||, max |gap|)."""
    out = {}
    for name, w in want.items():
        gap = (got[name].float() - w).abs()
        out[name] = (float(gap.max() / w.abs().max().clamp_min(1e-30)),
                     float(gap.norm() / w.norm().clamp_min(1e-30)), float(gap.max()))
    return out


def is_dead_bias(name):
    return name.startswith("fnet.") and name.endswith(".bias") and name != "fnet.conv3.bias"


def is_noisy_encoder_weight(name):
    return name.startswith("fnet.") and name.endswith(".weight") and not name.startswith(("fnet.conv2", "fnet.conv3"))


def assert_fp32_grads_match(got, want_flax):
    want = params_from_flax(jax.tree.map(np.asarray, want_flax))
    assert set(want) == set(got)
    for name, (rel, l2, absolute) in rel_gaps(got, want).items():
        if is_dead_bias(name):
            assert absolute <= DEAD_BIAS_ATOL, (name, absolute)
        elif is_noisy_encoder_weight(name):
            assert rel <= ENC_GRAD_RTOL and l2 <= ENC_GRAD_L2, (name, rel, l2)
        else:
            assert rel <= GRAD_RTOL, (name, rel)
        assert float(want[name].abs().max()) > 0 or is_dead_bias(name), name  # every leaf gets gradient


# ---------------------------------------------------------------------------
# (a) the optimizer alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,total_steps", [("cos", 100), ("linear", 100), ("const", 100), ("cos", 3)])
def test_optimizer_matches_optax(schedule, total_steps):
    """Six updates from the same seeded gradients, one step with a NaN and
    an inf, norms on both sides of the clip: learning rates, parameters and
    Adam moments agree to 1e-6. total_steps=3 is the degenerate-schedule
    guard (the warm-up would truncate to 0 steps)."""
    kw = dict(lr=1e-2, weight_decay=1e-2, total_steps=total_steps, grad_clip=1.0, schedule=schedule)
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float32)}
    norms = [0.3, 5.0, 0.9, 40.0, 1.0, 0.02]
    grad_seq = []
    for i, norm in enumerate(norms):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        scale = norm / np.sqrt(sum((x**2).sum() for x in g.values()))
        g = {k: x * np.float32(scale) for k, x in g.items()}
        if i == 1:
            g["w"][0, 0], g["b"][2] = np.nan, np.inf
        grad_seq.append(g)

    j_opt = j_step.make_optimizer(**kw)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = j_opt.init(j_params)
    t_opt = t_step.make_optimizer(**kw)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = t_opt.init(t_params)
    for g in grad_seq:
        updates, j_state = j_opt.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_opt.update(t_params, {k: torch.from_numpy(v) for k, v in g.items()}, t_state)
        for k in params:
            assert np.isfinite(t_params[k].numpy()).all()
            np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]), rtol=0, atol=1e-6)
    assert float(np.abs(t_params["w"].numpy() - params["w"]).max()) > 1e-3  # the updates are visible
    adam = j_state[2][0]
    assert t_state["count"] == int(adam.count) == len(norms)
    for k in params:
        np.testing.assert_allclose(t_state["mu"][k].numpy(), np.asarray(adam.mu[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_state["nu"][k].numpy(), np.asarray(adam.nu[k]), rtol=0, atol=1e-6)

    # Learning rates, over the whole schedule and past its end.
    steps = max(total_steps, 2)
    pct = max(0.05, 1.0 / steps)
    want = {
        "cos": optax.cosine_onecycle_schedule(steps, kw["lr"], pct_start=pct),
        "linear": optax.linear_onecycle_schedule(steps, kw["lr"], pct_start=pct),
        "const": lambda count: kw["lr"],
    }[schedule]
    for count in range(steps + 3):
        lr = t_opt.learning_rate(count)
        assert np.isfinite(lr)
        np.testing.assert_allclose(lr, float(want(count)), rtol=1e-6, atol=1e-9)


def test_zero_nonfinite_and_unknown_schedule():
    g = torch.tensor([1.0, float("nan"), float("inf"), -float("inf"), -2.0])
    assert t_step.zero_nonfinite(g).tolist() == [1.0, 0.0, 0.0, 0.0, -2.0]
    with pytest.raises(ValueError):
        t_step.make_optimizer(schedule="step")


# ---------------------------------------------------------------------------
# (b) the whole step in fp32
# ---------------------------------------------------------------------------

def test_scene_loss_and_gradients_match_jax(fp32, fp32_case):
    scene, (j_total, j_parts, j_grads), (t_total, t_parts, t_grads) = fp32_case
    query_t = scene["query_points"][:, 0]
    assert query_t.min() == 0 and query_t.max() >= 6  # some tracks start in the second window
    np.testing.assert_allclose(t_total, j_total, rtol=LOSS_RTOL)
    for key in ("xyz_loss", "vis_loss"):
        assert t_parts[key] > 1e-2
        np.testing.assert_allclose(t_parts[key], j_parts[key], rtol=LOSS_RTOL)
    # reproj_dev is fp32 rounding error of the same algebra on both sides, so
    # only its size can be compared. What is held exactly is the wiring: it
    # is the guard function of `utils/geometry.py` (held against the JAX one,
    # value for value, in `test_torch_geometry.py`) on the served tracks.
    assert 0 <= t_parts["reproj_dev"] < 1e-4 and 0 <= j_parts["reproj_dev"] < 1e-4
    inputs = [torch.from_numpy(scene[k]) for k in ("rgbs", "depths", "query_points", "intrs", "extrs")]
    served = fp32.model(*inputs, iters=ITERS)["traj"]
    assert t_parts["reproj_dev"] == float(t_geo.reprojection_roundtrip_dev(served, inputs[3], inputs[4]))
    assert_fp32_grads_match(t_grads, j_grads)
    j_norm = float(optax.global_norm(j_grads))
    t_norm = float(t_step.global_norm(t_grads.values()))
    assert t_norm > 1.0  # the clip at 1.0 is engaged in a step from here
    np.testing.assert_allclose(t_norm, j_norm, rtol=1e-4)  # measured 1.4e-5


def test_earliest_query_after_frame_zero(fp32):
    """Anchor at frame 3: the port runs 1 window, the JAX module stacks its
    static 2 and masks the second out of the loss. Same loss and gradients."""
    scene = scene_dict(1, earliest=3)
    out = fp32.model(*(scene[k] for k in ("rgbs", "depths", "query_points", "intrs", "extrs")), iters=1, is_train=True)
    assert out["train_data"]["coord_predictions"].shape[0] == 1  # W = n_exec
    j_total, j_parts, j_grads = fp32.jax_grads(scene)
    t_total, t_parts, t_grads = fp32.port_grads(scene)
    np.testing.assert_allclose(t_total, j_total, rtol=LOSS_RTOL)
    for key in ("xyz_loss", "vis_loss"):
        np.testing.assert_allclose(t_parts[key], j_parts[key], rtol=LOSS_RTOL)
    assert_fp32_grads_match(t_grads, j_grads)


@pytest.mark.parametrize("remat_encoder", [False, True])
def test_remat_gives_identical_gradients(fp32, fp32_case, remat_encoder):
    scene, _, (t_total, _, t_grads) = fp32_case
    model = t_mvt.MVTracker(**CFG, remat=True, remat_encoder=remat_encoder, device="cpu")
    model.load_state_dict(fp32.model.state_dict())
    r_total, _, r_grads = fp32.port_grads(scene, model=model)
    assert r_total == t_total
    for name, g in t_grads.items():
        assert torch.equal(r_grads[name], g), name


def test_optimizer_state_at_model_scale(fp32, fp32_case):
    """One optimizer update from the whole model's gradients on both sides:
    the Adam moments (linear in the clipped gradient) agree, through
    `opt_state_from_optax`; the parameters are not compared (module note)."""
    _, (_, _, j_grads), (_, _, t_grads) = fp32_case
    j_opt = j_step.make_optimizer(total_steps=100)
    _, j_state = jax.jit(lambda g, p: j_opt.update(g, j_opt.init(p), p))(j_grads, fp32.params)
    want = opt_state_from_optax(jax.tree.map(np.asarray, j_state))
    t_opt = t_step.make_optimizer(total_steps=100)
    params = {k: v.detach().clone() for k, v in fp32.model.named_parameters()}
    state = t_opt.init(params)
    t_opt.update(params, t_grads, state)
    assert state["count"] == want["count"] == 1
    assert set(want["mu"]) == set(state["mu"]) == set(params)
    for name in params:
        if is_dead_bias(name):
            continue
        # mu = 0.1 g / norm, nu = 1e-3 (g / norm)^2: the gradient's tolerances carry over.
        tol = ENC_GRAD_RTOL if is_noisy_encoder_weight(name) else GRAD_RTOL
        mu, nu = want["mu"][name], want["nu"][name]
        assert float((state["mu"][name] - mu).abs().max()) <= tol * float(mu.abs().max()), name
        assert float((state["nu"][name] - nu).abs().max()) <= 2 * tol * float(nu.abs().max()), name
    changed = [name for name, p in fp32.model.named_parameters() if not torch.equal(params[name], p)]
    assert len(changed) == len(params)


# ---------------------------------------------------------------------------
# (c) bf16
# ---------------------------------------------------------------------------

# bf16 on both sides, the JAX model on its kernel's correlation path. Each
# side rounds at its own places (XLA fuses and may keep fp32 between ops,
# eager PyTorch rounds after every op), and the backward amplifies that as
# the forward does, so the port is held to the size of the bf16 rounding
# itself: the JAX bf16 gradients' own distance from the JAX fp32 gradients,
# the control. Readings, as relative L2 gap per leaf over all leaves but the
# dead biases, and the loss:
#   port bf16 vs JAX bf16: worst leaf 0.43, median leaf 0.175, loss 2.5e-3;
#   control, JAX bf16 vs JAX fp32: worst leaf 0.35, median leaf 0.096, loss 2.2e-3.
# Leaf by leaf the port's gap is a median 1.75 times the control (two
# independent roundings of one size would give 1.41), at most 2.7 times.
# Limits: about twice the port's readings.
BF16_LOSS_RTOL = 5e-3
BF16_L2_WORST, BF16_L2_MEDIAN = 0.9, 0.35


def test_bf16_scene_loss_and_gradients_match_jax(fp32_case):
    scene, (j32_total, _, j32_grads), _ = fp32_case
    pair = Pair("bfloat16")
    j_total, j_parts, j_grads = pair.jax_grads(scene)
    t_total, t_parts, t_grads = pair.port_grads(scene)
    np.testing.assert_allclose(t_total, j_total, rtol=BF16_LOSS_RTOL)
    for key in ("xyz_loss", "vis_loss"):
        np.testing.assert_allclose(t_parts[key], j_parts[key], rtol=BF16_LOSS_RTOL)
    want = params_from_flax(jax.tree.map(np.asarray, j_grads))
    want32 = params_from_flax(jax.tree.map(np.asarray, j32_grads))
    for g in t_grads.values():
        assert g.dtype == torch.float32 and torch.isfinite(g).all()  # parameters and their gradients stay fp32
    live = [n for n in want if not is_dead_bias(n)]
    gap = np.array([rel_gaps(t_grads, want)[n][1] for n in live])
    control = np.array([rel_gaps(want, want32)[n][1] for n in live])
    assert gap.max() <= BF16_L2_WORST and np.median(gap) <= BF16_L2_MEDIAN, (gap.max(), np.median(gap))
    # bf16 is engaged on both sides: the control gap is far above fp32 noise,
    # and the port stays within three times it, leaf by leaf.
    assert np.median(control) > 1e-2 and abs(j_total - j32_total) > 1e-4
    assert (gap <= 3 * control).all(), (gap / control).max()


# ---------------------------------------------------------------------------
# (d) where gradient flows
# ---------------------------------------------------------------------------

def _window_inputs(model, scene):
    """The arguments `forward_iteration` gets for the first window."""
    rgbs, depths, query, intrs, extrs = (torch.from_numpy(scene[k]) for k in ("rgbs", "depths", "query_points", "intrs", "extrs"))
    s = model.sliding_window_len
    fmaps = model.compute_fmaps(rgbs)
    context = model._build_context(fmaps, depths[:, :, :: model.stride, :: model.stride], intrs, extrs)
    query_t, query_xyz = query[:, 0].long(), query[:, 1:].contiguous()
    feat_init = model._feat_init(context, query_t, query_xyz)
    context_w = [(xyz[:s], fvec[:s], valid) for xyz, fvec, valid in context]  # valid: None, no depth filter
    coords_init = query_xyz[None].expand(s, N, 3)
    track_mask = (torch.arange(s)[:, None] >= query_t[None, :]).float()
    return context_w, coords_init, torch.full((s, N), 10.0), track_mask, query_t < s, feat_init


def test_coords_are_detached_between_iterations(fp32):
    """The last flow-head bias adds straight into every iteration's delta.
    With the coords detached at the top of each iteration, iteration 2's
    prediction is detach(coords) + delta_2, and delta_2 depends on the
    first three bias entries only directly (the earlier delta's coordinate
    part reaches iteration 2 through the detached coords alone). So
    d sum(pred_i[..., j]) / d bias[j] is exactly S * N for every iteration;
    without the detach it would be 2 * S * N and more for the second."""
    model = fp32.model
    args = _window_inputs(model, scene_dict(0))
    bias = model.updateformer.flow_head[-1].bias
    preds, _ = model.forward_iteration(*args, iters=2)
    s = model.sliding_window_len
    for pred in preds:
        (g,) = torch.autograd.grad(pred.sum(), bias, retain_graph=True)
        np.testing.assert_allclose(g[:3].numpy(), np.full(3, s * N, np.float32), rtol=1e-5)
    # The track-feature part of the same bias does reach iteration 2 through
    # the undetached track features.
    (g,) = torch.autograd.grad(preds[1].sum(), bias)
    assert float(g[3:].abs().max()) > 0


def test_gradient_reaches_the_previous_window(fp32):
    """Ground truth valid only on frames 6..8, which only the second window
    covers: every loss term belongs to window 1. Gradient still reaches
    window 0's last prediction and visibility logits, through the position
    embedding of the chained coords and the `vis_init` input, as in the JAX
    module, and the parameter gradients agree with JAX's."""
    model = fp32.model
    scene = scene_dict(0)
    scene["valid"] = scene["valid"].copy()
    scene["valid"][:6] = 0
    scene["valid"][6:] = 1
    recorded = []
    inner = model.forward_iteration

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        recorded.append(out)
        return out

    model.forward_iteration = recording
    try:
        model.zero_grad(set_to_none=True)
        total, _ = t_step.scene_loss(model, scene, ITERS, GAMMA, VIS_WEIGHT)
    finally:
        del model.forward_iteration
    assert len(recorded) == 2
    (preds0, vis0), (preds1, vis1) = recorded
    g_coords, g_vis = torch.autograd.grad(total, [preds0[-1], vis0], retain_graph=True)
    assert float(g_coords.abs().max()) > 0 and float(g_vis.abs().max()) > 0
    assert torch.isfinite(g_coords).all() and torch.isfinite(g_vis).all()
    # Window 0's earlier iterations feed nothing but its own loss terms, which are masked out.
    (g_first,) = torch.autograd.grad(total, [preds0[0]], retain_graph=True, allow_unused=True)
    assert g_first is None or float(g_first.abs().max()) == 0
    total.backward()
    t_grads = {name: p.grad.clone() for name, p in model.named_parameters()}
    j_total, _, j_grads = fp32.jax_grads(scene)
    np.testing.assert_allclose(float(total.detach()), j_total, rtol=LOSS_RTOL)
    assert_fp32_grads_match(t_grads, j_grads)


# ---------------------------------------------------------------------------
# the step itself
# ---------------------------------------------------------------------------

def test_scene_loss_feature_identity_branch(fp32, fp32_case):
    """With `feat_id_weight` the encoder's contrastive loss joins the total
    and the parts; without it the parts have no such entry."""
    from mvtracker_torch.training import losses as t_losses

    scene, _, (t_total, t_parts, _) = fp32_case
    assert "feat_id" not in t_parts
    with torch.no_grad():
        total, parts = t_step.scene_loss(fp32.model, scene, ITERS, GAMMA, VIS_WEIGHT, feat_id_weight=0.5)
        tensors = [torch.from_numpy(scene[k]) for k in ("rgbs", "depths", "intrs", "extrs", "traj_gt")]
        want = t_losses.feature_identity_loss(
            fp32.model.compute_fmaps(tensors[0]), *tensors[1:], stride=fp32.model.stride
        )
    assert float(parts["feat_id"]) == float(want) and float(want) > 0.1
    np.testing.assert_allclose(float(total), t_total + 0.5 * float(want), rtol=1e-6)


def test_train_step_batches_scenes_and_updates(fp32):
    model = t_mvt.MVTracker(**CFG, device="cpu")
    model.load_state_dict(fp32.model.state_dict())
    scenes = [scene_dict(0), scene_dict(2)]
    batch = {k: np.stack([sc[k] for sc in scenes]) for k in scenes[0]}
    batch["track_upscaling_factor"] = np.ones(2, np.float32)
    # Compressed transfer: uint8 frames and float16 depths are cast on the device.
    batch["rgbs"] = np.clip(np.rint(batch["rgbs"]), 0, 255).astype(np.uint8)
    batch["depths"] = batch["depths"].astype(np.float16)
    per_scene, grads = [], None
    for i in range(2):
        scene = {k: v[i] for k, v in batch.items()}
        model.zero_grad(set_to_none=True)
        total, parts = t_step.scene_loss(model, scene, ITERS, GAMMA, VIS_WEIGHT)
        total.backward()
        per_scene.append((float(total.detach()), {k: float(v.detach()) for k, v in parts.items()}))
        g = {name: p.grad / 2 for name, p in model.named_parameters()}
        grads = g if grads is None else {name: grads[name] + g[name] for name in g}
    expected = {name: p.detach().clone() for name, p in model.named_parameters()}

    optimizer = t_step.make_optimizer(total_steps=100)
    state = t_step.init_state(model, optimizer)
    train_step = t_step.make_train_step(model, optimizer, iters=ITERS, gamma=GAMMA, vis_weight=VIS_WEIGHT)
    state, metrics = train_step(state, batch)
    assert state.step == 1 and state.opt_state["count"] == 1
    assert set(metrics) == {"loss", "grad_norm", "xyz_loss", "vis_loss", "reproj_dev"}
    np.testing.assert_allclose(float(metrics["loss"]), np.mean([t for t, _ in per_scene]), rtol=1e-6)
    for key in ("xyz_loss", "vis_loss"):
        np.testing.assert_allclose(float(metrics[key]), np.mean([p[key] for _, p in per_scene]), rtol=1e-6)
    assert float(metrics["reproj_dev"]) == max(p["reproj_dev"] for _, p in per_scene)
    # grad_norm is the norm of the mean gradient, before the clip.
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(t_step.global_norm(grads.values())), rtol=1e-5)
    assert float(metrics["grad_norm"]) > 1.0
    # The parameters moved as one optimizer update from that gradient moves them.
    check = t_step.make_optimizer(total_steps=100)
    check.update(expected, grads, check.init(expected))
    for name, p in model.named_parameters():
        # lr * g / (|g| + eps) flips by a full lr where g is rounding noise: compare where it is not.
        solid = grads[name].abs() > 1e-3 * grads[name].abs().max()
        np.testing.assert_allclose(p.detach()[solid].numpy(), expected[name][solid].numpy(), rtol=0, atol=2e-6)
    assert all(p.grad is None for p in model.parameters())  # the step leaves no gradient behind
    with pytest.raises(ValueError):
        train_step(t_step.init_state(fp32.model, optimizer), batch)
