"""The VGGT depth stage in front of the tracker on the CPU at a small size
(`models/vggt.py::aligned_depth`, `MVTracker(depth_estimator=...)`,
`forward(..., depth_source="vggt_aligned")`): the port against the plain
reference of the benchmark (`perfbench/reference/mvtracker_vggt.py`) in
fp32, the taps-only VGGT forward against its heads on every round,
the device Umeyama against the host one, the stage's profiler spans, the
tracker unchanged without the option, the config key, the demo's
`--depth_source vggt_aligned` and the checkpoint loader without the point
head. Weights are seeded by `perfbench/lib/weights.py::seeded_state`."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvtracker_torch import config as t_config
from mvtracker_torch import convert
from mvtracker_torch.cli import demo as t_demo
from mvtracker_torch.datasets.datapoint import align_umeyama
from mvtracker_torch.models import vggt as t_vggt
from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.scene import make_scene
from mvtracker_torch.utils import geometry as geo
from perfbench.lib import check, scene, weights
from tests.test_torch_observability import TINY
from tests.test_torch_tracing import counts, spans_of

ROOT = Path(__file__).resolve().parents[1]
# A DINOv2 front end of 2 blocks and 4 rounds, seen at 56x56 (4 x 4 patches).
VGGT_TINY = dict(img_size=56, patch_size=14, embed_dim=64, depth=4, num_heads=4, num_register_tokens=2,
                 camera_trunk_depth=2, dpt_features=32, dpt_out_channels=[32, 48, 64, 64], patch_embed="dinov2",
                 vit_depth=2, vit_num_heads=4)
# The flagship's layout at narrow widths, with the keys the reference reads.
WIDTHS = dict(TINY, stride=4, flow_embed_dim=64)
CONFIG = {"widths": dict(WIDTHS, depth_estimator=VGGT_TINY), "compute_dtype": "float32",
          "reference": "reference/mvtracker_vggt.py"}
# Three views, so three camera centres fix the Umeyama rotation; 64x64
# frames, which VGGT sees at 56x56.
V, T, H, W, N = 3, 3, 64, 64, 8


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded(model, seed):
    state = weights.seeded_state({k: tuple(v.shape) for k, v in model.state_dict().items()}, seed, "cpu", 0.001)
    model.load_state_dict(state)
    return state


def rig_clip(seed):
    """A rendered clip whose depth the rig does not give."""
    clip = scene.make_clip(seed, V, T, H, W, N, "cpu")
    return dict(clip, depths=torch.zeros(V, T, 0, 0))


def stage_model(seed):
    model = MVTracker(**TINY, depth_estimator=VGGT_TINY, device="cpu").eval()
    return model, seeded(model, seed)


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
def test_forward_matches_the_plain_reference(seed):
    """fp32 on both sides. The depth agrees to 1e-5 of its size: the port's
    attention is `scaled_dot_product_attention` and the reference's an
    explicit softmax, their resize weights are computed in float32 and in
    float64, and the Umeyama scale comes from Horn's quaternion on one side
    and an SVD on the other (both float64, equal to 1e-12). The tracks then
    agree as `perfbench/tests/test_perfbench_reference.py` holds the tracker
    (1e-5), no kNN tie parting the two searches at these seeds."""
    model, state = stage_model(seed)
    clip = rig_clip(seed + 1)
    ref = check.load_reference(ROOT / "perfbench", CONFIG).Ref(CONFIG["widths"], state)
    depth = model._estimate_depth(clip["rgbs"].float(), clip["extrs"], "vggt_aligned")
    want = ref.estimate_depth(clip["rgbs"], clip["extrs"])
    assert depth.shape == (V, T, H, W) and bool((want > 0).all())
    assert float(((depth - want).abs() / want).max()) < 1e-5
    args = (clip["rgbs"], clip["depths"], clip["queries"], clip["intrs"], clip["extrs"])
    with torch.no_grad():
        out = model(*args, iters=2, depth_source="vggt_aligned")
    traj, vis = ref.forward(*args, 2, depth_source="vggt_aligned")
    assert float((out["traj"] - traj).abs().max()) < 1e-5
    assert float((out["vis"] - vis).abs().max()) < 1e-5


def test_taps_only_depth_and_cameras_equal_the_full_forward():
    """Eight rounds, so that the taps (1, 3, 5, 7) leave rounds out: the
    forward, which keeps only the rounds its heads read, gives the depth and
    cameras of the heads run on every round, to the bit, and so does the
    model without the point head."""
    cfg = t_vggt.config_from_widths(dict(VGGT_TINY, depth=8))
    full = t_vggt.VGGT(cfg, device="cpu").eval()
    state = seeded(full, 3)
    stage = t_vggt.VGGT(cfg, device="cpu", point_head=False).eval()
    stage.load_state_dict({k: v for k, v in state.items() if not k.startswith("point_head.")})
    images = torch.rand(2, 3, 56, 70, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        rounds, patch_start = full.aggregator(images)
        depth, conf = full.depth_head(rounds, images, patch_start)
        extr, intr = t_vggt.pose_encoding_to_extri_intri(full.camera_head(rounds)[-1], (56, 70))
        taps, _ = full.aggregator(images, keep={1, 3, 5, 7})
        got = [full(images), stage(images)]
    assert [i for i, x in enumerate(taps) if x is not None] == [1, 3, 5, 7]
    assert "world_points" in got[0] and "world_points" not in got[1]
    for out in got:
        assert torch.equal(out["depth"], depth) and torch.equal(out["depth_conf"], conf)
        assert torch.equal(out["extrinsics"], extr) and torch.equal(out["intrinsics"], intr)


@pytest.mark.parametrize("n", [3, 4, 16])
@pytest.mark.parametrize("reflect", [False, True])
def test_device_umeyama_matches_align_umeyama(n, reflect):
    """Batched against the host SVD one on each set, with a mirrored target
    (the reflection the SVD's sign fix guards against) and spreads from
    1e-2 to 1e2."""
    rng = np.random.default_rng(n + 10 * reflect)
    src = rng.normal(size=(5, n, 3)) * np.array([1e-2, 1.0, 1.0, 1e2, 3.0])[:, None, None]
    rot = np.linalg.qr(rng.normal(size=(5, 3, 3)))[0]
    rot = rot * np.sign(np.linalg.det(rot))[:, None, None]
    if reflect:
        rot = rot @ np.diag([1.0, 1.0, -1.0])
    dst = np.einsum("bij,bnj->bni", rot, src) * rng.uniform(0.1, 10.0, (5, 1, 1)) + rng.normal(size=(5, 1, 3))
    dst = dst + rng.normal(size=dst.shape) * 0.05 * np.abs(src).mean((1, 2))[:, None, None]
    s, r, t = geo.umeyama_sim3(torch.from_numpy(src), torch.from_numpy(dst))
    assert s.dtype == torch.float64
    for b in range(5):
        ws, wr, wt = align_umeyama(dst[b], src[b])
        assert abs(float(s[b]) - ws) <= 1e-9 * ws
        np.testing.assert_allclose(r[b].numpy(), wr, atol=1e-9)
        np.testing.assert_allclose(t[b].numpy(), wt, atol=1e-9 * (1 + np.abs(wt).max()))
        assert abs(np.linalg.det(r[b].numpy()) - 1.0) < 1e-9


def test_camera_centers():
    extr = torch.tensor([[[0.0, -1.0, 0.0, 2.0], [1.0, 0.0, 0.0, -1.0], [0.0, 0.0, 1.0, 3.0]]])
    centre = geo.camera_centers(extr)
    assert torch.allclose(extr[0, :, :3] @ centre[0] + extr[0, :, 3], torch.zeros(3))


def test_depth_stage_spans_open_under_a_profiler():
    model, _ = stage_model(7)
    clip = rig_clip(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(clip["rgbs"], clip["depths"], clip["queries"], clip["intrs"], clip["extrs"], iters=1,
              depth_source="vggt_aligned")
    spans = spans_of(prof)
    assert counts(spans, parent="forward")["depth_estimator"] == 1
    assert counts(spans, parent="depth_estimator") == {"depth_align": 2, "vggt_patch_embed": 1, "vggt_rounds": 1,
                                                      "vggt_camera": 1, "vggt_depth_head": 1}
    starts = {name: s for name, s, _, _ in spans}
    assert starts["upload"] < starts["depth_estimator"] < starts["clouds"]


def test_forward_without_the_option_is_unchanged():
    """Without `depth_estimator` the state dict is the tracker's alone; with
    it, a forward without `depth_source` gives the same tracks to the bit
    and never calls the stage."""
    plain = MVTracker(**TINY, device="cpu").eval()
    state = seeded(plain, 9)
    model = MVTracker(**TINY, depth_estimator=VGGT_TINY, device="cpu").eval()
    seeded(model, 10)
    model.load_state_dict(state, strict=False)
    assert set(model.state_dict()) - set(plain.state_dict()) == {
        k for k in model.state_dict() if k.startswith("depth_estimator.")}
    assert not any(k.startswith("depth_estimator") for k in plain.state_dict())
    rgbs, depths, queries, intrs, extrs = (torch.as_tensor(a) for a in make_scene(np.random.default_rng(1), 2, 8,
                                                                                   32, 32, 6))
    model.depth_estimator.forward = None  # a call would raise
    with torch.no_grad():
        want = plain(rgbs, depths, queries, intrs, extrs, iters=2)
        got = model(rgbs, depths, queries, intrs, extrs, iters=2)
    assert torch.equal(got["traj"], want["traj"]) and torch.equal(got["vis"], want["vis"])


def test_depth_source_is_checked():
    clip = rig_clip(12)
    args = (clip["rgbs"], clip["depths"], clip["queries"], clip["intrs"], clip["extrs"])
    with pytest.raises(ValueError, match="needs a model built with depth_estimator"):
        MVTracker(**TINY, device="cpu")(*args, iters=1, depth_source="vggt_aligned")
    model, _ = stage_model(12)
    with pytest.raises(ValueError, match="depth_source must be"):
        model(*args, iters=1, depth_source="vggt_raw")
    with pytest.raises(ValueError, match="taller than wide"):
        model(clip["rgbs"].transpose(2, 3)[:, :, :, :40], clip["depths"], clip["queries"], clip["intrs"],
              clip["extrs"], iters=1, depth_source="vggt_aligned")


def test_the_reference_refuses_what_it_does_not_compute():
    ref_mod = check.load_reference(ROOT / "perfbench", CONFIG)
    with pytest.raises(ValueError, match="DINOv2 front end only"):
        ref_mod.Ref(dict(WIDTHS, depth_estimator=dict(VGGT_TINY, patch_embed="conv")), {})
    with pytest.raises(ValueError, match="no_such_width"):
        ref_mod.Ref(dict(WIDTHS, depth_estimator=dict(VGGT_TINY, no_such_width=1)), {})
    with pytest.raises(ValueError, match="corr_knn_reuse"):
        ref_mod.Ref(dict(WIDTHS, corr_knn_reuse=True, depth_estimator=VGGT_TINY), {})
    ref = ref_mod.Ref(dict(WIDTHS), {})
    with pytest.raises(ValueError, match="needs the configuration's depth_estimator"):
        ref.forward(*(torch.zeros(1),) * 5, 1, depth_source="vggt_aligned")
    with pytest.raises(ValueError, match="'vggt_aligned' only"):
        ref.forward(*(torch.zeros(1),) * 5, 1, depth_source="vggt_raw")


def test_config_key_builds_the_stage(tmp_path):
    """`model.depth_estimator` from a preset's nested mapping or from an
    override is set whole and handed to `MVTracker`."""
    small = dict(fmaps_dim=16, num_heads=2, hidden_size=32, space_depth=1, time_depth=1, num_virtual_tracks=4)
    assert t_config.ModelConfig().depth_estimator is None
    model = t_config.build_model(t_config.ModelConfig(**small, depth_estimator=VGGT_TINY), device="cpu")
    assert isinstance(model.depth_estimator, t_vggt.VGGT)
    assert model.depth_estimator.cfg.dpt_out_channels == (32, 48, 64, 64) and model.depth_estimator.point_head is None
    assert t_config.build_model(t_config.ModelConfig(**small), device="cpu").depth_estimator is None
    (tmp_path / "p.yaml").write_text("model:\n  fmaps_dim: 16\n  depth_estimator:\n    embed_dim: 64\n    depth: 4\n")
    cfg = t_config.load_config(str(tmp_path / "p.yaml"), ["model.num_heads=2"])
    assert cfg.model.depth_estimator == {"embed_dim": 64, "depth": 4} and cfg.model.fmaps_dim == 16
    cfg = t_config.load_config(None, ["model.depth_estimator={embed_dim: 64, dpt_out_channels: [8, 8, 8, 8]}"])
    assert cfg.model.depth_estimator == {"embed_dim": 64, "dpt_out_channels": [8, 8, 8, 8]}
    with pytest.raises(KeyError, match="unknown config key"):
        t_config.load_config(None, ["model.depth_estimator.embed_dim=64"])


def test_load_vggt_checkpoint_without_the_point_head(tmp_path):
    full = t_vggt.VGGT(t_vggt.config_from_widths(VGGT_TINY), device="cpu")
    state = seeded(full, 13)
    torch.save({"model": dict(state, **{"track_head.norm.weight": torch.ones(2)})}, tmp_path / "vggt.pt")
    loaded = convert.load_vggt_checkpoint(str(tmp_path / "vggt.pt"), point_head=False)
    stage = t_vggt.VGGT(t_vggt.config_from_widths(VGGT_TINY), device="cpu", point_head=False)
    assert set(loaded) == set(stage.state_dict())
    stage.load_state_dict(loaded, strict=True)
    assert set(convert.load_vggt_checkpoint(str(tmp_path / "vggt.pt"))) == set(state)


def write_rig_sample(path):
    clip = scene.make_clip(21, V, 6, 64, 128, N, "cpu")
    np.savez(path, rgbs=clip["rgbs"].numpy(), depths=clip["depths"].numpy(), intrs=clip["intrs"][:, 0].numpy(),
             extrs=clip["extrs"][:, 0].numpy(), query_points=clip["queries"].numpy())


def test_demo_tracks_on_vggt_depth(tmp_path, monkeypatch):
    """`--depth_source vggt_aligned` with a local checkpoint (seeded, saved to
    a file) builds the stage, loads it and tracks on its depth: the tracks
    part from the sensor depth's. Without the checkpoint, or with a support
    grid, it refuses. The demo builds VGGT-1B's widths; here they are the
    tiny ones, so that it runs on the CPU."""
    tiny = t_vggt.config_from_widths(VGGT_TINY)
    monkeypatch.setattr(t_vggt, "VGGTConfig", lambda: tiny)
    write_rig_sample(tmp_path / "s.npz")
    stage = t_vggt.VGGT(tiny, device="cpu")
    torch.save(seeded(stage, 17), tmp_path / "vggt.pt")
    base = ["--sample", str(tmp_path / "s.npz"), "--iters", "1", "--device", "cpu"]
    vggt = ["--depth_source", "vggt_aligned"]
    got = t_demo.main(base + vggt + ["--vggt_checkpoint", str(tmp_path / "vggt.pt"), "--out", str(tmp_path / "o.npz")])
    assert got["traj_e"].shape == (6, N, 3) and np.isfinite(got["traj_e"]).all()
    sensor = t_demo.main(base + ["--out", str(tmp_path / "gt.npz")])
    assert not np.allclose(sensor["traj_e"], got["traj_e"])
    for extra in ([], ["--vggt_checkpoint", str(tmp_path / "vggt.pt"), "--grid_size", "3"]):
        with pytest.raises(SystemExit):
            t_demo.main(base + vggt + extra + ["--out", str(tmp_path / "x.npz")])
