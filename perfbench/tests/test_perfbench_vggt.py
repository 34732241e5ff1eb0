"""The files of the cell `flagship-vggt1b.rgb-288p`: its traffic's clips
carry an empty depth and valid queries, the two depth-stage readers read a
hand-made trace and return None without the span, and the configuration's
widths build (on the meta device: VGGT-1B is 1.2e9 parameters) and are
taken by the reference."""

import json
from pathlib import Path

import pytest
import torch

from perfbench.lib import check, harness, program, traffic

ROOT = Path(__file__).resolve().parents[1]
CELL = "flagship-vggt1b.rgb-288p"
CONFIG = json.loads((ROOT / "configs" / "mvtracker-flagship-vggt1b.json").read_text())


def test_the_mix_states_its_shapes_and_its_call():
    mix = traffic.load(ROOT, "rgb-288p")
    assert (mix["views"], mix["frames"], mix["height"], mix["width"], mix["queries"]) == (4, 24, 288, 512, 512)
    assert mix["entry"] == "forward" and mix["options"] == {"iters": 4, "depth_source": "vggt_aligned"}
    assert mix["query_times"] == "first_half"


@pytest.mark.parametrize("index", [0, 1])
def test_clips_carry_no_depth_and_queries_on_the_scene(index):
    mix = dict(traffic.load(ROOT, "rgb-288p"), views=3, frames=6, height=32, width=64, queries=20)
    clip = mix["make_clip"](2**31 + 41, index, mix, "cpu")
    assert clip["depths"].shape == (3, 6, 0, 0) and clip["depths"].dtype == torch.float32
    assert clip["rgbs"].shape == (3, 6, 32, 64, 3) and clip["rgbs"].dtype == torch.uint8
    assert clip["intrs"].shape == (3, 6, 3, 3) and clip["extrs"].shape == (3, 6, 3, 4)
    q = clip["queries"]
    assert q.shape == (20, 4) and bool(torch.isfinite(q).all())
    assert sorted(q[:, 0].tolist()) == sorted(float(i % 3) for i in range(20))
    # Each query lies in front of some camera, inside its frame.
    for t, *xyz in q.tolist():
        seen = False
        for v in range(3):
            e, k = clip["extrs"][v, int(t)], clip["intrs"][v, int(t)]
            cam = e[:, :3] @ torch.tensor(xyz) + e[:, 3]
            pix = k @ cam
            seen |= bool(cam[2] > 0) and 0 <= float(pix[0] / pix[2]) <= 64 and 0 <= float(pix[1] / pix[2]) <= 32
        assert seen
    again = mix["make_clip"](2**31 + 41, index, mix, "cpu")
    assert all(torch.equal(clip[k], again[k]) for k in clip)


def _context(program_spans, flops_by_module, peaks, requests=2):
    return harness.TraceContext({}, {}, requests, [1.0], 0.0, peaks, program=program_spans,
                                flops_by_module=flops_by_module)


PEAKS = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_the_readers_on_a_hand_made_trace():
    """Two requests, 1.6 s of device time under the span: 800 ms a request;
    3.2e14 operations a request over 0.8 s against 989e12."""
    prog = {"requests": 2, "spans": {"depth_estimator": {"device_s": 1.6, "calls": 2},
                                     "forward": {"device_s": 2.0, "calls": 2}}}
    ops = {"Global": 4e14, "MVTracker.depth_estimator": 3.2e14}
    ms = harness.load_reader(ROOT, "depth_estimator_ms.serve")
    roof = harness.load_reader(ROOT, "depth_estimator_roofline.serve")
    assert ms(_context(prog, ops, PEAKS)) == pytest.approx(800.0)
    assert roof(_context(prog, ops, PEAKS)) == pytest.approx(100 * 3.2e14 / 0.8 / 989e12)


@pytest.mark.parametrize("name", ["depth_estimator_ms.serve", "depth_estimator_roofline.serve"])
def test_the_readers_give_none_without_the_stage(name):
    read = harness.load_reader(ROOT, name)
    tracker_only = {"requests": 2, "spans": {"forward": {"device_s": 2.0, "calls": 2}}}
    assert read(_context(tracker_only, {"Global": 4e14, "MVTracker.fnet": 1e14}, PEAKS)) is None
    assert read(_context(None, None, PEAKS)) is None
    assert read(harness.TraceContext({}, {}, 1, [1.0], 0.0, None)) is None


def test_the_roofline_needs_the_module_count_and_a_peak():
    prog = {"requests": 2, "spans": {"depth_estimator": {"device_s": 1.6, "calls": 2}}}
    roof = harness.load_reader(ROOT, "depth_estimator_roofline.serve")
    assert roof(_context(prog, {"Global": 4e14}, PEAKS)) is None
    assert roof(_context(prog, {"MVTracker.depth_estimator": 3.2e14}, None)) is None


def test_the_configuration_builds_at_its_widths_and_the_reference_takes_them():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG["name"])
    assert entry["reduced"] == CONFIG["reduced"] == [] and entry["file"].endswith("mvtracker-flagship-vggt1b.json")
    flagship = json.loads((ROOT / "configs" / "mvtracker-flagship.json").read_text())
    assert {k: v for k, v in CONFIG["widths"].items() if k != "depth_estimator"} == flagship["widths"]
    model = program.build_model(CONFIG, torch.device("meta"))
    shapes = program.state_shapes(model)
    stage = sum(torch.Size(s).numel() for k, s in shapes.items() if k.startswith("depth_estimator."))
    assert 1.1e9 < stage < 1.2e9  # VGGT-1B without its point and track heads
    assert not any(k.startswith("depth_estimator.point_head.") for k in shapes)
    assert shapes["depth_estimator.aggregator.frame_blocks.23.attn.qkv.weight"] == (3072, 1024)
    assert shapes["depth_estimator.aggregator.patch_embed.pos_embed"] == (1, 37 * 37 + 1, 1024)
    assert shapes["depth_estimator.camera_head.trunk.3.mlp.fc1.weight"] == (8192, 2048)
    ref = check.load_reference(ROOT, CONFIG).Ref(CONFIG["widths"], {})
    assert ref.input_size(288, 512) == (294, 518)
    assert any(w["name"] == CELL and w["config"] == CONFIG["name"] for w in bench["workloads"])
