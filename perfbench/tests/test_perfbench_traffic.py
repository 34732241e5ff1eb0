"""The traffic generator and the seeded weights: determined by the seed."""

import json
from pathlib import Path

import pytest
import torch

from perfbench.lib import harness, scene, traffic, weights


def test_clip_is_deterministic_for_a_seed_and_differs_across_seeds():
    a = scene.make_clip(2**31 + 7, 2, 6, 32, 48, 16, "cpu")
    b = scene.make_clip(2**31 + 7, 2, 6, 32, 48, 16, "cpu")
    c = scene.make_clip(2**31 + 8, 2, 6, 32, 48, 16, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["rgbs"], c["rgbs"])
    assert not torch.equal(a["queries"], c["queries"])


def test_clip_layout_and_same_query_times_for_every_seed():
    clips = [scene.make_clip(s, 3, 5, 24, 40, 12, "cpu") for s in (1, 99)]
    for c in clips:
        assert c["rgbs"].shape == (3, 5, 24, 40, 3) and c["rgbs"].dtype == torch.uint8
        assert c["depths"].shape == (3, 5, 24, 40) and c["depths"].dtype == torch.float32
        assert c["intrs"].shape == (3, 5, 3, 3) and c["extrs"].shape == (3, 5, 3, 4)
        assert c["queries"].shape == (12, 4)
        assert bool((c["depths"] >= 0).all()) and bool((c["depths"] > 0).any())
    times = [sorted(c["queries"][:, 0].tolist()) for c in clips]
    assert times[0] == times[1] == sorted([float(i % 2) for i in range(12)])


@pytest.mark.parametrize("rule, period", [("first_half", 3), ("first", 1)])
def test_query_time_rules(rule, period):
    c = scene.make_clip(11, 2, 6, 24, 32, 12, "cpu", query_times=rule)
    assert sorted(c["queries"][:, 0].tolist()) == sorted(float(i % period) for i in range(12))


def test_json_mix_shapes_may_change_from_clip_to_clip():
    mix = {"views": 2, "frames": [4, 6], "height": 24, "width": [32, 40], "queries": [8, 16], "query_times": "first"}
    a, b, c = (scene.generate(21, i, mix, "cpu") for i in range(3))
    assert a["rgbs"].shape == (2, 4, 24, 32, 3) and a["queries"].shape == (8, 4)
    assert b["rgbs"].shape == (2, 6, 24, 40, 3) and b["queries"].shape == (16, 4)
    assert c["rgbs"].shape == a["rgbs"].shape
    assert [harness.point_frames(x) for x in (a, b)] == [32, 96]


def test_traffic_found_by_name_as_json_or_as_python(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "a.json").write_text(json.dumps({"entry": "forward", "pool": 1}))
    (tmp_path / "traffic" / "b.py").write_text(
        "TRAFFIC = {'entry': 'predictor', 'pool': 2}\n"
        "def make_clip(seed, index, traffic, device):\n"
        "    return {'seed': seed, 'index': index}\n")
    a = traffic.load(tmp_path, "a")
    b = traffic.load(tmp_path, "b")
    assert a["entry"] == "forward" and a["make_clip"] is scene.generate
    assert b["entry"] == "predictor" and b["make_clip"](5, 1, b, "cpu") == {"seed": 5, "index": 1}
    with pytest.raises(FileNotFoundError):
        traffic.load(tmp_path, "c")


def test_every_mix_of_the_benchmark_makes_a_clip_of_its_own_layout():
    root = Path(__file__).resolve().parents[1]
    for path in sorted((root / "traffic").glob("*.json")):
        mix = traffic.load(root, path.stem)
        small = dict(mix, height=32, width=48, frames=4)
        c = mix["make_clip"](2**31 + 3, 0, small, "cpu")
        assert c["rgbs"].shape[:4] == (mix["views"], 4, 32, 48) and c["queries"].shape == (mix["queries"], 4)


def test_queries_lie_on_the_rendered_surface():
    """A query projects into some view at its frame onto a pixel whose depth
    is the query's camera depth (to the in-pixel jitter)."""
    c = scene.make_clip(5, 2, 4, 48, 64, 20, "cpu")
    for q in c["queries"]:
        t, xyz = int(q[0]), q[1:]
        best = float("inf")
        for v in range(2):
            e, k = c["extrs"][v, t], c["intrs"][v, t]
            cam = e[:, :3] @ xyz + e[:, 3]
            pix = k @ cam
            x, y = pix[0] / pix[2] - 0.5, pix[1] / pix[2] - 0.5
            xi, yi = int(torch.round(x)), int(torch.round(y))
            if 0 <= xi < 64 and 0 <= yi < 48 and c["depths"][v, t, yi, xi] > 0:
                best = min(best, abs(float(c["depths"][v, t, yi, xi] - cam[2])))
        assert best < 1e-4


def test_seeded_state_rules_and_determinism():
    shapes = {"fnet.conv1.weight": (64, 3, 7, 7), "fnet.conv1.bias": (64,), "ffeats_norm.weight": (8,),
              "updateformer.virual_tracks": (1, 4, 1, 16), "updateformer.flow_head.4.weight": (20, 30),
              "updateformer.input_transform.weight": (16, 100)}
    a = weights.seeded_state(shapes, 2**33 + 1, "cpu", flow_head_gain=0.001)
    b = weights.seeded_state(shapes, 2**33 + 1, "cpu", flow_head_gain=0.001)
    c = weights.seeded_state(shapes, 2**33 + 2, "cpu", flow_head_gain=0.001)
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["fnet.conv1.weight"], c["fnet.conv1.weight"])
    assert bool((a["fnet.conv1.bias"] == 0).all()) and bool((a["ffeats_norm.weight"] == 1).all())
    assert abs(float(a["fnet.conv1.weight"].std()) - 1 / (3 * 49) ** 0.5) < 0.01
    assert abs(float(a["updateformer.input_transform.weight"].std()) - 0.1) < 0.01
    assert float(a["updateformer.flow_head.4.weight"].std()) < 0.001 / 30**0.5 * 1.3
    assert abs(float(a["updateformer.virual_tracks"].std()) - 1.0) < 0.5
