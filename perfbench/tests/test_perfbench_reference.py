"""The plain reference against the port's CPU path at narrow widths, in
fp32. Where no kNN tie parts the two (most seeds of the forward), they agree
to rounding; the predictor's support grid sits on the ground plane's regular
lattice, where tied neighbours are ordered differently by the two searches
and the tracks part by some 1e-5 world units."""

from pathlib import Path

import pytest
import torch
from conftest import TINY_CONFIG, tiny_traffic

from perfbench.lib import check, program, scene, weights

ROOT = Path(__file__).resolve().parents[1]


def _both(entry, seed, **options):
    traffic = tiny_traffic(entry)
    traffic["options"].update(options)
    model = program.build_model(TINY_CONFIG, "cpu")
    state = weights.seeded_state(program.state_shapes(model), seed, "cpu", 0.001)
    model.load_state_dict(state)
    clip = scene.make_clip(seed + 50, 2, 12, 64, 64, 24, "cpu")
    traj, vis = program.build_call(model, traffic)(clip)
    ref = check.reference_answers(check.load_reference(ROOT, TINY_CONFIG), TINY_CONFIG, traffic, state, [clip], "cpu")
    return traj, vis, ref, clip


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_forward_matches_the_port(seed):
    traj, vis, ref, clip = _both("forward", seed)
    assert float((traj - ref[0][0]).abs().max()) < 1e-5
    assert float((vis - ref[0][1]).abs().max()) < 1e-5


def test_reference_predictor_matches_the_port():
    traj, vis, ref, clip = _both("predictor", 0)
    tracked, dt, dv = check.gaps(traj, vis, ref[0])
    assert float(dt[tracked].median()) < 1e-4 and float(dv[tracked].median()) < 1e-3 and float(dv.max()) < 0.01


def test_reference_predictor_with_a_resize_matches_the_port():
    traj, vis, ref, clip = _both("predictor", 0, interp_shape=[48, 32])
    tracked, dt, dv = check.gaps(traj, vis, ref[0])
    assert float(dt[tracked].median()) < 1e-4 and float(dv[tracked].median()) < 1e-3 and float(dv.max()) < 0.01


def test_reference_resize_matches_the_port():
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor

    from perfbench.reference.mvtracker import resize

    c = scene.make_clip(53, 2, 3, 40, 72, 8, "cpu")
    pred = EvaluationPredictor(program.build_model(TINY_CONFIG, "cpu"), interp_shape=(24, 50))
    rgbs, depths, intrs = pred._resize(c["rgbs"].float(), c["depths"], c["intrs"])
    r_rgbs, r_depths, r_intrs = resize(c["rgbs"], c["depths"], c["intrs"], (24, 50))
    assert torch.equal(rgbs, r_rgbs.float()) and torch.equal(depths, r_depths)
    assert float((intrs - r_intrs).abs().max()) < 1e-5


def test_an_option_either_side_does_not_take_is_refused():
    from perfbench.reference.mvtracker import Ref

    with pytest.raises(TypeError):
        program.build_model(dict(TINY_CONFIG, widths=dict(TINY_CONFIG["widths"], no_such_width=1)), "cpu")
    with pytest.raises(ValueError, match="corr_knn_reuse"):
        Ref(dict(TINY_CONFIG["widths"], corr_knn_reuse=True), {})
    with pytest.raises(TypeError):
        _both("predictor", 0, chunk_frames=6)


def test_reference_support_grid_matches_the_port():
    from mvtracker_torch.evaluation.predictor import build_support_grid_points

    from perfbench.reference.mvtracker import support_grid

    c = scene.make_clip(52, 3, 4, 40, 72, 8, "cpu")
    assert torch.equal(build_support_grid_points(c["depths"], c["intrs"], c["extrs"], 5, 1),
                       support_grid(c["depths"], c["intrs"], c["extrs"], 5))


def test_reference_encoder_matches_the_port():
    from mvtracker_torch.models.encoder import BasicEncoder

    from perfbench.reference.mvtracker import Ref

    torch.manual_seed(0)
    enc = BasicEncoder(output_dim=32, stride=4)
    state = {"fnet." + k: v for k, v in enc.state_dict().items()}
    x = torch.rand(3, 2, 40, 56, 3) * 255
    ref = Ref({"stride": 4}, state, frame_block=4).encode(x)
    with torch.no_grad():
        got = enc((x.reshape(6, 40, 56, 3) / 255.0 * 2 - 1).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert float((ref.reshape(got.shape) - got).abs().max()) < 1e-4
