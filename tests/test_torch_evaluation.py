"""Port parity: the evaluation modules of `mvtracker_torch` against the JAX
package's on the same arrays and scenes (CPU): the metrics copy, the
`Evaluator` (3D and per-view 2D metrics, sharding, CSV and JSON) on
CopyCat and on cached predictions."""

import json

import numpy as np
import pytest
import torch

from mvtracker_torch.datasets.loader import SyntheticSceneDataset as TorchScenes
from mvtracker_torch.evaluation import cached as t_cached
from mvtracker_torch.evaluation import evaluator as t_eval
from mvtracker_torch.evaluation import metrics as t_metrics
from mvtracker_torch.models import copycat as t_copycat
from mvtracker_tpu.datasets.loader import SyntheticSceneDataset as JaxScenes
from mvtracker_tpu.evaluation import cached as j_cached
from mvtracker_tpu.evaluation import evaluator as j_eval
from mvtracker_tpu.evaluation import metrics as j_metrics
from mvtracker_tpu.models import copycat as j_copycat

SCENE_KW = dict(n_views=2, n_frames=8, height=32, width=32, n_tracks=12, texture_detail=1.0, texture_noise=1.0)


def _case(rng, b=1, t=12, n=24, d=3):
    """Tracks, occlusions and queries with at least two visible frames from
    each query on."""
    gt_tracks = rng.normal(size=(b, t, n, d)).astype(np.float32)
    pred_tracks = (gt_tracks + rng.normal(size=(b, t, n, d)) * 0.1).astype(np.float32)
    gt_occ = rng.uniform(size=(b, t, n)) < 0.3
    pred_occ = rng.uniform(size=(b, t, n)) < 0.3
    qt = rng.integers(0, t // 2, size=(b, n))
    for bi in range(b):
        for p in range(n):
            gt_occ[bi, qt[bi, p] : qt[bi, p] + 2, p] = False
    qcoords = np.take_along_axis(gt_tracks, qt[:, None, :, None].repeat(d, -1), axis=1)[:, 0]
    query = np.concatenate([qt[..., None], qcoords], axis=-1).astype(np.float32)
    return query, gt_occ, gt_tracks, pred_occ, pred_tracks


# The per-view 2D metrics project the predictions with each package's own
# geometry (einsums summed in other orders): pixel errors differ in the last
# float32 digits (measured 7.9e-8 relative).
PIXEL_RTOL = 1e-6


def _assert_same(got, want, rtol=0.0):
    """Equal dicts, arrays compared exactly (NaN equal to NaN) unless
    `rtol` is given; groups named `view*_2d` get PIXEL_RTOL."""
    assert isinstance(got, dict) and got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _assert_same(got[key], want[key], PIXEL_RTOL if str(key).endswith("_2d") else rtol)
        elif rtol:
            np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=rtol, err_msg=str(key))
        else:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=str(key))


@pytest.mark.parametrize("query_mode", ["first", "strided"])
def test_metrics_copy_gives_jax_dicts(rng, query_mode):
    case = _case(rng, b=2)
    thresholds = [0.05, 0.1, 0.2, 0.4, 0.8]
    for name in ("compute_tapvid_metrics", "compute_metrics"):
        kw = dict(distance_thresholds=thresholds, query_mode=query_mode)
        if name == "compute_metrics":
            kw["survival_distance_threshold"] = 0.5
        _assert_same(getattr(t_metrics, name)(*case, **kw), getattr(j_metrics, name)(*case, **kw))
    # The original TAP-Vid layout: [b, n, t], (t, y, x) queries, pixel units.
    q, go, gt, po, pt = _case(rng, b=2, d=2)
    orig = (q, go.transpose(0, 2, 1), gt.transpose(0, 2, 1, 3) * 10, po.transpose(0, 2, 1), pt.transpose(0, 2, 1, 3) * 10)
    _assert_same(
        t_metrics.compute_tapvid_metrics_original(*orig, query_mode=query_mode),
        j_metrics.compute_tapvid_metrics_original(*orig, query_mode=query_mode),
    )
    # The stratified 3D aggregation, with static tracks so every group fills.
    query, gt_occ, gt_tracks, pred_occ, pred_tracks = _case(rng, t=16, n=32)
    gt_tracks[:, :, :8] = gt_tracks[:, 0:1, :8]
    args = (gt_tracks[0], ~gt_occ[0], pred_tracks[0], pred_occ[0])
    got = t_metrics.evaluate_predictions(*args, query_points=query[0], query_mode=query_mode)
    want = j_metrics.evaluate_predictions(*args, query_points=query[0], query_mode=query_mode)
    _assert_same(got[0], want[0])
    _assert_same(got[1], want[1])


@pytest.fixture(scope="module")
def scenes():
    """Two synthetic scenes, rendered by each package's own copy of the
    renderer (they must agree exactly)."""
    port = TorchScenes(n_scenes=2, seed=5, randomize=True, **SCENE_KW)
    jax_ds = JaxScenes(n_scenes=2, seed=5, randomize=True, **SCENE_KW)
    port, jax_ds = [port[i] for i in range(2)], [jax_ds[i] for i in range(2)]
    for a, b in zip(port, jax_ds):
        for name in ("video", "videodepth", "intrs", "extrs", "trajectory", "trajectory_3d", "visibility", "query_points_3d"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    return port, jax_ds


def _strip_fps(summary, per_seq):
    summary = {k: v for k, v in summary.items() if k != "fps"}
    return summary, [{k: v for k, v in r.items() if k != "fps"} for r in per_seq]


@pytest.mark.parametrize("compute_2d", [False, True])
def test_evaluator_on_copycat_gives_jax_summary(scenes, compute_2d):
    port, jax_ds = scenes
    got = t_eval.Evaluator("kubric-multiview", compute_2d_metrics=compute_2d).evaluate_sequence(
        t_copycat.CopyCatPredictor(), port
    )
    want = j_eval.Evaluator("kubric-multiview", compute_2d_metrics=compute_2d).evaluate_sequence(
        j_copycat.CopyCatPredictor(), jax_ds
    )
    got, want = _strip_fps(*got), _strip_fps(*want)
    _assert_same(got[0], want[0])
    assert len(got[1]) == len(want[1]) == 2
    for a, b in zip(got[1], want[1]):
        _assert_same(a, b)
    if compute_2d:
        assert "view1_2d" in got[0]


def test_evaluator_shards_cached_predictions_and_writes_files(scenes, tmp_path):
    """Cached predictions (`<seq>_tracks.npz`) through both evaluators, one
    shard each of two; the shards' merged summary is the whole one; CSV and
    JSON written."""
    port, jax_ds = scenes
    rng = np.random.default_rng(0)
    for dp in port:
        t, n = dp.trajectory_3d.shape[:2]
        np.savez(tmp_path / f"{dp.seq_name}_tracks.npz",
                 traj=dp.trajectory_3d + rng.normal(size=(t, n, 3)).astype(np.float32) * 0.05,
                 vis=rng.random((t, n)).astype(np.float32))
    evaluator = t_eval.Evaluator()
    whole = _strip_fps(*evaluator.evaluate_sequence(t_cached.CachedPredictionPredictor(str(tmp_path)), port))
    want = _strip_fps(*j_eval.Evaluator().evaluate_sequence(j_cached.CachedPredictionPredictor(str(tmp_path)), jax_ds))
    _assert_same(whole[0], want[0])
    shards = [evaluator.evaluate_sequence(t_cached.CachedPredictionPredictor(str(tmp_path)), port, shard=(i, 2))[1]
              for i in range(2)]
    assert [len(s) for s in shards] == [1, 1]
    merged = _strip_fps(t_eval.Evaluator.summarize(shards[0] + shards[1]), [])[0]
    _assert_same(merged, whole[0])
    per_seq = shards[0] + shards[1]
    t_eval.Evaluator.save_json(t_eval.Evaluator.summarize(per_seq), str(tmp_path / "summary.json"))
    t_eval.Evaluator.save_csv(per_seq, str(tmp_path / "per_seq.csv"))
    assert json.loads((tmp_path / "summary.json").read_text())["n_sequences"] == 2
    lines = (tmp_path / "per_seq.csv").read_text().splitlines()
    assert len(lines) == 3 and "all_any/average_jaccard" in lines[0]


def test_evaluator_times_after_an_untimed_first_call(scenes):
    """The first datapoint of a shape runs once untimed, then once timed."""
    calls = []

    class Counting(t_copycat.CopyCatPredictor):
        def __call__(self, *args, **kwargs):
            calls.append(args[0].shape)
            return super().__call__(*args, **kwargs)

    summary, per_seq = t_eval.Evaluator().evaluate_sequence(Counting(), scenes[0])
    assert len(calls) == 3  # untimed + timed for the first scene, timed for the second
    assert all(r["fps"] > 0 for r in per_seq) and summary["n_sequences"] == 2


def test_evaluator_and_copycat_refuse_and_keep_devices(scenes, tmp_path):
    """`viz_dir` writes the JAX evaluator's overlays (the sequences of
    `viz_indices`), and CopyCat keeps its outputs on the input's device."""
    for name, ev in (("t", t_eval), ("j", j_eval)):
        evaluator = ev.Evaluator(viz_dir=str(tmp_path / name), viz_indices=[1])
        evaluator.evaluate_sequence(t_copycat.CopyCat() if name == "t" else j_copycat.CopyCat(), scenes[0])
    written = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert written == sorted(p.name for p in (tmp_path / "j").iterdir()) and len(written) == 1
    assert (tmp_path / "t" / written[0]).read_bytes() == (tmp_path / "j" / written[0]).read_bytes()
    dp = scenes[0][0]
    out = t_copycat.CopyCatPredictor()(dp.video, dp.videodepth, torch.from_numpy(dp.query_points_3d), dp.intrs, dp.extrs)
    assert out["traj"].device.type == "cpu" and out["vis"].dtype == torch.float32
    np.testing.assert_array_equal(out["traj"][3].numpy(), dp.query_points_3d[:, 1:])
    host = t_copycat.CopyCat()(dp.video, dp.videodepth, dp.query_points_3d, dp.intrs, dp.extrs)
    assert isinstance(host["traj"], np.ndarray) and not host["occluded"].any()
