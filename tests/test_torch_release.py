"""The released checkpoint in the port: `convert.load_flax_msgpack` against
flax's own decoder, `convert.load_release`'s strictness, and the release
model's outputs and protocol rows against the JAX package's (the golden file
`mvtracker_torch/evaluation/golden/`, written by
`scripts/make_torch_release_golden.py`), at the full protocol size, fp32,
on the CPU."""

import importlib.util
import json
import os
import sys
from pathlib import Path

import flax.serialization
import flax.traverse_util
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from mvtracker_torch.cli import eval_checkpoint as t_cli
from mvtracker_torch.convert import load_flax_msgpack, load_release
from mvtracker_torch.datasets.loader import SyntheticSceneDataset
from mvtracker_torch.presets import SIZES, build_model

ROOT = Path(__file__).resolve().parent.parent
RELEASE = str(ROOT / "release" / "mvtracker_medium_synth.msgpack")
GOLDEN = ROOT / "mvtracker_torch" / "evaluation" / "golden"
KEY = "iters3_grid0_interp128"
SCENE_KW = dict(n_views=4, n_frames=12, height=128, width=128, n_tracks=32, texture_detail=1.0, texture_noise=1.0)
# The trained model amplifies rounding: most entries agree to fp32 rounding,
# a few tracks drift apart. The JAX package against itself shows it: its
# jitted forward (the golden's) against its eager one on held-out scene 0
# differs by traj median 7.7e-6, 90th percentile 6.1e-4, max 5.3e-2, and
# vis median 1.5e-3, 90th percentile 1.0e-2, max 4.0e-2. The port on the CPU
# against the golden, worst scene of 16: traj median 1.6e-5, 90th
# percentile 1.6e-3, max 1.1e-1; vis median 1.7e-3, 90th percentile
# 1.6e-2, max 7.3e-2. Limits per scene, about three times those readings,
# for scene 0 of each split, which stays on its branch under input changes
# of 1e-3 (rgb); held-out scene 77702336 forks under a 1e-6 move of the
# queries and would need looser ones (`chip_smoke.py` pools the scenes).
# (Faults show in the medians: z-test features zeroed give a vis median of
# 2.5e-2 on held-out scene 0, depths taken one frame late fail too.)
TRAJ_LIMITS = {"median": 5e-5, "p90": 5e-3, "max": 0.3}
VIS_LIMITS = {"median": 5e-3, "p90": 5e-2, "max": 0.2}


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gap_stats(got, want) -> dict:
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).ravel()
    return {"median": float(np.median(d)), "p90": float(np.quantile(d, 0.9)), "max": float(d.max())}


def assert_close_to_golden(traj, vis, want_traj, want_vis):
    for name, got, want, limits in (("traj", traj, want_traj, TRAJ_LIMITS), ("vis", vis, want_vis, VIS_LIMITS)):
        assert got.shape == want.shape, (name, got.shape, want.shape)
        stats = gap_stats(got, want)
        assert all(stats[k] <= limits[k] for k in limits), (name, stats, limits)


@pytest.fixture(scope="module")
def golden():
    arrays = dict(np.load(GOLDEN / "release_protocol.npz"))
    with open(GOLDEN / "release_protocol.json") as f:
        return arrays, json.load(f)


def _golden_scene(golden, split, seq_name):
    arrays, _ = golden
    i = list(arrays[f"{split}_seq_names"]).index(seq_name)
    return arrays[f"{split}_traj"][i], arrays[f"{split}_vis"][i]


def _load_jax_script():
    spec = importlib.util.spec_from_file_location("jax_eval_checkpoint", ROOT / "scripts" / "eval_checkpoint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# The msgpack decoder
# ---------------------------------------------------------------------------


def test_release_file_decodes_as_flax_decodes_it():
    """Leaf for leaf, bit for bit after widening flax's bf16 to fp32."""
    mine = flax.traverse_util.flatten_dict(load_flax_msgpack(RELEASE))
    with open(RELEASE, "rb") as f:
        ref = flax.traverse_util.flatten_dict(flax.serialization.msgpack_restore(f.read()))
    assert mine.keys() == ref.keys() and len(mine) == 105
    for key, leaf in ref.items():
        want = np.asarray(leaf).astype(np.float32)
        assert str(np.asarray(leaf).dtype) == "bfloat16"
        got = mine[key]
        assert got.dtype == np.float32 and got.shape == want.shape, key
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg="/".join(key))


def test_decoder_reads_every_format_flax_can_write(tmp_path):
    """Integers, floats, strings, binary data, arrays and maps at every
    length class, and ndarrays of several dtypes, against
    `flax.serialization.msgpack_restore` on the same bytes."""
    rng = np.random.default_rng(0)
    tree = {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, -1, -32, -33, -128, -129,
                 -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)],
        "floats": [0.5, -1e300, 3.25],
        "misc": [None, True, False],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é✓"],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "long_list": list(range(20)),
        "wide_map": {f"k{i}": i for i in range(20)},
        "arrays": {
            "f32": rng.normal(size=(3, 4)).astype(np.float32),
            "f64": rng.normal(size=(5,)),
            "i32": rng.integers(-1000, 1000, size=(2, 3, 2)).astype(np.int32),
            "u8": rng.integers(0, 255, size=(7,)).astype(np.uint8),
            "bool": rng.random((4,)) > 0.5,
            "bf16": np.asarray(jnp.asarray(rng.normal(size=(6, 2)), jnp.bfloat16)),
            "empty": np.zeros((0, 3), np.float32),
        },
    }
    data = flax.serialization.msgpack_serialize(tree)
    single = msgpack.packb({"f32": 1.5}, use_single_float=True)  # the 4-byte float format
    for name, blob in (("tree", data), ("single", single)):
        path = tmp_path / f"{name}.msgpack"
        path.write_bytes(blob)
        got = load_flax_msgpack(str(path))
        want = flax.serialization.msgpack_restore(blob)
        flat_got = flax.traverse_util.flatten_dict(got)
        flat_want = flax.traverse_util.flatten_dict(want)
        assert flat_got.keys() == flat_want.keys()
        for key, w in flat_want.items():
            g = flat_got[key]
            if isinstance(w, np.ndarray):
                w = w.astype(np.float32) if str(w.dtype) == "bfloat16" else w
                assert g.dtype == w.dtype and g.shape == w.shape, key
                np.testing.assert_array_equal(g, w)
            else:
                assert type(g) is type(w) and g == w, key


def test_decoder_refuses_what_a_params_file_never_holds(tmp_path):
    cases = {
        "scalar": (flax.serialization.msgpack_serialize({"x": np.float32(1.0)}), "ext type 3"),
        "chunked": (msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": {}, "chunks": {}}}), "chunked"),
        "truncated": (flax.serialization.msgpack_serialize({"x": np.ones(8, np.float32)})[:-5], "truncated"),
        "trailing": (msgpack.packb({"x": 1}) + b"\x00", "after the msgpack object"),
        "reserved": (b"\xc1", "unknown format byte"),
    }
    for name, (blob, match) in cases.items():
        path = tmp_path / f"{name}.msgpack"
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=match):
            load_flax_msgpack(str(path))


# ---------------------------------------------------------------------------
# Strict loading
# ---------------------------------------------------------------------------


def test_load_release_fills_every_parameter():
    model = load_release(RELEASE, build_model("medium", vis_geom=True, vis_head_hidden=128, device="cpu"))
    tree = load_flax_msgpack(RELEASE)["params"]
    np.testing.assert_array_equal(model.vis_hidden.weight.detach().numpy(), tree["vis_hidden"]["kernel"].T)
    np.testing.assert_array_equal(
        model.updateformer.time_blocks[3].mlp.fc2.weight.detach().numpy(),
        tree["updateformer"]["layers"]["time"]["mlp"]["fc2"]["kernel"][3].T,
    )
    assert model.fmaps_dim == SIZES["medium"]["fmaps_dim"] and model.sliding_window_len == 8


@pytest.mark.parametrize(
    "options,named",
    [
        ({}, "vis_hidden.weight"),  # the plain preset: the file's hidden layer has no place
        ({"vis_geom": True, "vis_head_hidden": 64}, "vis_hidden.bias (128,) vs the model's (64,)"),
        ({"vis_head_hidden": 128}, "vis_hidden.weight (128, 103) vs the model's (128, 96)"),
        ({"vis_geom": True}, "vis_hidden.weight"),
    ],
)
def test_load_release_refuses_a_model_of_other_options(options, named):
    model = build_model("medium", device="cpu", **options)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="strict load") as err:
        load_release(RELEASE, model)
    assert named in str(err.value)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())  # nothing was loaded


# ---------------------------------------------------------------------------
# The release model against the JAX package
# ---------------------------------------------------------------------------


def _protocol_scene(seed, index=0):
    return SyntheticSceneDataset(n_scenes=index + 1, seed=seed, randomize=True, **SCENE_KW)[index]


def _inputs(dp):
    return [np.asarray(a, np.float32) for a in (dp.video, dp.videodepth, dp.query_points_3d, dp.intrs, dp.extrs)]


def test_golden_file_is_what_jax_computes(golden):
    """Held-out scene 0 recomputed with the JAX package's predictor, as the
    JAX script runs it: the golden file is not stale."""
    from mvtracker_tpu.evaluation.predictor import EvaluationPredictor
    from mvtracker_tpu.presets import build_model as jax_build_model

    dp = _protocol_scene(777)
    with open(RELEASE, "rb") as f:
        params = flax.serialization.msgpack_restore(f.read())
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)
    model = jax_build_model("medium", vis_geom=True, vis_head_hidden=128, compute_dtype="float32")
    out = EvaluationPredictor(model, params, interp_shape=(128, 128), grid_size=0, n_iters=3)(*_inputs(dp))
    assert_close_to_golden(np.asarray(out["traj"]), np.asarray(out["vis"]), *_golden_scene(golden, "heldout", dp.seq_name))


def test_golden_rows_are_what_the_port_protocol_gives_on_them(golden):
    """The port's protocol code (threshold sweep, calibration, CopyCat,
    metrics) turns the golden outputs into exactly the JSON rows the JAX
    script printed for them, on all 16 scenes."""
    arrays, meta = golden
    want = meta["rows"]
    args = t_cli.build_parser().parse_args(meta["argv"])
    scenes = {}
    for split, seed, count in (("calib", 555, args.calib_scenes), ("heldout", 777, args.eval_scenes)):
        ds = SyntheticSceneDataset(n_scenes=count, cache=True, seed=seed, randomize=True, **SCENE_KW)
        scenes[split] = [ds[i] for i in range(count)]
        assert [dp.seq_name for dp in scenes[split]] == list(arrays[f"{split}_seq_names"])
    evaluator = t_cli.Evaluator("kubric-multiview")
    copycat, _ = evaluator.evaluate_sequence(t_cli.CopyCatPredictor(), scenes["heldout"])
    assert {k: round(v, 3) for k, v in copycat["all_any"].items() if isinstance(v, float)} == want["copycat"]
    outs = {split: {dp.seq_name: _golden_scene(golden, split, dp.seq_name) for dp in scenes[split]}
            for split in scenes}
    calib_rows = t_cli.sweep_thresholds(evaluator, outs["calib"], scenes["calib"], args.thresholds)
    assert json.loads(json.dumps(calib_rows)) == want[KEY]["calib_threshold_sweep"]
    th = max(args.thresholds, key=lambda t: calib_rows[t]["average_jaccard"])
    assert th == want[KEY]["calibrated_threshold"]
    held = t_cli.sweep_thresholds(evaluator, outs["heldout"], scenes["heldout"], [0.5, th])
    assert held[th] == want[KEY]["heldout_calibrated"] and held[0.5] == want[KEY]["heldout_at_0.5"]


@pytest.mark.parametrize("split,seed", [("heldout", 777), ("calib", 555)])
def test_release_forward_matches_jax(golden, split, seed):
    """Scene 0 of each split at the full protocol size (4 views x 12 frames
    x 128^2, 32 tracks, 3 iterations), fp32, the port's plain path."""
    dp = _protocol_scene(seed)
    model = load_release(RELEASE, build_model("medium", vis_geom=True, vis_head_hidden=128,
                                              compute_dtype="float32", device="cpu")).eval()
    out = model(*_inputs(dp), iters=3)
    assert_close_to_golden(out["traj"].numpy(), out["vis"].numpy(), *_golden_scene(golden, split, dp.seq_name))


def test_cli_gives_the_jax_scripts_json(golden, tmp_path):
    """`python -m mvtracker_torch.cli.eval_checkpoint` on 1 calibration and
    1 held-out scene, on the CPU: its outputs are the JAX package's within
    the forward's limits, and its JSON rows are exactly what the JAX script
    prints for those outputs (the JAX script run in this process with its
    model pass replaced by the port's outputs)."""
    argv = json.loads(json.dumps(golden[1]["argv"])) + ["--calib_scenes", "1", "--eval_scenes", "1"]
    port_json = tmp_path / "port.json"
    args = t_cli.build_parser().parse_args(argv + ["--device", "cpu", "--out_json", str(port_json)])
    with torch.no_grad():
        result = t_cli.run(args)
    outputs = result.outputs[KEY]
    for split in ("calib", "heldout"):
        (name, (traj, vis)), = outputs[split].items()
        assert_close_to_golden(traj, vis, *_golden_scene(golden, split, name))

    script = _load_jax_script()
    passes = iter([outputs["calib"], outputs["heldout"]])
    script.run_predictor = lambda predictor, scenes: next(passes)
    jax_json = tmp_path / "jax.json"
    cwd, saved_argv = os.getcwd(), sys.argv
    try:
        os.chdir(ROOT)
        sys.argv = ["eval_checkpoint.py", *argv, "--exp_dir", str(tmp_path / "exp"), "--out_json", str(jax_json)]
        script.main()
    finally:
        os.chdir(cwd)
        sys.argv = saved_argv
    want = json.loads(jax_json.read_text())
    assert json.loads(json.dumps(result.rows)) == want
    assert want["checkpoint_step"] == -1 and want[KEY]["calibrated_threshold"] in args.thresholds


def test_cli_refuses_what_is_not_ported(tmp_path):
    parser = t_cli.build_parser()
    (tmp_path / "checkpoints" / "5").mkdir(parents=True)  # the JAX trainer's orbax layout
    with pytest.raises(FileNotFoundError, match="orbax"):
        t_cli.run(parser.parse_args(["--exp_dir", str(tmp_path), "--step", "5", "--device", "cpu"]))
    with pytest.raises(ValueError, match="params_msgpack"):
        t_cli.run(parser.parse_args(["--device", "cpu"]))
    # The inference knobs are ported: they reach the model.
    assert t_cli.build(parser.parse_args(["--knn_reuse", "--device", "cpu"])).corr_knn_reuse


@pytest.mark.parametrize("flags, exact", [(["--fp32"], True), ([], False)])
def test_cli_sets_the_precision_its_flags_ask_for(monkeypatch, flags, exact):
    """With --fp32 the protocol runs with TF32 off for cuDNN and matmuls (the
    GPU's default would round the encoder's convolutions through TF32); in
    bf16 the process's settings stay. Either way they are restored
    afterwards."""
    seen = []
    monkeypatch.setattr(t_cli, "evaluate", lambda model, args: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
        t_cli.protocol(None, t_cli.build_parser().parse_args(flags + ["--device", "cpu"]))
        assert seen == [(False, False) if exact else (True, True)]
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
