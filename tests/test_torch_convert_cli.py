"""The port's checkpoint conversion against the JAX package's, without
tolerance: the msgpack encoder (`convert.flax_msgpack_bytes`) against
`flax.serialization`, `convert_reference_state_dict` and
`convert_vggt_state_dict` against the JAX functions of those names,
`cli.convert` against `mvtracker_tpu.cli.convert` byte for byte, and
`scripts/export_params_msgpack_torch.py` against flax's bytes for the same
weights."""

import contextlib
import io
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch import convert
from mvtracker_torch.cli import convert as t_cli
from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.models.vggt import VGGT, tiny_config
from mvtracker_torch.training import step as step_lib
from mvtracker_torch.training.train import TrainConfig, Trainer
from mvtracker_tpu import convert as j_convert
from mvtracker_tpu.cli import convert as j_cli

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(sliding_window_len=4, fmaps_dim=16, num_heads=2, hidden_size=32, space_depth=2, time_depth=2,
             num_virtual_tracks=4, corr_n_levels=2, corr_neighbors=4)


def seeded_state_dict(model, seed=0):
    """Seeded weights with random biases and norms too (flax's init leaves
    them at zero and one, which would hide a mix-up of the two)."""
    sd = convert.random_state_dict(model, seed)
    rng = np.random.default_rng(seed + 1)
    return {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
            if k.endswith(".bias") or "norm" in k else v for k, v in sd.items()}


def leaves(tree, path=""):
    """(path, leaf) in the tree's order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, f"{path}/{key}")
        else:
            yield f"{path}/{key}", value


def assert_same_tree(got, want):
    """The same keys in the same order, bit-equal leaves of the same dtype."""
    got, want = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("options", [{}, {"vis_head_hidden": 8, "space_depth": 1, "time_depth": 1}])
def test_convert_reference_state_dict_matches_jax(options):
    model = MVTracker(**{**SMALL, **options}, device="cpu")
    sd = seeded_state_dict(model)
    got = convert.convert_reference_state_dict(sd)
    want = j_convert.convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})
    if "vis_head_hidden" in options:  # the JAX converter (the reference's layout) has no hidden visibility layer
        assert set(got["params"]) - set(want["params"]) == {"vis_hidden"}
        got["params"].pop("vis_hidden")
    assert_same_tree(got, want)


@pytest.mark.parametrize("options", [
    {}, {"vis_head_hidden": 8, "vis_geom_features": True}, {"use_point_transformer": True},
    {"support_memory_tokens": 4}, {"corr_neighbors_per_level": (6, 4)},
])
def test_convert_inverts_params_from_flax(options):
    """Every parameter of every option survives the round trip, bit for bit."""
    model = MVTracker(**{**SMALL, **options}, device="cpu")
    sd = seeded_state_dict(model)
    back = convert.params_from_flax(convert.convert_reference_state_dict(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_unequal_depths_are_refused():
    model = MVTracker(**{**SMALL, "space_depth": 1}, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        convert.convert_reference_state_dict(model.state_dict())


@pytest.mark.parametrize("embed", ["conv", "dinov2"])
def test_convert_vggt_state_dict_matches_jax(embed):
    """The facebook/VGGT-1B layout (DINOv2 blocks chunked, a track head and
    the mask token the JAX converter does not read) from a small port VGGT."""
    sd = convert.random_state_dict(VGGT(tiny_config(patch_embed=embed), device="cpu"), seed=2)
    ref = {k.replace("patch_embed.blocks.", "patch_embed.blocks.0."): v for k, v in sd.items()}
    ref["aggregator.patch_embed.mask_token"] = torch.zeros(1, 8)
    ref["track_head.feature_extractor.norm.weight"] = torch.ones(3)
    got = convert.convert_vggt_state_dict(ref)
    assert_same_tree(got, j_convert.convert_vggt_state_dict({k: v.numpy() for k, v in ref.items()}))
    back = convert.vggt_params_from_flax(got)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def encoder_trees():
    """(port tree, the same tree as flax writes it) pairs."""
    rng = np.random.default_rng(3)
    x32 = rng.normal(size=(3, 5)).astype(np.float32)
    yield {"w": x32, "b": rng.normal(size=(7,)).astype(np.float32)}, None
    bf = torch.from_numpy(rng.normal(size=(4, 33)).astype(np.float32)).to(torch.bfloat16)
    yield {"layer": {"kernel": bf, "bias": bf[0]}}, {"layer": {
        "kernel": jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16), "bias": jnp.asarray(bf[0].float().numpy())
        .astype(jnp.bfloat16)}}
    f16 = rng.normal(size=(2, 3, 4)).astype(np.float16)
    yield {"half": torch.from_numpy(f16), "np_half": f16}, {"half": f16, "np_half": f16}
    ints = {"i32": np.arange(-70000, 70000, 7, dtype=np.int32), "u8": np.arange(256, dtype=np.uint8),
            "i64": np.array([-2**40, 2**40]), "t_i64": torch.tensor([3, -200]), "scalar": np.float32(2.5),
            "count": 7, "neg": -100, "big": 70000, "huge": 2**40, "bool": True, "none": None, "pi": 3.25}
    yield ints, {**ints, "t_i64": np.array([3, -200])}
    nested = {"": {}, "z": {"a": {}, "y": {"b": x32}}, "k" * 40: x32[0], "key" * 100: x32[:, 0],
              "many": {f"k{i:02d}": np.float32(i) * x32[:1] for i in range(20)}}
    yield nested, None
    yield {"big": np.zeros(70000, np.float32), "empty": np.zeros((0, 3), np.float32)}, None


@pytest.mark.parametrize("case", range(6))
def test_encoder_matches_flax(case):
    tree, flax_tree = list(encoder_trees())[case]
    flax_tree = tree if flax_tree is None else flax_tree
    assert convert.flax_msgpack_bytes(tree) == flax.serialization.msgpack_serialize(flax_tree)
    if not any(isinstance(v, (int, float, bool, type(None))) for _, v in leaves(tree)):
        # to_bytes keeps each dict's insertion order (its scalars would go
        # through numpy there).
        assert convert.flax_msgpack_bytes(tree, sort_keys=False) == flax.serialization.to_bytes(flax_tree)


def test_encoder_round_trips_through_the_decoder(tmp_path):
    tree = {"params": {"b": {"k": np.arange(6, dtype=np.float32).reshape(2, 3)},
                       "a": torch.tensor([1.5, -2.25]).to(torch.bfloat16)}}
    n = convert.save_flax_msgpack(tree, str(tmp_path / "t.msgpack"))
    assert n == (tmp_path / "t.msgpack").stat().st_size
    back = convert.load_flax_msgpack(str(tmp_path / "t.msgpack"))
    np.testing.assert_array_equal(back["params"]["b"]["k"], tree["params"]["b"]["k"])
    np.testing.assert_array_equal(back["params"]["a"], np.array([1.5, -2.25], np.float32))


def test_encoder_refuses_chunked_leaves(tmp_path):
    """A leaf over 1 GiB (flax would split it into chunks, which the port's
    reader refuses) raises naming it, and nothing is written. The leaf is a
    zero-stride view: it claims the bytes without holding them."""
    stub = np.broadcast_to(np.zeros(1, np.uint8), (convert.MAX_LEAF_BYTES + 1,))
    with pytest.raises(ValueError, match="/params/huge"):
        convert.flax_msgpack_bytes({"params": {"ok": np.zeros(2, np.float32), "huge": stub}})
    tstub = torch.zeros(1, dtype=torch.float16).expand(convert.MAX_LEAF_BYTES // 2 + 1)
    with pytest.raises(ValueError, match="/t"):
        convert.save_flax_msgpack({"t": tstub}, str(tmp_path / "x.msgpack"))
    assert not (tmp_path / "x.msgpack").exists()
    at_limit = np.broadcast_to(np.zeros(1, np.uint8), (16,))
    assert convert.flax_msgpack_bytes({"a": at_limit}) == flax.serialization.msgpack_serialize({"a": at_limit})


@pytest.mark.parametrize("nested", [False, True])
def test_convert_cli_matches_jax(tmp_path, nested):
    """The same `.pth`, flat or a training checkpoint under "model": the two
    CLIs write the same bytes and print the same line."""
    sd = seeded_state_dict(MVTracker(**SMALL, device="cpu"))
    torch.save({"model": sd, "step": 5} if nested else sd, tmp_path / "ref.pth")
    printed = {}
    for name, cli in (("t", t_cli), ("j", j_cli)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main([str(tmp_path / "ref.pth"), str(tmp_path / "out.msgpack")])
        printed[name] = out.getvalue().replace("out.msgpack", "")
        (tmp_path / "out.msgpack").rename(tmp_path / f"{name}.msgpack")
    assert printed["t"] == printed["j"] and printed["t"].startswith("converted 1,")
    assert (tmp_path / "t.msgpack").read_bytes() == (tmp_path / "j.msgpack").read_bytes()
    model = MVTracker(**SMALL, device="cpu")
    convert.load_release(str(tmp_path / "t.msgpack"), model)
    assert all(torch.equal(model.state_dict()[k], sd[k]) for k in sd)


def export_script():
    if str(ROOT / "scripts") not in sys.path:
        sys.path.insert(0, str(ROOT / "scripts"))
    import export_params_msgpack_torch

    return export_params_msgpack_torch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_export_matches_flax(tmp_path, dtype):
    """A port experiment's newest checkpoint exported: flax's bytes for the
    same weights cast as JAX's export casts them; `Trainer.warm_start` reads
    it back strictly, every leaf its cast value widened."""
    from mvtracker_torch.presets import build_model

    model = build_model("small", device="cpu")
    sd = seeded_state_dict(model)
    model.load_state_dict(sd)
    trainer = Trainer(model, TrainConfig(exp_dir=str(tmp_path / "exp"), tensorboard=False, watchdog_timeout_s=0))
    trainer.save(step_lib.init_state(model, trainer.optimizer), 1)
    trainer.save(step_lib.init_state(model, trainer.optimizer), 3)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        export_script().main(["--exp_dir", str(tmp_path / "exp"), "--model_size", "small", "--out",
                              str(tmp_path / "w.msgpack"), "--dtype", dtype, "--device", "cpu"])
    assert out.getvalue() == f"exported step-3 params ({dtype}) -> {tmp_path / 'w.msgpack'}\n"
    cast = {"float32": np.float32, "bfloat16": jnp.bfloat16, "float16": np.float16}[dtype]
    flax_tree = jax.tree.map(lambda x: np.asarray(x).astype(cast),
                             j_convert.convert_reference_state_dict({k: v.numpy() for k, v in sd.items()}))
    assert (tmp_path / "w.msgpack").read_bytes() == flax.serialization.msgpack_serialize(flax_tree)
    fresh = build_model("small", device="cpu")
    warm = Trainer(fresh, TrainConfig(exp_dir=str(tmp_path / "warm"), tensorboard=False, watchdog_timeout_s=0))
    warm.warm_start(step_lib.init_state(fresh, warm.optimizer), str(tmp_path / "w.msgpack"), strict=True)
    for k, v in sd.items():
        want = v.to(getattr(torch, dtype)).float() if dtype != "float32" else v
        assert torch.equal(fresh.state_dict()[k], want), k
