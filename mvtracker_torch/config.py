"""Config system (L8), counterpart of `mvtracker_tpu/config.py`: typed
dataclasses, YAML presets (`configs/*.yaml`) and `key.subkey=value`
overrides. A copy of the JAX module's dataclasses, loading and overrides;
the trainer section is the port's `TrainConfig`.

What the port does with the settings:
- `build_model` builds `mvtracker` (the port's `MVTracker`) and `copycat`.
  The other families raise `NotImplementedError` naming their `ROADMAP.md`
  item. `transformer_scan_unroll` is accepted at any value and ignored: the
  port runs the update transformer's layers as separate modules, with no
  scan to unroll. `corr_backend` picks among the JAX package's correlation
  implementations; the port has one (the CUDA kernel on the card, its plain
  version on the CPU), so only "auto" is accepted.
- `build_dataset` builds `synthetic`; `kubric`, `droid` and the
  `-multiview` names raise `NotImplementedError` (the real datasets,
  ROADMAP item 4).
- The trainer's TensorBoard, W&B, profiler and watchdog settings are off
  in the port by default and raise when turned on (ROADMAP item 5); the
  JAX package turns `tensorboard` and the watchdog (`watchdog_timeout_s`
  600) on by default.
- `mesh_data`, `mesh_model` and `shard_views` ask for a device mesh, which
  waits for ROADMAP item 6; the CLIs raise when one asks for more than one
  device.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Optional

import yaml

from mvtracker_torch.training.train import TrainConfig


@dataclasses.dataclass
class ModelConfig:
    """The model group: family name and `MVTracker` settings (the JAX
    package's names and defaults)."""

    name: str = "mvtracker"
    sliding_window_len: int = 12
    stride: int = 4
    fmaps_dim: int = 128
    add_space_attn: bool = True
    num_heads: int = 6
    hidden_size: int = 384
    space_depth: int = 6
    time_depth: int = 6
    num_virtual_tracks: int = 64
    corr_n_groups: int = 1
    corr_n_levels: int = 4
    corr_neighbors: int = 16
    corr_add_neighbor_offset: bool = True
    corr_add_neighbor_xyz: bool = False
    flow_embed_dim: int = 64
    knn_backend: str = "auto"
    compute_dtype: str = "float32"
    corr_filter_invalid_depth: bool = False
    corr_knn_reuse: bool = False
    corr_backend: str = "auto"
    vis_geom_features: bool = False
    vis_head_hidden: int = 0
    transformer_scan_unroll: int = 2  # ignored by the port
    # None keeps the family's own default (0 for MVTracker).
    support_memory_tokens: Optional[int] = None
    use_point_transformer: bool = False
    point_transformer_depth: int = 2
    normalize_scene_in_fwd_pass: bool = False
    remat: bool = False
    # Other families' settings (the learned 2D tracker, the triplane
    # SpaTracker), kept so their presets load.
    checkpoint_2d: str = ""
    triplane_res: int = 64
    corr_patch_radius: int = 3


@dataclasses.dataclass
class DataConfig:
    dataset: str = "synthetic"  # synthetic | kubric | droid | <name>-multiview...
    root: str = ""
    batch_size: int = 1
    num_workers: int = 4
    num_tracks: int = 256
    n_views: int = 4
    n_frames: int = 24
    height: int = 256
    width: int = 256
    view_subset: Optional[list] = None
    seed: int = 0


@dataclasses.dataclass
class EvalConfig:
    setting: str = "kubric-multiview"
    interp_shape: Optional[list] = None
    grid_size: int = 5
    n_grids_per_view: int = 1
    num_uniformly_sampled_pts: int = 0
    n_iters: int = 6
    visibility_threshold: float = 0.5
    max_sequences: Optional[int] = None


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    trainer: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mesh_data: Optional[int] = None  # None = all devices on the data axis
    mesh_model: int = 1
    shard_views: bool = False


def _apply(obj: Any, key: str, value: Any):
    parts = key.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"unknown config key: {key}")
    current = getattr(obj, leaf)
    if isinstance(current, bool):
        value = str(value).lower() in ("1", "true", "yes")
    elif isinstance(current, int) and not isinstance(value, bool):
        value = int(value)
    elif isinstance(current, float):
        value = float(value)
    elif current is None and isinstance(value, str):
        value = yaml.safe_load(value)  # Optional fields: the literal's type ("50" -> 50)
    setattr(obj, leaf, value)


def _merge_dict(cfg: Config, d: dict, prefix: str = ""):
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            _merge_dict(cfg, v, prefix=f"{key}.")
        else:
            _apply(cfg, key, v)


def load_config(yaml_path: Optional[str] = None, overrides: Optional[list[str]] = None) -> Config:
    """A Config from an optional YAML preset and `key=value` overrides."""
    cfg = Config()
    if yaml_path:
        with open(yaml_path) as f:
            _merge_dict(cfg, yaml.safe_load(f) or {})
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got: {ov}")
        k, v = ov.split("=", 1)
        _apply(cfg, k, yaml.safe_load(v))
    return cfg


def format_config_tree(cfg: Config) -> str:
    """The resolved config as a plain-text tree."""
    lines = ["config"]
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            lines.append(f"├── {f.name}")
            subfields = dataclasses.fields(v)
            for i, sf in enumerate(subfields):
                branch = "└──" if i == len(subfields) - 1 else "├──"
                lines.append(f"│   {branch} {sf.name}: {getattr(v, sf.name)}")
        else:
            lines.append(f"├── {f.name}: {v}")
    return "\n".join(lines)


# Families of the JAX package's `build_model` that the port does not build
# yet, with the ROADMAP item that ports them.
_FAMILIES_NOT_PORTED = {
    "spatracker_multiview": "item 7 (spatracker.py with ops/splat.py)",
    "cotracker2d": "item 7 (cotracker2d.py, monocular.py)",
    **{name: "item 7 (monocular.py, hub_baselines.py)" for name in (
        "cotracker1_offline", "cotracker1_online", "cotracker2_offline", "cotracker2_online",
        "cotracker3_offline", "cotracker3_online", "locotrack", "scenetracker", "delta", "spatialtrackerv2",
        "tapip3d", "spatracker_monocular", "monocular_nn",
    )},
}


def build_model(mc: ModelConfig, device="cuda"):
    """The model the config names, on `device` (MVTracker in eval mode
    with its initial weights; CopyCat has none)."""
    if mc.name == "copycat":
        from mvtracker_torch.models.copycat import CopyCat

        return CopyCat()
    if mc.name == "mvtracker":
        from mvtracker_torch.models.mvtracker import MVTracker

        if mc.corr_backend != "auto":
            raise NotImplementedError(
                f"corr_backend={mc.corr_backend!r}: the port has one correlation (the CUDA kernel on the card, "
                "its plain version on the CPU); leave it at 'auto'"
            )
        accepted = set(inspect.signature(MVTracker.__init__).parameters) - {"self", "device", "not_ported"}
        kwargs = {
            k: v
            for k, v in dataclasses.asdict(mc).items()
            if k in accepted | {"support_memory_tokens"} and v is not None
        }
        return MVTracker(**kwargs, device=device).eval()
    if mc.name in _FAMILIES_NOT_PORTED:
        raise NotImplementedError(f"model family {mc.name!r} is not ported yet: ROADMAP {_FAMILIES_NOT_PORTED[mc.name]}")
    raise ValueError(f"unknown model family: {mc.name}")


def build_dataset(dc: DataConfig):
    if dc.dataset == "synthetic":
        from mvtracker_torch.datasets.loader import SyntheticSceneDataset

        return SyntheticSceneDataset(
            n_scenes=64,
            seed=dc.seed,
            n_views=dc.n_views,
            n_frames=dc.n_frames,
            height=dc.height,
            width=dc.width,
            n_tracks=dc.num_tracks,
        )
    if dc.dataset in ("kubric", "droid") or "-multiview" in dc.dataset:
        raise NotImplementedError(f"dataset {dc.dataset!r} is not ported yet: ROADMAP item 4 (the real datasets)")
    raise ValueError(f"unknown dataset: {dc.dataset}")
