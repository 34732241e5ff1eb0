"""Config system (L8), counterpart of `mvtracker_tpu/config.py`: typed
dataclasses, YAML presets (`configs/*.yaml`) and `key.subkey=value`
overrides. A copy of the JAX module's dataclasses, loading and overrides;
the trainer section is the port's `TrainConfig`.

What the port does with the settings:
- `build_model` builds every family of the JAX package's: `mvtracker`,
  `spatracker_multiview` (the triplane variant), `copycat`, `cotracker2d`
  (the learned 2D tracker through the multi-view adapter, weights from
  `checkpoint_2d` when it is set) and the monocular-baseline zoo (the hub
  wrappers where torch.hub's cache holds them, otherwise the NCC tracker
  through the same adapter, with a warning that names what is missing;
  `_FAMILIES_NOT_PORTED` is empty). `transformer_scan_unroll` is accepted at any value and
  ignored: the port runs the update transformer's layers as separate
  modules, with no scan to unroll. `corr_backend` picks among the JAX package's correlation
  implementations; the port has one (the CUDA kernel on the card, its plain
  version on the CPU), so only "auto" is accepted.
- `build_dataset` builds `synthetic`, `kubric`, `droid` (the processed
  episodes under `root`, `datasets/droid.py`) and the `-multiview` names
  (Kubric, Panoptic Studio, DexYCB).
- `mesh_data`, `mesh_model` and `shard_views` shape the training mesh
  (`parallel/mesh.py`) when `cli.train` runs in a world of more than one
  process (`MVTRACKER_DISTRIBUTED=1`); `cli.eval` reads none of them and
  evaluates on one device, as the JAX CLI does.
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
    # None keeps the family's own default (0 for MVTracker, 100 for the
    # triplane SpaTracker).
    support_memory_tokens: Optional[int] = None
    use_point_transformer: bool = False
    point_transformer_depth: int = 2
    normalize_scene_in_fwd_pass: bool = False
    remat: bool = False
    # The widths of a VGGT depth stage (`models/vggt.py::VGGTConfig`; an
    # empty dict is VGGT-1B's) for `forward(..., depth_source=
    # "vggt_aligned")`; None builds none. The port's own key: the JAX
    # package's config has no such field.
    depth_estimator: Optional[dict] = None
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
        if isinstance(v, dict) and dataclasses.is_dataclass(_lookup(cfg, key)):
            _merge_dict(cfg, v, prefix=f"{key}.")
        else:
            _apply(cfg, key, v)  # a dict-valued setting (model.depth_estimator) is set whole


def _lookup(obj: Any, key: str) -> Any:
    """The setting at a dotted key, None where there is none."""
    for p in key.split("."):
        obj = getattr(obj, p, None)
    return obj


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
# yet, with the ROADMAP item that ports them: none.
_FAMILIES_NOT_PORTED: dict[str, str] = {}

# The reference's monocular-baseline zoo: 2D trackers lifted to the 3D API.
MONOCULAR_BASELINES = (
    "cotracker1_offline", "cotracker1_online", "cotracker2_offline", "cotracker2_online",
    "cotracker3_offline", "cotracker3_online", "locotrack", "scenetracker", "delta", "spatialtrackerv2",
    "tapip3d", "spatracker_monocular", "monocular_nn",
)


def _model_kwargs(mc: ModelConfig, cls) -> dict:
    """The config's settings that `cls`'s constructor (or the MVTracker
    base's) takes; None keeps the family's own default."""
    from mvtracker_torch.models.mvtracker import MVTracker

    if mc.corr_backend != "auto":
        raise NotImplementedError(
            f"corr_backend={mc.corr_backend!r}: the port has one correlation (the CUDA kernel on the card, "
            "its plain version on the CPU); leave it at 'auto'"
        )
    accepted = set()
    for klass in (cls, MVTracker):
        accepted |= set(inspect.signature(klass.__init__).parameters)
    accepted -= {"self", "device", "kwargs"}
    return {k: v for k, v in dataclasses.asdict(mc).items() if k in accepted and v is not None}


def load_checkpoint_2d(model, path: str):
    """Weights for the learned 2D tracker: a flax msgpack params file (the
    JAX package's `checkpoint_2d`), or a torch file of the port's trainer
    (its "model" entry) or of a bare state dict. Loaded strictly."""
    import torch

    from mvtracker_torch import convert

    if path.endswith(".msgpack"):
        tree = convert.migrate_updateformer_layout(convert.load_flax_msgpack(path))
        sd = convert.params_from_flax(tree)
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        sd = payload.get("model", payload)
    model.load_state_dict({k: v.to(model.device) for k, v in sd.items()}, strict=True)
    return model


def build_model(mc: ModelConfig, device="cuda"):
    """The model the config names, on `device`: a tracker module in eval
    mode with its initial weights, CopyCat (no weights), or a 2D tracker
    inside `MonocularToMultiViewAdapter`."""
    if mc.name == "copycat":
        from mvtracker_torch.models.copycat import CopyCat

        return CopyCat()
    if mc.name in ("mvtracker", "spatracker_multiview"):
        if mc.name == "spatracker_multiview":
            from mvtracker_torch.models.spatracker import MultiViewSpaTracker as cls
        else:
            from mvtracker_torch.models.mvtracker import MVTracker as cls
        return cls(**_model_kwargs(mc, cls), device=device).eval()
    if mc.name == "cotracker2d":
        from mvtracker_torch.models.cotracker2d import CoTracker2D, LearnedTracker2D
        from mvtracker_torch.models.monocular import MonocularToMultiViewAdapter

        model2d = CoTracker2D(**_model_kwargs(mc, CoTracker2D), device=device).eval()
        if mc.checkpoint_2d:
            load_checkpoint_2d(model2d, mc.checkpoint_2d)
        return MonocularToMultiViewAdapter(LearnedTracker2D(model2d), device=device)
    if mc.name in MONOCULAR_BASELINES:
        import logging

        from mvtracker_torch.models.hub_baselines import load_monocular_hub_tracker
        from mvtracker_torch.models.monocular import MonocularToMultiViewAdapter, SimpleNNTracker2D

        try:
            tracker = load_monocular_hub_tracker(mc.name, device=device)
        except Exception as e:  # no hub cache, a vendored repo missing, or a name with no wrapper
            # The weights are what is missing, not the device: the NCC
            # tracker runs on `device` through the same adapter.
            logging.warning(
                "monocular baseline %r unavailable (%s); falling back to the in-repo NCC tracker through the same "
                "adapter", mc.name, e,
            )
            tracker = SimpleNNTracker2D()
        return MonocularToMultiViewAdapter(tracker, device=device)
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
    if dc.dataset == "kubric":
        from mvtracker_torch.datasets.kubric import KubricMultiViewDataset

        return KubricMultiViewDataset(dc.root, view_subset=dc.view_subset, num_tracks=dc.num_tracks, seed=dc.seed)
    if dc.dataset == "droid":
        from mvtracker_torch.datasets.droid import DroidEpisodeDataset

        return DroidEpisodeDataset(dc.root, max_frames=dc.n_frames or None)
    if "-multiview" in dc.dataset:
        # The dataset-name grammar of the reference's `from_name` factories,
        # e.g. "kubric-multiview-v3-views0_1_2_3-noise2cm", "panoptic-multiview".
        from mvtracker_torch.datasets.real_world import dataset_from_name

        return dataset_from_name(dc.dataset, dc.root)
    raise ValueError(f"unknown dataset: {dc.dataset}")
