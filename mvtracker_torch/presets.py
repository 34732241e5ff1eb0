"""Model size presets, a copy of `mvtracker_tpu/presets.py` (the port
imports nothing of that package).

One table for the synthetic-domain model ladder, so that an evaluation
script cannot build a model that does not match its checkpoint.
`flagship` is the reference-width configuration; `small` and `medium` are
the narrow variants of the smoke runs and the synthetic-domain release
(`release/mvtracker_medium_synth.msgpack` is `medium` with
`vis_geom=True, vis_head_hidden=128`).

Knobs the port does not implement yet (`corr_k0`, `chain_velocity`,
`global_match`, `knn_reuse`) reach the model, which raises
`NotImplementedError` for any value but the default.
"""

from __future__ import annotations

from typing import Any

from mvtracker_torch.models.mvtracker import MVTracker

BASE: dict[str, Any] = dict(sliding_window_len=8, corr_n_levels=3)

SIZES: dict[str, dict[str, Any]] = {
    "small": dict(
        fmaps_dim=64, num_heads=6, hidden_size=192, space_depth=3,
        time_depth=3, num_virtual_tracks=16, corr_neighbors=8,
    ),
    "medium": dict(
        fmaps_dim=96, num_heads=8, hidden_size=256, space_depth=4,
        time_depth=4, num_virtual_tracks=32, corr_neighbors=12,
        compute_dtype="bfloat16",
    ),
    # Reference-width model; window stays 8 on the 12-frame synthetic
    # clips so chaining is exercised.
    "flagship": dict(
        fmaps_dim=128, num_heads=8, hidden_size=384, space_depth=6,
        time_depth=6, num_virtual_tracks=64, corr_neighbors=16,
        corr_n_levels=4, compute_dtype="bfloat16",
    ),
}


def build_model(
    model_size: str,
    *,
    vis_geom: bool = False,
    vis_head_hidden: int = 0,
    corr_k0: int = 0,
    chain_velocity: float = 0.0,
    global_match: bool = False,
    knn_reuse: bool = False,
    **overrides: Any,
) -> MVTracker:
    """An MVTracker from a size preset plus the evaluation and training
    knobs the scripts expose; `overrides` (e.g. `compute_dtype`, `device`)
    win over the preset.

    corr_k0 > 0 widens the finest correlation level to k=corr_k0 while the
    other levels keep the preset's corr_neighbors; 0 keeps uniform k.
    """
    kw = {**BASE, **SIZES[model_size]}
    if corr_k0:
        k = kw["corr_neighbors"]
        kw["corr_neighbors_per_level"] = (corr_k0,) + (k,) * (kw["corr_n_levels"] - 1)
    kw.update(
        vis_geom_features=vis_geom,
        vis_head_hidden=vis_head_hidden,
        chain_velocity=chain_velocity,
        global_match_init=global_match,
        corr_knn_reuse=knn_reuse,
    )
    kw.update(overrides)
    return MVTracker(**kw)
