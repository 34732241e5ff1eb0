"""TAP-Vid-style 3D tracking metrics (L6), pure numpy.

A copy of `mvtracker_tpu/evaluation/metrics.py` (the port imports nothing
of that package). It re-implements the reference metric suite
(`mvtracker/evaluation/metrics.py:10-406`): occlusion accuracy,
points-within-threshold, Jaccard per threshold with their averages, plus
MTE/ATE/FDE/survival per track, and the static/dynamic/very-dynamic
stratified aggregation with the "dynamic-static-mean" headline number.

Metrics are evaluation-time host work; numpy keeps them simple and exactly
reproducible.
"""

from __future__ import annotations

import warnings

import numpy as np


def compute_tapvid_metrics(
    query_points: np.ndarray,  # [B, N, D+1] (t, coords)
    gt_occluded: np.ndarray,  # [B, T, N] bool
    gt_tracks: np.ndarray,  # [B, T, N, D]
    pred_occluded: np.ndarray,  # [B, T, N] bool
    pred_tracks: np.ndarray,  # [B, T, N, D]
    distance_thresholds,
    query_mode: str = "first",
) -> dict[str, np.ndarray]:
    """Per-track TAP-Vid metrics; mirrors reference `metrics.py:61-171`."""
    n_batches, n_frames, n_points, d = gt_tracks.shape
    assert query_mode in ("first", "strided")

    # Don't evaluate at the query frame itself.
    evaluation_points = np.ones_like(gt_occluded, dtype=bool)
    t_q = query_points[:, :, 0].astype(np.int64)  # [B, N]
    for b in range(n_batches):
        evaluation_points[b, t_q[b], np.arange(n_points)] = False
    if query_mode == "first":
        before = np.arange(n_frames)[None, :, None] < t_q[:, None, :]
        evaluation_points &= ~before

    metrics: dict[str, np.ndarray] = {}
    eval_count = evaluation_points.sum(axis=1)  # [B, N]
    occ_correct = (pred_occluded == gt_occluded) & evaluation_points
    metrics["occlusion_accuracy_per_track"] = occ_correct.sum(axis=1) / eval_count

    with np.errstate(invalid="ignore", divide="ignore"):
        for gt_val, name in ((True, "vis0"), (False, "vis1")):
            sel = (gt_occluded == gt_val) & evaluation_points
            metrics[f"occlusion_accuracy_for_{name}_per_track"] = (
                (occ_correct & sel).sum(axis=1) / sel.sum(axis=1)
            )

    distances = np.linalg.norm(pred_tracks - gt_tracks, axis=-1)  # [B, T, N]
    visible_eval = ~gt_occluded & evaluation_points
    visible_count = visible_eval.sum(axis=1)
    assert visible_count.min() > 0, (
        "No visible points to evaluate; need at least two visible timesteps."
    )

    pts_list, jac_list = [], []
    for thresh in distance_thresholds:
        within = distances < thresh
        pts = (within & visible_eval).sum(axis=1) / visible_count
        metrics[f"pts_within_{thresh:.2f}_per_track"] = pts
        pts_list.append(pts)

        true_pos = (within & ~pred_occluded & visible_eval).sum(axis=1)
        false_pos = (~within & ~pred_occluded) | (~pred_occluded & gt_occluded)
        false_pos = (false_pos & evaluation_points).sum(axis=1)
        jac = true_pos / (visible_count + false_pos)
        metrics[f"jaccard_{thresh:.2f}_per_track"] = jac
        jac_list.append(jac)

    metrics["average_jaccard_per_track"] = np.stack(jac_list, -1).mean(-1)
    metrics["average_pts_within_thresh_per_track"] = np.stack(pts_list, -1).mean(-1)
    return metrics


def compute_tapvid_metrics_original(
    query_points: np.ndarray,  # [b, n, 3] (t, y, x) raster coords
    gt_occluded: np.ndarray,  # [b, n, t] bool
    gt_tracks: np.ndarray,  # [b, n, t, 2] (x, y)
    pred_occluded: np.ndarray,  # [b, n, t] bool
    pred_tracks: np.ndarray,  # [b, n, t, 2]
    query_mode: str,
) -> dict[str, np.ndarray]:
    """The DeepMind TAP-Vid reference implementation, kept verbatim in
    semantics as an independent numerical oracle for `compute_tapvid_metrics`
    (reference `metrics.py:174-300` keeps the same redundancy).

    Axis convention is the ORIGINAL's ([b, n, t], pixel thresholds
    {1,2,4,8,16}, query as (t, y, x)) — NOT this module's [B, T, N]
    convention. Metrics are per-video aggregates (pooled over points), not
    per-track; the two implementations therefore agree exactly whenever the
    per-track weighting coincides with pooled weighting (e.g. single-track
    videos), which is what `tests/test_metrics_original.py` asserts on
    randomized inputs.
    """
    metrics: dict[str, np.ndarray] = {}
    # Eval-frame selection ("fixed bug" from co-tracker#20: index by query
    # frame through an eye matrix rather than a range comparison).
    eye = np.eye(gt_tracks.shape[2], dtype=np.int32)
    if query_mode == "first":
        query_frame_to_eval_frames = np.cumsum(eye, axis=1) - eye
    elif query_mode == "strided":
        query_frame_to_eval_frames = 1 - eye
    else:
        raise ValueError("Unknown query mode " + query_mode)

    query_frame = np.round(query_points[..., 0]).astype(np.int32)
    evaluation_points = query_frame_to_eval_frames[query_frame] > 0  # [b, n, t]

    # NOTE: denominator pools over the WHOLE batch (the original's exact
    # behavior; only meaningful per-video at b=1).
    occ_acc = np.sum(
        np.equal(pred_occluded, gt_occluded) & evaluation_points, axis=(1, 2)
    ) / np.sum(evaluation_points)
    metrics["occlusion_accuracy"] = occ_acc

    visible = np.logical_not(gt_occluded)
    pred_visible = np.logical_not(pred_occluded)
    all_frac_within = []
    all_jaccard = []
    for thresh in [1, 2, 4, 8, 16]:
        within_dist = np.sum(
            np.square(pred_tracks - gt_tracks), axis=-1
        ) < np.square(thresh)
        is_correct = np.logical_and(within_dist, visible)

        count_correct = np.sum(is_correct & evaluation_points, axis=(1, 2))
        count_visible_points = np.sum(visible & evaluation_points, axis=(1, 2))
        frac_correct = count_correct / count_visible_points
        metrics["pts_within_" + str(thresh)] = frac_correct
        all_frac_within.append(frac_correct)

        true_positives = np.sum(
            is_correct & pred_visible & evaluation_points, axis=(1, 2)
        )
        # tp / (tp + fp + fn) with tp + fn = gt-visible count.
        gt_positives = np.sum(visible & evaluation_points, axis=(1, 2))
        false_positives = (~visible) & pred_visible
        false_positives = false_positives | ((~within_dist) & pred_visible)
        false_positives = np.sum(false_positives & evaluation_points, axis=(1, 2))
        jaccard = true_positives / (gt_positives + false_positives)
        metrics["jaccard_" + str(thresh)] = jaccard
        all_jaccard.append(jaccard)
    metrics["average_jaccard"] = np.mean(np.stack(all_jaccard, axis=1), axis=1)
    metrics["average_pts_within_thresh"] = np.mean(
        np.stack(all_frac_within, axis=1), axis=1
    )
    return metrics


def compute_metrics(
    query_points: np.ndarray,
    gt_occluded: np.ndarray,
    gt_tracks: np.ndarray,
    pred_occluded: np.ndarray,
    pred_tracks: np.ndarray,
    distance_thresholds=(1, 2, 4, 8, 16),
    survival_distance_threshold: float = 50.0,
    query_mode: str = "first",
) -> dict[str, np.ndarray]:
    """TAP-Vid metrics + MTE/ATE/FDE/survival; mirrors reference
    `metrics.py:10-58`."""
    n_batches, n_frames, n_points, _ = gt_tracks.shape
    out = compute_tapvid_metrics(
        query_points, gt_occluded, gt_tracks, pred_occluded, pred_tracks,
        distance_thresholds, query_mode,
    )

    visible = ~gt_occluded
    distances = np.linalg.norm(pred_tracks - gt_tracks, axis=-1)
    distances = distances.copy()
    distances[~visible] = np.nan
    t_q = query_points[:, :, 0].astype(np.int64)
    before = np.arange(n_frames)[None, :, None] < t_q[:, None, :]
    distances[before] = np.nan

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        # torch.nanmedian picks the LOWER middle element for even counts
        # (numpy averages the two) — match the reference exactly.
        sorted_d = np.sort(np.nan_to_num(distances, nan=np.inf), axis=1)
        n_valid = (~np.isnan(distances)).sum(axis=1)  # [B, N]
        mid = np.maximum(n_valid - 1, 0) // 2
        mte = np.take_along_axis(sorted_d, mid[:, None, :], axis=1)[:, 0]
        ate = np.nanmean(distances, axis=1)
    assert not np.isnan(mte).any()
    assert not np.isnan(ate).any()

    last_visible = np.argmax(visible * np.arange(n_frames)[None, :, None], axis=1)
    fde = np.take_along_axis(distances, last_visible[:, None, :], axis=1)[:, 0]

    failed = np.nan_to_num(distances, nan=0.0) > survival_distance_threshold
    failed &= visible
    failure_index = failed.argmax(axis=1).astype(np.float64)
    failure_index[~failed.any(axis=1)] = n_frames
    survival = (failure_index - t_q) / (n_frames - t_q)

    out.update(
        mte_visible_per_track=mte,
        ate_visible_per_track=ate,
        fde_visible_per_track=fde,
        survival_per_track=survival,
    )
    return out


def evaluate_predictions(
    gt_tracks: np.ndarray,  # [T, N, 3]
    gt_visibilities: np.ndarray,  # [T, N] bool
    pred_tracks: np.ndarray,  # [T, N, 3]
    pred_occluded: np.ndarray,  # [T, N] bool
    query_points: np.ndarray | None = None,  # [N, 4]
    distance_thresholds=(0.01, 0.02, 0.04, 0.08, 0.16),
    survival_distance_threshold: float = 0.5,
    static_threshold: float | None = 0.01,
    dynamic_threshold: float | None = 0.1,
    very_dynamic_threshold: float | None = 2.0,
    query_mode: str = "first",
):
    """Stratified sequence evaluation; mirrors reference `metrics.py:303-406`.

    Returns (results, results_per_track): dicts keyed
    `all_{any,static,dynamic,very_dynamic}` (+ `all_dynamic-static-mean`),
    metric values scaled by 100 like the reference's published tables.

    query_mode="strided" (TAP-Vid strided protocol): tracks are evaluated
    BIDIRECTIONALLY from mid-video queries — ground-truth visibility before
    the query frame is kept instead of masked out.
    """
    n_frames, n_points, _ = gt_tracks.shape

    if query_points is None:
        warnings.warn("Query points not provided; using first visible frame.")
        t0 = np.argmax(gt_visibilities, axis=0)
        qxyz = gt_tracks[t0, np.arange(n_points)]
        query_points = np.concatenate([t0[:, None], qxyz], axis=-1).astype(np.float32)

    if query_mode == "first":
        at_or_after = np.arange(n_frames)[:, None] >= query_points[:, 0][None, :]
        gt_visibilities = gt_visibilities & at_or_after

    movement = np.zeros(n_points)
    for p in range(n_points):
        track = gt_tracks[gt_visibilities[:, p], p]
        if len(track) > 1:
            movement[p] = np.linalg.norm(track[1:] - track[:-1], axis=-1).sum()

    point_masks = {"any": np.ones(n_points, bool)}
    if static_threshold is not None:
        point_masks["static"] = movement < static_threshold
    if dynamic_threshold is not None:
        point_masks["dynamic"] = movement > dynamic_threshold
    if very_dynamic_threshold is not None:
        point_masks["very_dynamic"] = movement > very_dynamic_threshold

    base_mask = gt_visibilities.sum(axis=0) >= 2

    results: dict[str, dict] = {}
    results_per_track: dict[str, dict] = {}
    for point_type, type_mask in point_masks.items():
        mask = base_mask & type_mask
        name = f"all_{point_type}"
        if mask.sum() == 0:
            continue
        m = compute_metrics(
            query_points[mask][None].astype(np.float32),
            ~gt_visibilities[:, mask][None],
            gt_tracks[:, mask][None].astype(np.float32),
            pred_occluded[:, mask][None],
            pred_tracks[:, mask][None].astype(np.float32),
            distance_thresholds=list(distance_thresholds),
            survival_distance_threshold=survival_distance_threshold,
            query_mode=query_mode,
        )
        results[name] = {
            k.replace("_per_track", ""): float(np.nanmean(v)) * 100 for k, v in m.items()
        }
        results[name]["n"] = float(mask.sum()) / n_points * 100
        results[name]["v"] = float(gt_visibilities[:, mask].sum()) / mask.sum() / n_frames * 100
        results_per_track[name] = {k: v[0] * 100 for k, v in m.items()}
        results_per_track[name]["indices"] = np.where(mask)[0]

    if "all_static" in results and "all_dynamic" in results:
        results["all_dynamic-static-mean"] = {
            k: (results["all_dynamic"][k] + results["all_static"][k]) / 2
            for k in results["all_static"]
        }
    return results, results_per_track
