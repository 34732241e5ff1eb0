"""Sequence evaluator (L6), counterpart of `mvtracker_tpu/evaluation/evaluator.py`.

Re-design of the reference `Evaluator.evaluate_sequence`
(`mvtracker/evaluation/evaluator_3dpt.py:176-919`): loops Datapoints
through a predictor, times each call, computes the 3D metrics with the
setting's distance thresholds, and aggregates CSV and JSON results. Host
numpy around the predictor's device work.
"""

from __future__ import annotations

import json
import logging
import time
import warnings
from typing import Iterable, Optional

import numpy as np
import torch

from mvtracker_torch.datasets.datapoint import Datapoint
from mvtracker_torch.evaluation import metrics as metrics_lib
from mvtracker_torch.utils import geometry as geo

# Distance thresholds per evaluation setting (reference `evaluator_3dpt.py:87-123`).
EVALUATION_SETTINGS = {
    "kubric-multiview": dict(
        distance_thresholds=[0.05, 0.1, 0.2, 0.4, 0.8],
        survival_distance_threshold=0.5,
        static_threshold=0.01,
        dynamic_threshold=0.1,
        very_dynamic_threshold=2.0,
    ),
    "dexycb-multiview": dict(
        distance_thresholds=[0.01, 0.02, 0.05, 0.1, 0.2],
        survival_distance_threshold=0.5,
        static_threshold=0.01,
        dynamic_threshold=0.1,
        very_dynamic_threshold=2.0,
    ),
    "panoptic-multiview": dict(
        distance_thresholds=[0.05, 0.1, 0.2, 0.4],
        survival_distance_threshold=0.5,
        static_threshold=0.01,
        dynamic_threshold=0.1,
        very_dynamic_threshold=2.0,
    ),
    # DROID robot episodes are metric tabletop scenes like DexYCB.
    "droid": dict(
        distance_thresholds=[0.01, 0.02, 0.05, 0.1, 0.2],
        survival_distance_threshold=0.5,
        static_threshold=0.01,
        dynamic_threshold=0.1,
        very_dynamic_threshold=2.0,
    ),
}


def to_host(x) -> np.ndarray:
    """A predictor output (tensor on any device, or array) as a numpy array;
    from a CUDA tensor this waits for the device."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Evaluator:
    """Evaluate a predictor over an iterable of Datapoints."""

    def __init__(
        self,
        evaluation_setting: str = "kubric-multiview",
        compute_2d_metrics: bool = False,
        pixel_thresholds=(1, 2, 4, 8, 16),
        viz_dir: Optional[str] = None,
        viz_indices: Optional[list[int]] = None,
        query_mode: str = "first",
    ):
        if viz_dir is not None:
            raise NotImplementedError("viz_dir: the video overlays (viz/) are not ported yet")
        self.setting = evaluation_setting
        self.thresholds = EVALUATION_SETTINGS[evaluation_setting]
        self.compute_2d_metrics = compute_2d_metrics
        self.pixel_thresholds = list(pixel_thresholds)
        # TAP-Vid query protocol: "first" masks pre-query ground truth;
        # "strided" evaluates mid-video queries bidirectionally.
        self.query_mode = query_mode
        # Input shapes whose first call (cuDNN autotuning, first kernel
        # launches) has already been paid.
        self._timed_shapes: set = set()

    def _metrics_2d(self, datapoint, traj, occluded):
        """Per-view 2D TAP-Vid metrics: world predictions projected into each
        view and compared in pixels (reference `evaluator_3dpt.py:575-640`).
        The projection runs on CPU tensors."""
        v = datapoint.video.shape[0]
        n = traj.shape[1]
        traj_t = torch.from_numpy(np.asarray(traj, np.float32))
        out = {}
        for vi in range(v):
            intrs = torch.from_numpy(np.asarray(datapoint.intrs[vi], np.float32))
            extrs = torch.from_numpy(np.asarray(datapoint.extrs[vi], np.float32))
            pix, z = geo.world_to_pixel_xy_and_camera_z(traj_t, intrs, extrs)
            # Round-trip guard (the reference warns above atol=1 and goes on:
            # a diverged model still gets its metrics).
            back = geo.pixel_xy_and_camera_z_to_world(pix, z, geo.invert_intrinsics(intrs), geo.invert_extrinsics(extrs))
            ok_z = np.abs(z.numpy())[..., 0] > 1e-3
            rdev = np.abs(back.numpy() - traj).max(axis=-1)
            rdev = float(rdev[ok_z].max(initial=0.0))
            if not rdev < 1.0:
                warnings.warn(
                    f"view {vi}: reprojection round-trip deviation {rdev:.3g} exceeds atol=1 "
                    "(intrinsics/extrinsics mis-application, or a diverged prediction?)"
                )
            pred_2d = pix.numpy()
            gt_2d = datapoint.trajectory[vi, :, :, :2]
            vis_view = datapoint.visibility[vi]
            if not vis_view.any():
                continue
            qt = datapoint.query_points_3d[:, 0:1]
            first_vis = np.argmax(vis_view, axis=0)
            q2d = gt_2d[first_vis, np.arange(n)]
            query_2d = np.concatenate([qt, q2d], axis=1).astype(np.float32)
            # Visibility at and after the query time only, as in the 3D path.
            t_frames = vis_view.shape[0]
            at_or_after = np.arange(t_frames)[:, None] >= qt[:, 0][None, :]
            vis_eval = vis_view & at_or_after
            ok = vis_eval.sum(axis=0) >= 2
            if ok.sum() == 0:
                continue
            m = metrics_lib.compute_metrics(
                query_2d[ok][None],
                ~vis_eval[:, ok][None],
                gt_2d[:, ok][None].astype(np.float32),
                occluded[:, ok][None],
                pred_2d[:, ok][None].astype(np.float32),
                distance_thresholds=self.pixel_thresholds,
                survival_distance_threshold=50,
            )
            out[f"view{vi}_2d"] = {k.replace("_per_track", ""): float(np.nanmean(val)) * 100 for k, val in m.items()}
        return out

    def evaluate_sequence(
        self,
        predictor,
        dataset: Iterable[Datapoint],
        max_sequences: Optional[int] = None,
        shard: Optional[tuple[int, int]] = None,
    ):
        """Returns (summary dict, per-sequence list).

        `shard=(index, count)` evaluates every count-th sequence starting at
        `index`; merge the shards' per-sequence lists with `summarize`.
        The first datapoint of each input shape runs once untimed; each
        timed call ends with its outputs on the host, so fps includes the
        device's work.
        """
        per_seq = []
        for i, datapoint in enumerate(dataset):
            if max_sequences is not None and i >= max_sequences:
                break
            if shard is not None and i % shard[1] != shard[0]:
                continue
            if hasattr(predictor, "set_sequence"):
                predictor.set_sequence(datapoint.seq_name)
            args = (
                np.asarray(datapoint.video, np.float32),
                np.asarray(datapoint.videodepth, np.float32),
                np.asarray(datapoint.query_points_3d, np.float32),
                np.asarray(datapoint.intrs, np.float32),
                np.asarray(datapoint.extrs, np.float32),
            )
            shape_key = tuple(a.shape for a in args)
            if shape_key not in self._timed_shapes:
                self._timed_shapes.add(shape_key)
                to_host(predictor(*args)["traj"])
            t0 = time.perf_counter()
            out = predictor(*args)
            traj = to_host(out["traj"])
            occluded = to_host(out["occluded"])
            elapsed = time.perf_counter() - t0
            fps = datapoint.video.shape[1] / elapsed

            vis_any = datapoint.visibility.any(axis=0)  # [T, N]
            results, _ = metrics_lib.evaluate_predictions(
                datapoint.trajectory_3d.astype(np.float32),
                vis_any,
                traj.astype(np.float32),
                occluded,
                query_points=datapoint.query_points_3d.astype(np.float32),
                query_mode=self.query_mode,
                **self.thresholds,
            )
            if self.compute_2d_metrics and datapoint.trajectory is not None:
                results.update(self._metrics_2d(datapoint, traj, occluded))
            results["fps"] = fps
            results["seq_name"] = datapoint.seq_name
            per_seq.append(results)
            logging.info(
                "eval %s: fps=%.2f ate=%.2f aj=%.2f",
                datapoint.seq_name,
                fps,
                results.get("all_any", {}).get("ate_visible", float("nan")),
                results.get("all_any", {}).get("average_jaccard", float("nan")),
            )
        return self.summarize(per_seq), per_seq

    @staticmethod
    def summarize(per_seq: list[dict]) -> dict:
        """Average metric groups across sequences; a group absent from some
        sequences is averaged over those that have it."""
        summary: dict = {"n_sequences": len(per_seq)}
        if not per_seq:
            return summary
        groups: list[str] = []
        for r in per_seq:
            for k, v in r.items():
                if isinstance(v, dict) and k not in groups:
                    groups.append(k)
        for g in groups:
            vals: dict[str, list] = {}
            for r in per_seq:
                if g not in r:
                    continue
                for k, v in r[g].items():
                    vals.setdefault(k, []).append(v)
            summary[g] = {k: float(np.mean(v)) for k, v in vals.items()}
        summary["fps"] = float(np.mean([r["fps"] for r in per_seq]))
        return summary

    @staticmethod
    def save_json(summary: dict, path: str):
        with open(path, "w") as f:
            json.dump(summary, f, indent=2, default=float)

    @staticmethod
    def save_csv(per_seq: list[dict], path: str):
        """Flat per-sequence CSV (group/metric columns)."""
        import csv

        rows = []
        for r in per_seq:
            row = {"seq_name": r["seq_name"], "fps": r["fps"]}
            for g, metrics in r.items():
                if isinstance(metrics, dict):
                    for k, v in metrics.items():
                        row[f"{g}/{k}"] = v
            rows.append(row)
        keys = sorted({k for row in rows for k in row}, key=str)
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            writer.writerows(rows)
