"""Episode quality gating + lab interleaving, counterpart of
`mvtracker_tpu/droid/quality.py`.

Mirrors the reference's episode ordering
(`conversions/droid/training_data/get_episodes_by_quality.py:43-110`):
score each episode from its calibration entry (number of valid external
cameras), sort within each lab by quality descending, and interleave across
labs (best of each lab first) so processing covers lab diversity early.

Episode keys follow the DROID convention ``LAB+serial+YYYY-MM-DD-HHh-MMm-SSs``.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Optional


def parse_episode_key(episode_id: str) -> Optional[dict]:
    parts = episode_id.split("+")
    if len(parts) != 3:
        return None
    return {"lab": parts[0], "serial": parts[1], "datetime": parts[2]}


def episode_quality(episode_data: dict) -> float:
    """Quality score; mirrors reference `get_episode_quality` (:43-64):
    10 points per external camera + 1 per valid 6-DoF transform."""
    score = 0.0
    for cam_id, transform in episode_data.items():
        if str(cam_id).isdigit():
            score += 10.0
            if isinstance(transform, (list, tuple)) and len(transform) == 6:
                score += 1.0
    return score


def order_episodes_by_quality(cam2base: dict, limit: int = -1) -> list[str]:
    """Quality-sorted, lab-interleaved episode order (reference :66-108)."""
    labs: dict[str, list] = defaultdict(list)
    for episode_id, data in cam2base.items():
        parsed = parse_episode_key(episode_id)
        if parsed is None:
            continue
        labs[parsed["lab"]].append((episode_quality(data), episode_id))
    for lab in labs:
        labs[lab].sort(key=lambda x: x[0], reverse=True)

    result = []
    lab_names = sorted(labs)
    max_len = max((len(labs[lab]) for lab in lab_names), default=0)
    for rank in range(max_len):
        for lab in lab_names:
            if rank < len(labs[lab]):
                result.append(labs[lab][rank][1])
    return result[:limit] if limit > 0 else result


def order_episodes_from_file(cam2base_path: str, limit: int = -1) -> list[str]:
    with open(cam2base_path) as f:
        return order_episodes_by_quality(json.load(f), limit)
