"""How `correct` is decided: the program's answers against the plain
reference's, on the same clips, queries and seeded weights.

After the window has closed, the reference (`perfbench/reference/`) runs
once per distinct clip of the pool, twice: in fp32 with TF32 off (the
reference answer) and with every product's operands rounded to bf16 (the
deviation that the configuration's own precision alone causes). Every
request of the window is then compared with its clip's answers:

- `traj_x`: the median distance, over the entries the reference tracks,
  between the program's and the fp32 reference's track points, over the
  same median for the bf16 reference; the largest over the requests;
- `vis_x`: the same for the visibility probability;
- `traj_p90x`, `vis_p90x`: the same with the 90th percentile of the gaps
  in place of the median, so that a fault on a minority of the queries or
  frames (a quarter of them, the last window), which leaves the median
  where it was, still shows.

So a reading of 1 is a program that deviates as a plain bf16 computation
does. The ratio is steady where the raw gap is not: with seeded weights the
tracks' sensitivity to rounding moves with the seed by about five times,
for the program and for the control alike (PERF.md has the readings). The
largest over the requests makes every answer count: one request answered
wrongly fails the run.

Each has a limit in `perfbench/limits/<cell>.json`; a run is correct when
every one is at or under its limit and no request failed. The raw medians
and largest gaps are printed beside them, not judged.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

NAMES = ("traj_x", "vis_x", "traj_p90x", "vis_p90x")
FLOOR = 1e-9  # a bf16 deviation below this counts as this


def load_reference(root: Path, config: dict):
    path = root / config["reference"]
    spec = importlib.util.spec_from_file_location(f"perfbench_reference_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_answers(ref_mod, config: dict, traffic: dict, state: dict, clips: list, device, lowp=None) -> list:
    """(traj, vis) on the host for every clip, from the plain reference with
    TF32 off on `device`; `lowp` rounds every product's operands."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = ref_mod.Ref(dict(config["widths"]), state, lowp=lowp)
        out = []
        for clip in clips:
            x = {k: v.to(device) for k, v in clip.items()}
            args = (x["rgbs"], x["depths"], x["queries"], x["intrs"], x["extrs"])
            if traffic["entry"] == "predictor":
                traj, vis = ref_mod.predictor(ref, *args, **traffic["options"])
            else:
                traj, vis = ref.forward(*args, **traffic["options"])
            out.append((traj.cpu(), vis.cpu()))
            del x
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def gaps(traj, vis, reference):
    """(tracked mask, track distance, visibility gap) of one answer."""
    r_traj, r_vis = reference
    tracked = (r_traj != 0).any(-1)  # [T, N]; untracked entries are 0 on both sides
    return tracked, (traj.float() - r_traj).norm(dim=-1), (vis.float() - r_vis).abs()


def _stats(dt, dv, tracked) -> tuple:
    """(track median, vis median, track p90, vis p90) over the tracked
    entries."""
    t, v = dt[tracked].double(), dv[tracked].double()
    return (float(t.median()), float(v.median()), float(torch.quantile(t, 0.9)), float(torch.quantile(v, 0.9)))


def numbers(answers: list, reference: list, base: list) -> dict:
    """`traj_x`, `vis_x`, `traj_p90x`, `vis_p90x` over `answers` = [(clip
    index, traj, vis), ...] against the fp32 `reference` and the bf16 `base`
    answers per clip, with the raw medians and largest gaps beside them."""
    base_stats = []
    for (b_traj, b_vis), ref in zip(base, reference):
        tracked, dt, dv = gaps(b_traj, b_vis, ref)
        base_stats.append(tuple(max(x, FLOOR) for x in _stats(dt, dv, tracked)))
    out = {n: 0.0 for n in NAMES + ("traj_med", "vis_med", "traj_max", "vis_max")}
    for ci, traj, vis in answers:
        tracked, dt, dv = gaps(traj, vis, reference[ci])
        got = _stats(dt, dv, tracked)
        for name, g, b in zip(NAMES, got, base_stats[ci]):
            out[name] = max(out[name], g / b)
        out["traj_med"], out["vis_med"] = max(out["traj_med"], got[0]), max(out["vis_med"], got[1])
        out["traj_max"] = max(out["traj_max"], float(dt.max()))
        out["vis_max"] = max(out["vis_max"], float(dv.max()))
    out["base_traj_med"] = max(b[0] for b in base_stats)
    out["base_vis_med"] = max(b[1] for b in base_stats)
    return out


def repeat_gap(answers: list) -> dict:
    """The largest gap between a clip's first answer and its later ones
    (traj in world units, vis): 0 where the program repeats itself."""
    first, gap = {}, {"traj": 0.0, "vis": 0.0}
    for ci, traj, vis in answers:
        if ci not in first:
            first[ci] = (traj, vis)
            continue
        gap["traj"] = max(gap["traj"], float((traj - first[ci][0]).abs().max()))
        gap["vis"] = max(gap["vis"], float((vis - first[ci][1]).abs().max()))
    return gap


def judge(values: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}); a number without a limit, or
    one that is not finite, is not correct."""
    checked = {name: {"value": values.get(name), "limit": limits.get(name)} for name in NAMES}
    ok = failed == 0
    for entry in checked.values():
        v, lim = entry["value"], entry["limit"]
        ok = ok and v is not None and lim is not None and v == v and v <= lim
    return ok, checked
