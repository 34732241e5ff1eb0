#!/usr/bin/env python3
"""CPU control behind the limits of `chip_smoke.py` phase 14 (c): the
sharded train step against one process, at small width on gloo CPU
processes.

    PYTHONPATH=. python3 scripts/control_torch_parallel.py [--out readings.json]

The comparison is the phase's own (`chip_smoke.par_step`, `par_run_steps`,
`step_gaps`): the flagship's structure (window 12, 4 levels of k=16) at
fmaps 32, hidden 64, 2 + 2 layers, in fp32 with remat, 2 steps of a 2-scene
batch (4 views x 18 frames x 64^2, 32 tracks), on a 2 x 1 mesh and on a 2 x 2
mesh with shard_views and shard_tracks, against the same steps in this
process, and the same steps again in this process. It prints the gaps as
JSON: the loss's relative gap, Adam's first moment after the first step per
leaf class and both moments after the last over every leaf, the largest
parameter gap.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WIDTH = dict(fmaps_dim=32, hidden_size=64, num_heads=2, space_depth=2, time_depth=2, num_virtual_tracks=8)
SCENE = (4, 18, 64, 64, 32)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="write the readings to this JSON file too")
    args = parser.parse_args()

    import torch

    import chip_smoke as cs
    from mvtracker_torch.parallel.launch import run_local

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    want = cs.par_run_steps(torch, cs.par_step_model(torch, "cpu", WIDTH), cs.par_step_batch(*SCENE), cs.PAR_STEPS)
    again = cs.par_run_steps(torch, cs.par_step_model(torch, "cpu", WIDTH), cs.par_step_batch(*SCENE), cs.PAR_STEPS)
    readings = {"one_process_loss": [m["loss"] for m in want["metrics"]],
                "one_process_again": cs.step_gaps(again, want)}
    spec = dict(device="cpu", width=WIDTH, scene=SCENE, bf16_steps=0)
    with tempfile.TemporaryDirectory() as tmp:
        for label, world, over in (("2x1", 2, dict(n_model=1, shard_views=False, shard_tracks=False)),
                                   ("2x2_views_tracks", 4, dict(n_model=2, shard_views=True, shard_tracks=True))):
            ranks = run_local(cs.par_child, world, tmp, [("step", dict(spec, **over))], "cpu", timeout=900, threads=1)
            steps = [r["step"] for r in ranks]
            readings[label] = {**cs.step_gaps(steps[0], want),
                               "ranks_equal": len({r["digest"] for r in steps}) == 1}
    readings["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(readings, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(readings, indent=2))


if __name__ == "__main__":
    main()
