"""Write the JAX package's outputs of the release protocol, the golden file
the PyTorch port is held against.

    JAX_PLATFORMS=cpu python scripts/make_torch_release_golden.py

Runs `scripts/eval_checkpoint.py` in this process with the command of
`release/README.md` (release weights, medium preset with `--vis_geom
--vis_head_hidden 128`, fp32, 4 views x 12 frames x 128^2, 32 tracks,
texture detail and noise 1.0, 3 iterations, grid 0, interp 128, 8
calibration and 8 held-out scenes), records every scene's `traj` and `vis`
as the script's predictor returned them, and writes under
`mvtracker_torch/evaluation/golden/`:

- `release_protocol.npz`: `calib_traj` [8, T, N, 3], `calib_vis` [8, T, N],
  `heldout_traj`, `heldout_vis`, and the scenes' names in the same order
  (`calib_seq_names`, `heldout_seq_names`);
- `release_protocol.json`: the JSON rows the script printed and its argv.

The file is read with numpy only (`chip_smoke.py`, the tests). This script
imports JAX; the port does not.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "mvtracker_torch", "evaluation", "golden")
PROTOCOL_ARGS = [
    "--params_msgpack", os.path.join("release", "mvtracker_medium_synth.msgpack"),
    "--model_size", "medium", "--vis_geom", "--vis_head_hidden", "128", "--fp32",
    "--views", "4", "--res", "128", "--iters", "3", "--grid", "0", "--interp", "128",
    "--texture_detail", "1.0", "--texture_noise", "1.0",
]


def load_eval_script():
    spec = importlib.util.spec_from_file_location("eval_checkpoint", os.path.join(ROOT, "scripts", "eval_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    os.chdir(ROOT)
    script = load_eval_script()
    recorded = []
    run_predictor = script.run_predictor

    def recording_run_predictor(predictor, scenes):
        out = run_predictor(predictor, scenes)
        recorded.append(out)
        return out

    script.run_predictor = recording_run_predictor
    with tempfile.TemporaryDirectory() as exp_dir:
        out_json = os.path.join(exp_dir, "rows.json")
        argv = PROTOCOL_ARGS + ["--exp_dir", exp_dir, "--out_json", out_json]
        sys.argv = ["eval_checkpoint.py"] + argv
        script.main()
        with open(out_json) as f:
            rows = json.load(f)
    if len(recorded) != 2:
        raise RuntimeError(f"expected one calibration and one held-out pass, got {len(recorded)}")
    arrays = {}
    for split, out in zip(("calib", "heldout"), recorded):
        names = list(out)
        arrays[f"{split}_seq_names"] = np.asarray(names)
        arrays[f"{split}_traj"] = np.stack([np.asarray(out[k][0], np.float32) for k in names])
        arrays[f"{split}_vis"] = np.stack([np.asarray(out[k][1], np.float32) for k in names])
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez_compressed(os.path.join(OUT_DIR, "release_protocol.npz"), **arrays)
    with open(os.path.join(OUT_DIR, "release_protocol.json"), "w") as f:
        json.dump({"argv": PROTOCOL_ARGS, "rows": rows}, f, indent=2)
        f.write("\n")
    print(f"wrote {OUT_DIR}: " + ", ".join(f"{k} {v.shape}" for k, v in arrays.items()))


if __name__ == "__main__":
    main()
