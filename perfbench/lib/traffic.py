"""A traffic mix, found by its name in `BENCHMARK.json`.

`perfbench/traffic/<name>.json` holds the mix's parameters, and the default
generator, `lib/scene.py::generate`, makes its clips. A mix that needs a
generator of its own is `perfbench/traffic/<name>.py` instead: its `TRAFFIC`
dict holds the same parameters, and its `make_clip(seed, index, traffic,
device)` makes clip `index` of the pool in the layout of
`scene.make_clip`.

Parameters: `entry` (the call, `lib/program.py`), `options` (the call's
keyword arguments, handed to the program and to the reference alike),
`pool`, `warmup_requests` and `profiled_requests`, and whatever the
generator reads.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def load(root: Path, name: str) -> dict:
    """The parameters of mix `name`, with its generator under `make_clip`."""
    path = root / "traffic" / f"{name}.json"
    if path.is_file():
        from perfbench.lib import scene

        return dict(json.loads(path.read_text()), make_clip=scene.generate)
    path = root / "traffic" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic/{name}.json or traffic/{name}.py under {root}")
    spec = importlib.util.spec_from_file_location("perfbench_traffic_" + name.replace(".", "_").replace("-", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return dict(mod.TRAFFIC, make_clip=mod.make_clip)
