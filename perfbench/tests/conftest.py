"""The benchmark's CPU tests. Run from the repository root:

    python -m pytest perfbench/tests -q

Tests marked `cuda` need the card and skip elsewhere (decided in a fixture)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TINY_CONFIG = {
    "model": "mvtracker",
    "widths": {"sliding_window_len": 8, "stride": 4, "fmaps_dim": 32, "hidden_size": 64, "num_heads": 2,
               "space_depth": 2, "time_depth": 2, "num_virtual_tracks": 8, "corr_n_levels": 3, "corr_neighbors": 4,
               "flow_embed_dim": 64, "vis_geom_features": True, "vis_head_hidden": 16},
    "compute_dtype": "float32", "reference": "reference/mvtracker.py", "assumed": {"flow_head_gain": 0.001},
}


def tiny_traffic(entry: str, options: dict | None = None, **kw) -> dict:
    """A `.json`-style mix at narrow sizes, with the default generator."""
    from perfbench.lib import scene

    if options is None:
        options = {"iters": 2} if entry == "forward" else {"interp_shape": None, "grid_size": 3, "n_iters": 2}
    t = {"entry": entry, "options": options, "views": 2, "frames": 12, "height": 64, "width": 64, "queries": 24,
         "query_times": "first_half", "pool": 2, "warmup_requests": 1, "profiled_requests": 1,
         "make_clip": scene.generate}
    t.update(kw)
    return t
