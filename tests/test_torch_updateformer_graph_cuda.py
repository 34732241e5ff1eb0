"""The update transformer replayed from a CUDA graph on the card
(`mvtracker_torch/models/updateformer.py::CallGraph`): inside a scope, a
serving call captures once and replays, with the eager call's outputs to
the bit; a scope with another N captures anew; a forward leaves no device
memory behind; `FlopCounterMode` and autograd keep the eager path.

Marked `cuda`; the tests skip on a host without a GPU. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_updateformer_graph_cuda.py
"""

import numpy as np
import pytest
import torch

from mvtracker_torch.convert import random_state_dict
from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.scene import make_scene

pytestmark = pytest.mark.cuda

# The benchmark's two configurations (perfbench/configs/), and the flagship
# with the update transformer's LoFTR support memory (fp32 inside).
WIDTHS = {
    "flagship": dict(sliding_window_len=12, fmaps_dim=128, hidden_size=384, num_heads=6, space_depth=6,
                     time_depth=6, num_virtual_tracks=64, corr_n_levels=4, corr_neighbors=16),
    "medium": dict(sliding_window_len=8, fmaps_dim=96, hidden_size=256, num_heads=8, space_depth=4, time_depth=4,
                   num_virtual_tracks=32, corr_n_levels=3, corr_neighbors=12, vis_geom_features=True,
                   vis_head_hidden=128),
    "flagship_support_memory": dict(sliding_window_len=12, fmaps_dim=128, hidden_size=384, num_heads=6,
                                    space_depth=6, time_depth=6, num_virtual_tracks=64, corr_n_levels=4,
                                    corr_neighbors=16, support_memory_tokens=16),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def seeded(name: str, card) -> MVTracker:
    model = MVTracker(**WIDTHS[name], compute_dtype="bfloat16", device=card).eval()
    model.load_state_dict({k: v.to(card) for k, v in random_state_dict(model, seed=0).items()})
    return model


def count_captures(graph) -> list:
    captured = []
    real = graph._capture

    def capture(fn):
        captured.append(tuple(graph.x.shape))
        return real(fn)

    graph._capture = capture
    return captured


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_replays_equal_the_eager_call_and_another_n_captures_anew(card, name):
    model = seeded(name, card)
    uf, s, d = model.updateformer, model.sliding_window_len, model.updateformer_input_dim
    gen = torch.Generator(device=card).manual_seed(0)
    calls = [(n, torch.randn(1, n, s, d, device=card, generator=gen),
              torch.rand(1, n, device=card, generator=gen) > 0.3) for n in (40, 40, 40, 72, 72)]
    with torch.enable_grad():
        eager = [uf(x, track_mask=m).detach() for _, x, m in calls]
    assert all(e.dtype == torch.float32 for e in eager)
    captured = count_captures(uf.graph)
    got = []
    with torch.no_grad():
        for n_scope in (40, 72):  # two forwards, one N each
            with uf.graph.scope():
                for n, x, m in calls:
                    if n == n_scope:
                        got.append(uf(x, track_mask=m).clone())
            assert uf.graph.buf is uf.graph.x is uf.graph.mask is uf.graph.out is None
    assert captured == [(1, 40, s, d), (1, 72, s, d)]
    for g, e in zip(got, eager):
        assert torch.equal(g, e), (g - e).abs().max().item()


def test_a_forward_leaves_no_device_memory_and_counts_like_eager(card):
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    model = seeded("flagship", card)
    rgbs, depths, queries, intrs, extrs = (torch.from_numpy(a).to(card) for a in
                                           make_scene(np.random.default_rng(0), 2, 24, 64, 64, 96))
    queries[:, 0] = torch.arange(96, device=card) % 6
    args = (rgbs, depths, queries, intrs, extrs)
    model(*args, iters=2)  # the kernels' build and first calls
    captured = count_captures(model.updateformer.graph)
    with FlopCounterMode(display=False) as counter:
        eager = model(*args, iters=2)
    assert captured == []
    flops = counter.get_flop_counts()
    assert sum(flops["MVTracker.updateformer"].values()) > 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = model(*args, iters=2)
    traj, vis = out["traj"].cpu(), out["vis"].cpu()
    del out
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert len(captured) == 1
    names = [e.name for e in prof.events() if e.name.startswith("mvtracker::transformer")]
    calls = names.count("mvtracker::transformer")
    assert calls == 2 * 3  # 3 windows of 12 frames with hop 6 from frame 0, 2 iterations
    assert names.count("mvtracker::transformer_capture") == 1
    assert names.count("mvtracker::transformer_replay") == calls - 1
    assert torch.equal(traj, eager["traj"].cpu()) and torch.equal(vis, eager["vis"].cpu())
