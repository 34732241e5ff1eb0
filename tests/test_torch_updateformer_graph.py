"""When the update transformer replays a CUDA graph
(`mvtracker_torch/models/updateformer.py::CallGraph`), on the CPU: only a
serving call on CUDA inside a forward's scope with no dispatch mode
engages; on the CPU, with autograd recording and under `FlopCounterMode`
the forward runs the eager transformer and opens no capture or replay
span; the scope's bookkeeping (one capture a forward and signature, the
input built in the static buffer, nothing kept after the forward) with an
eager stand-in for the graph; and the benchmark's reader of the replay
share. The graph itself runs on the card:
`tests/test_torch_updateformer_graph_cuda.py`."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from mvtracker_torch.convert import random_state_dict
from mvtracker_torch.models.mvtracker import MVTracker
from mvtracker_torch.models.updateformer import CallGraph
from mvtracker_torch.scene import make_scene
from mvtracker_torch.utils import observability as t_obs
from tests.test_torch_observability import TINY

ROOT = Path(__file__).resolve().parents[1]
PREFIX = t_obs.SPAN_PREFIX
V, T, H, W, ITERS = 2, 8, 32, 32, 2


@pytest.fixture(autouse=True, scope="module")
def single_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    m = MVTracker(**TINY, device="cpu").eval()
    m.load_state_dict(random_state_dict(m, seed=0))
    return m


def scene(n: int):
    rgbs, depths, queries, intrs, extrs = make_scene(np.random.default_rng(n), V, T, H, W, n)
    queries[:, 0] = np.arange(n) % 2
    return tuple(torch.as_tensor(a) for a in (rgbs, depths, queries, intrs, extrs))


def transformer_spans(prof) -> dict:
    out = {}
    for e in prof.events():
        if e.device_type.name == "CPU" and e.name.startswith(PREFIX + "transformer"):
            out[e.name[len(PREFIX):]] = out.get(e.name[len(PREFIX):], 0) + 1
    return out


CUDA = torch.device("cuda")  # a device object only: nothing here touches a card
ENGAGES = {
    "serving_on_cuda_in_a_scope": (True, lambda g: g.engages(CUDA)),
    "outside_a_scope": (False, None),
    "on_the_cpu": (False, lambda g: g.engages(torch.device("cpu"))),
    "autograd_recording": (False, None),
    "under_flop_counter_mode": (False, None),
}


@pytest.mark.parametrize("case", sorted(ENGAGES))
def test_engages_only_where_a_replay_is_the_eager_call(case):
    graph = CallGraph("transformer")
    expected, check = ENGAGES[case]
    with torch.no_grad():
        if case == "outside_a_scope":
            got = graph.engages(CUDA)
        else:
            with graph.scope():
                if case == "autograd_recording":
                    with torch.enable_grad():
                        got = graph.engages(CUDA)
                elif case == "under_flop_counter_mode":
                    with FlopCounterMode(display=False):
                        got = graph.engages(CUDA)
                else:
                    got = check(graph)
            assert graph.depth == 0
    assert got is expected
    assert graph.input_buffer((1, 4, 2, 3), torch.float32, torch.device("cpu")) is None


@pytest.mark.parametrize("mode", ["no_grad", "autograd", "flop_counter"])
def test_the_cpu_forward_runs_the_eager_transformer(model, mode, monkeypatch):
    args = scene(6)
    with torch.no_grad():
        ref = model(*args, iters=ITERS)

    def refuse(*a, **k):
        raise AssertionError("a CPU forward reached the graph")

    monkeypatch.setattr(CallGraph, "__call__", refuse)
    monkeypatch.setattr(CallGraph, "_capture", refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if mode == "no_grad":
            out = model(*args, iters=ITERS)
        elif mode == "autograd":
            with torch.enable_grad():
                out = model(*args, iters=ITERS, is_train=True)
            assert out["traj"].requires_grad
        else:
            with FlopCounterMode(display=False) as counter:
                out = model(*args, iters=ITERS)
            assert sum(counter.get_flop_counts()["MVTracker.updateformer"].values()) > 0
    spans = transformer_spans(prof)
    assert set(spans) == {"transformer"} and spans["transformer"] > 1
    assert torch.equal(out["traj"].detach(), ref["traj"]) and torch.equal(out["vis"].detach(), ref["vis"])


def test_one_capture_a_forward_with_an_eager_stand_in_for_the_graph(model, monkeypatch):
    """The scope's bookkeeping on the CPU: `engages` takes the CPU for the
    card, and the stand-in's replay runs the eager call on the static
    tensors into the static output, as a graph would."""
    captured, passed_static = [], []
    engages, call = CallGraph.engages, CallGraph.__call__

    def stand_in(self, fn):
        x, mask = self.x, self.mask
        captured.append(tuple(x.shape))
        out = fn(x, mask)

        class Replay:
            @staticmethod
            def replay():
                out.copy_(fn(x, mask))

        self.graph, self.out = Replay(), out

    def spy(self, fn, x, mask=None):
        passed_static.append(self.buf is not None and x.data_ptr() == self.buf.data_ptr())
        return call(self, fn, x, mask)

    with torch.no_grad():
        plain = {n: model(*scene(n), iters=ITERS) for n in (6, 9)}
    monkeypatch.setattr(CallGraph, "engages", lambda self, device: engages(self, CUDA))
    monkeypatch.setattr(CallGraph, "_capture", stand_in)
    monkeypatch.setattr(CallGraph, "__call__", spy)
    graph = model.updateformer.graph
    for n in (6, 6, 9):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = model(*scene(n), iters=ITERS)
        spans = transformer_spans(prof)
        assert spans["transformer_capture"] == 1
        assert spans["transformer_replay"] == spans["transformer"] - 1 > 0
        assert graph.buf is graph.x is graph.mask is graph.out is None and graph.depth == 0
        assert torch.equal(out["traj"], plain[n]["traj"]) and torch.equal(out["vis"], plain[n]["vis"])
    s, d = model.sliding_window_len, model.updateformer_input_dim
    assert captured == [(1, 6, s, d), (1, 6, s, d), (1, 9, s, d)]
    assert passed_static and all(passed_static)


def _reader():
    from perfbench.lib import harness

    return harness.load_reader(ROOT / "perfbench", "transformer_replay_share.serve")


def _context(spans):
    from perfbench.lib import harness

    return harness.TraceContext({}, {}, 1, [1e-3], 0.0, None, program={"spans": spans})


@pytest.mark.parametrize("spans, share", [
    ({"transformer": {"calls": 12}, "transformer_capture": {"calls": 1}, "transformer_replay": {"calls": 11}},
     100 * 11 / 12),
    ({"transformer": {"calls": 1}, "transformer_capture": {"calls": 1}}, 0.0),
    ({"transformer": {"calls": 12}}, None),
    ({}, None),
])
def test_replay_share_reads_the_replayed_calls_over_all(spans, share):
    got = _reader()(_context(spans))
    assert got == (None if share is None else pytest.approx(share))
