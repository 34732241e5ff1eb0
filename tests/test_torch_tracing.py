"""The port's profiler spans (`mvtracker_torch/utils/observability.py::span`)
on the CPU: a shared no-op while no profiler records; under
`torch.profiler` every span of the request path, nested as the layers are
inside one root range a call, with the counts the windows and iterations
give; the train step's `mvtracker::train.*`; the server's `serve.wait`;
the profiling scripts' table of them (`scripts/profile_torch_forward.py`)."""

import io
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvtracker_torch.cli import serve as t_serve
from mvtracker_torch.convert import random_state_dict
from mvtracker_torch.evaluation.predictor import EvaluationPredictor
from mvtracker_torch.models.mvtracker import MVTracker, window_starts
from mvtracker_torch.scene import make_scene
from mvtracker_torch.training import step as step_lib
from mvtracker_torch.utils import observability as t_obs
from scripts.profile_torch_forward import span_rows
from tests.test_torch_observability import TINY

V, T, H, W, N, ITERS = 2, 8, 32, 32, 6, 2
PREFIX = t_obs.SPAN_PREFIX


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


@pytest.fixture(scope="module")
def scene():
    rgbs, depths, queries, intrs, extrs = make_scene(np.random.default_rng(0), V, T, H, W, N)
    queries[:, 0] = np.arange(N) % 3  # start times 0 to 2: the earliest anchors the windows
    return rgbs, depths, queries, intrs, extrs


@pytest.fixture
def opened(monkeypatch):
    """The name of every range `span` opens."""
    seen = []
    real = t_obs.record_function

    def record(name):
        seen.append(name)
        return real(name)

    monkeypatch.setattr(t_obs, "record_function", record)
    return seen


def spans_of(prof) -> list:
    """The program's host ranges: (name without the prefix, start, end, the
    name of the nearest enclosing program range or None)."""
    out = []
    for e in prof.events():
        if e.device_type.name != "CPU" or not e.name.startswith(PREFIX):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(PREFIX):
            parent = parent.cpu_parent
        out.append((e.name[len(PREFIX):], e.time_range.start, e.time_range.end,
                    None if parent is None else parent.name[len(PREFIX):]))
    return out


ANY = object()


def counts(spans, parent=ANY) -> dict:
    """Spans by name; with `parent`, only those directly inside it (None:
    the roots)."""
    out = {}
    for name, _, _, p in spans:
        if parent is ANY or p == parent:
            out[name] = out.get(name, 0) + 1
    return out


def n_windows(t: int, s: int, qt_min: int) -> int:
    return min(max((t - qt_min - 1) // (s // 2), 1), len(window_starts(t, s)))


def test_span_is_a_shared_no_op_without_a_profiler(model, scene, opened):
    assert t_obs.span("window") is t_obs.span("transformer")
    with t_obs.span("window"):
        pass
    model(*(torch.as_tensor(a) for a in scene), iters=1)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t_obs.span("window"):
            pass
    assert t_obs.span("window") is t_obs.span("vis_head")
    assert counts(spans_of(prof)) == {"window": 1}
    assert opened == [PREFIX + "window"]


def test_forward_records_every_model_span_nested_by_layer(model, scene):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(*(torch.as_tensor(a) for a in scene), iters=ITERS)
    spans = spans_of(prof)
    w = n_windows(T, TINY["sliding_window_len"], 0)
    assert counts(spans, parent=None) == {"forward": 1}
    assert counts(spans, parent="forward") == {"upload": 1, "encode": 1, "clouds": 1, "feat_init": 1, "window": w}
    assert counts(spans, parent="encode") == {"encoder": 1}
    assert counts(spans, parent="feat_init") == {"knn": 1}
    assert counts(spans, parent="window") == {"correlation": w * ITERS, "transformer": w * ITERS, "vis_head": w}
    # Two levels of at most 1024 points share one search; a correlation call each.
    assert counts(spans, parent="correlation") == {"knn": w * ITERS, "corr": 2 * w * ITERS}
    # The profiling script's table groups by the same spans.
    assert {k[len(PREFIX):]: v[0] for k, v in span_rows(prof).items()} == counts(spans)
    # Every range lies inside its parent's.
    by_name = {}
    for name, s, e, _ in spans:
        by_name.setdefault(name, []).append((s, e))
    for name, s, e, parent in spans:
        if parent is not None:
            assert any(ps <= s and e <= pe for ps, pe in by_name[parent]), name


@pytest.mark.parametrize("mode", ["whole", "chunked", "single_point"])
def test_predictor_nests_its_forwards_under_one_root(model, scene, mode):
    kw = {"whole": {}, "chunked": {"chunk_frames": 5}, "single_point": {"single_point": True}}[mode]
    pred = EvaluationPredictor(model, interp_shape=None, grid_size=2, n_iters=1, device="cpu", **kw)
    queries = scene[2][:2] if mode == "single_point" else scene[2]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            pred(*scene[:2], queries, *scene[3:])
    spans = spans_of(prof)
    forwards = {"whole": 1, "chunked": 2, "single_point": 2}[mode]
    assert counts(spans, parent=None) == {"predict": 1}
    assert counts(spans, parent="predict") == {"upload": 1, "support": 1, "forward": forwards}
    assert counts(spans, parent="forward")["upload"] == forwards
    assert counts(spans)["transformer"] == counts(spans)["window"]
    # Every span of the call lies inside its one root range.
    (_, start, end, _), = [x for x in spans if x[3] is None]
    assert all(start <= s and e <= end for _, s, e, _ in spans)


def test_train_step_records_its_three_stages(model, scene):
    rgbs, depths, queries, intrs, extrs = scene
    batch = {"rgbs": rgbs, "depths": depths, "query_points": queries, "intrs": intrs, "extrs": extrs,
             "traj_gt": np.zeros((T, N, 3), np.float32), "vis_gt": np.ones((T, N), np.float32),
             "valid": np.ones((T, N), np.float32)}
    batch = {k: torch.as_tensor(v)[None] for k, v in batch.items()}
    train_model = MVTracker(**TINY, device="cpu")
    train_model.load_state_dict(model.state_dict())
    optimizer = step_lib.make_optimizer()
    state = step_lib.init_state(train_model, optimizer)
    train_step = step_lib.make_train_step(train_model, optimizer, iters=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, batch)
    spans = spans_of(prof)
    assert counts(spans, parent=None) == {"train.forward": 1, "train.backward": 1, "train.optimizer": 1}
    assert counts(spans, parent="train.forward")["forward"] == 1
    assert sorted(span_rows(prof, PREFIX + "train.")) == [PREFIX + "train." + k for k in ("backward", "forward",
                                                                                              "optimizer")]


def test_server_waits_for_the_card_inside_its_span(model, scene):
    """Each request is served in a thread of its own: a profiler recording
    every thread sees `serve.wait` around taking the lock, then `predict`."""
    server, _ = t_serve.build_server(model, port=0, interp_shape=None, grid_size=2, n_iters=1, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(("rgbs", "depths", "query_points", "intrs", "extrs"), scene)))
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    try:
        with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
            req = urllib.request.Request(f"http://{host}:{port}/track", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    waits = [s for s in spans_of(prof) if s[0] == "serve.wait"]
    predicts = [s for s in spans_of(prof) if s[0] == "predict"]
    assert len(waits) == 1 and len(predicts) == 1 and waits[0][2] <= predicts[0][1]
