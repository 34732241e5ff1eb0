"""The per-layer metrics that read the program's own spans, and the
per-module operation counts: the four readers on hand-made records, a span
and a module that the harness does not name read by a reader file alone,
and the operation counts of `harness.count_flops` by hand."""

import time
from pathlib import Path

import pytest
import torch
from torch.profiler import record_function

from perfbench.lib import counts, harness, program_trace, spans
from perfbench.lib.spans import PREFIX as OUTSIDE

ROOT = Path(__file__).resolve().parents[1]
P = program_trace.PREFIX
READINGS = {  # a request's numbers of `_records`, by hand (ms; calls)
    "upload_ms.serve": 12e-3, "host_wait_ms.serve": 7e-3, "syncs_per_request.serve": 2.0,
    "transformer_idle_ms.serve": 10e-3,
}


def _request(shift: float, corr: int) -> list:
    """One request over [0, 100] us: forward > (upload, transformer). The
    upload's copy ends at 14, after its range (2 to 10), and a synchronize in
    it is no host wait; a synchronize at 20 to 23 and a synchronous copy at
    70 to 74 are (7 us, 2 calls). Device busy 4-14, 32-40, 50-52: the gap
    40-50 is the transformer's (10 us), the others the forward's or the
    upload's."""
    recs = [
        ("host", OUTSIDE + "request", 0, 100, 0, 1),
        ("host", P + "forward", 1, 90, 0, 1),
        ("host", P + "upload", 2, 10, 0, 1),
        ("runtime", "cudaMemcpyAsync", 3, 4, 1, 1),
        ("runtime", "cudaStreamSynchronize", 5, 7, 0, 1),
        ("device", "Memcpy HtoD (Pinned -> Device)", 4, 14, 1, 7),
        ("runtime", "cudaStreamSynchronize", 20, 23, 0, 1),
        ("host", P + "transformer", 30, 60, 0, 1),
        ("runtime", "cudaLaunchKernel", 31, 32, 2, 1),
        ("device", "gemm_kernel", 32, 40, 2, 7),
        ("runtime", "cudaLaunchKernel", 45, 46, 3, 1),
        ("device", "gemm_kernel", 50, 52, 3, 7),
        ("runtime", "cudaMemcpy", 70, 74, 0, 1),
    ]
    return [(k, n, s + shift, e + shift, c + corr if c else 0, t) for k, n, s, e, c, t in recs]


def _records():
    return _request(0, 0) + _request(200, 100), [(0, 100), (200, 300)]


def _context(program):
    return harness.TraceContext({}, {}, 2, [1e-3], 0.0, None, program=program)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_gives_the_hand_count_a_request(name):
    recs, requests = _records()
    read = harness.load_reader(ROOT, name)
    assert read(_context(program_trace.summarize(recs, requests))) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_gives_none_without_program_spans(name):
    recs, requests = _records()
    plain = [r for r in recs if not r[1].startswith(P)]
    read = harness.load_reader(ROOT, name)
    assert read(_context(program_trace.summarize(plain, requests))) is None
    assert read(_context(None)) is None
    # A context built as before the program summary existed.
    assert read(harness.TraceContext({}, {}, 1, [1e-3], 0.0, None)) is None


class Tiny(torch.nn.Module):
    """Two children; the program opens its own range around the first."""

    def __init__(self):
        super().__init__()
        self.made_up = torch.nn.Linear(7, 11)
        self.other = torch.nn.Linear(11, 4, bias=False)

    def forward(self, x):
        with record_function(P + "made_up"):
            h = self.made_up(x)
        return self.other(h)


def _tiny_call(model):
    def call(clip):
        with torch.no_grad():
            return model(clip["x"]), None
    return call


def _hand(batch: int) -> dict:
    a, b = 2 * batch * 7 * 11, 2 * batch * 11 * 4
    return {"Global": a + b, "Tiny": a + b, "Tiny.made_up": a, "Tiny.other": b}


def test_flops_by_module_and_per_request_by_hand():
    model = Tiny()
    clips = [{"x": torch.randn(3, 7)}, {"x": torch.randn(5, 7)}]
    total, by_module = harness.count_flops(model, _tiny_call(model), clips[1], {})
    assert by_module == _hand(5) and total == _hand(5)["Global"]
    # The window answered clip 0 once and clip 1 twice.
    answers = [(0, None, None), (1, None, None), (1, None, None)]
    total, by_module = harness.flops_per_request(model, _tiny_call(model), clips, answers, {})
    want = {k: (_hand(3)[k] + 2 * _hand(5)[k]) / 3 for k in _hand(3)}
    assert by_module == pytest.approx(want)
    assert total == pytest.approx(want["Global"])


def _parent_count_flops(model, call, clip, span_specs) -> float:
    """`count_flops` as it stood before it kept the counts by module."""
    from torch.utils.flop_counter import FlopCounterMode

    sp = spans.install(model, span_specs)
    sp.recording = True
    try:
        with FlopCounterMode(display=False) as counter:
            sp.flop_counter = counter
            call(clip)
    finally:
        sp.close()
    dense = counter.get_total_flops() - sp.flops_inside
    knn = sum(counts.knn_operations(c["args"][0]["shape"][0], c["args"][0]["shape"][1], c["args"][1]["shape"][1])
              for c in sp.calls.get("knn", []))
    corr = sum(counts.corr_operations(*c["args"][2]["shape"], c["args"][0]["shape"][-1])
               for c in sp.calls.get("corr", []))
    return float(dense + knn + corr)


def test_the_total_is_what_it_was_on_the_tracker():
    """On the tracker at narrow widths with the benchmark's own spans: the
    total (what `mfu.serve` reads) is the earlier count, and the modules are
    the counter's own, unadjusted."""
    from conftest import TINY_CONFIG, tiny_traffic

    from perfbench.lib import program, weights

    torch.manual_seed(0)
    cpu = torch.device("cpu")
    model = program.build_model(TINY_CONFIG, cpu)
    model.load_state_dict(weights.seeded_state(program.state_shapes(model), 11, cpu, 0.001))
    traffic = tiny_traffic("forward", frames=8, height=32, width=32, queries=8)
    clip = harness.make_clips(traffic, 11, cpu)[0]
    call = program.build_call(model, traffic)
    specs = spans.load_specs(ROOT)
    total, by_module = harness.count_flops(model, call, clip, specs)
    assert total == _parent_count_flops(model, call, clip, specs)
    assert {"Global", "MVTracker", "MVTracker.fnet", "MVTracker.updateformer"} <= set(by_module)
    assert by_module["Global"] == by_module["MVTracker"] > by_module["MVTracker.updateformer"] > 0


def test_a_new_span_and_module_are_read_by_a_reader_file_alone(tmp_path):
    """A reader that a later change adds as a file reads a program span and
    a module that nothing under `perfbench/lib/` names, through the
    harness's own traced requests and operation count."""
    lib = "".join(p.read_text() for p in (ROOT / "lib").glob("*.py"))
    assert "made_up" not in lib
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "made_up_flops_per_host_s.py").write_text(
        "def read(t):\n"
        "    span = (t.program or {}).get('spans', {}).get('made_up')\n"
        "    ops = (t.flops_by_module or {}).get('Tiny.made_up')\n"
        "    if not span or not ops:\n"
        "        return None\n"
        "    return ops * t.requests / span['host_s'], span['calls']\n")
    model = Tiny()
    call = _tiny_call(model)
    clips = [{"x": torch.randn(64, 7)}]
    cpu = torch.device("cpu")
    _, by_module = harness.flops_per_request(model, call, clips, [(0, None, None)], {})
    tr = harness.traced(model, call, clips, {"profiled_requests": 3}, {}, cpu)
    n, prog = tr["requests"], tr["program"]
    assert n == 3 and prog["requests"] == 3 and prog["spans"]["made_up"]["calls"] == 3
    assert tr["records"] and tr["spans_missing"] == []
    host_s = prog["spans"]["made_up"]["host_s"]
    assert host_s > 0
    ctx = harness.TraceContext(tr["summary"], tr["calls"], n, [1e-3], by_module["Global"], None, prog, by_module)
    value, n_calls = harness.load_reader(tmp_path, "made_up_flops_per_host_s")(ctx)
    assert value == pytest.approx(2 * 64 * 7 * 11 * 3 / host_s) and n_calls == 3


def test_an_optional_span_whose_module_or_function_the_program_lacks_is_left_out():
    model = Tiny()
    specs = {"other": {"module": "other"}, "stage": {"module": "depth_stage.head", "optional": True},
             "gone": {"function": "perfbench.lib.stats:no_such_function", "optional": True},
             "pkg": {"function": "no_such_package.ops:knn", "optional": True}}
    sp = spans.install(model, specs)
    try:
        assert sp.missing == ["stage", "gone", "pkg"]
        with torch.profiler.profile() as prof:
            model(torch.randn(2, 7))
    finally:
        sp.close()
    assert [e.name for e in prof.events()].count(OUTSIDE + "other") == 1
    assert not model.other._forward_pre_hooks and not model.other._forward_hooks


@pytest.mark.parametrize("spec", [{"module": "depth_stage.head"}, {"function": "perfbench.lib.stats:no_such_function"},
                                  {"function": "no_such_package.ops:knn"}])
def test_a_span_that_is_not_optional_and_that_the_program_lacks_is_an_error(spec):
    model = Tiny()
    with pytest.raises(LookupError, match="span gone"):
        spans.install(model, {"other": {"module": "other"}, "gone": spec})


def test_a_module_missing_under_the_named_one_is_not_taken_for_it(monkeypatch):
    """Only the named module's own absence marks a span missing; a module
    whose name is a prefix of it (`perfbench.lib.stat` of
    `perfbench.lib.stats`), or one it imports, raises as it is."""
    def fail(name):
        raise ModuleNotFoundError(f"No module named {name!r}", name="perfbench.lib.stat")

    monkeypatch.setattr(spans.importlib, "import_module", fail)
    with pytest.raises(ModuleNotFoundError):
        spans.install(Tiny(), {"gone": {"function": "perfbench.lib.stats:mean", "optional": True}})


def test_a_traced_run_reads_the_program_metrics_on_the_cpu():
    """The whole traced run at narrow widths on the CPU: the program opens
    its spans, so the four readers find their numbers (no device time here:
    the idle reading is the whole request)."""
    from conftest import TINY_CONFIG, tiny_traffic

    per_layer = [(name, "x") for name in READINGS]
    kept = {}
    res = harness.run(ROOT, TINY_CONFIG, tiny_traffic("forward", frames=8, height=32, width=32, queries=8), {},
                      per_layer, 5, 0.1, True, "cpu", time.perf_counter(), keep=kept)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == set(READINGS)
    assert got["syncs_per_request.serve"] >= 0 and got["upload_ms.serve"] > 0
    assert "spans_missing" not in res
    # program_spans.py reads the same run from what the harness kept.
    from perfbench.program_spans import reading

    read = reading(kept)
    assert read["requests"] == kept["requests"] == len(read["request_ms"])
    assert {"forward", "transformer", "encoder"} <= set(read["spans"])
    assert read["spans"]["forward"]["calls"] == 1
