"""Reading the program's own spans (`lib/program_trace.py`) on hand-made
records, and the benchmark's seven readers unmoved by them."""

import importlib.util
import json
import types
from pathlib import Path

import pytest
import torch

from perfbench.lib import counts, harness, program_trace, trace
from perfbench.lib.spans import PREFIX as OUTSIDE

ROOT = Path(__file__).resolve().parents[2]
P = program_trace.PREFIX


def _request():
    """One request over [0, 120] on host thread 1: predict > (upload, forward
    > (encode > encoder, window > transformer)); a launch in each of upload
    (a copy that ends after the range), encoder, window and transformer (one
    kernel ends after the range); a synchronize in upload and one in the
    encoder; a synchronous copy after predict."""
    return [
        ("host", OUTSIDE + "request", 0, 120, 0, 1),
        ("host", P + "predict", 1, 90, 0, 1),
        ("host", P + "upload", 2, 10, 0, 1),
        ("runtime", "cudaMemcpyAsync", 3, 4, 201, 1),
        ("runtime", "cudaStreamSynchronize", 4, 8, 0, 1),
        ("host", P + "forward", 12, 88, 0, 1),
        ("host", P + "encode", 13, 30, 0, 1),
        ("host", P + "encoder", 14, 29, 0, 1),
        ("runtime", "cudaLaunchKernel", 15, 16, 202, 1),
        ("runtime", "cudaStreamSynchronize", 20, 26, 0, 1),
        ("host", P + "window", 31, 80, 0, 1),
        ("runtime", "cudaLaunchKernel", 35, 36, 205, 1),
        ("host", P + "transformer", 40, 60, 0, 1),
        ("runtime", "cudaLaunchKernel", 41, 42, 203, 1),
        ("runtime", "cudaLaunchKernel", 50, 51, 204, 1),
        ("runtime", "cudaMemcpy", 92, 95, 0, 1),
        ("device", "Memcpy HtoD (Pageable -> Device)", 5, 15, 201, 7),
        ("device", "encoder_kernel", 16, 25, 202, 7),
        ("device", "window_kernel", 36, 38, 205, 7),
        ("device", "transformer_kernel", 42, 44, 203, 7),
        ("device", "transformer_kernel", 62, 64, 204, 7),
    ]


def test_device_time_self_time_and_idle_by_innermost_span():
    s = program_trace.summarize(_request(), [(0, 120)])
    spans = s["spans"]
    assert {k: v["calls"] for k, v in spans.items()} == {
        "predict": 1, "upload": 1, "forward": 1, "encode": 1, "encoder": 1, "window": 1, "transformer": 1}
    us = 1e-6
    want_device = {"upload": 10, "encoder": 9, "encode": 9, "transformer": 4, "window": 6, "forward": 15,
                   "predict": 25}
    want_self = {"upload": 10, "encoder": 9, "encode": 0, "transformer": 4, "window": 2, "forward": 0, "predict": 0}
    for name in want_device:
        assert spans[name]["device_s"] == pytest.approx(want_device[name] * us), name
        assert spans[name]["self_device_s"] == pytest.approx(want_self[name] * us), name
    assert spans["forward"]["host_s"] == pytest.approx(76 * us)
    # Kernels launched inside, the upload's copy left out.
    assert {k: v["launches"] for k, v in spans.items()} == {
        "predict": 4, "upload": 0, "forward": 4, "encode": 1, "encoder": 1, "window": 3, "transformer": 2}
    # Gaps 0-5 (mid 2.5, upload), 15-16 (encoder), 25-36 (mid 30.5, forward between encode and window),
    # 38-42 and 44-62 (transformer), 64-120 (mid 92, after predict: no program span).
    want_idle = {"upload": 5, "encoder": 1, "forward": 11, "transformer": 22}
    for name, v in spans.items():
        assert v["idle_s"] == pytest.approx(want_idle.get(name, 0) * us), name
    assert s["idle_s"] == pytest.approx(95 * us)
    assert s["idle_in_spans_s"] == pytest.approx(39 * us)


def test_blocking_calls_counted_once_by_innermost_span():
    s = program_trace.summarize(_request(), [(0, 120)])
    spans = s["spans"]
    assert [(n, c) for n, c, _, _ in s["blocking_calls"]] == [
        ("upload", "cudaStreamSynchronize"), ("encoder", "cudaStreamSynchronize"),
        (program_trace.OUTSIDE, "cudaMemcpy")]
    assert sum(v["blocking"] for v in spans.values()) == 2
    assert spans["encoder"]["blocking"] == 1 and spans["encoder"]["blocking_s"] == pytest.approx(6e-6)
    assert spans["forward"]["blocking"] == 0 and spans["predict"]["blocking"] == 0
    # The host waits inside the roots but outside upload: the encoder's synchronize alone.
    assert s["waits"] == 1 and s["host_wait_s"] == pytest.approx(6e-6)
    assert not program_trace.is_blocking("cudaMemcpyAsync") and program_trace.is_blocking("cudaMemcpy")
    assert not program_trace.is_blocking("cudaLaunchKernel")


def test_upload_ends_with_its_last_device_operation():
    s = program_trace.summarize(_request(), [(0, 120)])
    # Host range 2-10, its copy ends at 15.
    assert s["upload_s"] == pytest.approx(13e-6)
    # A copy that ends inside the range leaves the host end.
    recs = [("device", *r[1:3], 9, *r[4:]) if r[4] == 201 and r[0] == "device" else r for r in _request()]
    assert program_trace.summarize(recs, [(0, 120)])["upload_s"] == pytest.approx(8e-6)


def test_metrics_per_request_and_none_without_program_spans():
    recs = _request()
    shifted = [(k, n, s + 200, e + 200, c + 1000 if c else 0, t) for k, n, s, e, c, t in recs]
    s = program_trace.summarize(recs + shifted, [(0, 120), (200, 320)])
    m = program_trace.metrics(s)
    assert m == pytest.approx({"upload_ms.serve": 13e-3, "host_wait_ms.serve": 6e-3, "syncs_per_request.serve": 1.0,
                               "transformer_idle_ms.serve": 22e-3})
    plain = [r for r in recs if not r[1].startswith(P)]
    assert program_trace.metrics(program_trace.summarize(plain, [(0, 120)])) == {k: None for k in m}


def test_records_keep_program_range_annotations_apart_from_device_operations():
    def event(name, device, annotation, start=0.0, end=1.0, eid=1):
        return types.SimpleNamespace(name=name, device_type=types.SimpleNamespace(name=device),
                                     time_range=types.SimpleNamespace(start=start, end=end), id=eid, thread=1,
                                     is_user_annotation=annotation)

    prof = types.SimpleNamespace(events=lambda: [
        event(P + "transformer", "CUDA", True), event(P + "transformer", "CPU", True),
        event("gemm_kernel", "CUDA", False), event("cudaLaunchKernel", "CPU", False)])
    assert [r[0] for r in trace.records(prof)] == ["annotation", "host", "device", "runtime"]


def _load_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = {}
    for m in bench["per_layer"]:
        path = ROOT / "perfbench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("program_trace_reader_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = mod.read
    return out


def _outside_records():
    """A request with the benchmark's four outside spans, each launching one
    kernel, on which the program's ranges and their device annotations are
    laid."""
    o = OUTSIDE
    return [
        ("host", o + "request", 0, 100, 0, 1),
        ("host", o + "fnet", 5, 20, 0, 1),
        ("runtime", "cudaLaunchKernel", 6, 7, 301, 1),
        ("host", o + "knn", 22, 30, 0, 1),
        ("runtime", "cudaLaunchKernel", 23, 24, 302, 1),
        ("host", o + "corr", 32, 40, 0, 1),
        ("runtime", "cudaLaunchKernel", 33, 34, 303, 1),
        ("host", o + "updateformer", 45, 70, 0, 1),
        ("runtime", "cudaLaunchKernel", 46, 47, 304, 1),
        ("host", "aten::addmm", 48, 60, 0, 1),
        ("device", "conv_kernel", 8, 18, 301, 7),
        ("device", "knn_kernel", 25, 29, 302, 7),
        ("device", "corr_kernel", 35, 37, 303, 7),
        ("device", "gemm_kernel", 50, 66, 304, 7),
    ]


def _program_ranges():
    ranges = [("predict", 1, 95), ("forward", 2, 94), ("encode", 4, 21), ("encoder", 4.5, 20.5),
              ("window", 21, 90), ("correlation", 21.5, 41), ("knn", 21.8, 30.5), ("corr", 31.5, 40.5),
              ("transformer", 44, 71)]
    host = [("host", P + n, s, e, 0, 1) for n, s, e in ranges]
    return host + [("annotation", P + n, s + 3, e + 3, 0, 7) for n, s, e in ranges]


def test_the_seven_readers_read_the_same_with_the_program_spans():
    calls = {
        "knn": [{"args": [{"shape": (2, 64, 3)}, {"shape": (2, 8, 3)}, 4]}],
        "corr": [{"args": [{"shape": (2, 64, 16), "itemsize": 2}, {"shape": (2, 8, 16)}, {"shape": (2, 8, 4)}],
                  "kept": {2: torch.arange(64).reshape(2, 8, 4) % 64}}],
    }
    peaks = counts.peaks("NVIDIA H100 80GB HBM3")
    span_names = ["corr", "fnet", "knn", "updateformer"]
    read = {}
    for label, recs in (("outside", _outside_records()), ("with program", _outside_records() + _program_ranges())):
        summary = trace.summarize(recs, span_names, (0, 100))
        ctx = harness.TraceContext(summary, calls, 1, [150e-6], 2e6, peaks)
        read[label] = {name: reader(ctx) for name, reader in _load_readers().items()}
    assert len(read["outside"]) == 7 and all(v is not None for v in read["outside"].values())
    assert read["with program"] == read["outside"]
    # The program's spans give the same device time as their outside twins.
    prog = program_trace.summarize(_outside_records() + _program_ranges(), [(0, 100)])["spans"]
    outside = trace.summarize(_outside_records(), span_names, (0, 100))["span_device_s"]
    for mine, theirs in (("encoder", "fnet"), ("knn", "knn"), ("corr", "corr"), ("transformer", "updateformer")):
        assert prog[mine]["device_s"] == pytest.approx(outside[theirs])
