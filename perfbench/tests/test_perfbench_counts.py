"""The yardstick's arithmetic: operation and byte counts, order statistics,
the busy union, and the trace reading, on hand-made inputs."""

import numpy as np
import pytest
import torch

from perfbench.lib import counts, stats, trace
from perfbench.lib.spans import PREFIX

H100 = counts.peaks("NVIDIA H100 80GB HBM3")


def test_knn_counts_by_hand():
    # B=2 clouds of N=5 points, M=3 queries, k=2.
    assert counts.knn_operations(2, 5, 3) == 9 * 2 * 5 * 3
    assert counts.knn_bytes(2, 5, 3, 2) == (2 * 5 * 3 + 2 * 3 * 3) * 4 + 2 * 3 * 2 * 12
    # Large clouds are bound by operations, tiny ones by bytes.
    b, n, m, k = 12, 16384, 2048, 16
    assert counts.knn_bound_s(b, n, m, k, H100) == pytest.approx(9 * b * n * m / 67e12)
    assert counts.knn_bound_s(1, 4, 1, 32, H100) == pytest.approx(counts.knn_bytes(1, 4, 1, 32) / 3.35e12)


def test_corr_counts_by_hand():
    assert counts.corr_operations(2, 3, 4, 8) == 2 * 2 * 3 * 4 * 8
    # 7 distinct bf16 rows of 8 channels, fp32 targets [2, 3, 8], int64 idx and fp32 out [2, 3, 4].
    assert counts.corr_bytes(7, 8, 2, 2, 3, 4) == 7 * 8 * 2 + 2 * 3 * 8 * 4 + 2 * 3 * 4 * 8 + 2 * 3 * 4 * 4
    assert counts.corr_bound_s(7, 8, 2, 2, 3, 4, H100) == pytest.approx(counts.corr_bytes(7, 8, 2, 2, 3, 4) / 3.35e12)


def test_flop_counter_counts_a_linear_as_two_flops_a_mac():
    from torch.utils.flop_counter import FlopCounterMode

    x, w = torch.randn(5, 7), torch.randn(11, 7)
    with FlopCounterMode(display=False) as c:
        torch.nn.functional.linear(x, w)
    assert c.get_total_flops() == 2 * 5 * 7 * 11


def test_percentile_matches_numpy():
    xs = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.3, 5.8, 9.7, 9.3]
    for q in (0, 50, 90, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))
    assert stats.percentile([7.0], 90) == 7.0


def test_busy_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.busy_union(iv) == pytest.approx(5.0)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert stats.gaps([], 1, 2) == [(1, 2)]


def _recs():
    """Two spans on the host: knn launches kernels 1 and 2, corr kernel 3; a
    copy with no launch inside a span; a gap while the host sits in aten::cat."""
    span = PREFIX
    return [
        ("host", span + "request", 0, 100, 0, 1),
        ("host", span + "knn", 10, 20, 0, 1),
        ("runtime", "cudaLaunchKernel", 11, 12, 101, 1),
        ("runtime", "cudaLaunchKernel", 15, 16, 102, 1),
        ("host", span + "corr", 30, 40, 0, 1),
        ("runtime", "cuLaunchKernel", 31, 32, 103, 1),
        ("host", "aten::cat", 50, 80, 0, 1),
        ("runtime", "cudaMemcpyAsync", 81, 82, 104, 1),
        ("device", "knn_kernel", 20, 30, 101, 7),
        ("device", "knn_kernel", 30, 35, 102, 7),
        ("device", "corr_kernel", 40, 44, 103, 7),
        ("device", "Memcpy HtoD (Pinned -> Device)", 85, 95, 104, 7),
    ]


def test_summarize_by_runtime_link():
    s = trace.summarize(_recs(), ["knn", "corr"], (0, 100))
    assert s["linked_share"] == 1.0
    assert s["device_ops"] == 4 and s["kernels"] == 3
    assert s["busy_s"] == pytest.approx(29e-6)
    assert s["span_device_s"]["knn"] == pytest.approx(15e-6)
    assert s["span_device_s"]["corr"] == pytest.approx(4e-6)
    names = dict(s["breakdown"]["device_ops"])
    assert names["knn_kernel"] == pytest.approx(15e-6)
    idle = dict(s["breakdown"]["idle_gaps"])
    # Gaps: 0-20 (host in knn at 10), 35-40 (corr at 37.5), 44-85 (aten::cat at 64.5), 95-100
    # (request at 97.5).
    assert idle[span_name("knn")] == pytest.approx(20e-6)
    assert idle[span_name("corr")] == pytest.approx(5e-6)
    assert idle["aten::cat"] == pytest.approx(41e-6)
    assert idle[span_name("request")] == pytest.approx(5e-6)


def span_name(n):
    return PREFIX + n


def test_summarize_leaves_unlinked_operations_out_of_spans():
    recs = [r for r in _recs() if not (r[0] == "runtime" and r[4] == 102)]
    s = trace.summarize(recs, ["knn", "corr"], (0, 100))
    assert s["linked_share"] == pytest.approx(3 / 4)
    assert s["span_device_s"]["knn"] == pytest.approx(10e-6)
