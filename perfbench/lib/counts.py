"""Operations, bytes and peaks: the yardstick of the roofline and MFU
metrics.

Copied from the port's measurement scripts so that a later change to them
cannot move the yardstick:
- `knn_operations`, `corr_operations` and the `FlopCounterMode` count of
  `forward_flops` from `bench_torch.py`;
- the kNN bound (9 fp32 operations per (query, point) pair against the
  bytes read and written) and the correlation bound (the distinct gathered
  rows, the other reads and the dense writes) from `chip_smoke.py` phase 2;
- the dense bf16 peak from `scripts/timing_torch.py`, with the fp32 and
  HBM peaks of the same data sheet (`chip_smoke.py`).
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM part, dense rates without sparsity,
# by the name `torch.cuda.get_device_name` gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def knn_operations(b: int, n: int, m: int) -> int:
    """9 operations per (query, point) pair: 3 subtractions, 3 products, 2
    sums and a compare."""
    return 9 * b * n * m


def knn_bytes(b: int, n: int, m: int, k: int) -> int:
    """Each input read once (fp32 ref [B, N, 3] and queries [B, M, 3]) and
    each output written once (fp32 distances and int64 indices [B, M, k])."""
    return (b * n * 3 + b * m * 3) * 4 + b * m * k * (4 + 8)


def knn_bound_s(b: int, n: int, m: int, k: int, pk: dict) -> float:
    return max(knn_operations(b, n, m) / pk["fp32_flops"], knn_bytes(b, n, m, k) / pk["hbm_bytes_per_s"])


def corr_operations(b: int, n: int, k: int, c: int) -> int:
    """2 * C operations per neighbour: a product and a sum per channel."""
    return 2 * b * n * k * c


def corr_bytes(distinct_rows: int, c: int, row_bytes: int, b: int, n: int, k: int) -> int:
    """The distinct gathered rows of the cloud, the fp32 targets [B, N, C],
    the int64 indices and the fp32 output [B, N, K]."""
    return distinct_rows * c * row_bytes + b * n * c * 4 + b * n * k * 8 + b * n * k * 4


def corr_bound_s(distinct_rows: int, c: int, row_bytes: int, b: int, n: int, k: int, pk: dict) -> float:
    return max(corr_operations(b, n, k, c) / pk["fp32_flops"],
               corr_bytes(distinct_rows, c, row_bytes, b, n, k) / pk["hbm_bytes_per_s"])
