"""knn_roofline.serve (%): the least time the card could take for every kNN
call of the profiled requests, over the device time of the kernels launched
inside the `knn` span. A call's least time is the larger of 9 B N M fp32
operations at the fp32 peak and its bytes (each input read once, each
output written once) at the HBM peak (`perfbench/lib/counts.py`), from the
call's shapes: ref [B, N, 3], query [B, M, 3], k."""

from perfbench.lib import counts


def read(t):
    calls = t.calls.get("knn")
    s = t.summary.get("span_device_s", {}).get("knn")
    if not calls or not s or not t.peaks:
        return None
    bound = 0.0
    for c in calls:
        (b, n, _), (_, m, _), k = c["args"][0]["shape"], c["args"][1]["shape"], c["args"][2]
        bound += counts.knn_bound_s(b, n, m, k, t.peaks)
    return 100.0 * bound / s
