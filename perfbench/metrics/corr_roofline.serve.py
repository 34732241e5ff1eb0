"""corr_roofline.serve (%): the least time the card could take for every
correlation call of the profiled requests, over the device time of the
kernels launched inside the `corr` span. A call's least time is its bytes
at the HBM peak, or its 2 B N K C operations at the fp32 peak where that is
larger: the distinct gathered rows of the cloud fvec [B, P, C] (counted
from the call's own indices), the fp32 targets [B, N, C], the int64 indices
and the fp32 output [B, N, K] (`perfbench/lib/counts.py`)."""

import torch

from perfbench.lib import counts


def read(t):
    calls = t.calls.get("corr")
    s = t.summary.get("span_device_s", {}).get("corr")
    if not calls or not s or not t.peaks:
        return None
    bound = 0.0
    for c in calls:
        fvec = c["args"][0]
        p, ch = fvec["shape"][1], fvec["shape"][2]
        idx = c["kept"][2]
        b, n, k = idx.shape
        flat = idx.long() + torch.arange(b, device=idx.device).view(b, 1, 1) * p
        rows = int(torch.unique(flat).numel())
        bound += counts.corr_bound_s(rows, ch, fvec["itemsize"], b, n, k, t.peaks)
    return 100.0 * bound / s
