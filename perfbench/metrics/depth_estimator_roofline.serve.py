"""depth_estimator_roofline.serve (%): the depth stage's operations a request
(`FlopCounterMode`'s count under the module `MVTracker.depth_estimator`:
VGGT's matmuls, convolutions and attention) over its device time a request
(`depth_estimator_ms.serve`), against the card's dense bf16 peak
(`lib/counts.py`). None where the span, the module's count or the peak is
missing."""


def read(t):
    spans = (t.program or {}).get("spans", {})
    ops = (t.flops_by_module or {}).get("MVTracker.depth_estimator")
    if "depth_estimator" not in spans or not ops or not t.peaks or not t.requests:
        return None
    device_s = spans["depth_estimator"]["device_s"] / t.requests
    if not device_s:
        return None
    return 100.0 * ops / device_s / t.peaks["bf16_flops"]
