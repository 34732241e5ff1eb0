"""depth_estimator_ms.serve (ms): device time a request under the program's
`depth_estimator` span (`mvtracker::depth_estimator`: VGGT's patch embed,
rounds and heads, and the alignment of its depth to the rig), the union of
the device operations launched inside it (`lib/program_trace.py`). None
where the program opens no such span (no depth stage, or a program without
one)."""


def read(t):
    spans = (t.program or {}).get("spans", {})
    if "depth_estimator" not in spans or not t.requests:
        return None
    return 1e3 * spans["depth_estimator"]["device_s"] / t.requests
