"""transformer_ms.serve (ms): device time a request of the kernels launched
inside the `updateformer` span (every call of the update transformer)."""


def read(t):
    s = t.summary.get("span_device_s", {}).get("updateformer")
    if not s or not t.requests:
        return None
    return 1e3 * s / t.requests
