"""encoder_ms.serve (ms): device time a request of the kernels launched
inside the `fnet` span (the convolutional encoder over every frame)."""


def read(t):
    s = t.summary.get("span_device_s", {}).get("fnet")
    if not s or not t.requests:
        return None
    return 1e3 * s / t.requests
