"""device_idle_share.serve (%): the share of a request in which the card
runs nothing. 100 * (1 - device busy time a request / mean request time):
the busy time is the union of the device operations' intervals in the
profiled requests, divided by their number; the request time is the mean
of the window's requests, timed before the profiler started (tracing slows
the host)."""


def read(t):
    busy = t.summary.get("busy_s")
    if not busy or not t.plain_request_s or not t.requests:
        return None
    mean = sum(t.plain_request_s) / len(t.plain_request_s)
    return 100.0 * (1.0 - busy / t.requests / mean)
