"""launches_per_request.serve (launches): kernels that ran on the card in
the profiled requests, over their number (copies and memsets left out)."""


def read(t):
    kernels = t.summary.get("kernels")
    if not kernels or not t.requests:
        return None
    return kernels / t.requests
