"""syncs_per_request.serve (calls): the number of blocking calls that
`host_wait_ms.serve` times, a request: a count, the same in every run of
one program (`lib/program_trace.py`). None where the program opens no root
span."""

from perfbench.lib import program_trace


def read(t):
    if not t.program:
        return None
    return program_trace.metrics(t.program)["syncs_per_request.serve"]
