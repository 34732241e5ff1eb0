"""host_wait_ms.serve (ms): a request's host time in calls that stop the
host until the card has caught up (a synchronize, or a copy without
`Async`), inside the program's root spans (`predict`, `forward`) and outside
`upload`: the host standing still when it could queue work
(`lib/program_trace.py`). Read on the traced requests; None where the
program opens no root span."""

from perfbench.lib import program_trace


def read(t):
    if not t.program:
        return None
    return program_trace.metrics(t.program)["host_wait_ms.serve"]
