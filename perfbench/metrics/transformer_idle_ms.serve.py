"""transformer_idle_ms.serve (ms): the card's idle time a request whose
midpoint falls inside the program's `transformer` span as the innermost
program span: the eager dispatch of the update transformer, which its
device time (`transformer_ms.serve`) cannot see (`lib/program_trace.py`).
Traced requests run 1.1 to 2.6 times as long as plain ones on the host, so
this overstates what dispatch costs a plain request; it compares two
programs, traced alike. None where the program opens no `transformer`
span."""

from perfbench.lib import program_trace


def read(t):
    if not t.program:
        return None
    return program_trace.metrics(t.program)["transformer_idle_ms.serve"]
