"""upload_ms.serve (ms): a request's time in the program's `upload` spans
(`mvtracker::upload`, where the inputs cross to the card), each from its
start on the host to the later of its end and the end of the last device
operation launched inside it, so that moving the copy or the cast between
host and card cannot hide it (`lib/program_trace.py`). Read on the traced
requests, which run slower than plain ones; None where the program opens no
`upload` span."""

from perfbench.lib import program_trace


def read(t):
    if not t.program:
        return None
    return program_trace.metrics(t.program)["upload_ms.serve"]
