"""Faults planted in the timed path, to show that the check catches them.

Each is a breaker for `harness.run(breaker=...)`: it takes the request's
call, the model and the traffic mix and returns the call that the window
then drives. `perfbench/tests/test_perfbench_faults.py` runs each on the CPU
at narrow widths; `perfbench/control.py --faults` runs them at a cell's own
size on the card.
"""

from __future__ import annotations

import torch


def state_unchanged(call, model, traffic):
    """The update transformer's output dropped: every refinement step
    returns the coordinates and features it was given."""
    out_dim = model.updateformer.flow_head[-1].out_features

    def frozen(x, track_mask=None):
        return torch.zeros(*x.shape[:3], out_dim, device=x.device, dtype=x.dtype)

    model.updateformer.forward = frozen
    return call


def _left_out(call, keep: float):
    """Only the first `keep` share of the queries tracked; the rest answered
    with the tracked ones' answers, in turn."""
    def broken(x):
        n = x["queries"].shape[0]
        h = max(int(n * keep), 1)
        traj, vis = call(dict(x, queries=x["queries"][:h]))
        idx = torch.arange(n) % h
        return traj[:, idx], vis[:, idx]
    return broken


def half_left_out(call, model, traffic):
    """Half of the queries left out, answered with the other half's
    answers."""
    return _left_out(call, 0.5)


def quarter_left_out(call, model, traffic):
    """The last quarter of the queries left out, answered with the first
    quarter's answers: a fault that leaves the median gap where it was."""
    return _left_out(call, 0.75)


def answer_altered(call, model, traffic):
    """The window's first answer has its track points moved by 1 cm where
    they are produced; every other answer is the program's."""
    calls = []
    first_in_window = traffic["warmup_requests"] + 1

    def broken(x):
        traj, vis = call(x)
        calls.append(1)
        if len(calls) == first_in_window:
            traj = torch.where(traj != 0, traj + 0.01, traj)
        return traj, vis
    return broken


FAULTS = {f.__name__: f for f in (state_unchanged, half_left_out, quarter_left_out, answer_altered)}
