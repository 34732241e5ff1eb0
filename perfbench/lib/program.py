"""The system under test: the port's model built from a configuration file,
and the call a request makes, from a traffic mix's `entry` and `options`.

- The model is `MVTracker` built with every key of the configuration's
  `widths`, so a key it does not take raises rather than being dropped.
- "forward": `model(rgbs, depths, queries, intrs, extrs, **options)`;
- "predictor": `EvaluationPredictor(model, **options)` called on the same
  inputs.

The inputs are host tensors (pinned in the timed runs); a request ends when
`traj` and `vis` are back on the host.
"""

from __future__ import annotations

import torch


def build_model(config: dict, device):
    from mvtracker_torch.models.mvtracker import MVTracker

    return MVTracker(**config["widths"], compute_dtype=config["compute_dtype"], device=device).eval()


def state_shapes(model) -> dict:
    return {name: tuple(t.shape) for name, t in model.state_dict().items()}


def build_call(model, traffic: dict):
    """The request's call: inputs dict of host tensors -> (traj, vis) on the
    host."""
    options = traffic["options"]
    if traffic["entry"] == "forward":
        def call(x):
            with torch.no_grad():
                out = model(x["rgbs"], x["depths"], x["queries"], x["intrs"], x["extrs"], **options)
            return out["traj"].cpu(), out["vis"].cpu()
        return call
    if traffic["entry"] == "predictor":
        from mvtracker_torch.evaluation.predictor import EvaluationPredictor

        pred = EvaluationPredictor(model, **options)

        def call(x):
            with torch.no_grad():
                out = pred(x["rgbs"], x["depths"], x["queries"], x["intrs"], x["extrs"])
            return out["traj"].cpu(), out["vis"].cpu()
        return call
    raise ValueError(f"unknown entry {traffic['entry']!r}")
