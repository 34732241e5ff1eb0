"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a `torch.device`; raise if it asks for CUDA and
    there is none.

    Entry points default to the GPU and never fall back to the CPU on their
    own: a caller who wants the CPU (the tests) says so.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return device
