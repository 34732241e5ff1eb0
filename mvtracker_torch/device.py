"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def fp32_precision(exact: bool):
    """Within the block, with `exact`, fp32 convolutions and matmuls on the
    GPU round as fp32: TF32 off for cuDNN (on by default in PyTorch, which
    puts the encoder's feature maps about 1e-3 off) and for matmuls. Without
    `exact` the process's settings stay. They are restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if exact:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
