"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import numpy as np
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


def to_device_fp32(x, device) -> torch.Tensor:
    """`x` (a tensor, or an array `np.asarray` takes) on `device` as fp32:
    moved at its own width, then widened on the device. uint8 frames and
    fp16 depths cross the bus at a quarter or half of fp32's bytes, and a
    pinned source is copied as it is; a cast on the host first would fill a
    fresh pageable buffer. The widening rounds as the host's would (uint8 is
    exact, float64 rounds to nearest). An fp32 tensor already on `device`
    comes back as it is."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))  # from_numpy refuses negative strides
    return x.to(device).float()


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
