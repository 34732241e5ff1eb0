"""PyTorch/CUDA port of the multi-view 3D point tracker.

The package mirrors the module layout of `mvtracker_tpu` (the JAX reference)
so that each function has an obvious counterpart there: `utils/geometry.py`,
`utils/embeddings.py`, `ops/knn.py`, `ops/corr.py`, `models/encoder.py`,
`models/updateformer.py`, `models/mvtracker.py`, `training/losses.py`,
`training/step.py`, `training/train.py`, `datasets/` and `convert.py`. The
hot operations of the forward and the backward, the kNN search, the
neighbour correlation and its gradient, run as hand-written CUDA kernels
(`csrc/*.cu`) on an NVIDIA GPU and as plain PyTorch on the CPU.

Nothing here imports JAX or the JAX package.
"""

from mvtracker_torch.device import resolve_device

__all__ = ["resolve_device"]
