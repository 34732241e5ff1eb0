"""PyTorch/CUDA port of the multi-view 3D point tracker.

The package mirrors the module layout of `mvtracker_tpu` (the JAX reference)
so that each function has an obvious counterpart there: `utils/geometry.py`,
`utils/embeddings.py`, `ops/knn.py`, `ops/corr.py`, `models/encoder.py`,
`models/updateformer.py`, `models/mvtracker.py` and `convert.py`. The two
hot operations of the forward, the kNN search and the neighbour correlation,
run as hand-written CUDA kernels (`csrc/*.cu`) on an NVIDIA GPU and as plain
PyTorch on the CPU.

Nothing here imports JAX or the JAX package.
"""

from mvtracker_torch.device import resolve_device

__all__ = ["resolve_device"]
