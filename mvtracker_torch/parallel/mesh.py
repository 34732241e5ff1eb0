"""A ("data", "model") process mesh over `torch.distributed`, counterpart of
`mvtracker_tpu/parallel/mesh.py`.

The JAX package shards inside one process: XLA's SPMD partitioner splits
arrays over a device mesh and inserts the collectives. The port runs one
process per device instead, and each process holds only its own part:

- ``data``: scenes. Each data coordinate trains on its own scenes
  (`shard_batch_pytree`, or the loader's per-process stride), and the
  gradients are summed over the world (`training/step.py`).
- ``model``: work inside a scene. The ranks of one model group see the same
  scenes and split the views during encoding (`shard_views`), the tracks
  through the correlation stage (`shard_tracks`) or a level's cloud in the
  kNN (`MVTracker(knn_mesh=)`, `ops/knn.py::knn_sharded`).

Ranks lie on the mesh as JAX lays devices out, `arange(world).reshape(
n_data, n_model)`. The JAX module's `batch_sharding` and `replicated` name
XLA shardings, which have no counterpart here, and are left out.

The collectives below take a process group. A gloo group moves CUDA tensors
through host memory: PyTorch's gloo backend runs point-to-point and
all-gather on CPU tensors only (its all-reduce and broadcast take CUDA
tensors too), so, one rule for all, every collective of a gloo group on CUDA
tensors copies them to the host, runs there and copies the result back.
That is how several processes on one card exchange data (NCCL admits one
rank per device). An NCCL group takes the tensors where they are.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")


class Mesh:
    """This process's place on an (n_data, n_model) mesh of the world.

    `shape` is {"data": n_data, "model": n_model}, as a JAX `Mesh` has it;
    `coords` this rank's {"data": i, "model": j}; `group(axis)` the process
    group of the ranks that share this rank's other coordinate. Collectives
    over every rank use the default group, whose backend is the mesh's."""

    def __init__(self, n_data: int, n_model: int, backend: str, groups: dict):
        self.shape = {"data": n_data, "model": n_model}
        self.backend = backend
        self.rank = dist.get_rank()
        self.coords = {"data": self.rank // n_model, "model": self.rank % n_model}
        self._groups = groups

    def group(self, axis: str):
        if axis not in AXES:
            raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, backend={self.backend!r}, coords={self.coords})"


def make_mesh(n_data: int | None = None, n_model: int = 1, *, backend: str) -> Mesh:
    """Build the mesh over the initialised default process group.

    `backend` ("gloo" or "nccl") is the caller's choice for the mesh's
    groups and is never changed here; it must be the default group's. Every
    rank must call this, with the same arguments: each creates every group,
    in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    if backend != dist.get_backend():
        raise ValueError(f"mesh backend {backend!r} differs from the default group's {dist.get_backend()!r}")
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the world of {n} processes")
    ranks = np.arange(n).reshape(n_data, n_model)
    rank = dist.get_rank()
    groups = {}
    for axis, lines in (("data", ranks.T), ("model", ranks)):
        for line in lines:
            group = dist.new_group([int(r) for r in line], backend=backend)
            if rank in line:
                groups[axis] = group
    return Mesh(n_data, n_model, backend, groups)


def shard_batch_pytree(batch, mesh: Mesh):
    """This rank's slice of the leading scene axis of every array in a dict
    (or list, tuple) of arrays: the scenes of its data coordinate. The scene
    count must divide over the data axis."""
    n_data, i = mesh.shape["data"], mesh.coords["data"]

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        if getattr(x, "ndim", 0) == 0:
            return x
        if len(x) % n_data:
            raise ValueError(f"{len(x)} scenes do not divide over {n_data} data ranks")
        per = len(x) // n_data
        return x[i * per : (i + 1) * per]

    return take(batch)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _via_host(tensor: torch.Tensor, group) -> bool:
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(tensor: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `tensor` over `group`; returns it."""
    if _via_host(tensor, group):
        host = tensor.cpu()
        dist.all_reduce(host, op=op, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, op=op, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's `tensor` (all of one shape), in group-rank order."""
    tensor = tensor.contiguous()
    src = tensor.cpu() if _via_host(tensor, group) else tensor
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(tensor.device) for p in parts]


def broadcast(tensor: torch.Tensor, src: int, group) -> torch.Tensor:
    """In-place broadcast from the global rank `src`; returns `tensor`."""
    if _via_host(tensor, group):
        host = tensor.cpu()
        dist.broadcast(host, src=src, group=group)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, src=src, group=group)
    return tensor


def ring_shift(tensor: torch.Tensor, group) -> torch.Tensor:
    """Send `tensor` to the next rank of the group and return the previous
    rank's (all of one shape), group-rank order wrapping around."""
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    nxt, prv = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]
    send = tensor.contiguous()
    if _via_host(send, group):
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, nxt, group=group), dist.P2POp(dist.irecv, recv, prv, group=group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(tensor.device)


def split_sizes(n: int, parts: int) -> list[int]:
    """The sizes of `torch.tensor_split` of n items into `parts`."""
    return [len(c) for c in np.array_split(np.arange(n), parts)]


class _GatherCat(torch.autograd.Function):
    """Concatenate every rank's slice along `dim` (slices of `sizes`).

    The backward sums the output's gradient over the group and returns this
    rank's slice of the sum: the gradient of the sum of the ranks' losses.
    When every rank computes the same loss from the gathered tensor, each
    scales its loss by 1 / group size for the gradients to be those of one
    loss (`training/step.py` does). `torch.distributed.nn.functional.
    all_gather` has that backward too, but takes the default group's rank
    for the group's and goes through an all-to-all that gloo lacks."""

    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        width = max(sizes)
        pad = list(x.shape)
        pad[dim] = width - x.shape[dim]
        padded = torch.cat([x, x.new_zeros(pad)], dim) if pad[dim] else x
        parts = all_gather(padded, group)
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce(grad.contiguous().clone(), ctx.group)
        me = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, sum(ctx.sizes[:me]), ctx.sizes[me]), None, None, None


def gather_cat(x: torch.Tensor, group, dim: int, sizes: list[int]) -> torch.Tensor:
    """Differentiable concatenation of the group's slices along `dim`; this
    rank's `x` holds `sizes[rank in group]` entries there."""
    return _GatherCat.apply(x, group, dim, list(sizes))
