"""Port parity: the plain correlation of `mvtracker_torch.ops.corr` against
the JAX package's TPU kernel (`corr_select_pallas`, interpret mode) and its
gather path (`corr_sample(backend="gather")`), on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.ops import corr as t_corr
from mvtracker_tpu.ops import corr as j_corr
from mvtracker_tpu.ops.corr_pallas import corr_select_pallas

# fp32 sums of C products in another order.
FP32_ATOL = 1e-4
# bf16 inputs, fp32 products and sums on both sides: only the order differs.
BF16_ATOL = 1e-3


def _inputs(rng, b, p, c, n, k):
    fvec = rng.normal(size=(b, p, c)).astype(np.float32)
    targets = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, p, size=(b, n, k))
    return fvec, targets, idx


def test_gather_neighbors(rng):
    fvec, _, idx = _inputs(rng, 2, 50, 7, 9, 4)
    want = j_corr.gather_neighbors(jnp.asarray(fvec), jnp.asarray(idx, jnp.int32))
    got = t_corr.gather_neighbors(torch.from_numpy(fvec), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_select_matches_pallas_kernel(rng, dtype):
    b, p, c, n, k = 2, 700, 32, 60, 8
    fvec, targets, idx = _inputs(rng, b, p, c, n, k)
    idx[:, :, -1] = -1  # padding index -> 0 in both
    jdt = None if dtype == "float32" else jnp.bfloat16
    want = corr_select_pallas(
        jnp.asarray(fvec), jnp.asarray(targets), jnp.asarray(idx, jnp.int32), None, 256, True, jdt
    )
    tdt = getattr(torch, dtype)
    got = t_corr.corr_select(
        torch.from_numpy(fvec).to(tdt), torch.from_numpy(targets).to(tdt), torch.from_numpy(idx)
    )
    assert got.dtype == torch.float32 and got.shape == (b, n, k)
    assert torch.all(got[:, :, -1] == 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL if jdt is None else BF16_ATOL)


@pytest.mark.parametrize("groups,add_xyz", [(1, False), (1, True), (2, False)])
def test_corr_sample_matches_gather_path(rng, groups, add_xyz):
    b, p, c, n, k = 2, 300, 16, 20, 4
    fvec, targets, idx = _inputs(rng, b, p, c, n, k)
    xyz = rng.normal(size=(b, p, 3)).astype(np.float32)
    coords = rng.normal(size=(b, n, 3)).astype(np.float32)
    kw = dict(groups=groups, add_neighbor_offset=True, add_neighbor_xyz=add_xyz)
    want = j_corr.corr_sample(
        *map(jnp.asarray, (xyz, fvec, targets, coords)), jnp.asarray(idx, jnp.int32), backend="gather", **kw
    )
    got = t_corr.corr_sample(*map(torch.from_numpy, (xyz, fvec, targets, coords, idx)), **kw)
    assert tuple(got.shape) == want.shape == (b, n, k, groups + 3 + 3 * add_xyz)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)


def test_cuda_wrapper_rejects_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        t_corr.corr_select_cuda(x, x, torch.zeros(1, 4, 2, dtype=torch.int64))


def test_corr_sample_bf16_stream_matches_pallas_path(rng):
    """The tracker's bf16 call: cloud features stored bf16, fp32 targets
    streamed in bf16 (`compute_dtype`), as the JAX package's kernel path.
    Both sides round the same inputs to bf16 and sum exact products in fp32,
    so they agree to fp32 rounding (reading: 1.2e-7 on values up to 2.8;
    streaming the targets in fp32 moves the output by 6.0e-3)."""
    b, p, c, n, k = 2, 300, 32, 20, 4
    fvec, targets, idx = _inputs(rng, b, p, c, n, k)
    xyz = rng.normal(size=(b, p, 3)).astype(np.float32)
    coords = rng.normal(size=(b, n, 3)).astype(np.float32)
    want = j_corr.corr_sample(
        jnp.asarray(xyz), jnp.asarray(fvec, jnp.bfloat16), jnp.asarray(targets), jnp.asarray(coords),
        jnp.asarray(idx, jnp.int32), backend="pallas_interpret", compute_dtype=jnp.bfloat16,
    )
    args = (torch.from_numpy(xyz), torch.from_numpy(fvec).bfloat16(), torch.from_numpy(targets),
            torch.from_numpy(coords), torch.from_numpy(idx))
    got = t_corr.corr_sample(*args, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (b, n, k, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # Streaming the targets in fp32 instead is a visible change.
    fp32_stream = t_corr.corr_sample(*args)
    assert float((fp32_stream - got).abs().max()) > 1e-4
