"""Port parity: the plain correlation of `mvtracker_torch.ops.corr` against
the JAX package's TPU kernel (`corr_select_pallas`, interpret mode) and its
gather path (`corr_sample(backend="gather")`), on the same numpy inputs; and
the gradients of `CorrSelect` against the kernel's `custom_vjp`."""

import jax
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


def test_corr_select_plain_rounds_fp32_targets_to_the_cloud_dtype(rng):
    """The tracker's bf16 call hands fp32 targets to a bf16 cloud: the plain
    version rounds them first, so it computes what the call with the targets
    cast beforehand computes, bit for bit (the kernel does the same)."""
    fvec, targets, idx = _inputs(rng, 2, 300, 32, 20, 8)
    idx[:, :, 0] = -1
    f = torch.from_numpy(fvec).bfloat16()
    t = torch.from_numpy(targets)
    i = torch.from_numpy(idx)
    got = t_corr.corr_select_plain(f, t, i)
    assert got.dtype == torch.float32
    assert torch.equal(got, t_corr.corr_select_plain(f, t.bfloat16(), i))
    assert torch.equal(got, t_corr.corr_select(f, t, i))
    # and it is not the fp32 product of the unrounded targets
    assert float((got - t_corr.corr_select_plain(f.float(), t, i)).abs().max()) > 1e-4


# The card the backward's tile plan is checked for: an H100 has 132 multiprocessors.
H100_SMS = 132


@pytest.mark.parametrize("b,p,c", [
    (12, 16384, 128), (12, 4096, 128), (12, 1024, 128), (12, 256, 128),  # the path's four levels
    (12, 281600, 128), (1, 1, 8), (2, 1001, 40), (200, 3, 256), (1, 100000, 4),
])
def test_corr_backward_plan(b, p, c):
    """Tiles cover every row once, fit shared memory with their copies, and at
    the path's levels give the card at least one block per multiprocessor."""
    rows, tiles, copies = t_corr.corr_backward_plan(b, p, c, H100_SMS)
    assert rows >= 1 and (tiles - 1) * rows < p <= tiles * rows
    covered = np.zeros(p, int)
    for t in range(tiles):
        covered[t * rows: min(p, (t + 1) * rows)] += 1
    assert (covered == 1).all()
    assert copies in (1, 2, 4, 8)
    assert copies * rows * c * 4 <= t_corr.CORR_BWD_TILE_BYTES
    assert t_corr.CORR_BWD_TILE_BYTES + 9 * 1024 <= 227 * 1024  # with the kernel's 8 KB of lists, in a block's 227 KB
    if c == 128 and p <= 16384:
        assert b * tiles >= H100_SMS


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


# Gradients. Measured gaps (seeds 0..2): d_targets 9.5e-7 to 1.4e-6 on values
# up to 15 (fp32 sums of k products in another order); d_fvec 0, in fp32 and
# with a bf16 cloud (both scatter-add in the same order here). The bf16
# d_fvec is an fp32 sum rounded once to bf16, so another summation order may
# move an entry by one bf16 step, 6.25e-2 at magnitudes 8..16: that is the
# bf16 tolerance.
GRAD_FP32_ATOL = 1e-5
GRAD_BF16_ATOL = 6.3e-2


def _grads_both(fvec, targets, idx, g, dtype):
    """(d_fvec, d_targets) from the JAX custom_vjp and from CorrSelect, for
    an fp32 call or the tracker's bf16 call (bf16 cloud, fp32 targets)."""
    bf16 = dtype == "bfloat16"
    jf = jnp.asarray(fvec, jnp.bfloat16 if bf16 else jnp.float32)
    jdt = jnp.bfloat16 if bf16 else None
    _, vjp = jax.vjp(
        lambda f, t: corr_select_pallas(f, t, jnp.asarray(idx, jnp.int32), None, 256, True, jdt),
        jf, jnp.asarray(targets),
    )
    want = vjp(jnp.asarray(g))
    tf = torch.from_numpy(fvec).to(torch.bfloat16 if bf16 else torch.float32).requires_grad_()
    tt = torch.from_numpy(targets).requires_grad_()
    out = t_corr.CorrSelect.apply(tf, tt, torch.from_numpy(idx), torch.bfloat16 if bf16 else None)
    (out * torch.from_numpy(g)).sum().backward()
    return want, (tf.grad, tt.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_select_gradients_match_pallas_vjp(rng, dtype):
    b, p, c, n, k = 2, 300, 32, 40, 8
    fvec, targets, idx = _inputs(rng, b, p, c, n, k)
    g = rng.normal(size=(b, n, k)).astype(np.float32)
    (want_f, want_t), (got_f, got_t) = _grads_both(fvec, targets, idx, g, dtype)
    # The forward too: CorrSelect gives the kernel's correlations.
    bf16 = dtype == "bfloat16"
    want = corr_select_pallas(jnp.asarray(fvec, jnp.bfloat16 if bf16 else jnp.float32), jnp.asarray(targets),
                              jnp.asarray(idx, jnp.int32), None, 256, True, jnp.bfloat16 if bf16 else None)
    got = t_corr.CorrSelect.apply(torch.from_numpy(fvec).to(torch.bfloat16 if bf16 else torch.float32),
                                  torch.from_numpy(targets), torch.from_numpy(idx), torch.bfloat16 if bf16 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_ATOL if bf16 else FP32_ATOL)
    # Each gradient has its own tensor's dtype: the cast sits inside.
    assert got_t.dtype == torch.float32 and want_t.dtype == jnp.float32
    assert got_f.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert want_f.dtype == (jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=GRAD_FP32_ATOL)
    atol = GRAD_BF16_ATOL if dtype == "bfloat16" else GRAD_FP32_ATOL
    np.testing.assert_allclose(got_f.float().numpy(), np.asarray(want_f, np.float32), atol=atol)
    if dtype == "bfloat16":
        # The backward multiplies g by the unrounded fp32 targets: an autograd
        # graph through targets.to(bf16) would give another d_fvec.
        rounded = torch.from_numpy(targets).bfloat16().float()
        alt, _ = t_corr.corr_select_backward_plain(
            torch.from_numpy(fvec).float(), rounded, torch.from_numpy(idx), torch.from_numpy(g)
        )
        exact, _ = t_corr.corr_select_backward_plain(
            torch.from_numpy(fvec).float(), torch.from_numpy(targets), torch.from_numpy(idx), torch.from_numpy(g)
        )
        assert float((alt - exact).abs().max()) > 1e-3
        np.testing.assert_allclose(got_f.float().numpy(), exact.numpy(), atol=GRAD_BF16_ATOL)


def test_corr_select_gradients_drop_out_of_range_indices(rng):
    b, p, c, n, k = 2, 50, 16, 10, 6
    fvec, targets, idx = _inputs(rng, b, p, c, n, k)
    idx[:, :, 0] = -1
    idx[:, :, 1] = p
    g = rng.normal(size=(b, n, k)).astype(np.float32)
    # The forward gives 0 at such an index, so its true gradient is none. The
    # JAX backward is asked with those neighbours taken out (index 0, g 0):
    # on the indices themselves its gather and scatter wrap -1 to the last
    # row, which the forward never read.
    idx_in, g_in = idx.copy(), g.copy()
    idx_in[:, :, :2] = 0
    g_in[:, :, :2] = 0
    (want_f, want_t), _ = _grads_both(fvec, targets, idx_in, g_in, "float32")
    _, (got_f, got_t) = _grads_both(fvec, targets, idx, g, "float32")
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=GRAD_FP32_ATOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=GRAD_FP32_ATOL)
    # Zeroing g at the dropped neighbours changes nothing.
    g0 = g.copy()
    g0[:, :, :2] = 0
    d_f, d_t = t_corr.corr_select_backward_plain(*map(torch.from_numpy, (fvec, targets, idx, g0)))
    np.testing.assert_array_equal(d_f.numpy(), got_f.numpy())
    np.testing.assert_array_equal(d_t.numpy(), got_t.numpy())
    # Rows no valid index names get exactly zero.
    hit = np.zeros((b, p), bool)
    for bi in range(b):
        hit[bi, idx[bi][(idx[bi] >= 0) & (idx[bi] < p)]] = True
    assert not got_f.numpy()[~hit].any()


def test_corr_select_backward_plain_finite_difference(rng):
    """Directional derivative of the plain forward in float64 against the
    plain backward: <g, corr(x + h d) - corr(x - h d)> / 2h = <grad, d>."""
    b, p, c, n, k = 2, 30, 8, 6, 5
    fvec, targets, idx = _inputs(rng, b, p, c, n, k)
    idx[0, 0, 0] = -1
    fvec, targets = torch.from_numpy(fvec).double(), torch.from_numpy(targets).double()
    idx = torch.from_numpy(idx)
    g = torch.from_numpy(rng.normal(size=(b, n, k)))
    d_f = torch.from_numpy(rng.normal(size=fvec.shape))
    d_t = torch.from_numpy(rng.normal(size=targets.shape))
    h = 1e-6
    plus = t_corr.corr_select_plain(fvec + h * d_f, targets + h * d_t, idx)
    minus = t_corr.corr_select_plain(fvec - h * d_f, targets - h * d_t, idx)
    assert plus.dtype == torch.float64
    numeric = float((g * (plus - minus)).sum() / (2 * h))
    grad_f, grad_t = t_corr.corr_select_backward_plain(fvec, targets, idx, g)
    assert grad_f.dtype == grad_t.dtype == torch.float64
    analytic = float((grad_f * d_f).sum() + (grad_t * d_t).sum())
    assert abs(numeric - analytic) <= 1e-7 * max(1.0, abs(analytic))


def test_cuda_backward_wrapper_rejects_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    i = torch.zeros(1, 4, 2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        t_corr.corr_select_backward_cuda(x, x, i, torch.zeros(1, 4, 2))
