"""Port parity: the plain kNN versions of `mvtracker_torch.ops.knn` against
the JAX package's three TPU kernels (`knn_pallas_fused`, `knn_pallas_packed`
and `knn_pallas`, interpret mode) and `knn_reference`, on the same numpy
inputs (CPU).

Distances and neighbour sets are compared, not tie order. Both JAX
versions compute d^2 by the centred expansion |q|^2 - 2 q.r + |r|^2, whose
absolute error is about eps_fp32 * |p - centre|^2 (< 1e-5 for these unit
clouds), and the fused kernel also truncates d^2 to its packed key (<=
2^-12 relative). So squared distances are compared with D2_RTOL and
D2_ATOL, and neighbour sets may differ only where the k-th and (k+1)-th
d^2 lie within that tolerance of each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtracker_torch.ops import knn as t_knn
from mvtracker_tpu.ops import knn as j_knn

D2_RTOL = 2.0**-11  # the packed-key truncation (2^-12), doubled for margin
D2_ATOL = 1e-5  # the expansion's cancellation


def _check(ref, query, k, jd, ji, backend="auto"):
    """The port's plain kNN against JAX's (dists, idx) on the same input."""
    td, ti = t_knn.knn(torch.from_numpy(ref), torch.from_numpy(query), k, backend=backend)
    assert td.shape == ji.shape and ti.dtype == torch.int64
    np.testing.assert_allclose(td.numpy() ** 2, np.asarray(jd) ** 2, rtol=D2_RTOL, atol=D2_ATOL)
    n = ref.shape[1]
    same = np.all(np.sort(ti.numpy(), -1) == np.sort(np.asarray(ji), -1), axis=-1)
    if k < n:
        d1, _ = t_knn.knn_plain(torch.from_numpy(ref), torch.from_numpy(query), k + 1)
        d2 = d1.numpy() ** 2
        same |= (d2[..., k] - d2[..., k - 1]) <= 2 * (D2_ATOL + D2_RTOL * d2[..., k])
    assert np.all(same), "neighbour sets differ beyond near-ties"


@pytest.mark.parametrize("b,n,m,k", [(2, 2048, 128, 8), (3, 700, 90, 1), (1, 1500, 64, 8)])
def test_plain_matches_fused_kernel(rng, b, n, m, k):
    ref = rng.normal(size=(b, n, 3)).astype(np.float32)
    query = rng.normal(size=(b, m, 3)).astype(np.float32)
    chunk = 4096 if n >= 4096 else max(512, 1 << (n - 1).bit_length())  # the JAX dispatch
    jd, ji = j_knn.knn_pallas_fused(jnp.asarray(ref), jnp.asarray(query), k, chunk=chunk, interpret=True)
    _check(ref, query, k, jd, ji)


@pytest.mark.parametrize("b,n,m,k", [(2, 1500, 100, 8), (1, 700, 30, 1), (1, 2048, 64, 16)])
def test_plain_matches_packed_kernel(rng, b, n, m, k):
    """`backend="tiled"` on the CPU against the TPU kernel it replaces, with
    the cloud spread over several of that kernel's reference tiles."""
    ref = rng.normal(size=(b, n, 3)).astype(np.float32)
    query = rng.normal(size=(b, m, 3)).astype(np.float32)
    jd, ji = j_knn.knn_pallas_packed(
        jnp.asarray(ref), jnp.asarray(query), k, query_tile=128, ref_tile=512, interpret=True
    )
    _check(ref, query, k, jd, ji, backend="tiled")


@pytest.mark.parametrize("b,n,m,k", [(2, 1300, 70, 8), (1, 600, 33, 1)])
def test_exact_matches_streaming_kernel(rng, b, n, m, k):
    """`backend="exact"` on the CPU against the TPU kernel it replaces. Some
    reference points are planted twice and a query sits on one of them:
    both put the lower index first among equal distances."""
    ref = rng.normal(size=(b, n, 3)).astype(np.float32)
    query = rng.normal(size=(b, m, 3)).astype(np.float32)
    ref[:, 900 % n] = ref[:, 40]
    ref[:, 555] = ref[:, 40]
    query[:, 0] = ref[:, 40] + np.float32(1e-3)
    jd, ji = j_knn.knn_pallas(jnp.asarray(ref), jnp.asarray(query), k, query_tile=128, ref_tile=512, interpret=True)
    _check(ref, query, k, jd, ji, backend="exact")
    td, ti = t_knn.knn(torch.from_numpy(ref), torch.from_numpy(query), k, backend="exact")
    want = sorted([40, 555, 900 % n])[:k]
    assert ti[:, 0, : len(want)].tolist() == [want] * b == np.asarray(ji)[:, 0, : len(want)].tolist()
    assert bool((td[:, 0, : len(want)] == td[:, 0, :1]).all())


def test_exact_plain_is_a_stable_sort(rng):
    """Indices of the exact version equal a stable argsort of the same fp32
    d^2, on a lattice cloud where most distances tie; chunking the queries
    changes nothing; k > N fills."""
    ref = rng.integers(0, 3, size=(2, 200, 3)).astype(np.float32)
    query = rng.integers(0, 3, size=(2, 31, 3)).astype(np.float32)
    diff = ref[:, None] - query[:, :, None]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    want = np.argsort(d2, axis=-1, kind="stable")[..., :16]
    td, ti = t_knn.knn_exact_plain(torch.from_numpy(ref), torch.from_numpy(query), 16)
    np.testing.assert_array_equal(ti.numpy(), want)
    np.testing.assert_allclose(td.numpy() ** 2, np.maximum(np.take_along_axis(d2, want, -1), 1e-12), rtol=1e-6)
    d1, i1 = t_knn.knn_exact_plain(torch.from_numpy(ref), torch.from_numpy(query), 16, max_elems=2 * 200 * 4)
    assert torch.equal(td, d1) and torch.equal(ti, i1)
    d3, i3 = t_knn.knn(torch.from_numpy(ref[:, :5]), torch.from_numpy(query), 8, backend="exact")
    assert np.all(d3.numpy()[..., 5:] > 1e8) and np.all(i3.numpy()[..., 5:] == 0)


def test_backend_dispatch():
    """`auto` is the JAX dispatcher's rule: the fused kernel up to 262144
    reference points, the tiled one above."""
    assert t_knn.FUSED_MAX_POINTS == 256 * 1024
    assert t_knn.resolve_backend("auto", 256 * 1024) == "fused"
    assert t_knn.resolve_backend("auto", 256 * 1024 + 1) == "tiled"
    for name in ("fused", "tiled", "exact"):
        assert t_knn.resolve_backend(name, 10) == t_knn.resolve_backend(name, 10**6) == name
    with pytest.raises(ValueError, match="backend"):
        t_knn.knn(torch.zeros(1, 4, 3), torch.zeros(1, 2, 3), 1, backend="pallas")


@pytest.mark.parametrize("b,n,m", [(12, 281600, 256), (18, 281600, 256), (1, 5000, 3), (1, 100, 5),
                                   (1, 281600, 4096), (2, 2048, 8), (1, 2049, 1), (3, 10**6, 7)])
@pytest.mark.parametrize("resident", [132, 396, 1056])
def test_tiled_plan_covers_the_cloud(b, n, m, resident):
    """The spans of the tiled kernel are whole tiles, cover the cloud, none
    is empty, the grid stays near one full load of the card, and a grid that
    fills the card without splitting is not split."""
    splits, span = t_knn.tiled_plan(b, n, m, resident)
    assert span % t_knn.TILE == 0 and 1 <= splits <= 65535
    assert splits * span >= n > (splits - 1) * span
    query_blocks = -(-m // 8) * b
    assert splits == 1 or splits * query_blocks <= 1.5 * resident
    if query_blocks >= resident:
        assert splits == 1


def test_tiled_plan_splits_where_queries_are_few():
    assert t_knn.tiled_plan(12, 281600, 256, 396) == (1, 138 * t_knn.TILE)  # 384 query blocks fill 396 slots
    assert t_knn.tiled_plan(18, 281600, 256, 1056)[0] == 2  # 576 blocks, 1056 slots
    assert t_knn.tiled_plan(1, 281600, 256, 396)[0] == 12  # 32 blocks, 396 slots


@pytest.mark.parametrize("b,n,m,k", [(2, 300, 40, 8), (1, 1024, 128, 1)])
def test_plain_matches_reference(rng, b, n, m, k):
    ref = rng.normal(size=(b, n, 3)).astype(np.float32)
    query = rng.normal(size=(b, m, 3)).astype(np.float32)
    jd, ji = j_knn.knn_reference(jnp.asarray(ref), jnp.asarray(query), k)
    _check(ref, query, k, jd, ji)


def test_k_exceeds_cloud_fill_contract(rng):
    """k > N: ranks >= N get distance > 1e8 and index 0, as in the JAX package."""
    ref = rng.normal(size=(2, 5, 3)).astype(np.float32)
    query = rng.normal(size=(2, 7, 3)).astype(np.float32)
    td, ti = t_knn.knn(torch.from_numpy(ref), torch.from_numpy(query), 8)
    assert np.all(td.numpy()[..., 5:] > 1e8) and np.all(ti.numpy()[..., 5:] == 0)
    _check(ref, query, 8, *j_knn.knn_reference(jnp.asarray(ref), jnp.asarray(query), 8))
    jd, ji = j_knn.knn_pallas_fused(jnp.asarray(ref), jnp.asarray(query), 8, chunk=512, interpret=True)
    _check(ref[:, :5], query, 5, jd[..., :5], ji[..., :5])


def test_far_from_origin(rng):
    """Direct differences keep cm-scale distances exact far from the origin."""
    b, n, m, k = 1, 400, 50, 8
    offset = np.asarray([100.0, -50.0, 200.0], np.float32)
    ref = (rng.normal(size=(b, n, 3)) * 0.1 + offset).astype(np.float32)
    query = (rng.normal(size=(b, m, 3)) * 0.1 + offset).astype(np.float32)
    brute = np.sort(np.linalg.norm(query[:, :, None].astype(np.float64) - ref[:, None], axis=-1), -1)[..., :k]
    td, _ = t_knn.knn(torch.from_numpy(ref), torch.from_numpy(query), k)
    np.testing.assert_allclose(td.numpy(), brute, atol=1e-5)
    jd, _ = j_knn.knn_pallas_fused(jnp.asarray(ref), jnp.asarray(query), k, chunk=512, interpret=True)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-3)  # the JAX test's tolerance


def test_query_chunking_is_exact(rng):
    ref = torch.from_numpy(rng.normal(size=(2, 300, 3)).astype(np.float32))
    query = torch.from_numpy(rng.normal(size=(2, 97, 3)).astype(np.float32))
    d0, i0 = t_knn.knn_plain(ref, query, 8)
    d1, i1 = t_knn.knn_plain(ref, query, 8, max_elems=2 * 300 * 10)  # 10 queries per chunk
    assert torch.equal(d0, d1) and torch.equal(i0, i1)


@pytest.mark.parametrize("wrapper", ["knn_cuda", "knn_tiled_cuda", "knn_exact_cuda"])
def test_cuda_wrapper_rejects_cpu_tensors(wrapper):
    ref = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(t_knn, wrapper)(ref, ref, 1)
