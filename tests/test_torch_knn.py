"""Port parity: the plain kNN of `mvtracker_torch.ops.knn` against the JAX
package's TPU kernel (`knn_pallas_fused`, interpret mode) and
`knn_reference`, on the same numpy inputs (CPU).

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


def _check(ref, query, k, jd, ji):
    """The port's plain kNN against JAX's (dists, idx) on the same input."""
    td, ti = t_knn.knn(torch.from_numpy(ref), torch.from_numpy(query), k)
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


def test_cuda_wrapper_rejects_cpu_tensors():
    ref = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        t_knn.knn_cuda(ref, ref, 1)
