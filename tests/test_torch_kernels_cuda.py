"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; every test skips on a host without a GPU. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest` because the suite's conftest imports JAX.)
"""

import pytest
import torch

from mvtracker_torch.ops import corr as t_corr
from mvtracker_torch.ops import knn as t_knn

pytestmark = pytest.mark.cuda

KNN_RTOL, KNN_ATOL = 1e-5, 1e-6  # both compute d^2 directly in fp32
CORR_ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}  # fp32 sums, other order


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("b,n,m,k", [(1, 5000, 37, 16), (3, 300, 9, 1), (2, 2049, 64, 20), (2, 700, 17, 32), (2, 6, 11, 8)])
def test_knn_kernel_matches_plain(gen, b, n, m, k):
    ref = torch.randn(b, n, 3, generator=gen, device="cuda")
    query = torch.randn(b, m, 3, generator=gen, device="cuda")
    before = t_knn.knn_cuda.launches
    d, i = t_knn.knn(ref, query, k)
    assert t_knn.knn_cuda.launches == before + 1
    dp, ip = t_knn.knn_plain(ref, query, k)
    torch.testing.assert_close(d, dp, rtol=KNN_RTOL, atol=KNN_ATOL)
    real = min(k, n)
    # each index lies at its distance (ties may order differently)
    pts = torch.gather(ref, 1, i[..., :real].reshape(b, -1, 1).expand(-1, -1, 3)).reshape(b, m, real, 3)
    torch.testing.assert_close((pts - query[:, :, None]).norm(dim=-1).clamp_min(1e-6), d[..., :real].clamp_min(1e-6),
                               rtol=KNN_RTOL, atol=KNN_ATOL)
    if k > n:
        assert bool((i[..., n:] == 0).all()) and bool((d[..., n:] > 1e8).all())


def test_knn_kernel_rejects_what_it_cannot_take(gen):
    x = torch.randn(1, 50, 3, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        t_knn.knn_cuda(x, x, 33)
    with pytest.raises(TypeError):
        t_knn.knn_cuda(x.double(), x.double(), 4)
    with pytest.raises(ValueError):
        t_knn.knn_cuda(x[:, ::2], x, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 40, 128, 256])
def test_corr_kernel_matches_plain(gen, dtype, c):
    b, p, n, k = 2, 900, 33, 16
    fvec = torch.randn(b, p, c, generator=gen, device="cuda").to(dtype)
    targets = torch.randn(b, n, c, generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, p, (b, n, k), generator=gen, device="cuda")
    idx[:, :, 3] = -1  # padding
    idx[:, :, 5] = p  # out of range
    before = t_corr.corr_select_cuda.launches
    got = t_corr.corr_select(fvec, targets, idx)
    assert t_corr.corr_select_cuda.launches == before + 1
    want = t_corr.corr_select_plain(fvec, targets, idx)
    torch.testing.assert_close(got, want, rtol=0, atol=CORR_ATOL[dtype])
    assert bool((got[:, :, 3] == 0).all()) and bool((got[:, :, 5] == 0).all())


def test_corr_kernel_rejects_what_it_cannot_take(gen):
    fvec = torch.randn(1, 10, 6, generator=gen, device="cuda")
    idx = torch.zeros(1, 4, 2, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):  # C=6 is not a multiple of 4 floats
        t_corr.corr_select_cuda(fvec, fvec[:, :4].contiguous(), idx)
    with pytest.raises(TypeError):
        t_corr.corr_select_cuda(fvec.half(), fvec[:, :4].half().contiguous(), idx)
