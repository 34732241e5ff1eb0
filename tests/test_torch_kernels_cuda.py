"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; every test skips on a host without a GPU. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest` because the suite's conftest imports JAX.)
"""

import pytest
import torch

from mvtracker_torch.ops import _cuda
from mvtracker_torch.ops import corr as t_corr
from mvtracker_torch.ops import knn as t_knn
from scripts.timing_torch import recording

pytestmark = pytest.mark.cuda

KNN_RTOL, KNN_ATOL = 1e-5, 1e-6  # both compute d^2 directly in fp32
CORR_ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}  # fp32 sums, other order
# Backward: fp32 sums of up to a few dozen products of N(0,1) values in
# another order than the plain version's; a bf16 result is also rounded to
# bf16 once on each side, at magnitudes up to ~16.
BWD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 7e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("b,n,m,k", [
    (1, 5000, 37, 16), (3, 300, 9, 1), (2, 2049, 64, 20), (2, 700, 17, 32), (2, 6, 11, 8),
    # the medium model's evaluation path: k=12 at the release protocol's level 0
    # and the predictor's defaults' level 0, and the defaults' query features
    (8, 4096, 32, 12), (8, 49152, 132, 12), (12, 49152, 132, 1),
])
def test_knn_kernel_matches_plain(gen, b, n, m, k):
    ref = torch.randn(b, n, 3, generator=gen, device="cuda")
    query = torch.randn(b, m, 3, generator=gen, device="cuda")
    before = _cuda.launches["knn"]
    d, i = t_knn.knn(ref, query, k)
    assert _cuda.launches["knn"] == before + 1
    dp, ip = t_knn.knn_plain(ref, query, k)
    torch.testing.assert_close(d, dp, rtol=KNN_RTOL, atol=KNN_ATOL)
    real = min(k, n)
    # each index lies at its distance (ties may order differently)
    pts = torch.gather(ref, 1, i[..., :real].reshape(b, -1, 1).expand(-1, -1, 3)).reshape(b, m, real, 3)
    torch.testing.assert_close((pts - query[:, :, None]).norm(dim=-1).clamp_min(1e-6), d[..., :real].clamp_min(1e-6),
                               rtol=KNN_RTOL, atol=KNN_ATOL)
    if k > n:
        assert bool((i[..., n:] == 0).all()) and bool((d[..., n:] > 1e8).all())


@pytest.mark.parametrize("b,n,m,k", [
    (2, 300000, 64, 16), (1, 281600, 256, 1), (3, 5000, 37, 16), (2, 2049, 9, 20), (2, 700, 17, 32), (2, 6, 11, 8),
])
def test_knn_tiled_kernel_matches_plain(gen, b, n, m, k):
    """The split-cloud kernel: several spans, one span, fewer points than k."""
    ref = torch.randn(b, n, 3, generator=gen, device="cuda")
    query = torch.randn(b, m, 3, generator=gen, device="cuda")
    before = _cuda.launches["knn_tiled"]
    d, i = t_knn.knn(ref, query, k, backend="tiled")
    assert _cuda.launches["knn_tiled"] == before + 1
    dp, ip = t_knn.knn_plain(ref, query, k)
    torch.testing.assert_close(d, dp, rtol=KNN_RTOL, atol=KNN_ATOL)
    real = min(k, n)
    pts = torch.gather(ref, 1, i[..., :real].reshape(b, -1, 1).expand(-1, -1, 3)).reshape(b, m, real, 3)
    torch.testing.assert_close((pts - query[:, :, None]).norm(dim=-1).clamp_min(1e-6), d[..., :real].clamp_min(1e-6),
                               rtol=KNN_RTOL, atol=KNN_ATOL)
    if k > n:
        assert bool((i[..., n:] == 0).all()) and bool((d[..., n:] > 1e8).all())
    # The fused kernel evaluates the same expression: same distances, bit for bit.
    assert torch.equal(d, t_knn.knn_cuda(ref, query, k)[0])


def test_knn_auto_takes_the_tiled_kernel_above_the_switch(gen):
    ref = torch.randn(1, t_knn.FUSED_MAX_POINTS + 1, 3, generator=gen, device="cuda")
    query = torch.randn(1, 5, 3, generator=gen, device="cuda")
    fused, tiled = _cuda.launches["knn"], _cuda.launches["knn_tiled"]
    t_knn.knn(ref, query, 4)
    t_knn.knn(ref[:, :-1].contiguous(), query, 4)
    assert (_cuda.launches["knn"], _cuda.launches["knn_tiled"]) == (fused + 1, tiled + 1)


@pytest.mark.parametrize("b,n,m,k", [(1, 20000, 300, 16), (2, 4099, 33, 1), (2, 700, 17, 32), (2, 6, 11, 8)])
def test_knn_exact_kernel_equals_the_stable_sort(gen, b, n, m, k):
    """Indices equal the plain exact version's one for one, on a cloud where
    a third of the points are copies of others and some queries sit on one."""
    ref = torch.randn(b, n, 3, generator=gen, device="cuda")
    copies = torch.randint(0, n, (n // 3,), generator=gen, device="cuda")
    ref[:, torch.randperm(n, generator=gen, device="cuda")[: n // 3]] = ref[:, copies]
    query = torch.randn(b, m, 3, generator=gen, device="cuda")
    on_a_point = min(m // 2, len(copies))
    query[:, :on_a_point] = ref[:, copies[:on_a_point]]
    before = _cuda.launches["knn_exact"]
    d, i = t_knn.knn(ref, query, k, backend="exact")
    assert _cuda.launches["knn_exact"] == before + 1
    dp, ip = t_knn.knn_exact_plain(ref, query, k)
    assert torch.equal(i, ip)
    torch.testing.assert_close(d, dp, rtol=1e-6, atol=0)
    if k > 1 and n > k:
        assert bool((d[..., 1:] == d[..., :-1]).any())  # ties were there to break


@pytest.mark.parametrize("wrapper", ["knn_cuda", "knn_tiled_cuda", "knn_exact_cuda"])
def test_knn_kernel_rejects_what_it_cannot_take(gen, wrapper):
    fn = getattr(t_knn, wrapper)
    x = torch.randn(1, 50, 3, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        fn(x, x, 33)
    with pytest.raises(TypeError):
        fn(x.double(), x.double(), 4)
    with pytest.raises(ValueError):
        fn(x[:, ::2], x, 4)


@pytest.mark.parametrize("dtype,targets_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),  # the tracker's call: fp32 targets rounded in the kernel
])
@pytest.mark.parametrize("c", [8, 40, 128, 256])
@pytest.mark.parametrize("k", [1, 8, 16, 20, 32])
def test_corr_kernel_matches_plain(gen, dtype, targets_dtype, c, k):
    b, p, n = 2, 900, 33
    fvec = torch.randn(b, p, c, generator=gen, device="cuda").to(dtype)
    targets = torch.randn(b, n, c, generator=gen, device="cuda").to(targets_dtype)
    idx = torch.randint(0, p, (b, n, k), generator=gen, device="cuda")
    idx[:, 0::3, 0] = -1  # padding
    idx[:, 1::3, k - 1] = p  # out of range
    before = _cuda.launches["corr"]
    got = t_corr.corr_select(fvec, targets, idx)
    assert _cuda.launches["corr"] == before + 1
    want = t_corr.corr_select_plain(fvec, targets, idx)
    torch.testing.assert_close(got, want, rtol=0, atol=CORR_ATOL[dtype])
    assert bool((got[:, 0::3, 0] == 0).all()) and bool((got[:, 1::3, k - 1] == 0).all())
    # A fixed order of sums: the same bits again, and fp32 targets give the
    # bits of the same targets cast to the cloud's dtype first.
    assert torch.equal(t_corr.corr_select_cuda(fvec, targets, idx), got)
    assert torch.equal(t_corr.corr_select_cuda(fvec, targets.to(dtype), idx), got)


@pytest.mark.parametrize("dtype,targets_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
])
@pytest.mark.parametrize("p,n", [(4096, 32), (256, 32), (49152, 132)])
def test_corr_kernel_at_the_medium_shape(gen, dtype, targets_dtype, p, n):
    """K=12, C=96: the generic-K instance (neighbours in chunks of 16), 24
    sixteen-byte chunks per fp32 row (8 idle lanes of 32) and 12 per bf16 row
    (4 idle of 16), on kNN indices of the tracker's kind."""
    b, c, k = 8, 96, 12
    xyz = torch.rand(b, p, 3, generator=gen, device="cuda") * 4 - 2
    q = torch.randn(b, n, 3, generator=gen, device="cuda") * 0.5
    idx = t_knn.knn_plain(xyz, q, k)[1]
    fvec = torch.randn(b, p, c, generator=gen, device="cuda").to(dtype)
    targets = torch.randn(b, n, c, generator=gen, device="cuda").to(targets_dtype)
    got = t_corr.corr_select(fvec, targets, idx)
    want = t_corr.corr_select_plain(fvec, targets, idx)
    torch.testing.assert_close(got, want, rtol=0, atol=CORR_ATOL[dtype])
    assert torch.equal(t_corr.corr_select_cuda(fvec, targets, idx), got)


def test_corr_kernel_rejects_what_it_cannot_take(gen):
    fvec = torch.randn(1, 10, 6, generator=gen, device="cuda")
    idx = torch.zeros(1, 4, 2, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):  # C=6 is not a multiple of 4 floats
        t_corr.corr_select_cuda(fvec, fvec[:, :4].contiguous(), idx)
    with pytest.raises(TypeError):
        t_corr.corr_select_cuda(fvec.half(), fvec[:, :4].half().contiguous(), idx)


@pytest.mark.parametrize("fvec_dtype,targets_dtype", [
    (torch.bfloat16, torch.float32),  # the bf16 tracker: bf16 cloud, fp32 track features
    (torch.float32, torch.float32),  # the fp32 tracker
])
@pytest.mark.parametrize("b,p,n,k,c,pattern,rows", [
    # the path's four levels; at level 3 every tile is contended
    (12, 16384, 256, 16, 128, "random", None), (12, 4096, 256, 16, 128, "random", None),
    (12, 1024, 256, 16, 128, "random", None), (12, 256, 256, 16, 128, "random", None),
    (2, 900, 33, 16, 32, "random", None), (2, 50, 7, 5, 8, "random", None), (1, 300, 9, 20, 256, "random", None),
    (2, 700, 50, 16, 40, "random", None),
    (3, 1000, 700, 16, 128, "one_row", None),  # one long segment, several rounds of the index scan
    (2, 1001, 33, 16, 40, "random", 64),  # P not a multiple of the tile rows
    (2, 100, 33, 16, 128, "random", 128),  # P smaller than one tile
    (2, 50, 0, 16, 8, "empty", None), (2, 50, 7, 0, 8, "empty", None),
    (12, 256, 0, 16, 128, "empty", None),  # no contribution; each tile's 8 copies span all 8 warps
])
def test_corr_backward_kernel_matches_plain(gen, monkeypatch, fvec_dtype, targets_dtype, b, p, n, k, c, pattern, rows):
    if rows is not None:  # a tile plan other than the wrapper's own, within its limit
        assert rows * c * 4 <= t_corr.CORR_BWD_TILE_BYTES
        monkeypatch.setattr(t_corr, "corr_backward_plan",
                            lambda b_, p_, c_, sms: (rows, -(-p_ // rows), t_corr.corr_backward_copies(rows, c_)))
    fvec = torch.randn(b, p, c, generator=gen, device="cuda").to(fvec_dtype)
    targets = torch.randn(b, n, c, generator=gen, device="cuda").to(targets_dtype)
    idx = torch.randint(0, p, (b, n, k), generator=gen, device="cuda")
    g = torch.randn(b, n, k, generator=gen, device="cuda")
    if pattern == "random":
        idx[:, :, 1] = -1  # padding
        idx[:, :, 2] = p  # out of range
        idx[:, :, 3] = idx[:, :, 4]  # a row hit twice by one query
    elif pattern == "one_row":  # every query names row p // 2 at every rank
        idx[:] = p // 2
        g /= (n * k) ** 0.5  # sums of order 1, as at the other shapes
    before = _cuda.launches["corr_bwd"]
    d_fvec, d_targets = t_corr.corr_select_backward(fvec, targets, idx, g)
    torch.cuda.synchronize()
    assert _cuda.launches["corr_bwd"] == before + 1
    want_fvec, want_targets = t_corr.corr_select_backward_plain(fvec, targets, idx, g)
    assert d_fvec.dtype == fvec_dtype and d_targets.dtype == targets_dtype
    assert d_fvec.shape == fvec.shape and d_targets.shape == targets.shape
    torch.testing.assert_close(d_fvec.float(), want_fvec.float(), rtol=0, atol=BWD_ATOL[fvec_dtype])
    torch.testing.assert_close(d_targets.float(), want_targets.float(), rtol=0, atol=BWD_ATOL[targets_dtype])
    # Both gradients are summed in a fixed order: the same bits again.
    again_fvec, again_targets = t_corr.corr_select_backward(fvec, targets, idx, g)
    assert torch.equal(again_fvec, d_fvec) and torch.equal(again_targets, d_targets)
    if pattern == "random":
        # The padding and out-of-range neighbours gave nothing: the same call
        # with their g zeroed has the same d_targets, bit for bit.
        g2 = g.clone()
        g2[:, :, 1:3] = 0
        torch.testing.assert_close(t_corr.corr_select_backward(fvec, targets, idx, g2)[1], d_targets, rtol=0, atol=0)
    if pattern == "empty":
        assert not d_fvec.any() and not d_targets.any()


def test_corr_select_autograd_on_the_card(gen):
    """`CorrSelect` end to end on CUDA tensors: kernel forward, kernel
    backward, gradients in the inputs' own dtypes."""
    b, p, n, k, c = 3, 500, 40, 16, 128
    fvec = torch.randn(b, p, c, generator=gen, device="cuda").bfloat16().requires_grad_()
    targets = torch.randn(b, n, c, generator=gen, device="cuda").requires_grad_()
    idx = torch.randint(0, p, (b, n, k), generator=gen, device="cuda")
    w = torch.randn(b, n, k, generator=gen, device="cuda")
    f0, b0 = _cuda.launches["corr"], _cuda.launches["corr_bwd"]
    (t_corr.CorrSelect.apply(fvec, targets, idx, torch.bfloat16) * w).sum().backward()
    assert (_cuda.launches["corr"], _cuda.launches["corr_bwd"]) == (f0 + 1, b0 + 1)
    assert fvec.grad.dtype == torch.bfloat16 and targets.grad.dtype == torch.float32
    want_fvec, want_targets = t_corr.corr_select_backward_plain(fvec.detach(), targets.detach(), idx, w)
    torch.testing.assert_close(targets.grad, want_targets, rtol=0, atol=BWD_ATOL[torch.float32])
    torch.testing.assert_close(fvec.grad.float(), want_fvec.float(), rtol=0, atol=BWD_ATOL[torch.bfloat16])


def test_corr_backward_kernel_rejects_what_it_cannot_take(gen):
    fvec = torch.randn(1, 10, 8, generator=gen, device="cuda")
    targets = torch.randn(1, 4, 8, generator=gen, device="cuda")
    idx = torch.zeros(1, 4, 2, dtype=torch.int64, device="cuda")
    g = torch.zeros(1, 4, 2, device="cuda")
    with pytest.raises(TypeError):
        t_corr.corr_select_backward_cuda(fvec.half(), targets, idx, g)
    with pytest.raises(TypeError):  # the track features are fp32 in both models
        t_corr.corr_select_backward_cuda(fvec, targets.bfloat16(), idx, g)
    with pytest.raises(TypeError):
        t_corr.corr_select_backward_cuda(fvec, targets, idx, g.double())
    with pytest.raises(ValueError):
        t_corr.corr_select_backward_cuda(fvec, targets, idx, g[:, :, :1])
    with pytest.raises(ValueError):  # C=6 is not a multiple of 4 floats
        t_corr.corr_select_backward_cuda(fvec[..., :6].contiguous(), targets[..., :6].contiguous(), idx, g)
    with pytest.raises(ValueError):
        t_corr.corr_select_backward_cuda(fvec.cpu(), targets, idx, g)


# ---------------------------------------------------------------------------
# Shapes of the tracker's options: k=24 at level 0 (`corr_neighbors_per_level`
# with corr_k0=24), clouds with invalid-depth points at the 1e9 sentinel
# (`corr_filter_invalid_depth`).
# ---------------------------------------------------------------------------

def sentinel_cloud(gen, b, n, frame=0):
    """A cloud with half its points, and all of batch entry `frame`, at the
    1e9 sentinel: many exact ties far beyond every real point."""
    ref = torch.rand(b, n, 3, generator=gen, device="cuda") * 4 - 2
    ref[:, torch.randperm(n, generator=gen, device="cuda")[: n // 2]] = 1e9
    ref[frame] = 1e9
    return ref


@pytest.mark.parametrize("b,n,m", [(8, 4096, 32), (8, 49152, 132), (12, 16384, 256)])
def test_knn_kernel_at_k24(gen, b, n, m):
    """K1 at k=24: the level-0 search of corr_k0=24 at the release protocol's,
    the predictor defaults' and the flagship's level-0 shapes."""
    ref = torch.rand(b, n, 3, generator=gen, device="cuda") * 4 - 2
    query = torch.randn(b, m, 3, generator=gen, device="cuda") * 0.5
    before, ks = _cuda.launches["knn"], []
    with recording(t_knn, "knn", ks, keep=lambda args, kw, out: args[2]):
        d, i = t_knn.knn(ref, query, 24)
    assert ks == [24] and _cuda.launches["knn"] == before + 1
    dp, _ = t_knn.knn_plain(ref, query, 24)
    torch.testing.assert_close(d, dp, rtol=KNN_RTOL, atol=KNN_ATOL)
    pts = torch.gather(ref, 1, i.reshape(b, -1, 1).expand(-1, -1, 3)).reshape(b, m, 24, 3)
    torch.testing.assert_close((pts - query[:, :, None]).norm(dim=-1), d, rtol=KNN_RTOL, atol=KNN_ATOL)


@pytest.mark.parametrize("k", [1, 12, 24])
@pytest.mark.parametrize("b,n,m", [(8, 4096, 32), (4, 1024, 50)])
def test_knn_kernel_on_sentinel_clouds(gen, b, n, m, k):
    """Half the points and one whole frame at 1e9: the real points come first
    in order; in the all-sentinel frame every distance is the sentinel's and
    every index a sentinel point. The exact kernel's indices equal the
    stable sort's there too."""
    ref = sentinel_cloud(gen, b, n)
    query = torch.randn(b, m, 3, generator=gen, device="cuda") * 0.5
    d, i = t_knn.knn(ref, query, k)
    dp, _ = t_knn.knn_plain(ref, query, k)
    torch.testing.assert_close(d, dp, rtol=KNN_RTOL, atol=KNN_ATOL)
    assert bool((d[0] > 1e8).all()) and bool((d[1:] < 1e8).all())
    assert bool((ref[0].gather(0, i[0].reshape(-1, 1).expand(-1, 3)) == 1e9).all())
    de, ie = t_knn.knn_exact_cuda(ref, query, k)
    _, ip = t_knn.knn_exact_plain(ref, query, k)
    assert torch.equal(ie, ip)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p,n", [(4096, 32), (49152, 132)])
def test_corr_kernel_at_k24(gen, dtype, p, n):
    """K2 at K=24, C=96: a full chunk of 16 neighbours and a partial one of 8,
    fp32 targets (the tracker's call); a fixed order of sums."""
    b, c, k = 8, 96, 24
    xyz = torch.rand(b, p, 3, generator=gen, device="cuda") * 4 - 2
    q = torch.randn(b, n, 3, generator=gen, device="cuda") * 0.5
    idx = t_knn.knn_plain(xyz, q, k)[1]
    fvec = torch.randn(b, p, c, generator=gen, device="cuda").to(dtype)
    targets = torch.randn(b, n, c, generator=gen, device="cuda")
    got = t_corr.corr_select(fvec, targets, idx)
    want = t_corr.corr_select_plain(fvec, targets, idx)
    torch.testing.assert_close(got, want, rtol=0, atol=CORR_ATOL[dtype])
    assert torch.equal(t_corr.corr_select_cuda(fvec, targets, idx), got)
    assert torch.equal(t_corr.corr_select_cuda(fvec, targets.to(dtype), idx), got)


@pytest.mark.parametrize("fvec_dtype", [torch.bfloat16, torch.float32])
def test_corr_backward_kernel_at_k24(gen, fvec_dtype):
    """K3 at the protocol's training level 0 with K=24 (B=8, P=4096, N=32,
    C=96), on kNN indices: 1.5 times the contributions per b of K=16."""
    b, p, n, k, c = 8, 4096, 32, 24, 96
    xyz = torch.rand(b, p, 3, generator=gen, device="cuda") * 4 - 2
    q = torch.randn(b, n, 3, generator=gen, device="cuda") * 0.5
    idx = t_knn.knn_plain(xyz, q, k)[1]
    fvec = torch.randn(b, p, c, generator=gen, device="cuda").to(fvec_dtype)
    targets = torch.randn(b, n, c, generator=gen, device="cuda")
    g = torch.randn(b, n, k, generator=gen, device="cuda")
    d_fvec, d_targets = t_corr.corr_select_backward(fvec, targets, idx, g)
    want_fvec, want_targets = t_corr.corr_select_backward_plain(fvec, targets, idx, g)
    torch.testing.assert_close(d_fvec.float(), want_fvec.float(), rtol=0, atol=BWD_ATOL[fvec_dtype])
    torch.testing.assert_close(d_targets, want_targets, rtol=0, atol=BWD_ATOL[torch.float32])
    again_fvec, again_targets = t_corr.corr_select_backward(fvec, targets, idx, g)
    assert torch.equal(again_fvec, d_fvec) and torch.equal(again_targets, d_targets)
