"""The port's native data path (`mvtracker_torch/native.py`) against the JAX
package's (`mvtracker_tpu/native.py`) and against its own numpy versions,
on the CPU; and `datapoint.aug_depth`, which calls it, against the JAX
package's on the same generator.

Both packages compile the same `native/datapath.cpp`, the JAX package with
`-march=native` and the port without, so the float functions round apart
by a few ulps (measured: blur 1.2e-7 and align-corners resize 2.4e-7 on
values of order 1, photometric jitter 4.6e-5 on 0..255): held to 1e-6 and
2e-4 (NATIVE_ATOL); the integer and copy functions exactly. The numpy
versions sum in another order: held to 1e-4 on values of order 1 (blur,
resize), 2e-3 on 0..255 (photometric jitter), exactly elsewhere. They equal
the JAX package's numpy fallbacks exactly, but for the align-corners resize,
whose interpolation matrices the port multiplies with BLAS where the JAX
package calls `einsum` (300 times slower at the flagship size): 1e-6.
"""

import threading

import numpy as np
import pytest

from mvtracker_torch import native
from mvtracker_torch.datasets import datapoint as t_dp
from mvtracker_tpu import native as j_native
from mvtracker_tpu.datasets import datapoint as j_dp


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    return dict(
        stack=rng.normal(size=(3, 24, 32)).astype(np.float32),
        hwc=rng.normal(size=(2, 3, 16, 20, 3)).astype(np.float32),
        rgb8=rng.integers(0, 256, size=(2, 9, 11, 3), dtype=np.uint8),
        frames=rng.uniform(0, 255, size=(3, 16, 20, 3)).astype(np.float32),
        depth=np.where(rng.random((4, 5, 6)) < 0.3, 0.0, rng.uniform(0.5, 4, (4, 5, 6))).astype(np.float32),
    )


def calls(a):
    """(name, callable taking a native module) for the six functions."""
    n = a["frames"].shape[0]
    jitter = (np.full(n, a["frames"].mean(), np.float32), np.array([1.1, 0.9, 1.0], np.float32),
              np.array([0.8, 1.2, 1.0], np.float32), np.array([1.3, 0.7, 1.0], np.float32))
    return [
        ("gaussian_blur", lambda m: m.gaussian_blur(a["stack"], 7, 2.0)),
        ("gaussian_blur_5_0.7", lambda m: m.gaussian_blur(a["stack"], 5, 0.7)),
        ("nearest_resize_down", lambda m: m.nearest_resize(a["hwc"], 7, 9)),
        ("nearest_resize_up", lambda m: m.nearest_resize(a["hwc"], 37, 41)),
        ("bilinear_resize_ac", lambda m: m.bilinear_resize_ac(a["hwc"], 31, 45)),
        ("normalize_rgb", lambda m: m.normalize_rgb(a["rgb8"])),
        ("photometric_jitter", lambda m: m.photometric_jitter(a["frames"], *jitter)),
        ("depth_invalid_fraction", lambda m: m.depth_invalid_fraction(a["depth"])),
    ]


NAMES = [name for name, _ in calls({"frames": np.zeros((3, 1, 1, 3), np.float32)})]
NATIVE_ATOL = {"gaussian_blur": 1e-6, "gaussian_blur_5_0.7": 1e-6, "bilinear_resize_ac": 1e-6,
               "photometric_jitter": 2e-4}
PLAIN_ATOL = {"gaussian_blur": 1e-4, "gaussian_blur_5_0.7": 1e-4, "bilinear_resize_ac": 1e-4,
              "photometric_jitter": 2e-3}


def test_library_builds_into_the_ports_build_dir():
    assert native.available()
    so = native.library_path()
    assert so.exists() and so.parent.name == "_build" and so.parent.parent.name == "mvtracker_torch"
    assert so.name.startswith("libdatapath_") and so.suffix == ".so"


@pytest.mark.parametrize("name", NAMES)
def test_native_equals_the_jax_packages(arrays, name):
    fn = dict(calls(arrays))[name]
    got, want = fn(native), fn(j_native)
    assert j_native.available()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=NATIVE_ATOL.get(name, 0), rtol=0)
    assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("name", NAMES)
def test_numpy_versions_equal_the_jax_fallbacks_and_the_library(arrays, name, monkeypatch):
    """With the library unavailable both packages take their numpy versions:
    those agree exactly; the library agrees with them within PLAIN_ATOL."""
    fn = dict(calls(arrays))[name]
    lib = np.asarray(fn(native))
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(j_native, "_load", lambda: None)
    plain, want = np.asarray(fn(native)), np.asarray(fn(j_native))
    np.testing.assert_allclose(plain, want, atol=1e-6 if name == "bilinear_resize_ac" else 0, rtol=0)
    np.testing.assert_allclose(lib, plain, atol=PLAIN_ATOL.get(name, 0), rtol=0)


def test_aug_depth_equals_the_jax_packages():
    """`aug_depth` runs (it imports the native module) and makes the JAX
    function's draws: same generator state in, the same depth out (to the
    blur's ulps, NATIVE_ATOL, on depths up to about 7; zeros exactly), the
    same generator state after."""
    rng = np.random.default_rng(3)
    depth = np.where(rng.random((2, 3, 24, 28)) < 0.2, 0.0, rng.uniform(1, 5, (2, 3, 24, 28))).astype(np.float32)
    g_t, g_j = np.random.default_rng(11), np.random.default_rng(11)
    got = t_dp.aug_depth(depth, rng=g_t)
    want = j_dp.aug_depth(depth, rng=g_j)
    np.testing.assert_allclose(got, want, atol=NATIVE_ATOL["gaussian_blur"] * 10, rtol=0)
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got[depth == 0] == 0).all() and not np.allclose(got, depth)
    assert g_t.random() == g_j.random()


def test_concurrent_first_calls_build_once(tmp_path, monkeypatch):
    """Eight threads call at once into a module that has not loaded the
    library: one build under the lock, no temporary file left, and every
    thread gets the library's result."""
    x = np.random.default_rng(1).normal(size=(4, 40, 40)).astype(np.float32)
    assert native.available()
    want = native.gaussian_blur(x, 7, 2.0)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    results, errors = [None] * 8, []
    barrier = threading.Barrier(8)

    def work(i):
        try:
            barrier.wait(timeout=30)
            results[i] = native.gaussian_blur(x, 7, 2.0)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert native.available()
    assert sorted(p.name for p in tmp_path.iterdir()) == [native.library_path().name]
    for r in results:
        np.testing.assert_array_equal(r, want)
