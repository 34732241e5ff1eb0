"""ctypes bindings for the native data-path functions (`native/datapath.cpp`),
counterpart of `mvtracker_tpu/native.py`.

The library is compiled from the repo's `native/datapath.cpp` with `g++`
into `mvtracker_torch/_build/` (listed in `.gitignore`; nothing is written
under `native/`). Its file name carries a hash of the source and the flags,
so a stale library is never loaded. It is built once per process, under a
lock, at the first call: loader threads call these functions concurrently.
The build writes a temporary file and renames it, so processes that build
at the same time do not see half a library.

Every function takes and returns numpy arrays, and has a numpy version with
the JAX package's semantics that serves when the library cannot be built
(no compiler on the host: a warning is logged, as the JAX package does).
`available()` says which one runs. The native code runs without the GIL, so
loader threads really run in parallel inside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "datapath.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path(source: Path = SOURCE) -> Path:
    """Where the library built from `source` with `CXX_FLAGS` lives."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def _build(so: Path, source: Path = SOURCE) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    out = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name}:\n{out.stderr}")
    os.replace(tmp, so)


def build_library(source: Path) -> Path:
    """Build `source` with g++ into `_build/` unless it is built already;
    return the library's path. Raises `RuntimeError` when g++ fails."""
    so = library_path(source)
    if not so.exists():
        _build(so, source)
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build_library(SOURCE)))
            i64 = ctypes.c_int64
            fp = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            signatures = {
                "gaussian_blur_f32": [fp, i64, i64, i64, ctypes.c_int, ctypes.c_float],
                "nearest_resize_f32": [fp, fp, i64, i64, i64, i64, i64, i64],
                "bilinear_resize_ac_f32": [fp, fp, i64, i64, i64, i64, i64, i64],
                "normalize_rgb_u8_f32": [u8p, fp, i64],
                "photometric_jitter_f32": [fp, i64, i64, fp, fp, fp, fp],
                "depth_invalid_fraction_f32": [fp, i64],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            lib.depth_invalid_fraction_f32.restype = ctypes.c_double
            _lib = lib
        except (OSError, RuntimeError) as e:
            logging.warning("native datapath unavailable (%s); using numpy fallbacks", e)
            _lib = None
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def gaussian_blur(x: np.ndarray, kernel: int = 7, sigma: float = 2.0) -> np.ndarray:
    """Separable reflect-padded blur over the last two axes; float32 copy."""
    lib = _load()
    shape = x.shape
    if lib is not None:
        out = np.ascontiguousarray(x, np.float32).reshape(-1, shape[-2], shape[-1]).copy()
        lib.gaussian_blur_f32(_fptr(out), out.shape[0], out.shape[1], out.shape[2], kernel, sigma)
        return out.reshape(shape)
    return gaussian_blur_plain(x, kernel, sigma)


def gaussian_blur_plain(x: np.ndarray, kernel: int = 7, sigma: float = 2.0) -> np.ndarray:
    from mvtracker_torch.datasets.datapoint import _gaussian_blur

    return _gaussian_blur(np.asarray(x, np.float32), kernel, sigma).astype(np.float32)


def nearest_resize(x: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """[..., H, W, C] nearest resize (torch 'nearest' semantics)."""
    lib = _load()
    *lead, h, w, c = x.shape
    if lib is not None:
        n = int(np.prod(lead)) if lead else 1
        src = np.ascontiguousarray(x, np.float32).reshape(n, h, w, c)
        dst = np.empty((n, oh, ow, c), np.float32)
        lib.nearest_resize_f32(_fptr(src), _fptr(dst), n, h, w, c, oh, ow)
        return dst.reshape(*lead, oh, ow, c)
    return nearest_resize_plain(x, oh, ow)


def nearest_resize_plain(x: np.ndarray, oh: int, ow: int) -> np.ndarray:
    *lead, h, w, c = x.shape
    src = np.asarray(x, np.float32).reshape(-1, h, w, c)
    ri = np.arange(oh) * h // oh
    ci = np.arange(ow) * w // ow
    return src[:, ri[:, None], ci[None, :], :].reshape(*lead, oh, ow, c)


def bilinear_resize_ac(x: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """[..., H, W, C] bilinear align-corners resize."""
    lib = _load()
    *lead, h, w, c = x.shape
    if lib is not None:
        n = int(np.prod(lead)) if lead else 1
        src = np.ascontiguousarray(x, np.float32).reshape(n, h, w, c)
        dst = np.empty((n, oh, ow, c), np.float32)
        lib.bilinear_resize_ac_f32(_fptr(src), _fptr(dst), n, h, w, c, oh, ow)
        return dst.reshape(*lead, oh, ow, c)
    return bilinear_resize_ac_plain(x, oh, ow)


def _ac_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] align-corners linear interpolation weights (those of
    `datapoint._bilinear_upsample_ac`)."""
    if n_out == 1:
        m = np.zeros((1, n_in), np.float32)
        m[0, 0] = 1.0
        return m
    pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = pos - lo
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] += 1 - frac
    m[np.arange(n_out), hi] += frac
    return m


def bilinear_resize_ac_plain(x: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """The JAX package's numpy fallback (interpolation matrices applied
    along H, then W), with the products as matrix multiplications: the same
    weights, summed in BLAS's order."""
    *lead, h, w, c = x.shape
    src = np.asarray(x, np.float32).reshape(-1, h, w, c).transpose(0, 3, 1, 2)
    r = _ac_matrix(ow, w) @ np.swapaxes(_ac_matrix(oh, h) @ src, -1, -2)  # [n, c, ow, oh]
    return np.ascontiguousarray(r.transpose(0, 3, 2, 1)).reshape(*lead, oh, ow, c)


def normalize_rgb(x: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] -> float32 2*(x/255)-1."""
    lib = _load()
    src = np.ascontiguousarray(x, np.uint8)
    if lib is not None:
        dst = np.empty(src.shape, np.float32)
        lib.normalize_rgb_u8_f32(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _fptr(dst), src.size)
        return dst
    return normalize_rgb_plain(src)


def normalize_rgb_plain(x: np.ndarray) -> np.ndarray:
    return 2.0 * (np.asarray(x, np.uint8).astype(np.float32) / 255.0) - 1.0


def photometric_jitter(
    x: np.ndarray,  # [N, H, W, 3] float32
    mean: np.ndarray,  # [N] per-image (or per-group, replicated) mean
    brightness: np.ndarray,  # [N]
    contrast: np.ndarray,  # [N]
    saturation: np.ndarray,  # [N]
) -> np.ndarray:
    """Contrast, saturation and brightness jitter (the formula of
    `datasets/augmentations.py::photometric_augment`); the caller supplies
    the mean, so a group's mean survives the per-image layout."""
    lib = _load()
    n, h, w, _ = x.shape
    if lib is not None:
        out = np.ascontiguousarray(x, np.float32).copy()
        lib.photometric_jitter_f32(
            _fptr(out), n, h * w,
            _fptr(np.ascontiguousarray(mean, np.float32)),
            _fptr(np.ascontiguousarray(brightness, np.float32)),
            _fptr(np.ascontiguousarray(contrast, np.float32)),
            _fptr(np.ascontiguousarray(saturation, np.float32)),
        )
        return out
    return photometric_jitter_plain(x, mean, brightness, contrast, saturation)


def photometric_jitter_plain(x, mean, brightness, contrast, saturation) -> np.ndarray:
    n = x.shape[0]
    out = np.asarray(x, np.float32)
    m = np.asarray(mean).reshape(n, 1, 1, 1).astype(np.float32)
    xc = (out - m) * np.asarray(contrast).reshape(n, 1, 1, 1) + m
    gray = xc.mean(axis=-1, keepdims=True)
    return ((xc - gray) * np.asarray(saturation).reshape(n, 1, 1, 1) + gray) * np.asarray(brightness).reshape(
        n, 1, 1, 1)


def depth_invalid_fraction(depth: np.ndarray) -> float:
    """Fraction of the entries that are 0 (invalid depth)."""
    lib = _load()
    d = np.ascontiguousarray(depth, np.float32)
    if lib is not None:
        return float(lib.depth_invalid_fraction_f32(_fptr(d), d.size))
    return depth_invalid_fraction_plain(d)


def depth_invalid_fraction_plain(depth: np.ndarray) -> float:
    return float((np.asarray(depth, np.float32) == 0).mean())
