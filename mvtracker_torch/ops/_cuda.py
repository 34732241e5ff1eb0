"""Build and load the port's CUDA kernels (`mvtracker_torch/csrc/*.cu`).

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface and loaded with `ctypes`. A library is
built at first use and rebuilt when its source, a shared header
(`csrc/*.cuh`) or the flags change (the file name carries a hash of all
three), so a fresh checkout builds everything
the first time a kernel is called. Nothing is built or imported when this
module is imported: the CPU test host has no `nvcc`.

Build outputs go to `mvtracker_torch/_build/` (listed in `.gitignore`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# Each library's C entry points and their argument types: every pointer and
# the stream as c_void_p, sizes as c_int; all return c_int. Set once, when
# the library loads.
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {
    "knn": {"knn_forward": [_P] * 4 + [_I] * 4 + [_P]},
    "knn_tiled": {"knn_tiled_forward": [_P] * 6 + [_I] * 6 + [_P], "knn_tiled_blocks_per_sm": [_I]},
    "knn_exact": {"knn_exact_forward": [_P] * 4 + [_I] * 4 + [_P]},
    "corr": {"corr_forward": [_P] * 4 + [_I] * 7 + [_P]},
    "corr_bwd": {"corr_backward": [_P] * 6 + [_I] * 9 + [_P]},
}
SOURCES = tuple(ENTRIES)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start_build(name: str):
    """Start `nvcc` for one source; return (process, tmp path, final path),
    or None when the library is already built."""
    so = _library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish_build(name: str, job) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)


def build_all(names=SOURCES) -> None:
    """Compile every kernel source, all `nvcc` processes started together."""
    jobs = {name: _start_build(name) for name in names}
    for name, job in jobs.items():
        if job is not None:
            _finish_build(name, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed, with
    the signatures of its entry points (`ENTRIES`) and `mvt_error_string`."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(str(_library_path(name)))
        for entry, argtypes in ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.mvt_error_string.restype = ctypes.c_char_p
        lib.mvt_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code (`cudaGetLastError`)."""
    if status != 0:
        msg = lib.mvt_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg}) at launch")
