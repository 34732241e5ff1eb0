"""ctypes bindings for the FFV1 frame codec (`mvtracker_torch/csrc/ffv1.cpp`).

The library is built with g++ at the first use into `mvtracker_torch/_build/`
(as `native.py` builds the data-path library) and needs no CUDA. Unlike the
data path there is no numpy fallback: when g++ fails the error is raised.

`Decoder` turns the packets of one FFV1 track into BGR frames, `Encoder`
turns BGR frames into packets and gives the configuration record that goes
into the container. Both take and return numpy arrays and bytes; see the
source's header for what is supported.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from mvtracker_torch import native

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ffv1.cpp"
_ERR_LEN = 512

_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The codec library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build_library(SOURCE)))
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            sigs = {
                "ffv1_decoder_new": ([p, i64, i, i, p, i], p),
                "ffv1_decoder_free": ([p], None),
                "ffv1_decoder_info": ([p, p], i),
                "ffv1_decoder_decode": ([p, p, i64, p, p, i], i),
                "ffv1_encoder_new": ([i, i, i, i], p),
                "ffv1_encoder_free": ([p], None),
                "ffv1_encoder_record": ([p, p, i64], i64),
                "ffv1_encoder_encode": ([p, p], i64),
                "ffv1_encoder_packet": ([p], p),
            }
            for name, (args, res) in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
        return _lib


INFO_KEYS = ("version", "micro_version", "coder_type", "colorspace_type", "bits_per_raw_sample", "transparency",
             "slices", "ec", "intra")


class Decoder:
    """Decodes the packets of one stream, in order (the frames between
    keyframes carry their contexts over)."""

    _h = None

    def __init__(self, record: bytes, width: int, height: int, name: str = "<stream>"):
        self._lib = load()
        self.width, self.height, self.name = int(width), int(height), name
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._h = self._lib.ffv1_decoder_new(record, len(record), self.width, self.height, err, _ERR_LEN)
        if not self._h:
            raise ValueError(f"{name}: {err.value.decode()}")

    def info(self) -> dict:
        out = (ctypes.c_int * len(INFO_KEYS))()
        self._lib.ffv1_decoder_info(self._h, out)
        return dict(zip(INFO_KEYS, out))

    def decode(self, packet: bytes) -> np.ndarray:
        """One packet -> BGR uint8 [height, width, 3]."""
        bgr = np.empty((self.height, self.width, 3), np.uint8)
        err = ctypes.create_string_buffer(_ERR_LEN)
        if self._lib.ffv1_decoder_decode(self._h, packet, len(packet), bgr.ctypes.data, err, _ERR_LEN) != 0:
            raise ValueError(f"{self.name}: {err.value.decode()}")
        return bgr

    def close(self):
        if self._h:
            self._lib.ffv1_decoder_free(self._h)
            self._h = None

    __del__ = close


def slice_grid(width: int, height: int) -> tuple[int, int]:
    """Slices across and down for a frame: up to 4 x 4, none under 64 pixels
    on a side, so the encoder and decoder have work for several cores."""
    return max(1, min(4, width // 64)), max(1, min(4, height // 64))


class Encoder:
    """Encodes BGR frames of one size as FFV1 keyframes."""

    _h = None

    def __init__(self, width: int, height: int):
        self._lib = load()
        self.width, self.height = int(width), int(height)
        nh, nv = slice_grid(self.width, self.height)
        self._h = self._lib.ffv1_encoder_new(self.width, self.height, nh, nv)
        if not self._h:
            raise ValueError(f"FFV1 encoder: bad frame size {width}x{height}")

    def record(self) -> bytes:
        """The configuration record (Matroska CodecPrivate)."""
        buf = ctypes.create_string_buffer(4096)
        n = self._lib.ffv1_encoder_record(self._h, buf, len(buf))
        if n < 0:
            raise RuntimeError("FFV1 encoder: configuration record longer than its buffer")
        return buf.raw[:n]

    def encode(self, bgr: np.ndarray) -> bytes:
        """BGR uint8 [height, width, 3] -> one packet."""
        bgr = np.ascontiguousarray(bgr, np.uint8)
        if bgr.shape != (self.height, self.width, 3):
            raise ValueError(f"FFV1 encoder: frame of shape {bgr.shape}, expected {(self.height, self.width, 3)}")
        n = self._lib.ffv1_encoder_encode(self._h, bgr.ctypes.data)
        return ctypes.string_at(self._lib.ffv1_encoder_packet(self._h), n)

    def close(self):
        if self._h:
            self._lib.ffv1_encoder_free(self._h)
            self._h = None

    __del__ = close
