"""FFV1 lossless 16-bit depth videos (`depth.mkv`), counterpart of
`mvtracker_tpu/droid/depth_video.py`.

Depth in millimetres as uint16, split into the B (low byte) and G (high
byte) planes of an FFV1-coded BGR stream in Matroska:

    depth_meters = ((G << 8) | B) / 1000.0

The JAX package writes and reads these files through OpenCV's FFmpeg
backend; the port has its own codec (`droid/ffv1.py` over
`csrc/ffv1.cpp`) and container (`droid/matroska.py`), so it reads the files
OpenCV writes and OpenCV reads the files it writes, bit for bit.
"""

from __future__ import annotations

import json

import numpy as np

from mvtracker_torch.droid import ffv1, matroska

DEPTH_SCALE_MM = 1000.0
DEPTH_MAX_MM = 65535
CODEC_ID = "V_FFV1"


def encode_depth_frame(depth_meters: np.ndarray) -> np.ndarray:
    """Depth meters [H, W] -> BGR uint8 [H, W, 3] (NaN and inf as 0,
    clipped to 65535 mm)."""
    depth_mm = np.nan_to_num(depth_meters * DEPTH_SCALE_MM, nan=0.0, posinf=0.0, neginf=0.0)
    d16 = np.clip(depth_mm, 0, DEPTH_MAX_MM).astype(np.uint16)
    low = (d16 & 0xFF).astype(np.uint8)
    high = (d16 >> 8).astype(np.uint8)
    return np.stack([low, high, np.zeros_like(low)], axis=-1)


class FFV1DepthVideoWriter:
    """Writes depth frames to `output_path` as they come; `close` finishes
    the file."""

    def __init__(self, output_path: str, width: int, height: int, fps: float = 30.0):
        self.output_path = output_path
        self.width = width
        self.height = height
        self.fps = fps
        self.frame_count = 0
        self._encoder = ffv1.Encoder(width, height)
        self._file = open(output_path, "wb")
        self.writer = matroska.Writer(self._file, CODEC_ID, self._encoder.record(), width, height, fps)

    def write_frame(self, depth_meters: np.ndarray):
        self.writer.write(self._encoder.encode(encode_depth_frame(depth_meters)))
        self.frame_count += 1

    def close(self):
        if self.writer is not None:
            self.writer.close()
            self._file.close()
            self._encoder.close()
            self.writer = None

    def get_metadata(self) -> dict:
        return {
            "format": "ffv1_depth_z16",
            "encoding": "bgr_split_uint16",
            "channel_layout": {"B": "low_byte", "G": "high_byte", "R": "unused"},
            "depth_scale": DEPTH_SCALE_MM,
            "depth_unit": "millimeters",
            "depth_max_mm": DEPTH_MAX_MM,
            "width": self.width,
            "height": self.height,
            "fps": self.fps,
            "frame_count": self.frame_count,
            "decode_formula": "depth_meters = ((G << 8) | B) / 1000.0",
        }

    def save_metadata(self, path: str | None = None):
        path = path or self.output_path + ".json"
        with open(path, "w") as f:
            json.dump(self.get_metadata(), f, indent=2)


def decode_depth_frame(bgr_frame: np.ndarray) -> np.ndarray:
    """BGR uint8 frame -> depth meters."""
    low = bgr_frame[:, :, 0].astype(np.uint16)
    high = bgr_frame[:, :, 1].astype(np.uint16)
    return ((high << 8) | low).astype(np.float32) / DEPTH_SCALE_MM


def read_bgr_frames(path: str, max_frames: int | None = None) -> list:
    """The decoded BGR frames of an FFV1 Matroska file (at most `max_frames`)."""
    c = matroska.read(path)
    if c.video.codec_id != CODEC_ID:
        raise ValueError(f"{path}: codec {c.video.codec_id!r}, expected {CODEC_ID}")
    if not c.video.codec_private:
        raise ValueError(f"{path}: FFV1 without a configuration record (version 0 or 1) is not supported")
    dec = ffv1.Decoder(c.video.codec_private, c.video.width, c.video.height, name=path)
    n = len(c.frames) if max_frames is None else min(max_frames, len(c.frames))
    try:
        return [dec.decode(c.frame(i)) for i in range(n)]
    finally:
        dec.close()


def read_depth_video(path: str, max_frames: int | None = None) -> np.ndarray:
    """Decode a full depth.mkv into [T, H, W] float32 meters."""
    frames = [decode_depth_frame(f) for f in read_bgr_frames(path, max_frames)]
    return np.stack(frames) if frames else np.zeros((0, 0, 0), np.float32)


def write_depth_video(path: str, depth: np.ndarray, fps: float = 30.0):
    """[T, H, W] float32 meters -> depth.mkv + sidecar metadata json."""
    t, h, w = depth.shape
    writer = FFV1DepthVideoWriter(path, w, h, fps)
    for i in range(t):
        writer.write_frame(depth[i])
    writer.close()
    writer.save_metadata()
