"""The Matroska container of the DROID depth videos (`depth.mkv`), read and
written in Python.

Reading takes what FFmpeg's muxer writes and more: the EBML header with the
DocType "matroska" or "webm", a Segment and Clusters of known or unknown
size, CRC-32, Void, SeekHead, Cues and Tags elements (skipped), one video
track, and its frames as SimpleBlocks or Blocks in BlockGroups. Laced blocks
and a second video track raise `ValueError` naming the file.

Writing makes the simplest file of the same kind: the EBML header, a Segment
with Info (millisecond timestamps, duration), Tracks (one video track with
its codec ID, CodecPrivate, frame size and frame duration) and Clusters of
SimpleBlocks, each marked as a keyframe.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator, Optional

EBML = 0x1A45DFA3
SEGMENT = 0x18538067
INFO, TIMESTAMP_SCALE, DURATION, MUXING_APP, WRITING_APP = 0x1549A966, 0x2AD7B1, 0x4489, 0x4D80, 0x5741
TRACKS, TRACK_ENTRY = 0x1654AE6B, 0xAE
TRACK_NUMBER, TRACK_UID, TRACK_TYPE, FLAG_LACING, CODEC_ID, CODEC_PRIVATE = 0xD7, 0x73C5, 0x83, 0x9C, 0x86, 0x63A2
DEFAULT_DURATION, VIDEO, PIXEL_WIDTH, PIXEL_HEIGHT = 0x23E383, 0xE0, 0xB0, 0xBA
CLUSTER, CLUSTER_TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, BLOCK = 0x1F43B675, 0xE7, 0xA3, 0xA0, 0xA1
DOC_TYPE = 0x4282
# Masters whose children are read in place; every other element is skipped
# by its size (the ones above that are not masters are read as values).
_DESCEND = {SEGMENT, TRACKS, TRACK_ENTRY, VIDEO, CLUSTER, BLOCK_GROUP}
TRACK_TYPE_VIDEO = 1
APP = "mvtracker_torch"


@dataclass
class Track:
    number: int = 0
    type: int = 0
    codec_id: str = ""
    codec_private: bytes = b""
    width: int = 0
    height: int = 0


@dataclass
class Container:
    """A parsed file: its tracks, and the frames of its one video track
    (as byte ranges into `data`, in file order)."""

    path: str
    data: bytes
    tracks: list = field(default_factory=list)
    video: Optional[Track] = None
    frames: list = field(default_factory=list)  # (offset, length, keyframe)

    def frame(self, i: int) -> bytes:
        off, n, _ = self.frames[i]
        return self.data[off:off + n]


def _vint(data: bytes, pos: int, path: str, marker: bool) -> tuple[int, int, bool]:
    """(value, length, all-ones) of the EBML variable-size integer at `pos`;
    with `marker` the length marker stays in the value (element IDs)."""
    if pos >= len(data):
        raise ValueError(f"{path}: truncated Matroska element at byte {pos}")
    first = data[pos]
    n = 8 - first.bit_length() + 1
    if n > 8:
        raise ValueError(f"{path}: invalid EBML length byte 0x00 at byte {pos}")
    if pos + n > len(data):
        raise ValueError(f"{path}: truncated Matroska element at byte {pos}")
    v = first if marker else first & ((1 << (8 - n)) - 1)
    ones = v == (1 << (8 - n)) - 1
    for b in data[pos + 1:pos + n]:
        v = (v << 8) | b
        ones = ones and b == 0xFF
    return v, n, ones


def _elements(data: bytes, path: str) -> Iterator[tuple[int, int, int]]:
    """(id, data offset, data size) of every element, depth-first, entering
    the masters of `_DESCEND`; an unknown size runs to the end of the file."""
    pos = 0
    while pos < len(data):
        eid, n, _ = _vint(data, pos, path, marker=True)
        size, m, unknown = _vint(data, pos + n, path, marker=False)
        start = pos + n + m
        if unknown:
            if eid not in _DESCEND:
                raise ValueError(f"{path}: element 0x{eid:X} of unknown size")
            size = len(data) - start
        if start + size > len(data) and eid not in _DESCEND:
            raise ValueError(f"{path}: element 0x{eid:X} at byte {pos} runs past the end of the file")
        yield eid, start, size
        pos = start if eid in _DESCEND else start + size


def _uint(b: bytes) -> int:
    return int.from_bytes(b, "big")


def parse(data: bytes, path: str = "<bytes>") -> Container:
    """Parse a Matroska file held in `data`."""
    c = Container(path, data)
    if data[:4] != EBML.to_bytes(4, "big"):
        raise ValueError(f"{path}: not a Matroska file (no EBML header)")
    track = None
    for eid, start, size in _elements(data, path):
        body = data[start:start + size]
        if eid == DOC_TYPE and body.rstrip(b"\0") not in (b"matroska", b"webm"):
            raise ValueError(f"{path}: EBML DocType {body!r} is not matroska or webm")
        elif eid == TRACK_ENTRY:
            track = Track()
            c.tracks.append(track)
        elif track is not None and eid in (TRACK_NUMBER, TRACK_TYPE, CODEC_ID, CODEC_PRIVATE, PIXEL_WIDTH,
                                           PIXEL_HEIGHT):
            if eid == TRACK_NUMBER:
                track.number = _uint(body)
            elif eid == TRACK_TYPE:
                track.type = _uint(body)
            elif eid == CODEC_ID:
                track.codec_id = body.rstrip(b"\0").decode("ascii", "replace")
            elif eid == CODEC_PRIVATE:
                track.codec_private = bytes(body)
            elif eid == PIXEL_WIDTH:
                track.width = _uint(body)
            else:
                track.height = _uint(body)
        elif eid in (SIMPLE_BLOCK, BLOCK):
            if c.video is None:
                videos = [t for t in c.tracks if t.type == TRACK_TYPE_VIDEO]
                if len(videos) != 1:
                    raise ValueError(f"{path}: {len(videos)} video tracks, expected one")
                c.video = videos[0]
            num, n, _ = _vint(data, start, path, marker=False)
            if num != c.video.number:
                continue
            flags = data[start + n + 2]
            if flags & 0x06:
                raise ValueError(f"{path}: laced Matroska blocks are not supported")
            off = start + n + 3
            c.frames.append((off, start + size - off, eid == SIMPLE_BLOCK and bool(flags & 0x80)))
    if c.video is None:
        videos = [t for t in c.tracks if t.type == TRACK_TYPE_VIDEO]
        if len(videos) != 1:
            raise ValueError(f"{path}: {len(videos)} video tracks, expected one")
        c.video = videos[0]
    return c


def read(path: str) -> Container:
    with open(path, "rb") as f:
        return parse(f.read(), path)


# -- writing -------------------------------------------------------------------


def _id(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def _size(n: int, width: int = 0) -> bytes:
    width = width or next(w for w in range(1, 9) if n < (1 << (7 * w)) - 1)
    return ((1 << (7 * width)) | n).to_bytes(width, "big")


def _el(eid: int, body: bytes) -> bytes:
    return _id(eid) + _size(len(body)) + body


def _uel(eid: int, v: int) -> bytes:
    return _el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


class Writer:
    """Streams one video track's frames to a Matroska file; the Segment size
    and the duration are filled in by `close`."""

    CLUSTER_MS = 30000  # a SimpleBlock's timestamp is an int16 offset from its Cluster's

    def __init__(self, f: BinaryIO, codec_id: str, codec_private: bytes, width: int, height: int, fps: float):
        self.f, self.fps, self.frames = f, float(fps), 0
        header = b"".join([
            _uel(0x4286, 1), _uel(0x42F7, 1), _uel(0x42F2, 4), _uel(0x42F3, 8),
            _el(DOC_TYPE, b"matroska"), _uel(0x4287, 4), _uel(0x4285, 2),
        ])
        f.write(_el(EBML, header))
        f.write(_id(SEGMENT))
        self._segment_size_at = f.tell()
        f.write(_size(0, 8))
        self._segment_start = f.tell()
        info = _uel(TIMESTAMP_SCALE, 1_000_000) + _el(MUXING_APP, APP.encode()) + _el(WRITING_APP, APP.encode())
        f.write(_id(INFO) + _size(len(info) + 11))
        f.write(info)
        self._duration_at = f.tell() + 3
        f.write(_el(DURATION, struct.pack(">d", 0.0)))
        video = _uel(PIXEL_WIDTH, width) + _uel(PIXEL_HEIGHT, height)
        entry = b"".join([
            _uel(TRACK_NUMBER, 1), _uel(TRACK_UID, 1), _uel(TRACK_TYPE, TRACK_TYPE_VIDEO), _uel(FLAG_LACING, 0),
            _el(CODEC_ID, codec_id.encode()), _el(CODEC_PRIVATE, codec_private),
            _uel(DEFAULT_DURATION, round(1e9 / self.fps)), _el(VIDEO, video),
        ])
        f.write(_el(TRACKS, _el(TRACK_ENTRY, entry)))
        self._cluster: list[bytes] = []
        self._cluster_ms = 0

    def _timestamp_ms(self, i: int) -> int:
        return round(i * 1000.0 / self.fps)

    def _flush(self):
        if self._cluster:
            body = _uel(CLUSTER_TIMESTAMP, self._cluster_ms) + b"".join(self._cluster)
            self.f.write(_el(CLUSTER, body))
            self._cluster = []

    def write(self, packet: bytes):
        ts = self._timestamp_ms(self.frames)
        if self._cluster and ts - self._cluster_ms > self.CLUSTER_MS:
            self._flush()
        if not self._cluster:
            self._cluster_ms = ts
        block = b"\x81" + struct.pack(">hB", ts - self._cluster_ms, 0x80) + packet
        self._cluster.append(_el(SIMPLE_BLOCK, block))
        self.frames += 1

    def close(self):
        self._flush()
        end = self.f.tell()
        self.f.seek(self._segment_size_at)
        self.f.write(_size(end - self._segment_start, 8))
        self.f.seek(self._duration_at)
        self.f.write(struct.pack(">d", float(self._timestamp_ms(self.frames))))
        self.f.seek(end)
