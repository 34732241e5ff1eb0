"""Image files for the dataset loaders, in numpy and `zlib`: the port's own
reader and writer, standing in for `imageio.v3.imread`/`imwrite`, which
the JAX package's loaders call. The GPU host has neither imageio nor an
image library behind it.

Read (`read_image` for a file, `decode_image` for bytes, by the magic bytes):
- PNG, non-interlaced: 8-bit gray, RGB and RGBA, 16-bit gray; all five
  row filters. Returned as imageio returns them: uint8 [H, W] or
  [H, W, C], uint16 [H, W].
- baseline TIFF: one float32 sample per pixel in strips, uncompressed or
  Deflate, either byte order. Returned as float32 [H, W].
- JPEG only through `imageio` when it imports; otherwise `ImportError`
  naming the file. There is no substitute decoder.
- Videos (`read_video`, `write_video`, `write_gif`) only through `imageio`
  in the same way.

Any other variant (interlaced or palette PNG, LZW or tiled TIFF, a
predictor, another sample type) raises `ValueError` naming the file and
the tag or field that is not supported.

Write: `write_png` (the same PNG variants, any of the five filters) and
`write_tiff` (uncompressed float32 in one strip, either byte order).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (color type, bit depth) -> channels
_PNG_FORMATS = {(0, 8): 1, (2, 8): 3, (6, 8): 4, (0, 16): 1}
_PNG_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


def _imageio(path, what: str):
    """The imageio package; `ImportError` naming `path` where it is absent."""
    try:
        import imageio
    except ImportError as e:
        raise ImportError(f"{path}: {what} needs imageio, which is not installed here") from e
    return imageio


def read_video(path) -> np.ndarray:
    """The frames [T, H, W, C] of a video file (mp4 and the like), through
    imageio and its ffmpeg plugin; `ImportError` naming the file without
    imageio."""
    return np.asarray(_imageio(path, "video").v3.imread(path))


def write_video(path, frames: np.ndarray, fps: float) -> None:
    """[T, H, W, 3] uint8 frames to a video file through imageio (an mp4
    needs its ffmpeg plugin); raises where imageio or the plugin is absent."""
    _imageio(path, "video").v3.imwrite(path, frames, fps=fps)


def write_gif(path, frames: np.ndarray, fps: float) -> None:
    """[T, H, W, 3] uint8 frames to an animated GIF through imageio."""
    _imageio(path, "GIF").v2.mimsave(path, list(frames), fps=fps)


def read_image(path) -> np.ndarray:
    """The image in `path` (PNG, float TIFF, or JPEG through imageio)."""
    path = Path(path)
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def decode_image(data: bytes, path="<bytes>") -> np.ndarray:
    """The image encoded in `data` (as `read_image`); `path` names it in
    errors."""
    if data.startswith(PNG_SIGNATURE):
        return _read_png(data, path)
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return _read_tiff(data, path)
    if data[:2] == b"\xff\xd8":
        return np.asarray(_imageio(path, "JPEG").v3.imread(bytes(data)))
    raise ValueError(f"{path}: not a PNG, TIFF or JPEG file (starts with {data[:8]!r})")


# -- PNG ---------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(scan: np.ndarray, h: int, w: int, bpp: int, path) -> np.ndarray:
    """[h, 1 + w*bpp] filtered scanlines -> [h, w*bpp] raw bytes."""
    types, filt = scan[:, 0], scan[:, 1:]
    if types.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter type {int(types.max())} is not one of 0-4")
    if not np.isin(types, (3, 4)).any():
        # None, Sub and Up only: row by row, each row in one numpy operation.
        out = np.empty_like(filt)
        prior = np.zeros(filt.shape[1], np.uint8)
        for y in range(h):
            t, row = types[y], filt[y]
            if t == 0:
                out[y] = row
            elif t == 1:
                out[y] = np.cumsum(row.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
            else:
                out[y] = row + prior
            prior = out[y]
        return out
    # Average and Paeth depend on the left, upper and upper-left pixels: one
    # anti-diagonal of pixels at a time, in a zero-padded frame.
    px = filt.reshape(h, w, bpp).astype(np.int16)
    raw = np.zeros((h + 1, w + 1, bpp), np.int16)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = raw[y + 1, x], raw[y, x + 1], raw[y, x]
        t = types[y][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        raw[y + 1, x + 1] = (px[y, x] + pred) & 255
    return raw[1:, 1:].astype(np.uint8).reshape(h, w * bpp)


def _read_png(data: bytes, path) -> np.ndarray:
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk header at byte {pos}")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: PNG chunk {kind!r} at byte {pos} is truncated or fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color, compression, filter_method, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG (IHDR interlace method {interlace}) is not supported")
    if (color, depth) not in _PNG_FORMATS:
        raise ValueError(f"{path}: PNG color type {color} ({_PNG_COLOR_NAMES.get(color, '?')}) at bit depth "
                         f"{depth} is not supported")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"{path}: PNG compression {compression} / filter method {filter_method} is not 0")
    channels = _PNG_FORMATS[color, depth]
    bpp = channels * depth // 8
    scan = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if scan.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: PNG image data holds {scan.size} bytes, want {h * (1 + w * bpp)}")
    raw = _unfilter(scan.reshape(h, 1 + w * bpp), h, w, bpp, path)
    img = raw.view(">u2").astype(np.uint16) if depth == 16 else raw
    return img.reshape(h, w) if channels == 1 else img.reshape(h, w, channels)


def _filter_rows(raw: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """[h, w*bpp] raw bytes -> [h, w*bpp] bytes filtered with one type."""
    r = raw.astype(np.int16)
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :-bpp]
    b = np.zeros_like(r)
    b[1:] = r[:-1]
    c = np.zeros_like(r)
    c[1:, bpp:] = r[:-1, :-bpp]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[filter_type]
    return ((r - pred) & 255).astype(np.uint8)


def write_png(path, img: np.ndarray, filter_type: int = 2) -> None:
    """Write uint8 [H, W], [H, W, 3], [H, W, 4] or uint16 [H, W] as a PNG,
    every row with filter `filter_type` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    color = {1: 0, 3: 2, 4: 6}.get(channels)
    if color is None or (color, depth) not in _PNG_FORMATS or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{path}: cannot write a {img.dtype} image of shape {img.shape} as PNG")
    if filter_type not in range(5):
        raise ValueError(f"{path}: PNG filter type {filter_type} is not one of 0-4")
    bpp = channels * depth // 8
    raw = (img.astype(">u2") if depth == 16 else img).reshape(h, -1).view(np.uint8).reshape(h, w * bpp)
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8), _filter_rows(raw, bpp, filter_type)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    out = (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))
    Path(path).write_bytes(out)


# -- TIFF --------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
               16: "Q"}
_TIFF_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8}
_TIFF_TILE_TAGS = {322: "TileWidth", 323: "TileLength", 324: "TileOffsets", 325: "TileByteCounts"}
_DEFLATE = (8, 32946)


def _read_tiff(data: bytes, path) -> np.ndarray:
    bo = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(bo + "I", data[4:8])
    (n_entries,) = struct.unpack(bo + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n_entries):
        tag, typ, count, value = struct.unpack(bo + "HHI4s", data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        if typ not in _TIFF_TYPES:
            continue
        size = _TIFF_SIZES[typ] * count
        if size <= 4:
            raw = value[:size]
        else:
            (offset,) = struct.unpack(bo + "I", value)
            raw = data[offset:offset + size]
        if typ == 2:
            tags[tag] = raw
        else:
            code = _TIFF_TYPES[typ]
            tags[tag] = struct.unpack(bo + code * count, raw)
    for tag, name in _TIFF_TILE_TAGS.items():
        if tag in tags:
            raise ValueError(f"{path}: tiled TIFF (tag {tag} {name}) is not supported")

    def one(tag, name, default=None):
        if tag not in tags:
            if default is None:
                raise ValueError(f"{path}: TIFF lacks tag {tag} {name}")
            return default
        return tags[tag][0]

    w, h = one(256, "ImageWidth"), one(257, "ImageLength")
    checks = {258: ("BitsPerSample", 32, 1), 277: ("SamplesPerPixel", 1, 1), 339: ("SampleFormat", 3, 1),
              284: ("PlanarConfiguration", 1, 1), 317: ("Predictor", 1, 1)}
    for tag, (name, want, default) in checks.items():
        got = tags.get(tag, (default,))
        if any(v != want for v in got):
            raise ValueError(f"{path}: TIFF tag {tag} {name} = {got} is not supported (want {want})")
    compression = one(259, "Compression", 1)
    if compression not in (1, *_DEFLATE):
        raise ValueError(f"{path}: TIFF tag 259 Compression = {compression} is not supported (1 or Deflate)")
    offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None or len(offsets) != len(counts):
        raise ValueError(f"{path}: TIFF strips (tags 273 StripOffsets, 279 StripByteCounts) missing or unequal")
    strips = [data[o:o + c] for o, c in zip(offsets, counts)]
    if compression in _DEFLATE:
        strips = [zlib.decompress(s) for s in strips]
    body = b"".join(strips)
    if len(body) < h * w * 4:
        raise ValueError(f"{path}: TIFF strips hold {len(body)} bytes, want {h * w * 4}")
    return np.frombuffer(body[:h * w * 4], bo + "f4").astype(np.float32).reshape(h, w)


def write_tiff(path, img: np.ndarray, byteorder: str = "<") -> None:
    """Write a float32 [H, W] image as an uncompressed TIFF in one strip,
    little-endian (`byteorder="<"`) or big-endian (">")."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.float32:
        raise ValueError(f"{path}: write_tiff takes float32 [H, W], got {img.dtype} {img.shape}")
    h, w = img.shape
    bo = byteorder
    entries = [(256, 4, w), (257, 4, h), (258, 3, 32), (259, 3, 1), (262, 3, 1), (273, 4, 0), (277, 3, 1),
               (278, 4, h), (279, 4, h * w * 4), (284, 3, 1), (339, 3, 3)]
    ifd_size = 2 + 12 * len(entries) + 4
    data_offset = 8 + ifd_size
    ifd = struct.pack(bo + "H", len(entries))
    for tag, typ, value in entries:
        value = data_offset if tag == 273 else value
        packed = struct.pack(bo + ("H" if typ == 3 else "I"), value).ljust(4, b"\x00")
        ifd += struct.pack(bo + "HHI", tag, typ, 1) + packed
    ifd += struct.pack(bo + "I", 0)
    head = (b"II*\x00" if bo == "<" else b"MM\x00*") + struct.pack(bo + "I", 8)
    Path(path).write_bytes(head + ifd + img.astype(bo + "f4").tobytes())
