"""The port's image reader and writer (`mvtracker_torch/datasets/image_io.py`)
against imageio, which the JAX package's loaders read with: what imageio
writes here is read bit for bit (values, dtype, shape) for every supported
PNG and TIFF variant, imageio reads what the port writes (each of the five
PNG row filters, both TIFF byte orders), and unsupported variants raise
naming the file and the field."""

import struct
import sys
import zlib

import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from mvtracker_torch.datasets import image_io

PNG_VARIANTS = {
    "gray8": ((37, 45), np.uint8),
    "rgb8": ((37, 45, 3), np.uint8),
    "rgba8": ((37, 45, 4), np.uint8),
    "gray16": ((37, 45), np.uint16),
}


def smooth_image(shape, dtype, seed):
    """Noise with a gradient, so an adaptive PNG encoder picks several row
    filters."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    ramp = np.linspace(0, top * 0.8, shape[1])[None, :]
    ramp = ramp.reshape(ramp.shape + (1,) * (len(shape) - 2))
    img = ramp + rng.normal(0, top * 0.05, shape)
    return np.clip(img, 0, top).astype(dtype)


def png_filters(path):
    """The row filter types a PNG file uses."""
    data = path.read_bytes()
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + length])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    w, h, depth, color = header[:4]
    bpp = {0: 1, 2: 3, 6: 4}[color] * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    return set(rows[:, 0].tolist())


@pytest.mark.parametrize("variant", sorted(PNG_VARIANTS))
def test_reads_imageios_png_bit_for_bit(tmp_path, variant):
    shape, dtype = PNG_VARIANTS[variant]
    img = smooth_image(shape, dtype, seed=len(variant))
    path = tmp_path / "x.png"
    iio.imwrite(path, img)
    want = iio.imread(path)
    got = image_io.read_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("variant", sorted(PNG_VARIANTS))
def test_writes_png_that_imageio_reads(tmp_path, variant, filter_type):
    shape, dtype = PNG_VARIANTS[variant]
    img = smooth_image(shape, dtype, seed=filter_type)
    path = tmp_path / "x.png"
    image_io.write_png(path, img, filter_type=filter_type)
    assert png_filters(path) == {filter_type}
    want = iio.imread(path)
    assert want.dtype == img.dtype and want.shape == img.shape
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(image_io.read_image(path), img)


def test_reads_a_png_of_mixed_row_filters(tmp_path):
    """Rows of all five filters in one file, Average and Paeth among them
    (the diagonal-by-diagonal path), as an adaptive encoder writes them."""
    img = smooth_image((23, 31, 3), np.uint8, seed=7)
    path = tmp_path / "mixed.png"
    image_io.write_png(path, img, filter_type=4)
    raw = img.reshape(23, -1)
    rows = np.concatenate([np.array([[i % 5] for i in range(23)], np.uint8),
                           np.stack([image_io._filter_rows(raw, 3, i % 5)[i] for i in range(23)])], axis=1)
    data = path.read_bytes()
    start = data.index(b"IDAT") - 4
    (length,) = struct.unpack(">I", data[start:start + 4])
    body = zlib.compress(rows.tobytes())
    chunk = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(">I", zlib.crc32(b"IDAT" + body))
    path.write_bytes(data[:start] + chunk + data[start + 12 + length:])
    assert png_filters(path) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(iio.imread(path), img)
    np.testing.assert_array_equal(image_io.read_image(path), img)


@pytest.mark.parametrize("writer", ["imageio", "pillow_deflate", "port_little", "port_big"])
def test_float_tiff_round_trips(tmp_path, writer):
    img = np.random.default_rng(3).uniform(0, 10, (29, 35)).astype(np.float32)
    img[3, 4] = 0.0
    img[5, 6] = 1e4
    path = tmp_path / "d.tiff"
    if writer == "imageio":
        iio.imwrite(path, img)
    elif writer == "pillow_deflate":
        Image.fromarray(img).save(path, compression="tiff_adobe_deflate")
    else:
        image_io.write_tiff(path, img, byteorder="<" if writer == "port_little" else ">")
        np.testing.assert_array_equal(iio.imread(path), img)
    got = image_io.read_image(path)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, iio.imread(path))


def patch_ihdr(data: bytes, **fields) -> bytes:
    """A PNG with IHDR fields replaced and its CRC recomputed."""
    names = ("width", "height", "depth", "color", "compression", "filter", "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    values.update(fields)
    body = struct.pack(">IIBBBBB", *(values[n] for n in names))
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


def patch_tiff_entry(data: bytes, old: tuple, new: tuple) -> bytes:
    """A little-endian TIFF with one IFD entry (tag, type, count, value)
    replaced."""
    pack = lambda tag, typ, count, value: struct.pack("<HHI", tag, typ, count) + struct.pack(
        "<H" if typ == 3 else "<I", value).ljust(4, b"\x00")
    assert data.count(pack(*old)) == 1
    return data.replace(pack(*old), pack(*new))


def unsupported_files(tmp_path):
    rgb = smooth_image((9, 11, 3), np.uint8, 0)
    image_io.write_png(tmp_path / "base.png", rgb)
    png = (tmp_path / "base.png").read_bytes()
    image_io.write_tiff(tmp_path / "base.tiff", np.ones((4, 5), np.float32))
    tiff = (tmp_path / "base.tiff").read_bytes()
    Image.fromarray(np.ones((4, 5), np.float32)).save(tmp_path / "lzw.tiff", compression="tiff_lzw")
    Image.fromarray(rgb).convert("P").save(tmp_path / "palette.png")
    Image.fromarray(rgb).convert("LA").save(tmp_path / "gray_alpha.png")
    Image.fromarray(rgb).save(tmp_path / "uint8.tiff")
    files = {
        "interlaced.png": (patch_ihdr(png, interlace=1), "interlace"),
        "rgb16.png": (patch_ihdr(png, depth=16), "color type 2"),
        "bad_crc.png": (png[:40] + bytes([png[40] ^ 1]) + png[41:], "CRC"),
        "tiled.tiff": (patch_tiff_entry(tiff, (278, 4, 1, 4), (322, 4, 1, 16)), "tag 322 TileWidth"),
        "predictor.tiff": (patch_tiff_entry(tiff, (284, 3, 1, 1), (317, 3, 1, 3)), "tag 317 Predictor"),
        "lzw.tiff": (None, "tag 259 Compression = 5"),
        "palette.png": (None, "color type 3"),
        "gray_alpha.png": (None, "color type 4"),
        "uint8.tiff": (None, "tag 258 BitsPerSample"),
        "text.png": (b"not an image at all", "not a PNG, TIFF or JPEG"),
    }
    for name, (data, _) in files.items():
        if data is not None:
            (tmp_path / name).write_bytes(data)
    return {name: match for name, (_, match) in files.items()}


def test_unsupported_variants_raise_naming_file_and_field(tmp_path):
    for name, match in unsupported_files(tmp_path).items():
        with pytest.raises(ValueError, match=match) as err:
            image_io.read_image(tmp_path / name)
        assert name in str(err.value), name
    with pytest.raises(ValueError, match="filter type 5"):
        image_io.write_png(tmp_path / "x.png", np.zeros((2, 2), np.uint8), filter_type=5)
    with pytest.raises(ValueError, match="as PNG"):
        image_io.write_png(tmp_path / "x.png", np.zeros((2, 2, 2), np.uint8))
    with pytest.raises(ValueError, match="float32"):
        image_io.write_tiff(tmp_path / "x.tiff", np.zeros((2, 2), np.float64))


def test_jpeg_goes_through_imageio_or_raises(tmp_path, monkeypatch):
    img = smooth_image((16, 24, 3), np.uint8, 1)
    path = tmp_path / "frame.jpg"
    iio.imwrite(path, img)
    np.testing.assert_array_equal(image_io.read_image(path), iio.imread(path))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    with pytest.raises(ImportError, match="frame.jpg"):
        image_io.read_image(path)
