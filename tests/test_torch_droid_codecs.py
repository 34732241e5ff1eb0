"""The port's own file formats for the DROID factory against the libraries
the JAX package uses: FFV1 depth videos in Matroska (`droid/depth_video.py`,
`droid/ffv1.py`, `droid/matroska.py`) against OpenCV's FFmpeg backend, and
HDF5 (`datasets/hdf5.py`) against h5py. Every comparison is bit-exact: the
codecs are lossless."""

import json
import os
import struct

import h5py
import numpy as np
import pytest

from mvtracker_torch.datasets import hdf5
from mvtracker_torch.droid import depth_video as t_dv
from mvtracker_torch.droid import ffv1, matroska
from mvtracker_tpu.droid import depth_video as j_dv


def _depth(rng, t, h, w):
    """Depth in meters with holes (0), a far band near 65 m and noise: every
    byte of the uint16 millimetres varies."""
    yy, xx = np.mgrid[0:h, 0:w]
    d = np.stack([0.6 + 0.3 * np.sin(xx / 7.0 + i) + 0.2 * np.cos(yy / 5.0 - i) + rng.normal(0, 0.004, (h, w))
                  for i in range(t)]).astype(np.float32)
    d[:, h // 3:h // 2 + 1, w // 4:w // 2 + 1] = 0.0
    d[:, :max(h // 8, 1), :] = rng.uniform(64.0, 65.5, (t, max(h // 8, 1), w))
    d[:, -1, -1] = np.nan
    return d


def _mm(depth):
    """What a depth video holds: the writer's uint16 millimetres, decoded."""
    return np.stack([t_dv.decode_depth_frame(t_dv.encode_depth_frame(f)) for f in depth])


SIZES = [(1, 6, 8), (3, 7, 9), (12, 48, 64), (5, 97, 131), (2, 192, 256)]


@pytest.mark.parametrize("t,h,w", SIZES, ids=lambda v: str(v))
def test_port_reads_opencvs_depth_video(tmp_path, rng, t, h, w):
    """OpenCV writes Golomb-Rice FFV1 version 3 with 2 x 2 slices, an alpha
    plane and frames between keyframes; the port decodes every frame to the
    bit. OpenCV's writer drops an odd last row and column; both readers see
    the same frames."""
    depth = _depth(rng, t, h, w)
    path = str(tmp_path / "depth.mkv")
    j_dv.write_depth_video(path, depth)
    want = j_dv.read_depth_video(path)
    got = t_dv.read_depth_video(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (t, h - h % 2, w - w % 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _mm(depth)[:, :h - h % 2, :w - w % 2])
    info = ffv1.Decoder(matroska.read(path).video.codec_private, w - w % 2, h - h % 2).info()
    assert (info["version"], info["coder_type"], info["colorspace_type"], info["transparency"]) == (3, 0, 1, 1)


@pytest.mark.parametrize("t,h,w", SIZES + [(2, 1, 1), (3, 2, 5)], ids=lambda v: str(v))
def test_opencv_reads_the_ports_depth_video(tmp_path, rng, t, h, w):
    """The port writes the range-coded kind (coder 1) with slice CRCs; OpenCV
    decodes it to the bit at every size, odd ones too."""
    depth = _depth(rng, t, h, w)
    path = str(tmp_path / "depth.mkv")
    t_dv.write_depth_video(path, depth)
    want = _mm(depth)
    np.testing.assert_array_equal(j_dv.read_depth_video(path), want)
    np.testing.assert_array_equal(t_dv.read_depth_video(path), want)


def test_all_zero_frame_and_max_frames(tmp_path, rng):
    depth = _depth(rng, 6, 48, 64)
    depth[2] = 0.0
    for writer in (j_dv, t_dv):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.mkv")
        writer.write_depth_video(path, depth)
        for n in (None, 0, 1, 3, 6, 10):
            got, want = t_dv.read_depth_video(path, max_frames=n), j_dv.read_depth_video(path, max_frames=n)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        assert not t_dv.read_depth_video(path)[2].any()


def test_metadata_sidecar_matches_jax(tmp_path, rng):
    depth = _depth(rng, 3, 32, 48)
    t_dv.write_depth_video(str(tmp_path / "p.mkv"), depth, fps=15.0)
    j_dv.write_depth_video(str(tmp_path / "j.mkv"), depth, fps=15.0)
    with open(tmp_path / "p.mkv.json") as f, open(tmp_path / "j.mkv.json") as g:
        assert json.load(f) == json.load(g)


def test_writer_streams_frames(tmp_path, rng):
    """`FFV1DepthVideoWriter` frame by frame, as the reprojection writes."""
    depth = _depth(rng, 4, 24, 40)
    path = str(tmp_path / "s.mkv")
    writer = t_dv.FFV1DepthVideoWriter(path, 40, 24, fps=30.0)
    for f in depth:
        writer.write_frame(f)
    writer.close()
    assert writer.get_metadata()["frame_count"] == 4
    np.testing.assert_array_equal(j_dv.read_depth_video(path), _mm(depth))


def _record_with(coder=None, version=None, colorspace=None):
    """The head of a configuration record (version, micro version, coder,
    colourspace, bits) with the fields given, its CRC made right."""
    rc = _RangeEncoder()
    values = {"version": version, "coder": coder, "colorspace": colorspace}
    state = [128] * 32
    for name, default in (("version", 3), ("micro", 4), ("coder", 1), ("colorspace", 1), ("bits", 8)):
        v = values.get(name)
        rc.symbol(state, default if v is None else v)
    return rc.finish()


class _RangeEncoder:
    """A few symbols of FFV1's range coder (RFC 9043 section 3.8.1) in Python,
    enough to forge the head of a configuration record."""

    def __init__(self):
        self.low, self.range, self.out, self.pending, self.count = 0, 0xFF00, bytearray(), -1, 0
        self.one, self.zero = _default_states()

    def _renorm(self):
        while self.range < 0x100:
            if self.pending < 0:
                self.pending = self.low >> 8
            elif self.low <= 0xFF00:
                self.out.append(self.pending)
                self.out += b"\xff" * self.count
                self.count, self.pending = 0, self.low >> 8
            elif self.low >= 0x10000:
                self.out.append(self.pending + 1)
                self.out += b"\x00" * self.count
                self.count, self.pending = 0, (self.low >> 8) - 0x100
            else:
                self.count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def put(self, state, i, bit):
        r1 = (self.range * state[i]) >> 8
        if bit:
            self.low += self.range - r1
            self.range = r1
            state[i] = self.one[state[i]]
        else:
            self.range -= r1
            state[i] = self.zero[state[i]]
        self._renorm()

    def symbol(self, state, v):
        if v == 0:
            self.put(state, 0, 1)
            return
        e = v.bit_length() - 1
        self.put(state, 0, 0)
        for i in range(e):
            self.put(state, 1 + min(i, 9), 1)
        self.put(state, 1 + min(e, 9), 0)
        for i in range(e - 1, -1, -1):
            self.put(state, 22 + min(i, 9), (v >> i) & 1)

    def finish(self) -> bytes:
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        body = bytes(self.out) + b"\0" * 8
        crc = 0
        for byte in body:
            crc ^= byte << 24
            for _ in range(8):
                crc = ((crc << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if crc & 0x80000000 else (crc << 1) & 0xFFFFFFFF
        return body + struct.pack(">I", crc)


def _default_states():
    one = [0] * 256
    big = 1 << 32
    factor, max_p = int(0.05 * big), 248
    last, p = 0, big // 2
    for _ in range(128):
        p8 = max((256 * p + big // 2) >> 32, last + 1)
        if last and last < 256 and p8 <= max_p:
            one[last] = p8
        p += ((big - p) * factor + big // 2) >> 32
        last = p8
    for i in range(256 - max_p, max_p + 1):
        if one[i]:
            continue
        p = (i * big + 128) >> 8
        p += ((big - p) * factor + big // 2) >> 32
        one[i] = min(max((256 * p + big // 2) >> 32, i + 1), max_p)
    zero = [0] * 256
    for i in range(1, 255):
        zero[i] = 256 - one[256 - i]
    return one, zero


@pytest.mark.parametrize("change,message", [
    (dict(coder=2), "coder_type 2 (range coder with a custom state-transition table)"),
    (dict(coder=3), "coder_type 3"),
    (dict(version=2), "version 2"),
    (dict(version=4), "version 4"),
    (dict(colorspace=0), "colorspace_type 0 (YCbCr)"),
])
def test_unsupported_streams_raise_with_their_name(change, message):
    with pytest.raises(ValueError, match=message.replace("(", r"\(").replace(")", r"\)")):
        ffv1.Decoder(_record_with(**change), 8, 6, name="forged")


def test_corrupt_slice_raises(tmp_path, rng):
    path = str(tmp_path / "c.mkv")
    t_dv.write_depth_video(path, _depth(rng, 1, 48, 64))
    c = matroska.read(path)
    dec = ffv1.Decoder(c.video.codec_private, 64, 48)
    packet = bytearray(c.frame(0))
    packet[len(packet) // 2] ^= 0x10
    with pytest.raises(ValueError, match="CRC mismatch"):
        dec.decode(bytes(packet))


def test_matroska_round_trip_and_refusals(tmp_path):
    path = tmp_path / "m.mkv"
    frames = [bytes([i]) * (i + 3) for i in range(5)]
    with open(path, "wb") as f:
        w = matroska.Writer(f, "V_TEST", b"\x01\x02", 4, 2, fps=2.0)
        w.CLUSTER_MS = 1000  # several clusters
        for p in frames:
            w.write(p)
        w.close()
    c = matroska.read(str(path))
    assert (c.video.codec_id, c.video.codec_private, c.video.width, c.video.height) == ("V_TEST", b"\x01\x02", 4, 2)
    assert [c.frame(i) for i in range(len(c.frames))] == frames and all(k for _, _, k in c.frames)
    with pytest.raises(ValueError, match="codec 'V_TEST'"):
        t_dv.read_depth_video(str(path))
    with pytest.raises(ValueError, match="not a Matroska file"):
        matroska.parse(b"RIFF....", "x.avi")


def test_codec_builds_with_gxx_only(tmp_path):
    """The codec library is g++ code: it builds with no CUDA toolkit."""
    lib_path = ffv1.native.library_path(ffv1.SOURCE)
    assert lib_path.parent.name == "_build" and lib_path.name.startswith("libffv1_")
    ffv1.load()
    assert lib_path.exists()


# -- HDF5 ----------------------------------------------------------------------

DATASETS = {
    "observation/robot_state/cartesian_position": ("f8", (300, 6)),
    "observation/robot_state/gripper_position": ("f8", (300, 1)),
    "observation/timestamp/robot_state/robot_timestamp_seconds": ("i8", (300,)),
    "action/gripper_velocity": ("f4", (300, 1)),
    "observation/controller_info/movement_enabled": ("bool", (300,)),
    "observation/robot_state/joint_positions": (">f8", (300, 7)),
    "small/u16": ("u2", (3, 4)),
    "small/i8": ("i1", (5,)),
    "small/scalar": ("f8", ()),
    "small/empty": ("f8", (0, 6)),
}


def _arrays(rng):
    out = {}
    for name, (dtype, shape) in DATASETS.items():
        if dtype == "bool":
            out[name] = rng.uniform(size=shape) > 0.5
        elif dtype[-2] in "iu":
            out[name] = rng.integers(0, 100, shape).astype(dtype)
        else:
            out[name] = rng.normal(size=shape).astype(dtype)
    return out


@pytest.mark.parametrize("layout", ["contiguous", "chunked", "deflate", "resized"])
def test_port_reads_what_h5py_writes(tmp_path, rng, layout):
    """h5py (HDF5's default "earliest" format) writes; the port reads every
    dataset, its dtype and shape, nested groups, attributes skipped."""
    data = _arrays(rng)
    path = str(tmp_path / "trajectory.h5")
    with h5py.File(path, "w") as f:
        for name, arr in data.items():
            kw = {}
            if layout != "contiguous" and arr.ndim and arr.shape[0]:
                kw = dict(chunks=(17,) + arr.shape[1:], maxshape=(None,) + arr.shape[1:])
                if layout == "deflate":
                    kw["compression"] = "gzip"
            if layout == "resized" and kw:
                ds = f.create_dataset(name, shape=(0,) + arr.shape[1:], dtype=arr.dtype, **kw)
                for i in range(0, arr.shape[0], 41):  # DROID's trajectory writer appends step by step
                    ds.resize(min(i + 41, arr.shape[0]), axis=0)
                    ds[i:i + 41] = arr[i:i + 41]
            else:
                f.create_dataset(name, data=arr, **kw)
        f["observation"].attrs["note"] = "skipped"
        for i in range(20):  # a group of more members than one symbol-table node holds
            f.create_dataset(f"many/x{i:02d}", data=np.arange(i))
    got = hdf5.read_all(path)
    assert set(got) == set(data) | {f"many/x{i:02d}" for i in range(20)}
    for name, arr in data.items():
        assert got[name].dtype == arr.dtype.newbyteorder("=") and got[name].shape == arr.shape, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    with hdf5.File(path) as f:
        ds = f["observation/robot_state/cartesian_position"]
        assert ds.shape == (300, 6) and ds.chunks == (None if layout == "contiguous" else (17, 6))
        assert ds.compression == ("gzip" if layout == "deflate" else None)
        np.testing.assert_array_equal(ds[10:20], data["observation/robot_state/cartesian_position"][10:20])
        assert "observation/robot_state" in f and "nope" not in f


@pytest.mark.parametrize("chunked", [False, True])
def test_h5py_reads_the_ports_files(tmp_path, rng, chunked):
    """`hdf5.write`, contiguous or chunked (resizable along axis 0, deflated),
    read by h5py, which can append to the chunked datasets."""
    data = _arrays(rng)
    path = str(tmp_path / "w.h5")
    chunks = {n: (64,) + a.shape[1:] for n, a in data.items() if a.ndim and a.shape[0]} if chunked else None
    hdf5.write(path, data, chunks=chunks, deflate=4 if chunked else None)
    with h5py.File(path, "r") as f:
        for name, arr in data.items():
            assert f[name].dtype == arr.dtype and f[name].shape == arr.shape, name
            np.testing.assert_array_equal(f[name][()], arr, err_msg=name)
            if chunks and name in chunks:
                assert f[name].chunks == chunks[name] and f[name].maxshape[0] is None
    if chunked:
        with h5py.File(path, "a") as f:
            ds = f["observation/robot_state/cartesian_position"]
            ds.resize(310, axis=0)
            ds[300:] = 7.0
        got = hdf5.read_all(path)["observation/robot_state/cartesian_position"]
        np.testing.assert_array_equal(got[:300], data["observation/robot_state/cartesian_position"])
        assert (got[300:] == 7.0).all()


@pytest.mark.parametrize("kind,message", [
    ("shuffle", "filter 2 (shuffle)"),
    ("fletcher32", "filter 3 (fletcher32)"),
    ("latest", "superblock version 3"),
    ("string", "datatype class 3 (string)"),
])
def test_unsupported_hdf5_raises_with_its_name(tmp_path, kind, message):
    path = str(tmp_path / "x.h5")
    with h5py.File(path, "w", libver="latest" if kind == "latest" else None) as f:
        if kind == "string":
            f.create_dataset("a", data=np.array([b"abc", b"de"]))
        else:
            f.create_dataset("a", data=np.arange(20.0), chunks=(5,), **{kind: True} if kind != "latest" else {})
    with pytest.raises(ValueError, match=message.replace("(", r"\(").replace(")", r"\)")):
        with hdf5.File(path) as f:
            f["a"][()]


def test_raw_episode_trajectory_through_both(tmp_path):
    """`make_raw_episode`'s trajectory.h5 from the port's writer is what the
    JAX package's (h5py) writes, value for value."""
    from mvtracker_torch.droid import synth_episode as t_se
    from mvtracker_tpu.droid import synth_episode as j_se

    t_se.make_raw_episode(str(tmp_path / "t"), seed=3, n_frames=12)
    j_se.make_raw_episode(str(tmp_path / "j"), seed=3, n_frames=12)
    with h5py.File(tmp_path / "t" / "trajectory.h5") as a, h5py.File(tmp_path / "j" / "trajectory.h5") as b:
        for key in ("observation/robot_state/cartesian_position", "observation/robot_state/gripper_position"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key][()], b[key][()])
    assert open(tmp_path / "t" / "metadata.json").read() == open(tmp_path / "j" / "metadata.json").read()
    assert os.path.getsize(tmp_path / "t" / "trajectory.h5") > 0
