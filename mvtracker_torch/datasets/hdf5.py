"""HDF5 files in Python and numpy: the port's own reader and writer, standing
in for the `h5py` calls of the JAX package's DROID factory (raw episodes'
`trajectory.h5`). The GPU host has no h5py.

Read (`File`): what h5py writes with its default settings (HDF5's
"earliest" format) -- superblock version 0 or 1, version 1 object headers
with their continuation blocks, groups as symbol tables (version 1 B-tree,
local heap), and datasets with a compact, contiguous or chunked layout
(layout message versions 1-3, chunks indexed by a version 1 B-tree, so
resizable `maxshape=(None, ...)` datasets read too). Chunks may carry the
deflate filter, undone with `zlib`. Element types: IEEE float (32 and 64
bits), integers of 1-8 bytes either signed or not, in either byte order, and
h5py's booleans (an enum of int8 with FALSE = 0 and TRUE = 1).

Anything else raises `ValueError` naming the file and what is not
supported: superblock versions 2 and 3 (`libver="latest"` files, with their
version 2 object headers and link messages), layout version 4, any filter
but deflate (shuffle, Fletcher-32, szip, ...), and other element types
(strings, compounds, references, ...). Attributes are skipped.

Write (`write`): datasets in nested groups, contiguous or chunked (one
B-tree leaf of up to 64 chunks a dataset, resizable along axis 0, optionally
deflated), in the same format h5py writes by default, which h5py reads
back.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF
FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset"}
CLASS_NAMES = {0: "integer", 1: "float", 2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
               7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
LAYOUT_NAMES = {0: "compact", 1: "contiguous", 2: "chunked", 3: "virtual"}

# Message types of version 1 object headers.
MSG_DATASPACE, MSG_DATATYPE, MSG_FILL_OLD, MSG_FILL, MSG_LAYOUT = 0x1, 0x3, 0x4, 0x5, 0x8
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE, MSG_LINK = 0xB, 0x10, 0x11, 0x6


class _Reader:
    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        base = data.find(SIGNATURE)
        while base > 0 and base & (base - 1):  # the superblock sits at 0, 512, 1024, 2048, ...
            base = data.find(SIGNATURE, base + 1)
        if base < 0:
            raise ValueError(f"{path}: not an HDF5 file (no superblock signature)")
        version = data[base + 8]
        if version not in (0, 1):
            raise ValueError(f"{path}: HDF5 superblock version {version} (libver='latest' files) is not supported")
        self.so, self.sl = data[base + 13], data[base + 14]
        if self.so != 8 or self.sl != 8:
            raise ValueError(f"{path}: HDF5 offsets of {self.so} and lengths of {self.sl} bytes are not supported")
        p = base + 24 + (4 if version == 1 else 0)
        self.base = self.u(p, 8)
        root_entry = p + 32
        self.root = self.u(root_entry + 8, 8)

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def u(self, pos: int, n: int) -> int:
        if pos + n > len(self.data):
            self.fail(f"truncated HDF5 file (read of {n} bytes at {pos})")
        return int.from_bytes(self.data[pos:pos + n], "little")

    def addr(self, a: int) -> int:
        return self.base + a

    # -- object headers
    def messages(self, addr: int) -> list[tuple[int, int, int, int]]:
        """(type, flags, data offset, size) of an object header's messages."""
        p = self.addr(addr)
        version = self.data[p]
        if self.data[p:p + 4] == b"OHDR":
            self.fail("HDF5 version 2 object headers (libver='latest') are not supported")
        if version != 1:
            self.fail(f"HDF5 object header version {version} is not supported")
        n = self.u(p + 2, 2)
        blocks = [(p + 16, self.u(p + 8, 4))]
        out = []
        while blocks and len(out) < n:
            start, size = blocks.pop(0)
            q = start
            while q + 8 <= start + size and len(out) < n:
                mtype, msize, flags = self.u(q, 2), self.u(q + 2, 2), self.data[q + 4]
                body = q + 8
                if mtype == MSG_CONTINUATION:
                    blocks.append((self.addr(self.u(body, 8)), self.u(body + 8, 8)))
                out.append((mtype, flags, body, msize))
                q = body + msize
        return out

    def is_group(self, addr: int) -> bool:
        return any(t in (MSG_SYMBOL_TABLE, MSG_LINK) for t, _, _, _ in self.messages(addr))

    # -- groups
    def group_members(self, addr: int) -> dict[str, int]:
        msgs = self.messages(addr)
        tables = [(b, s) for t, _, b, s in msgs if t == MSG_SYMBOL_TABLE]
        if not tables:
            if any(t == MSG_LINK for t, _, _, _ in msgs):
                self.fail("HDF5 groups stored as link messages (libver='latest') are not supported")
            self.fail(f"object at {addr} is not a group")
        body = tables[0][0]
        btree, heap = self.u(body, 8), self.u(body + 8, 8)
        h = self.addr(heap)
        if self.data[h:h + 4] != b"HEAP":
            self.fail("HDF5 local heap signature missing")
        heap_data = self.addr(self.u(h + 24, 8))
        members: dict[str, int] = {}
        self._walk_group_btree(btree, heap_data, members)
        return members

    def _walk_group_btree(self, addr: int, heap_data: int, members: dict):
        p = self.addr(addr)
        if self.data[p:p + 4] != b"TREE" or self.data[p + 4] != 0:
            self.fail("HDF5 group B-tree node missing or of the wrong type")
        level, used = self.data[p + 5], self.u(p + 6, 2)
        q = p + 24 + 8  # after the header and key 0
        for _ in range(used):
            child = self.u(q, 8)
            q += 16  # child address, then the next key
            if level > 0:
                self._walk_group_btree(child, heap_data, members)
                continue
            s = self.addr(child)
            if self.data[s:s + 4] != b"SNOD":
                self.fail("HDF5 symbol table node signature missing")
            for e in range(self.u(s + 6, 2)):
                entry = s + 8 + 40 * e
                name_at = heap_data + self.u(entry, 8)
                name = self.data[name_at:self.data.index(b"\0", name_at)].decode()
                members[name] = self.u(entry + 8, 8)

    # -- datasets
    def dtype(self, p: int) -> np.dtype:
        cls, version = self.data[p] & 0x0F, self.data[p] >> 4
        bits = self.data[p + 1]
        size = self.u(p + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0:
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:
            if size not in (4, 8) or bits & 0x40:
                self.fail(f"HDF5 float of {size} bytes (or VAX order) is not supported")
            return np.dtype(f"{order}f{size}")
        if cls == 8:
            base = self.dtype(p + 8)
            nmembers = self.u(p + 1, 2)
            q = p + 8 + 8 + (4 if base.kind in "iu" else 12)  # past the base type's header and properties
            names = []
            for _ in range(nmembers):
                end = self.data.index(b"\0", q)
                names.append(self.data[q:end].decode())
                n = end + 1 - q
                q += n if version >= 3 else -(-n // 8) * 8  # versions 1 and 2 pad each name to 8 bytes
            values = np.frombuffer(self.data[q:q + nmembers * base.itemsize], base)
            if base.itemsize == 1 and dict(zip(names, values.tolist())) == {"FALSE": 0, "TRUE": 1}:
                return np.dtype(bool)
            self.fail(f"HDF5 enum {names} is not supported (only h5py's booleans)")
        self.fail(f"HDF5 datatype class {cls} ({CLASS_NAMES.get(cls, '?')}) is not supported")

    def dataset(self, addr: int, name: str) -> dict:
        info: dict = {"name": name, "filters": [], "fill": None}
        for mtype, flags, b, size in self.messages(addr):
            if flags & 0x02 and mtype in (MSG_DATATYPE, MSG_DATASPACE, MSG_FILTERS, MSG_FILL):
                self.fail(f"{name}: shared HDF5 messages (committed datatypes) are not supported")
            if mtype == MSG_DATASPACE:
                version, rank, fl = self.data[b], self.data[b + 1], self.data[b + 2]
                q = b + (8 if version == 1 else 4)
                if version == 2 and self.data[b + 3] == 2:
                    self.fail(f"{name}: HDF5 null dataspace is not supported")
                info["shape"] = tuple(self.u(q + 8 * i, 8) for i in range(rank))
            elif mtype == MSG_DATATYPE:
                info["dtype"] = self.dtype(b)
            elif mtype == MSG_LAYOUT:
                info["layout"] = self._layout(b, name)
            elif mtype == MSG_FILTERS:
                info["filters"] = self._filters(b, name)
            elif mtype == MSG_FILL:
                version = self.data[b]
                if version in (1, 2) and (version == 1 or self.data[b + 3]):
                    n = self.u(b + 4, 4)
                    info["fill"] = self.data[b + 8:b + 8 + n] if n else None
                elif version == 3 and self.data[b + 1] & 0x20:
                    n = self.u(b + 2, 4)
                    info["fill"] = self.data[b + 6:b + 6 + n] if n else None
        for key in ("shape", "dtype", "layout"):
            if key not in info:
                self.fail(f"{name}: HDF5 dataset without its {key} message")
        return info

    def _layout(self, b: int, name: str) -> dict:
        version = self.data[b]
        if version in (1, 2):
            rank, cls = self.data[b + 1], self.data[b + 2]
            q = b + 8
            a = None
            if cls != 0:
                a, q = self.u(q, 8), q + 8
            dims = [self.u(q + 4 * i, 4) for i in range(rank)]
            q += 4 * rank
            if cls == 0:
                n = self.u(q, 4)
                return {"class": 0, "data": (q + 4, n)}
            if cls == 1:
                return {"class": 1, "address": a, "size": int(np.prod(dims))}
            return {"class": 2, "btree": a, "chunk": dims[:-1]}
        if version != 3:
            self.fail(f"{name}: HDF5 data layout version {version} is not supported")
        cls = self.data[b + 1]
        if cls == 0:
            return {"class": 0, "data": (b + 4, self.u(b + 2, 2))}
        if cls == 1:
            return {"class": 1, "address": self.u(b + 2, 8), "size": self.u(b + 10, 8)}
        if cls == 2:
            rank = self.data[b + 2]
            a = self.u(b + 3, 8)
            dims = [self.u(b + 11 + 4 * i, 4) for i in range(rank)]
            return {"class": 2, "btree": a, "chunk": dims[:-1]}
        self.fail(f"{name}: HDF5 {LAYOUT_NAMES.get(cls, str(cls))} layout is not supported")

    def _filters(self, b: int, name: str) -> list[int]:
        version, n = self.data[b], self.data[b + 1]
        q = b + (8 if version == 1 else 2)
        ids = []
        for _ in range(n):
            fid = self.u(q, 2)
            name_len = self.u(q + 2, 2) if (version == 1 or fid >= 256) else 0
            q += 4 if (version == 1 or fid >= 256) else 2
            nvals = self.u(q + 2, 2)
            q += 4
            if version == 1:
                q += ((name_len + 7) // 8) * 8 + 4 * nvals + (4 if nvals % 2 else 0)
            else:
                q += name_len + 4 * nvals
            if fid != 1:
                self.fail(f"{name}: HDF5 filter {fid} ({FILTER_NAMES.get(fid, 'unknown')}) is not supported")
            ids.append(fid)
        return ids

    def read_dataset(self, info: dict) -> np.ndarray:
        shape, dtype, lay = info["shape"], info["dtype"], info["layout"]
        count = int(np.prod(shape)) if shape else 1
        storage = np.dtype(np.int8) if dtype == np.dtype(bool) else dtype
        if lay["class"] == 0:
            off, n = lay["data"]
            arr = np.frombuffer(self.data[off:off + n], storage, count)
        elif lay["class"] == 1:
            if lay["address"] == UNDEFINED:
                arr = self._filled(info, storage, count)
            else:
                off = self.addr(lay["address"])
                if off + count * storage.itemsize > len(self.data):
                    self.fail(f"{info['name']}: dataset runs past the end of the file")
                arr = np.frombuffer(self.data[off:off + count * storage.itemsize], storage, count)
        else:
            arr = self._read_chunked(info, storage)
        arr = arr.reshape(shape)
        return arr.astype(bool) if dtype == np.dtype(bool) else arr.astype(dtype.newbyteorder("="))

    def _filled(self, info, storage, count):
        fill = info["fill"]
        if fill and len(fill) == storage.itemsize:
            return np.full(count, np.frombuffer(fill, storage)[0], storage)
        return np.zeros(count, storage)

    def _read_chunked(self, info: dict, storage: np.dtype) -> np.ndarray:
        shape, chunk = info["shape"], info["layout"]["chunk"]
        rank = len(shape)
        out = self._filled(info, storage, int(np.prod(shape))).reshape(shape)
        if info["layout"]["btree"] == UNDEFINED:
            return out.reshape(-1)
        chunk_bytes = int(np.prod(chunk)) * storage.itemsize
        for size, mask, offsets, addr in self._chunks(info["layout"]["btree"], rank):
            raw = self.data[self.addr(addr):self.addr(addr) + size]
            if info["filters"] and not mask & 1:
                raw = zlib.decompress(raw)
            if len(raw) != chunk_bytes:
                self.fail(f"{info['name']}: chunk of {len(raw)} bytes, expected {chunk_bytes}")
            block = np.frombuffer(raw, storage).reshape(chunk)
            region = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, shape))
            out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
        return out.reshape(-1)

    def _chunks(self, addr: int, rank: int):
        p = self.addr(addr)
        if self.data[p:p + 4] != b"TREE" or self.data[p + 4] != 1:
            self.fail("HDF5 chunk B-tree node missing or of the wrong type")
        level, used = self.data[p + 5], self.u(p + 6, 2)
        key_size = 8 + 8 * (rank + 1)
        q = p + 24
        for _ in range(used):
            size, mask = self.u(q, 4), self.u(q + 4, 4)
            offsets = [self.u(q + 8 + 8 * i, 8) for i in range(rank)]
            child = self.u(q + key_size, 8)
            if level > 0:
                yield from self._chunks(child, rank)
            else:
                yield size, mask, offsets, child
            q += key_size + 8


class Dataset:
    """A dataset of an open `File`; `ds[()]`, `ds[:]` or any numpy index
    reads it (all of it, then the index)."""

    def __init__(self, reader: _Reader, addr: int, name: str):
        self._r = reader
        self._info = reader.dataset(addr, name)
        self.name = name
        self.shape = self._info["shape"]
        self.dtype = self._info["dtype"]
        lay = self._info["layout"]
        self.chunks = tuple(lay["chunk"]) if lay["class"] == 2 else None
        self.compression = "gzip" if self._info["filters"] else None

    def __getitem__(self, index):
        arr = self._r.read_dataset(self._info)
        return arr if index == () else arr[index]


class Group:
    def __init__(self, reader: _Reader, addr: int, name: str):
        self._r, self._addr, self.name = reader, addr, name
        self._members = reader.group_members(addr)

    def keys(self):
        return list(self._members)

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
            return True
        except KeyError:
            return False

    def __getitem__(self, key: str):
        node: Group = self
        parts = [p for p in key.split("/") if p]
        for i, part in enumerate(parts):
            if not isinstance(node, Group) or part not in node._members:
                raise KeyError(f"{self._r.path}: no object {key!r}")
            addr = node._members[part]
            name = node.name.rstrip("/") + "/" + part
            node = Group(self._r, addr, name) if self._r.is_group(addr) else Dataset(self._r, addr, name)
        return node


class File(Group):
    """Read-only HDF5 file (the whole file is read into memory)."""

    def __init__(self, path, mode: str = "r"):
        if mode != "r":
            raise ValueError("hdf5.File only reads; write with hdf5.write")
        with open(path, "rb") as f:
            reader = _Reader(f.read(), str(path))
        super().__init__(reader, reader.root, "/")

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_all(path) -> dict[str, np.ndarray]:
    """Every dataset of a file, by its full name without the leading '/'."""
    out: dict[str, np.ndarray] = {}

    def walk(g: Group):
        for k in g.keys():
            node = g[k]
            if isinstance(node, Group):
                walk(node)
            else:
                out[node.name.lstrip("/")] = node[()]

    with File(path) as f:
        walk(f)
    return out


# -- writing -------------------------------------------------------------------

_LEAF_K, _INTERNAL_K = 4, 16  # the defaults HDF5 writes in the superblock
_CHUNK_K = 32  # HDF5's default for chunk B-trees (superblock version 0 cannot say another)
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_GROUP_BTREE_SIZE = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _datatype_message(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    if dtype == np.dtype(bool):
        base = _datatype_message(np.dtype(np.int8))
        names = b"".join(_pad8(n + b"\0") for n in (b"FALSE", b"TRUE"))
        return struct.pack("<B3sI", 0x18, (2).to_bytes(3, "little"), 1) + base + names + bytes([0, 1])
    order = 1 if dtype.byteorder == ">" else 0
    if dtype.kind in "iu":
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return struct.pack("<B3sIHH", 0x10, bytes([bits, 0, 0]), dtype.itemsize, 0, 8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in (4, 8):
        if dtype.itemsize == 8:
            props = struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)
            sign = 63
        else:
            props = struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
            sign = 31
        return struct.pack("<B3sI", 0x11, bytes([0x20 | order, sign, 0]), dtype.itemsize) + props
    raise ValueError(f"hdf5.write: dtype {dtype} is not supported (float32/64, integers, bool)")


def _object_header(messages: list[tuple[int, bytes]]) -> bytes:
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(m)), 0) + _pad8(m) for t, m in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Writer:
    def __init__(self, deflate: Optional[int] = None):
        self.buf = bytearray(b"\0" * 96)  # the superblock, written last
        self.deflate = deflate

    def alloc(self, data: bytes) -> int:
        addr = len(self.buf)
        self.buf += data
        self.buf += b"\0" * (-len(self.buf) % 8)
        return addr

    def dataset(self, arr: np.ndarray, chunks=None, deflate=None) -> int:
        """Write one dataset: contiguous, or with `chunks` (a chunk shape) in
        chunks indexed by a version 1 B-tree, resizable along axis 0 like
        h5py's `maxshape=(None, ...)`, each chunk deflated at level
        `deflate` when it is given."""
        storage = arr.astype(np.int8) if arr.dtype == bool else arr
        maxshape = arr.shape if chunks is None else (UNDEFINED,) + arr.shape[1:]
        space = struct.pack("<BBBB4x", 1, arr.ndim, 1, 0) + b"".join(
            struct.pack("<Q", d) for d in arr.shape + maxshape)
        messages = [(MSG_DATASPACE, space), (MSG_DATATYPE, _datatype_message(arr.dtype))]
        fill = struct.pack("<BBBB", 2, 2, 2, 0)  # late allocation, fill if set, no fill value defined
        if chunks is None:
            raw = storage.tobytes()  # C order
            data_addr = self.alloc(raw) if raw else UNDEFINED
            layout = struct.pack("<BBQQ", 3, 1, data_addr, len(raw))
        else:
            chunks = tuple(int(c) for c in chunks)
            if len(chunks) != arr.ndim or arr.ndim == 0 or min(chunks) < 1:
                raise ValueError(f"hdf5.write: chunk shape {chunks} for a dataset of shape {arr.shape}")
            fill = struct.pack("<BBBB", 2, 3, 2, 0)  # incremental allocation
            btree = self._chunk_btree(storage, chunks, deflate)
            layout = struct.pack("<BBBQ", 3, 2, arr.ndim + 1, btree) + b"".join(
                struct.pack("<I", c) for c in chunks + (storage.itemsize,))
            if deflate is not None:
                # Filter pipeline version 1: deflate, optional, its level as
                # the one client value (padded to an even count).
                messages.append((MSG_FILTERS, struct.pack("<BB6xHHHH", 1, 1, 1, 8, 1, 1) + _pad8(b"deflate\0")
                                 + struct.pack("<II", int(deflate), 0)))
        messages += [(MSG_FILL, fill), (MSG_LAYOUT, layout)]
        return self.alloc(_object_header(messages))

    def _chunk_btree(self, storage: np.ndarray, chunks: tuple, deflate) -> int:
        """Write the chunks (edge chunks padded with zeros) and one leaf node
        of a version 1 B-tree indexing them; return the node's address."""
        grid = [range(0, max(d, 1), c) for d, c in zip(storage.shape, chunks)]
        origins = [tuple(o) for o in np.stack(np.meshgrid(*grid, indexing="ij"), -1).reshape(-1, storage.ndim)]
        if len(origins) > 2 * _CHUNK_K:
            raise ValueError(f"hdf5.write: {len(origins)} chunks, more than one B-tree node holds ({2 * _CHUNK_K})")
        rank = storage.ndim
        key = struct.Struct("<II" + "Q" * (rank + 1))
        node = bytearray(b"TREE" + bytes([1, 0]) + struct.pack("<HQQ", len(origins), UNDEFINED, UNDEFINED))
        for o in origins:
            block = np.zeros(chunks, storage.dtype)
            part = storage[tuple(slice(a, a + c) for a, c in zip(o, chunks))]
            block[tuple(slice(0, n) for n in part.shape)] = part
            raw = block.tobytes()
            if deflate is not None:
                raw = zlib.compress(raw, int(deflate))
            node += key.pack(len(raw), 0, *o, 0) + struct.pack("<Q", self.alloc(raw))
        # The last key bounds the last chunk: its origin plus the chunk shape.
        node += key.pack(0, 0, *(a + c for a, c in zip(origins[-1], chunks)), 0)
        node += b"\0" * (24 + (2 * _CHUNK_K + 1) * key.size + 2 * _CHUNK_K * 8 - len(node))
        return self.alloc(bytes(node))

    def group(self, tree: dict) -> tuple[int, int, int]:
        """Write a group's members and the group; (header, B-tree, heap)."""
        names = sorted(tree, key=lambda n: n.encode())
        if len(names) > 2 * _LEAF_K * 2 * _INTERNAL_K:
            raise ValueError(f"hdf5.write: more than {4 * _LEAF_K * _INTERNAL_K} members in one group")
        entries = []
        for name in names:
            node = tree[name]
            if isinstance(node, dict):
                header, btree, heap = self.group(node)
                entries.append((name, header, 1, struct.pack("<QQ", btree, heap)))
            else:
                arr, chunk_shape = node
                header = self.dataset(arr, chunk_shape, self.deflate if chunk_shape is not None else None)
                entries.append((name, header, 0, b"\0" * 16))
        heap_data = bytearray(b"\0" * 8)  # offset 0: the empty name
        offsets = []
        for name, *_ in entries:
            offsets.append(len(heap_data))
            heap_data += _pad8(name.encode() + b"\0")
        heap_data_addr = self.alloc(bytes(heap_data))
        heap = self.alloc(b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack("<QQQ", len(heap_data), 1, heap_data_addr))
        snods, keys = [], [0]
        for i in range(0, max(len(entries), 1), 2 * _LEAF_K):
            chunk = list(zip(entries, offsets))[i:i + 2 * _LEAF_K]
            node = bytearray(b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(chunk)))
            for (name, header, cache, scratch), off in chunk:
                node += struct.pack("<QQII", off, header, cache, 0) + scratch
            node += b"\0" * (_SNOD_SIZE - len(node))
            snods.append(self.alloc(bytes(node)))
            keys.append(chunk[-1][1] if chunk else 0)
        tree_node = bytearray(b"TREE" + bytes([0, 0]) + struct.pack("<HQQ", len(snods), UNDEFINED, UNDEFINED))
        for k, child in zip(keys, snods):
            tree_node += struct.pack("<QQ", k, child)
        tree_node += struct.pack("<Q", keys[-1])
        tree_node += b"\0" * (_GROUP_BTREE_SIZE - len(tree_node))
        btree = self.alloc(bytes(tree_node))
        header = self.alloc(_object_header([(MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]))
        return header, btree, heap

    def finish(self, root: tuple[int, int, int]) -> bytes:
        header, btree, heap = root
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
        sb += struct.pack("<QQQQ", 0, UNDEFINED, len(self.buf), UNDEFINED)
        sb += struct.pack("<QQII", 0, header, 1, 0) + struct.pack("<QQ", btree, heap)
        assert len(sb) == 96
        self.buf[:96] = sb
        return bytes(self.buf)


def write(path, datasets: dict[str, np.ndarray], chunks: Optional[dict] = None, deflate: Optional[int] = None):
    """Write `datasets` ({"group/sub/name": array}) to a new file at `path`.

    Datasets named in `chunks` ({name: chunk shape}) are chunked and
    resizable along axis 0 (DROID's trajectory writer makes such datasets),
    their chunks deflated at level `deflate` when it is given; the others
    are contiguous."""
    chunks = chunks or {}
    unknown = set(chunks) - set(datasets)
    if unknown:
        raise ValueError(f"hdf5.write: chunk shapes for datasets that are not written: {sorted(unknown)}")
    tree: dict = {}
    for full, arr in datasets.items():
        parts = [p for p in full.split("/") if p]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"hdf5.write: {full!r} needs {p!r} as a group and a dataset")
        node[parts[-1]] = (np.asarray(arr), chunks.get(full))
    w = _Writer(deflate)
    root = w.group(tree)
    with open(path, "wb") as f:
        f.write(w.finish(root))
