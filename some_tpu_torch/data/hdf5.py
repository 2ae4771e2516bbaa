"""The subset of HDF5 that the binarized dataset store uses, in numpy alone.

The card's machine has no h5py, and the binarizer writes, and the trainer
reads, ``{prefix}.data`` files in the layout that the JAX package's
``IndexedDatasetWriter`` gets from h5py's defaults (HDF5's earliest file
format). This module writes and reads that layout and nothing else:

* superblock version 0 (8-byte offsets and lengths), version-1 object
  headers (their continuation blocks followed);
* groups stored as symbol tables: a version-1 B-tree of group nodes over
  symbol-table nodes (``SNOD``, at most 2 x 4 entries each) and a local heap
  of names, of any depth;
* a file of groups (one an item, named ``"0"``, ``"1"``, ...) of datasets
  (one a field);
* every dataset contiguous (layout class 1), unfiltered, scalars included;
  an empty dataset has no address;
* datatypes: little- or big-endian integers of 1, 2, 4 or 8 bytes, IEEE
  floats of 2, 4 or 8 bytes, and bool as h5py stores it, an enum over int8
  with members FALSE = 0 and TRUE = 1, which reads back as bool.

Anything else (chunked, compact or filtered layouts, external storage,
variable-length or string types, version-2 object headers, superblocks of
another version, a group in the new link format) raises
:class:`UnsupportedHDF5`; nothing outside the subset is misread.

:class:`Hdf5Reader` reads the item index once, when the file is opened, and
each dataset's bytes at their offset (``os.pread``), never the whole file.
:class:`Hdf5Writer` streams each dataset's bytes to the file as it comes and
writes the metadata (object headers, heaps, symbol-table nodes, B-trees,
the superblock) when it is closed.

The byte layouts follow the HDF5 File Format Specification (version 0
superblock; version 1 object headers, B-trees and symbol-table nodes) and
the message encodings h5py 3.14 / HDF5 1.14 write.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K, INTERNAL_K = 4, 16        # h5py's defaults: SNODs of 8, B-tree nodes of 32
SNOD_ENTRIES, BTREE_CHILDREN = 2 * LEAF_K, 2 * INTERNAL_K
ENTRY_SIZE = 40                   # a symbol-table entry with 8-byte offsets
SNOD_SIZE = 8 + SNOD_ENTRIES * ENTRY_SIZE
BTREE_SIZE = 24 + BTREE_CHILDREN * 8 + (BTREE_CHILDREN + 1) * 8
HEAP_FREE_NULL = 1                # a local heap's free list ends at offset 1
SUPERBLOCK_SIZE = 96
# object header message types
MSG_NIL, MSG_DATASPACE, MSG_DATATYPE = 0x0, 0x1, 0x3
MSG_FILL_OLD, MSG_FILL, MSG_LAYOUT = 0x4, 0x5, 0x8
MSG_ATTRIBUTE, MSG_COMMENT, MSG_MTIME_OLD = 0xC, 0xD, 0xE
MSG_CONTINUATION, MSG_SYMBOL_TABLE, MSG_MTIME = 0x10, 0x11, 0x12
# messages that say nothing about a dataset's values or a group's members
_IGNORED = {MSG_NIL, MSG_FILL_OLD, MSG_FILL, MSG_ATTRIBUTE, MSG_COMMENT, MSG_MTIME_OLD,
            MSG_MTIME}
_FLOAT_LAYOUT = {  # size -> (exponent location, exponent size, mantissa size, bias)
    2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}
_BOOL_NAMES = (b"FALSE", b"TRUE")


class UnsupportedHDF5(ValueError):
    """A file, or a part of one, outside the subset this module reads."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---- datatypes ----

def _fixed_point_message(size: int, signed: bool) -> bytes:
    """A little-endian integer of ``size`` bytes."""
    return struct.pack("<B3BIHH", 0x10, 0x08 if signed else 0, 0, 0, size, 0, 8 * size)


def _datatype_message(dtype: np.dtype) -> bytes:
    """The datatype message h5py writes for a numpy dtype (little-endian)."""
    if dtype == np.bool_:
        base = _fixed_point_message(1, signed=True)
        names = b"".join(name + b"\0" * (_pad8(len(name) + 1) - len(name))
                         for name in _BOOL_NAMES)
        return struct.pack("<B3BI", 0x18, 2, 0, 0, 1) + base + names + bytes([0, 1])
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        return _fixed_point_message(dtype.itemsize, dtype.kind == "i")
    if dtype.kind == "f" and dtype.itemsize in _FLOAT_LAYOUT:
        size = dtype.itemsize
        exp_loc, exp_size, mant_size, bias = _FLOAT_LAYOUT[size]
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size, 0, 8 * size,
                           exp_loc, exp_size, 0, mant_size, bias)
    raise UnsupportedHDF5(f"dtype {dtype} is outside the subset (bool, integers, floats)")


def _parse_datatype(data: bytes) -> Tuple[np.dtype, int]:
    """(numpy dtype, bytes the message used) of a datatype message."""
    class_version, b0, b1, b2, size = struct.unpack_from("<B3BI", data, 0)
    cls, version = class_version & 0x0F, class_version >> 4
    if version not in (1, 2, 3):
        raise UnsupportedHDF5(f"datatype message version {version}")
    order = ">" if b0 & 0x01 else "<"
    if cls == 0:  # fixed point
        offset, precision = struct.unpack_from("<HH", data, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size or b0 & 0x06:
            raise UnsupportedHDF5(f"integer of {size} bytes, offset {offset}, precision "
                                  f"{precision}, padding bits {b0:#x}")
        return np.dtype(f"{order}{'i' if b0 & 0x08 else 'u'}{size}"), 12
    if cls == 1:  # floating point
        offset, precision, exp_loc, exp_size, mant_loc, mant_size, bias = struct.unpack_from(
            "<HHBBBBI", data, 8)
        want = _FLOAT_LAYOUT.get(size)
        if (want is None or (exp_loc, exp_size, mant_size, bias) != want or offset
                or mant_loc or precision != 8 * size or b1 != 8 * size - 1
                or (b0 & 0x30) != 0x20 or b0 & 0x0E or b2):
            raise UnsupportedHDF5(f"a float of {size} bytes that is not IEEE 754 "
                                  f"({data[:20].hex()})")
        return np.dtype(f"{order}f{size}"), 20
    if cls == 8:  # enumeration: h5py's bool only
        members = b0 | (b1 << 8)
        base, used = _parse_datatype(data[8:])
        at = 8 + used
        names = []
        for _ in range(members):
            end = data.index(b"\0", at)
            names.append(data[at:end])
            at += _pad8(end - at + 1) if version < 3 else end - at + 1
        values = np.frombuffer(data[at:at + members * base.itemsize], base).tolist()
        if (members != 2 or size != 1 or base != np.dtype("i1")
                or dict(zip(names, values)) != {b"FALSE": 0, b"TRUE": 1}):
            raise UnsupportedHDF5(f"an enum other than h5py's bool: {dict(zip(names, values))} "
                                  f"over {base}")
        return np.dtype(np.bool_), at + members * base.itemsize
    raise UnsupportedHDF5(f"datatype class {cls} (only integers, floats and h5py's bool)")


# ---- dataspaces and layouts ----

def _dataspace_message(shape: Tuple[int, ...]) -> bytes:
    """Version 1; a scalar is rank 0, a simple space carries its max dims."""
    if not shape:
        return struct.pack("<BBBB4x", 1, 0, 0, 0)
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBBB4x", 1, len(shape), 1, 0) + dims + dims


def _parse_dataspace(data: bytes) -> Tuple[int, ...]:
    """The shape of a version-1 dataspace message (rank 0: a scalar)."""
    version, rank, flags = struct.unpack_from("<BBB", data, 0)
    if version != 1:
        raise UnsupportedHDF5(f"dataspace message version {version}")
    if flags & 0x02:
        raise UnsupportedHDF5("a dataspace with a permutation index")
    return tuple(struct.unpack_from(f"<{rank}Q", data, 8))


def _parse_layout(data: bytes) -> Tuple[int, int]:
    """(address, size) of a contiguous layout message (version 3)."""
    version, cls = data[0], data[1]
    if version != 3:
        raise UnsupportedHDF5(f"data layout message version {version}")
    if cls != 1:
        raise UnsupportedHDF5({0: "a compact dataset", 2: "a chunked dataset",
                               3: "a virtual dataset"}.get(cls, f"layout class {cls}")
                              + " (only contiguous datasets)")
    return struct.unpack_from("<QQ", data, 2)


class DatasetInfo:
    """Where one dataset's values lie: shape, dtype, address and bytes."""

    __slots__ = ("shape", "dtype", "address", "nbytes")

    def __init__(self, shape, dtype, address, nbytes):
        self.shape, self.dtype, self.address, self.nbytes = shape, dtype, address, nbytes


# ---- the reader ----

class Hdf5Reader:
    """A read-only HDF5 file of the subset: ``items`` maps each top-level
    group's name to its object header, read once at open; :meth:`fields`
    lists a group's datasets, :meth:`read` one dataset's values."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            self._size = os.fstat(self._fd).st_size
            root = self._superblock()
            self.items = {name: header for name, header in self._group(root)}
        except BaseException:
            os.close(self._fd)
            raise
        self._fields: Dict[str, Dict[str, DatasetInfo]] = {}

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def _read(self, address: int, n: int) -> bytes:
        if address == UNDEF or address + n > self._size:
            raise UnsupportedHDF5(f"{self.path}: {n} bytes at {address:#x} lie outside the file "
                                  f"of {self._size} bytes")
        data = os.pread(self._fd, n, address)
        if len(data) != n:
            raise UnsupportedHDF5(f"{self.path}: short read at {address:#x}")
        return data

    def _superblock(self) -> int:
        head = self._read(0, SUPERBLOCK_SIZE)
        if head[:8] != SIGNATURE:
            raise UnsupportedHDF5(f"{self.path}: no HDF5 signature at offset 0")
        if head[8] != 0:
            raise UnsupportedHDF5(f"{self.path}: superblock version {head[8]} (only 0)")
        if head[13] != 8 or head[14] != 8:
            raise UnsupportedHDF5(f"{self.path}: offsets of {head[13]} and lengths of "
                                  f"{head[14]} bytes (only 8)")
        base, = struct.unpack_from("<Q", head, 24)
        if base != 0:
            raise UnsupportedHDF5(f"{self.path}: base address {base} (a user block)")
        return struct.unpack_from("<Q", head, 64)[0]  # the root entry's object header

    def _messages(self, address: int) -> Iterable[Tuple[int, bytes]]:
        """(type, data) of every message of a version-1 object header."""
        prefix = self._read(address, 16)
        if prefix[:4] == b"OHDR":
            raise UnsupportedHDF5(f"{self.path}: a version 2 object header at {address:#x}")
        version, _, count, _, size = struct.unpack_from("<BBHII", prefix, 0)
        if version != 1:
            raise UnsupportedHDF5(f"{self.path}: object header version {version}")
        chunks, seen = [(address + 16, size)], 0
        while chunks:
            start, length = chunks.pop(0)
            block, at = self._read(start, length), 0
            while at + 8 <= length:
                kind, n, flags = struct.unpack_from("<HHB", block, at)
                data = block[at + 8:at + 8 + n]
                at += 8 + n
                seen += 1
                if flags & 0x02:
                    raise UnsupportedHDF5(f"{self.path}: a shared message (type {kind:#x})")
                if kind == MSG_CONTINUATION:
                    chunks.append(struct.unpack_from("<QQ", data, 0))
                elif kind not in _IGNORED:
                    yield kind, data
        if seen != count:
            raise UnsupportedHDF5(f"{self.path}: object header at {address:#x} holds {seen} "
                                  f"messages, says {count}")

    def _heap(self, address: int) -> bytes:
        head = self._read(address, 32)
        if head[:4] != b"HEAP" or head[4] != 0:
            raise UnsupportedHDF5(f"{self.path}: no version 0 local heap at {address:#x}")
        size, _, data = struct.unpack_from("<QQQ", head, 8)
        return self._read(data, size)

    def _group(self, header: int) -> List[Tuple[str, int]]:
        """(name, object header) of a group's members, in name order."""
        tables = [struct.unpack_from("<QQ", data, 0) for kind, data in self._messages(header)
                  if kind == MSG_SYMBOL_TABLE]
        if len(tables) != 1:
            raise UnsupportedHDF5(f"{self.path}: object {header:#x} is no symbol-table group")
        btree, heap_address = tables[0]
        heap = self._heap(heap_address)
        members = []
        self._walk(btree, heap, members, None)
        return members

    def _walk(self, address: int, heap: bytes, members: list, level: Optional[int]) -> None:
        node = self._read(address, BTREE_SIZE)
        signature, kind, node_level, used = struct.unpack_from("<4sBBH", node, 0)
        if signature != b"TREE" or kind != 0:
            raise UnsupportedHDF5(f"{self.path}: no group B-tree node at {address:#x}")
        if level is not None and node_level != level:
            raise UnsupportedHDF5(f"{self.path}: B-tree node at {address:#x} of level "
                                  f"{node_level}, want {level}")
        for i in range(used):
            child, = struct.unpack_from("<Q", node, 24 + 8 + 16 * i)
            if node_level:
                self._walk(child, heap, members, node_level - 1)
            else:
                self._symbols(child, heap, members)

    def _symbols(self, address: int, heap: bytes, members: list) -> None:
        node = self._read(address, 8)
        signature, version, count = struct.unpack_from("<4sBxH", node, 0)
        if signature != b"SNOD" or version != 1:
            raise UnsupportedHDF5(f"{self.path}: no symbol-table node at {address:#x}")
        entries = self._read(address + 8, count * ENTRY_SIZE)
        for i in range(count):
            name_at, header = struct.unpack_from("<QQ", entries, i * ENTRY_SIZE)
            name = heap[name_at:heap.index(b"\0", name_at)].decode()
            members.append((name, header))

    def fields(self, item: str) -> Dict[str, DatasetInfo]:
        """The datasets of top-level group ``item``, by name in name order
        (parsed once, then kept)."""
        out = self._fields.get(item)
        if out is None:
            out = {name: self._dataset(header) for name, header in self._group(self.items[item])}
            self._fields[item] = out
        return out

    def _dataset(self, header: int) -> DatasetInfo:
        shape = dtype = layout = None
        for kind, data in self._messages(header):
            if kind == MSG_DATASPACE:
                shape = _parse_dataspace(data)
            elif kind == MSG_DATATYPE:
                dtype = _parse_datatype(data)[0]
            elif kind == MSG_LAYOUT:
                layout = _parse_layout(data)
            elif kind == MSG_SYMBOL_TABLE:
                raise UnsupportedHDF5(f"{self.path}: a group where a dataset should be")
            else:
                raise UnsupportedHDF5(f"{self.path}: object header message type {kind:#x} "
                                      "(a filter pipeline, external storage, ...)")
        if shape is None or dtype is None or layout is None:
            raise UnsupportedHDF5(f"{self.path}: object {header:#x} is no dataset")
        address, nbytes = layout
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if (address != UNDEF or nbytes) and nbytes != want:
            raise UnsupportedHDF5(f"{self.path}: a dataset of shape {shape} {dtype} stores "
                                  f"{nbytes} bytes, want {want}")
        if address == UNDEF and want:
            raise UnsupportedHDF5(f"{self.path}: a dataset of shape {shape} never written")
        return DatasetInfo(shape, dtype, address, want)

    def read(self, info: DatasetInfo) -> np.ndarray:
        """One dataset's values, read at their offset."""
        if not info.nbytes:
            return np.zeros(info.shape, info.dtype)
        raw = self._read(info.address, info.nbytes)
        if info.dtype == np.bool_:
            return np.frombuffer(raw, np.int8).reshape(info.shape) != 0
        return np.frombuffer(raw, info.dtype).reshape(info.shape).copy()


# ---- the writer ----

class _Entry:
    """One member of a group as its symbol-table entry gives it."""

    __slots__ = ("name", "header", "btree", "heap")

    def __init__(self, name, header, btree=None, heap=None):
        self.name, self.header, self.btree, self.heap = name, header, btree, heap


class Hdf5Writer:
    """Writes a file of the subset: ``add_group(name, {field: array})`` one
    top-level group at a time, each dataset's bytes as it comes; ``close``
    writes the metadata and the superblock."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._file = open(self.path, "wb")
        self._file.write(bytes(SUPERBLOCK_SIZE))
        self._end = SUPERBLOCK_SIZE
        self._groups: List[Tuple[str, List[Tuple[str, bytes, bytes, int, int]]]] = []

    def _append(self, data: bytes) -> int:
        address = self._end
        self._file.write(data + bytes(_pad8(len(data)) - len(data)))
        self._end += _pad8(len(data))
        return address

    def add_group(self, name: str, fields: Dict[str, np.ndarray]) -> None:
        datasets = []
        for key, value in fields.items():
            array = np.asarray(value)
            datatype = _datatype_message(array.dtype)
            if array.dtype.byteorder == ">":
                array = array.astype(array.dtype.newbyteorder("<"))
            raw = np.ascontiguousarray(array).tobytes()
            address = self._append(raw) if raw else UNDEF
            datasets.append((key, _dataspace_message(array.shape), datatype, address, len(raw)))
        self._groups.append((name, datasets))

    @staticmethod
    def _header(messages: List[Tuple[int, int, bytes]]) -> bytes:
        """A version-1 object header of (type, flags, data) messages."""
        body = b"".join(struct.pack("<HHB3x", kind, _pad8(len(data)), flags)
                        + data + bytes(_pad8(len(data)) - len(data))
                        for kind, flags, data in messages)
        return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body

    def _dataset_header(self, dataspace: bytes, datatype: bytes, address: int,
                        nbytes: int) -> int:
        fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)  # h5py's: late, if set, defined, default
        layout = struct.pack("<BBQQ", 3, 1, address, nbytes)
        return self._append(self._header([(MSG_DATASPACE, 0, dataspace),
                                          (MSG_DATATYPE, 1, datatype),
                                          (MSG_FILL, 1, fill), (MSG_LAYOUT, 0, layout)]))

    def _group(self, members: List[_Entry]) -> _Entry:
        """Write a group of ``members``: heap, symbol-table nodes, B-tree and
        object header. Returns its entry (without a name)."""
        members = sorted(members, key=lambda m: m.name.encode())
        heap_data, offsets = bytearray(8), []  # offset 0: the empty name
        for m in members:
            offsets.append(len(heap_data))
            name = m.name.encode() + b"\0"
            heap_data += name + bytes(_pad8(len(name)) - len(name))
        data_address = self._append(bytes(heap_data))
        heap = self._append(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data),
                                        HEAP_FREE_NULL, data_address))
        # level 0: symbol-table nodes of SNOD_ENTRIES members; each child
        # carries the heap offset of its last (largest) name
        children = []
        for start in range(0, len(members), SNOD_ENTRIES):
            chunk = members[start:start + SNOD_ENTRIES]
            node = bytearray(struct.pack("<4sBxH", b"SNOD", 1, len(chunk)))
            for i, m in enumerate(chunk, start):
                cache = 1 if m.btree is not None else 0
                node += struct.pack("<QQII", offsets[i], m.header, cache, 0)
                node += struct.pack("<QQ", m.btree, m.heap) if cache else bytes(16)
            node += bytes(SNOD_SIZE - len(node))
            children.append((self._append(bytes(node)), offsets[start + len(chunk) - 1]))
        # then B-tree nodes of up to BTREE_CHILDREN children, level by level,
        # until one node (an empty group's root has none); a node's first key
        # is the last name left of it, each later key its child's last name
        level = 0
        while True:
            nodes = []
            groups = [children[i:i + BTREE_CHILDREN]
                      for i in range(0, max(len(children), 1), BTREE_CHILDREN)]
            addresses = [self._end + i * BTREE_SIZE for i in range(len(groups))]
            left_key = 0
            for n, group in enumerate(groups):
                node = bytearray(struct.pack(
                    "<4sBBHQQ", b"TREE", 0, level, len(group),
                    addresses[n - 1] if n else UNDEF,
                    addresses[n + 1] if n + 1 < len(groups) else UNDEF))
                node += struct.pack("<Q", left_key)
                for child, key in group:
                    node += struct.pack("<QQ", child, key)
                node += bytes(BTREE_SIZE - len(node))
                if self._append(bytes(node)) != addresses[n]:
                    raise AssertionError("B-tree nodes must lie back to back")
                last_key = group[-1][1] if group else 0
                nodes.append((addresses[n], last_key))
                left_key = last_key
            if len(nodes) == 1:
                btree = nodes[0][0]
                break
            children, level = nodes, level + 1
        header = self._append(self._header([(MSG_SYMBOL_TABLE, 0,
                                             struct.pack("<QQ", btree, heap))]))
        return _Entry("", header, btree, heap)

    def close(self) -> None:
        if self._file is None:
            return
        items = []
        for name, datasets in self._groups:
            fields = [_Entry(key, self._dataset_header(space, dtype, address, nbytes))
                      for key, space, dtype, address, nbytes in datasets]
            group = self._group(fields)
            items.append(_Entry(name, group.header, group.btree, group.heap))
        root = self._group(items)
        superblock = (SIGNATURE + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
                      + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
                      + struct.pack("<QQQQ", 0, UNDEF, self._end, UNDEF)
                      + struct.pack("<QQII", 0, root.header, 1, 0)
                      + struct.pack("<QQ", root.btree, root.heap))
        self._file.seek(0)
        self._file.write(superblock)
        self._file.close()
        self._file = None
