"""A minimal HDF5 reader and writer for one array at the root of a file, on
the standard library and numpy, so that the port reads and writes the
reference's `ins_rgb.hdf5` palettes (`f["datasets"][:]`) without h5py.

read_dataset(path, name) reads the dataset `name` of the root group from:
- superblock version 0 with a symbol-table root group (v1 B-tree of group
  nodes, SNOD symbol nodes, a local heap of names): what h5py.File(p, "w")
  writes;
- superblock version 2 or 3 with a version-2 object header whose links are
  compact Link messages: what h5py.File(p, "w", libver="latest") writes;
- object headers of version 1 or 2, with continuation blocks;
- fixed-point datatypes of 1, 2, 4 or 8 bytes, signed or unsigned, either
  byte order, and IEEE float32 / float64;
- compact or contiguous layouts (layout message version 3 or 4).
Chunked or filtered layouts, dense link storage, shared messages, other
datatypes, a superblock that does not start the file and anything else
raise a ValueError naming the file and the structure met. Checksums of the
version-2 structures are not verified.

write_dataset(path, name, array) writes one contiguous dataset at the root,
in the layout of the first kind above (superblock 0, no checksums).
"""

from __future__ import annotations

import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL, _LINK = 0x1, 0x2, 0x3, 0x5, 0x6
_LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x8, 0xB, 0x10, 0x11


class _Reader:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read()
        self.base = self._superblock()

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def u(self, off: int, n: int) -> int:
        if off + n > len(self.buf):
            self.fail(f"read of {n} bytes at offset {off} runs past the end of the file")
        return int.from_bytes(self.buf[off:off + n], "little")

    def addr(self, off: int) -> int:
        return self.u(off, self.so)

    def at(self, off: int, sig: bytes, what: str) -> None:
        if self.buf[off:off + len(sig)] != sig:
            self.fail(f"expected a {what} ({sig!r}) at offset {off}")

    def _superblock(self) -> int:
        if self.buf[:8] != _SIGNATURE:
            self.fail("no HDF5 superblock signature at the start of the file")
        version = self.buf[8]
        if version == 0:
            self.so, self.sl = self.buf[13], self.buf[14]
            base = self.addr(24)
            entry = 24 + 4 * self.so                      # the root group's symbol table entry
            self.root = base + self.addr(entry + self.so)
        elif version in (2, 3):
            self.so, self.sl = self.buf[9], self.buf[10]
            base = self.addr(12)
            self.root = base + self.addr(12 + 3 * self.so)
        else:
            self.fail(f"superblock version {version} is not supported")
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            self.fail(f"superblock sizes of offsets {self.so} / lengths {self.sl}")
        self.undef = (1 << 8 * self.so) - 1                  # the undefined address
        return base

    # ------------------------------------------------------------ object headers

    def messages(self, oh: int):
        """[(type, payload offset, payload size, flags)] of the object header at oh."""
        out = []
        if self.buf[oh:oh + 4] == b"OHDR":
            version, flags = self.buf[oh + 4], self.buf[oh + 5]
            if version != 2:
                self.fail(f"object header at {oh}: OHDR version {version}")
            p = oh + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 0x3)
            size = self.u(p, width)
            blocks = [(p + width, p + width + size)]
            order = 2 if flags & 0x04 else 0
            while blocks:                                 # (start, end) of messages
                p, end = blocks.pop(0)
                while p + 4 + order <= end:                   # a shorter rest is a gap
                    mtype, msize, mflags = self.buf[p], self.u(p + 1, 2), self.buf[p + 3]
                    payload = p + 4 + order
                    out.append((mtype, payload, msize, mflags))
                    if mtype == _CONTINUATION:               # signature ... checksum
                        c = self.base + self.addr(payload)
                        self.at(c, b"OCHK", "continuation block")
                        blocks.append((c + 4, c + self.u(payload + self.so, self.sl) - 4))
                    p = payload + msize
            return out
        version = self.buf[oh]
        if version != 1:
            self.fail(f"object header at {oh}: version {version} is not supported")
        count, size = self.u(oh + 2, 2), self.u(oh + 8, 4)
        blocks = [(oh + 16, oh + 16 + size)]
        while blocks and len(out) < count:
            p, end = blocks.pop(0)
            while p + 8 <= end and len(out) < count:
                mtype, msize, mflags = self.u(p, 2), self.u(p + 2, 2), self.buf[p + 4]
                out.append((mtype, p + 8, msize, mflags))
                if mtype == _CONTINUATION:
                    c = self.base + self.addr(p + 8)
                    blocks.append((c, c + self.u(p + 8 + self.so, self.sl)))
                p += 8 + msize
        return out

    # ------------------------------------------------------------ groups

    def lookup(self, name: str) -> int:
        """The object header address of the root group's link `name`."""
        msgs = self.messages(self.root)
        for mtype, p, _, _ in msgs:
            if mtype == _SYMBOL_TABLE:
                heap = self.base + self.addr(p + self.so)
                names = self._heap_names(heap)
                for name_off, oh in self._btree_entries(self.base + self.addr(p)):
                    if names(name_off) == name:
                        return oh
                self.fail(f"no object {name!r} in the root group")
        for mtype, p, _, _ in msgs:
            if mtype == _LINK_INFO and \
                    self.addr(p + 2 + (8 if self.buf[p + 1] & 1 else 0)) != self.undef:
                self.fail("the root group keeps its links in dense storage (a fractal "
                          "heap), which is not supported")
        for mtype, p, _, _ in msgs:
            if mtype == _LINK:
                link_name, target = self._link(p)
                if link_name == name:
                    if target is None:
                        self.fail(f"link {name!r} is not a hard link")
                    return target
        self.fail(f"no object {name!r} in the root group")

    def _heap_names(self, heap: int):
        self.at(heap, b"HEAP", "local heap")
        data = self.base + self.addr(heap + 8 + 2 * self.sl)

        def name(off):
            start = data + off
            return self.buf[start:self.buf.index(b"\0", start)].decode()
        return name

    def _btree_entries(self, node: int):
        """(name offset, object header) of every symbol under a v1 group B-tree."""
        self.at(node, b"TREE", "v1 B-tree node")
        ntype, level, used = self.buf[node + 4], self.buf[node + 5], self.u(node + 6, 2)
        if ntype != 0:
            self.fail(f"B-tree node at {node} has type {ntype}, not a group node")
        p = node + 8 + 2 * self.so + self.sl                # past key 0
        for i in range(used):
            child = self.base + self.addr(p + i * (self.so + self.sl))
            if level > 0:
                yield from self._btree_entries(child)
                continue
            self.at(child, b"SNOD", "symbol table node")
            for k in range(self.u(child + 6, 2)):
                e = child + 8 + k * (2 * self.so + 24)       # one symbol table entry
                yield self.addr(e), self.base + self.addr(e + self.so)

    def _link(self, p: int):
        """(name, object header or None) of a Link message."""
        version, flags = self.buf[p], self.buf[p + 1]
        if version != 1:
            self.fail(f"link message version {version}")
        q = p + 2
        ltype = 0
        if flags & 0x08:
            ltype = self.buf[q]
            q += 1
        if flags & 0x04:
            q += 8                                           # creation order
        if flags & 0x10:
            q += 1                                           # name character set
        width = 1 << (flags & 0x3)
        n = self.u(q, width)
        name = self.buf[q + width:q + width + n].decode()
        q += width + n
        return name, (self.base + self.addr(q) if ltype == 0 else None)

    # ------------------------------------------------------------ datasets

    def dataset(self, oh: int, name: str) -> np.ndarray:
        shape = dtype = layout = None
        for mtype, p, size, mflags in self.messages(oh):
            if mtype in (_DATASPACE, _DATATYPE, _LAYOUT) and mflags & 0x02:
                self.fail(f"dataset {name!r}: shared message of type {mtype} is not supported")
            if mtype == _DATASPACE:
                shape = self._dataspace(p, name)
            elif mtype == _DATATYPE:
                dtype = self._datatype(p, name)
            elif mtype == _LAYOUT:
                layout = (p, size)
            elif mtype == _FILTERS:
                self.fail(f"dataset {name!r} has a filter pipeline (compressed or filtered "
                          "data), which is not supported")
        if shape is None or dtype is None or layout is None:
            self.fail(f"object {name!r} is not a dataset (no dataspace, datatype or layout)")
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * dtype.itemsize
        p, _ = layout
        version, klass = self.buf[p], self.buf[p + 1]
        if version not in (3, 4):
            self.fail(f"dataset {name!r}: layout message version {version}")
        if klass == 0:
            size, start = self.u(p + 2, 2), p + 4
        elif klass == 1:
            addr, size = self.addr(p + 2), self.u(p + 2 + self.so, self.sl)
            start = None if addr == self.undef else self.base + addr
        else:
            self.fail(f"dataset {name!r}: layout class {klass} "
                      f"({'chunked' if klass == 2 else 'virtual'}) is not supported")
        if count == 0:
            return np.zeros(shape, dtype)
        if start is None:
            self.fail(f"dataset {name!r}: contiguous storage was never allocated")
        if size < nbytes or start + nbytes > len(self.buf):
            self.fail(f"dataset {name!r}: storage of {size} bytes at {start} cannot hold "
                      f"{nbytes} bytes")
        return np.frombuffer(self.buf, dtype, count, start).reshape(shape).copy()

    def _dataspace(self, p: int, name: str):
        version, ndims = self.buf[p], self.buf[p + 1]
        if version == 1:
            q = p + 8
        elif version == 2:
            stype = self.buf[p + 3]
            if stype == 2:
                self.fail(f"dataset {name!r} has a null dataspace")
            q = p + 4
        else:
            self.fail(f"dataset {name!r}: dataspace message version {version}")
        return tuple(self.u(q + i * self.sl, self.sl) for i in range(ndims))

    def _datatype(self, p: int, name: str) -> np.dtype:
        klass, bits, size = self.buf[p] & 0x0F, self.u(p + 1, 3), self.u(p + 4, 4)
        order = ">" if bits & 0x01 else "<"
        if klass == 0:
            offset, precision = self.u(p + 8, 2), self.u(p + 10, 2)
            if size in (1, 2, 4, 8) and offset == 0 and precision == 8 * size:
                return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        elif klass == 1 and not bits & 0x40:
            props = (self.u(p + 8, 2), self.u(p + 10, 2), self.buf[p + 12], self.buf[p + 13],
                     self.buf[p + 14], self.buf[p + 15], self.u(p + 16, 4))
            if (size, props) in (((4, (0, 32, 23, 8, 0, 23, 127))),
                                 ((8, (0, 64, 52, 11, 0, 52, 1023)))):
                return np.dtype(f"{order}f{size}")
        self.fail(f"dataset {name!r}: datatype class {klass} of {size} bytes (bit field "
                  f"{bits:#x}) is not a supported integer or IEEE float type")


def read_dataset(path: str, name: str) -> np.ndarray:
    """The dataset `name` of the root group of the HDF5 file at path, as a
    numpy array in the file's byte order (as h5py returns it)."""
    r = _Reader(path)
    return r.dataset(r.lookup(name), name)


# ---------------------------------------------------------------- writer

def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, payload: bytes, flags: int = 0) -> bytes:
    payload = _pad8(payload)
    return struct.pack("<HHB3x", mtype, len(payload), flags) + payload


def _object_header(messages) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    order = 1 if dtype.byteorder == ">" or (dtype.byteorder == "=" and
                                            np.little_endian is False) else 0
    if dtype.kind in "iu":
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return struct.pack("<B3sIHH", 0x10, bits.to_bytes(3, "little"), dtype.itemsize,
                           0, 8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in (4, 8):
        exp_loc, exp_size, mant, bias = ((23, 8, 23, 127) if dtype.itemsize == 4
                                         else (52, 11, 52, 1023))
        # byte order, mantissa normalisation "implied", sign bit at the top
        bits = order | 0x20 | ((8 * dtype.itemsize - 1) << 8)
        return struct.pack("<B3sIHHBBBBI", 0x11, bits.to_bytes(3, "little"), dtype.itemsize,
                           0, 8 * dtype.itemsize, exp_loc, exp_size, 0, mant, bias)
    raise TypeError(f"write_dataset: dtype {dtype} is not an integer or float32/float64")


def write_dataset(path: str, name: str, array) -> None:
    """Write `array` as the one contiguous dataset `name` of a new HDF5 file
    (superblock 0, a symbol-table root group), which h5py and read_dataset
    read back equal."""
    arr = np.asarray(array, order="C")
    dtype = arr.dtype
    _datatype_message(dtype)                                 # refuse unsupported types first
    if not name or "/" in name or "\0" in name:
        raise ValueError(f"write_dataset: {name!r} is not a root-level dataset name")
    leaf_k, node_k = 4, 16                                   # the library's defaults
    sb_size, oh_root_size = 96, 16 + 8 + 16
    btree_size = 24 + 2 * node_k * 8 + (2 * node_k + 1) * 8
    snod_size = 8 + 2 * leaf_k * 40
    heap_data = _pad8(b"\0") + _pad8(name.encode() + b"\0")
    name_off = 8
    heap_size = 32

    root_oh = sb_size
    btree = root_oh + oh_root_size
    snod = btree + btree_size
    heap = snod + snod_size
    heap_seg = heap + heap_size
    data_oh = heap_seg + len(heap_data)

    space = struct.pack("<BBBB4x", 1, arr.ndim, 0, 0) + b"".join(
        struct.pack("<Q", d) for d in arr.shape)
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)             # late allocation, default fill
    msgs = [_message(_DATASPACE, space), _message(_DATATYPE, _datatype_message(dtype), 0x01),
            _message(_FILL, fill, 0x01)]
    layout_size = len(_message(_LAYOUT, b"\0" * 18))
    oh_size = 16 + sum(map(len, msgs)) + layout_size
    data_addr = data_oh + oh_size if arr.size else _UNDEF
    msgs.append(_message(_LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr, arr.nbytes)))
    data_ohdr = _object_header(msgs)
    eof = data_oh + len(data_ohdr) + arr.nbytes

    out = bytearray()
    out += _SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
    out += struct.pack("<HHI", leaf_k, node_k, 0)
    out += struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
    out += struct.pack("<QQII", 0, root_oh, 1, 0) + struct.pack("<QQ", btree, heap)
    out += _object_header([_message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))])
    node = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
    node += struct.pack("<QQQ", 0, snod, name_off)          # key 0, child 0, key 1
    out += node + b"\0" * (btree_size - len(node))
    entry = struct.pack("<QQII16x", name_off, data_oh, 0, 0)
    sym = b"SNOD" + struct.pack("<BBH", 1, 0, 1) + entry
    out += sym + b"\0" * (snod_size - len(sym))
    # local heap: no free block (the library's "null" free-list offset is 1)
    out += b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, heap_seg)
    out += heap_data
    out += data_ohdr
    out += arr.tobytes()
    assert len(out) == eof
    with open(path, "wb") as f:
        f.write(out)
