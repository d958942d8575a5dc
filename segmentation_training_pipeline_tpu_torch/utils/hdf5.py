"""Keras ``.h5`` weight files without h5py: a reader of the HDF5 subset
that libhdf5 writes for them.

Written from the *HDF5 File Format Specification* (version 3.0) with
numpy, ``zlib``, ``struct`` and ``mmap`` only.  It reads what h5py writes
under its default ``libver="earliest"`` and under ``libver="latest"``:

  * superblocks 0-3, 4- or 8-byte offsets and lengths;
  * object headers 1 (with continuation blocks) and 2 (``OHDR``/``OCHK``,
    the checksums read past);
  * groups: symbol tables (a v1 B-tree of type 0 at any depth, ``SNOD``
    nodes, the local heap), and link messages, compact or dense (link
    info, fractal heap, v2 B-tree name index);
  * attributes 1-3, in the header or dense (the same heap and B-tree
    code; huge heap objects included); fixed-length strings trimmed as
    h5py trims them, variable-length strings from the global heap;
    scalar and simple dataspaces;
  * IEEE floats of 2, 4 and 8 bytes, integers of 1-8 bytes, either byte
    order (big-endian data keeps numpy's ``>``);
  * layout messages 3 and 4: compact, contiguous, and (3) chunked through
    a v1 B-tree of type 1 with deflate, shuffle and fletcher32; storage
    never written reads as the fill value.

Everything else raises :class:`PretrainedWeightsError` naming what it met:
v4 chunk indexes, other filters, compound, enum, array, reference and
non-string variable-length types, external and virtual storage, shared
messages, a truncated file, a file that is not HDF5.

``File(path)`` opens the root group.  A group takes ``in`` and ``[...]``
with ``/``-separated paths; a dataset reads as the ``np.ndarray`` that
``np.asarray(h5py_dataset)`` gives (dtype, shape and bytes); ``.attrs``
maps names to values as h5py returns them (numpy scalars for scalar
dataspaces, ``str`` for variable-length strings), decoding each one only
when it is read.
"""

from __future__ import annotations

import mmap
import struct
import zlib
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..models.pretrained import PretrainedWeightsError

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
            5: "n-bit", 6: "scale-offset", 32000: "lzf"}
_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
            7: "reference", 8: "enum", 10: "array"}
# message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 1, 2, 3, 4, 5
_LINK, _EXTERNAL, _LAYOUT, _FILTER_PIPELINE, _ATTRIBUTE = 6, 7, 8, 11, 12
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 16, 17, 21
# IEEE layouts: size → (precision, exponent bits, mantissa bits, bias)
_IEEE = {2: (16, 5, 10, 15), 4: (32, 8, 23, 127), 8: (64, 11, 52, 1023)}


def _refuse(what: str):
    raise PretrainedWeightsError(f"HDF5: {what} is not supported")


def _enc_size(n: int) -> int:
    """Bytes libhdf5 takes to encode counts up to ``n``
    (``H5VM_limit_enc_size``)."""
    return (n.bit_length() - 1) // 8 + 1


class _Cursor:
    """Little-endian fields read through ``f`` (the file, or one message's
    bytes) from ``pos`` on; offsets and lengths of the file's sizes, the
    undefined address as None."""

    __slots__ = ("f", "pos")

    def __init__(self, f, pos: int):
        self.f, self.pos = f, pos

    def take(self, n: int) -> bytes:
        out = self.f.read(self.pos, n)
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def addr(self) -> Optional[int]:
        v = self.uint(self.f.so)
        return None if v == (1 << 8 * self.f.so) - 1 else v

    def length(self) -> int:
        return self.uint(self.f.sl)

    def signature(self, sig: bytes) -> None:
        got = self.take(len(sig))
        if got != sig:
            raise PretrainedWeightsError(
                f"HDF5: expected {sig.decode()} at {self.pos - len(sig)}, "
                f"found {got!r} (a corrupt file?)")


class _Store:
    """The file's bytes (memory-mapped), its superblock's sizes and the
    caches of what was parsed once."""

    def __init__(self, path: str):
        self.fh = open(path, "rb")
        try:
            self.size = self.fh.seek(0, 2)
            self.buf = (mmap.mmap(self.fh.fileno(), 0, access=mmap.ACCESS_READ)
                        if self.size else b"")
        except BaseException:
            self.fh.close()
            raise
        self.path = path
        self.so = self.sl = 8
        self.base = 0
        self.heaps: Dict[int, "_FractalHeap"] = {}
        self.collections: Dict[int, Dict[int, bytes]] = {}

    def close(self) -> None:
        if isinstance(self.buf, mmap.mmap):
            self.buf.close()
        self.fh.close()

    def read(self, addr: int, n: int) -> bytes:
        if addr < 0 or addr + n > self.size:
            raise PretrainedWeightsError(
                f"HDF5: {self.path} is truncated ({n} bytes at {addr} of a "
                f"{self.size}-byte file)")
        return self.buf[addr:addr + n]

    def at(self, addr: int) -> _Cursor:
        return _Cursor(self, self.base + addr)

    def superblock(self) -> int:
        """Parse the superblock; returns the root group's object header
        address."""
        pos = 0
        while True:            # after a user block of 512, 1024, … bytes
            if pos + 8 > self.size:
                raise PretrainedWeightsError(
                    f"{self.path} is not an HDF5 file (no HDF5 signature)")
            if self.read(pos, 8) == _SIGNATURE:
                break
            pos = 512 if pos == 0 else 2 * pos
        c = _Cursor(self, pos + 8)
        version = c.uint(1)
        if version in (0, 1):
            c.take(4)       # free-space, root entry, reserved, shared header
            self.so, self.sl = c.uint(1), c.uint(1)
            c.take(1 + 4 + 4)          # reserved, leaf K, internal K, flags
            if version == 1:
                c.take(4)              # indexed storage K, reserved
        elif version in (2, 3):
            self.so, self.sl = c.uint(1), c.uint(1)
            c.take(1)                  # flags
        else:
            _refuse(f"superblock version {version}")
        if self.so not in (4, 8) or self.sl not in (4, 8):
            _refuse(f"{self.so}-byte offsets with {self.sl}-byte lengths")
        c.addr()                       # base address: libhdf5 takes pos
        self.base = pos
        if version in (0, 1):
            c.addr()                   # free-space info
            eof = c.addr()
            c.addr()                   # driver info block
            c.length()                 # root entry: link name offset
            root = c.addr()
        else:
            c.addr()                   # superblock extension
            eof = c.addr()
            root = c.addr()
        if eof is None or eof > self.size:
            raise PretrainedWeightsError(
                f"HDF5: {self.path} is truncated (end of file at "
                f"{eof}, {self.size} bytes on disk)")
        return root

    def messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """(type, data) of every message of the object header at
        ``addr``, continuation blocks followed."""
        out: List[Tuple[int, bytes]] = []
        c = self.at(addr)
        if self.read(self.base + addr, 4) == b"OHDR":
            c.signature(b"OHDR")
            version, flags = c.uint(1), c.uint(1)
            if version != 2:
                _refuse(f"object header version {version}")
            if flags & 0x20:
                c.take(16)             # times
            if flags & 0x10:
                c.take(4)              # attribute phase change
            size0 = c.uint(1 << (flags & 3))
            blocks = [(c.pos, size0)]
            order = 2 if flags & 0x04 else 0
            while blocks:
                start, size = blocks.pop(0)
                blocks += self._chunk(start, size, 4 + order, out, 2)
        else:
            version = c.uint(1)
            if version != 1:
                raise PretrainedWeightsError(
                    f"HDF5: no object header at {addr} (version byte "
                    f"{version})")
            c.take(1 + 2 + 4)          # reserved, message count, refcount
            size0 = c.uint(4)
            blocks = [(c.pos + 4, size0)]      # messages 8-byte aligned
            while blocks:
                start, size = blocks.pop(0)
                blocks += self._chunk(start, size, 8, out, 1)
        return out

    def _chunk(self, start: int, size: int, head: int, out: list,
               version: int) -> List[Tuple[int, int]]:
        """The messages of one header chunk into ``out``; returns the
        continuation blocks it names (their message areas)."""
        more = []
        c = _Cursor(self, start)
        end = start + size
        while end - c.pos >= head:
            if version == 1:
                mtype, msize, mflags = c.uint(2), c.uint(2), c.uint(1)
                c.take(3)
            else:
                mtype, msize, mflags = c.uint(1), c.uint(2), c.uint(1)
                c.take(head - 4)       # creation order
            data = c.take(msize)
            if mflags & 0x02 and mtype in (_DATASPACE, _DATATYPE, _FILL_OLD,
                                           _FILL, _FILTER_PIPELINE,
                                           _ATTRIBUTE):
                _refuse(f"a shared message (type {mtype})")
            if mtype == _CONTINUATION:
                d = _message_cursor(data, self)
                where, n = d.addr(), d.length()
                if version == 1:
                    more.append((self.base + where, n))
                else:
                    _Cursor(self, self.base + where).signature(b"OCHK")
                    more.append((self.base + where + 4, n - 8))
            elif mtype:
                out.append((mtype, data))
        return more


class _Slice:
    """A message's bytes read through a ``_Cursor`` with the file's
    sizes."""

    def __init__(self, data: bytes, f: _Store):
        self.data, self.so, self.sl, self.path = data, f.so, f.sl, f.path

    def read(self, pos: int, n: int) -> bytes:
        if pos + n > len(self.data):
            raise PretrainedWeightsError(
                f"HDF5: {self.path}: a message shorter than its fields")
        return self.data[pos:pos + n]


def _message_cursor(data: bytes, f: _Store, pos: int = 0) -> _Cursor:
    return _Cursor(_Slice(data, f), pos)


# --------------------------------------------------------------------------
# v1 and v2 B-trees, heaps
# --------------------------------------------------------------------------

def _btree1(f: _Store, addr: int, node_type: int, key_size: int
            ) -> Iterator[Tuple[bytes, int]]:
    """(key before the child, child address) of every leaf entry of the
    v1 B-tree at ``addr``, in order."""
    c = f.at(addr)
    c.signature(b"TREE")
    kind, level, used = c.uint(1), c.uint(1), c.uint(2)
    if kind != node_type:
        raise PretrainedWeightsError(
            f"HDF5: B-tree node of type {kind} where {node_type} belongs")
    c.addr(), c.addr()                 # siblings
    entries = []
    for _ in range(used):
        key = c.take(key_size)
        entries.append((key, c.addr()))
    for key, child in entries:
        if level:
            yield from _btree1(f, child, node_type, key_size)
        else:
            yield key, child


def _btree2(f: _Store, addr: int, record_type: int) -> List[bytes]:
    """Every record of the v2 B-tree at ``addr``."""
    c = f.at(addr)
    c.signature(b"BTHD")
    c.uint(1)
    kind = c.uint(1)
    if kind != record_type:
        raise PretrainedWeightsError(
            f"HDF5: v2 B-tree of type {kind} where {record_type} belongs")
    node_size, rec_size, depth = c.uint(4), c.uint(2), c.uint(2)
    c.take(2)                          # split and merge percents
    root, nrec = c.addr(), c.uint(2)
    if root is None:
        return []
    # field widths of the internal nodes' child pointers (H5B2hdr.c)
    leaf_max = (node_size - 10) // rec_size
    nrec_size = _enc_size(leaf_max)
    cum, cum_size = [leaf_max], [0]
    for d in range(1, depth + 1):
        ptr = f.so + nrec_size + cum_size[d - 1]
        most = (node_size - (10 + ptr)) // (rec_size + ptr)
        cum.append((most + 1) * cum[d - 1] + most)
        cum_size.append(_enc_size(cum[d]))
    out: List[bytes] = []

    def node(where: int, n: int, d: int) -> None:
        c = f.at(where)
        c.signature(b"BTIN" if d else b"BTLF")
        c.take(2)                      # version, type
        out.extend(c.take(rec_size) for _ in range(n))
        if d:
            kids = []
            for _ in range(n + 1):
                child, k = c.addr(), c.uint(nrec_size)
                c.uint(cum_size[d - 1])
                kids.append((child, k))
            for child, k in kids:
                node(child, k, d - 1)

    node(root, nrec, depth)
    return out


class _FractalHeap:
    """Objects of a fractal heap by heap ID: managed objects in its
    doubling table of direct blocks, tiny ones in the ID, huge ones
    through its v2 B-tree."""

    def __init__(self, f: _Store, addr: int):
        self.f = f
        c = f.at(addr)
        c.signature(b"FRHP")
        c.uint(1)
        self.id_len, filter_len = c.uint(2), c.uint(2)
        c.uint(1)                      # flags
        max_managed = c.uint(4)
        c.length()                     # next huge ID
        self.huge_tree = c.addr()
        c.length(), c.addr()           # free space, its manager
        for _ in range(8):             # managed, huge and tiny sizes, counts
            c.length()
        self.width = c.uint(2)
        self.start, max_direct = c.length(), c.length()
        self.max_bits = c.uint(2)
        c.uint(2)                      # starting rows
        self.root, self.root_rows = c.addr(), c.uint(2)
        if filter_len:
            _refuse("a filtered fractal heap")
        self.off_bytes = (self.max_bits + 7) // 8
        self.len_bytes = min((max_direct.bit_length() - 1 + 7) // 8,
                             _enc_size(max_managed))
        self.direct_rows = (max_direct.bit_length()
                            - self.start.bit_length()) + 2
        self.huge_direct = f.so + f.sl <= self.id_len - 1
        self.blocks: Optional[List[Tuple[int, int, int]]] = None
        self.huge: Optional[Dict[int, Tuple[int, int]]] = None

    def _row_size(self, r: int) -> int:
        return self.start if r == 0 else self.start << (r - 1)

    def _direct_blocks(self) -> List[Tuple[int, int, int]]:
        """(heap offset, size, address) of every direct block."""
        if self.blocks is None:
            self.blocks = []
            if self.root is not None:
                if self.root_rows == 0:
                    self.blocks.append((0, self.start, self.root))
                else:
                    self._indirect(self.root, self.root_rows, 0)
        return self.blocks

    def _indirect(self, addr: int, rows: int, heap_off: int) -> None:
        c = self.f.at(addr)
        c.signature(b"FHIB")
        c.uint(1)
        c.addr()
        c.take(self.off_bytes)
        off = heap_off
        log_width = self.width.bit_length() - 1
        children = []
        for r in range(rows):
            size = self._row_size(r)
            for _ in range(self.width):
                children.append((r, off, size, c.addr()))
                off += size
        for r, off, size, child in children:
            if child is None:
                continue
            if r < self.direct_rows:
                self.blocks.append((off, size, child))
            else:
                self._indirect(child, r - log_width, off)

    def get(self, hid: bytes) -> bytes:
        kind = (hid[0] >> 4) & 3
        if hid[0] >> 6:
            _refuse(f"heap ID version {hid[0] >> 6}")
        if kind == 0:
            c = _message_cursor(hid, self.f, 1)
            off, n = c.uint(self.off_bytes), c.uint(self.len_bytes)
            for start, size, addr in self._direct_blocks():
                if start <= off and off + n <= start + size:
                    return self.f.read(self.f.base + addr + off - start, n)
            raise PretrainedWeightsError(
                f"HDF5: heap object at offset {off} lies in no block")
        if kind == 2:                  # tiny: the object is in the ID
            if self.id_len - 1 <= 16:
                n = (hid[0] & 0x0F) + 1
                return bytes(hid[1:1 + n])
            n = (((hid[0] & 0x0F) << 8) | hid[1]) + 1
            return bytes(hid[2:2 + n])
        if kind == 1:
            c = _message_cursor(hid, self.f, 1)
            if self.huge_direct:
                addr, n = c.addr(), c.length()
            else:
                key = c.uint(min(self.id_len - 1, 8))
                if self.huge is None:
                    self.huge = {}
                    if self.huge_tree is not None:
                        for rec in _btree2(self.f, self.huge_tree, 1):
                            r = _message_cursor(rec, self.f)
                            a, m = r.addr(), r.length()
                            self.huge[r.length()] = (a, m)
                if key not in self.huge:
                    raise PretrainedWeightsError(
                        f"HDF5: no huge heap object {key}")
                addr, n = self.huge[key]
            return self.f.read(self.f.base + addr, n)
        _refuse(f"heap ID type {kind}")


def _heap(f: _Store, addr: int) -> _FractalHeap:
    if addr not in f.heaps:
        f.heaps[addr] = _FractalHeap(f, addr)
    return f.heaps[addr]


def _global_object(f: _Store, addr: int, index: int) -> bytes:
    """Object ``index`` of the global heap collection at ``addr``."""
    if addr not in f.collections:
        c = f.at(addr)
        c.signature(b"GCOL")
        c.take(4)
        end = addr + c.length()
        align = -(8 + f.sl) % 8        # headers are padded to 8 bytes
        c.take(align)
        objs: Dict[int, bytes] = {}
        while f.base + end - c.pos >= 8 + f.sl:
            i = c.uint(2)
            if i == 0:
                break
            c.take(6)
            n = c.length()
            c.take(align)
            objs[i] = c.take(n)
            c.take(-n % 8)
        f.collections[addr] = objs
    if index not in f.collections[addr]:
        raise PretrainedWeightsError(
            f"HDF5: no object {index} in the global heap at {addr}")
    return f.collections[addr][index]


# --------------------------------------------------------------------------
# datatypes, dataspaces, values
# --------------------------------------------------------------------------

class _Type:
    """A datatype message: the numpy dtype of its elements, or the
    variable-length string marker, and a string's padding."""

    def __init__(self, data: bytes):
        cls, bits = data[0] & 0x0F, int.from_bytes(data[1:4], "little")
        self.size = int.from_bytes(data[4:8], "little")
        self.vlen, self.pad = False, None
        order = ">" if bits & 1 else "<"
        if cls == 0:
            if self.size not in (1, 2, 4, 8):
                _refuse(f"a {self.size}-byte integer")
            offset, precision = struct.unpack_from("<HH", data, 8)
            if offset or precision != 8 * self.size:
                _refuse(f"an integer of {precision} bits at bit {offset}")
            self.dtype = np.dtype(f"{order}{'i' if bits & 8 else 'u'}"
                                  f"{self.size}")
        elif cls == 1:
            if bits & 0x40:
                _refuse("VAX-ordered floats")
            ieee = _IEEE.get(self.size)
            offset, precision, _, exp, _, mant, bias = struct.unpack_from(
                "<HHBBBBI", data, 8)
            if ieee != (precision, exp, mant, bias) or offset:
                _refuse(f"a {self.size}-byte float of {exp} exponent and "
                        f"{mant} mantissa bits (not IEEE)")
            self.dtype = np.dtype(f"{order}f{self.size}")
        elif cls == 3:
            self.pad = bits & 0x0F
            self.dtype = np.dtype(f"S{self.size}")
        elif cls == 9:
            if bits & 0x0F != 1:
                _refuse("a variable-length sequence type "
                        "(non-string variable-length)")
            self.vlen = True
            self.dtype = np.dtype(object)
        else:
            _refuse(f"the {_CLASSES.get(cls, f'class {cls}')} datatype")


def _dataspace(data: bytes, f: _Store) -> Tuple[int, ...]:
    c = _message_cursor(data, f)
    version, rank = c.uint(1), c.uint(1)
    c.take(1)                          # flags: maximum dimensions follow
    if version == 1:
        c.take(5)
    elif version == 2:
        if c.uint(1) == 2:
            _refuse("a null dataspace")
    else:
        _refuse(f"dataspace version {version}")
    return tuple(c.length() for _ in range(rank))


def _strings(raw: np.ndarray, pad: int) -> np.ndarray:
    """Fixed-length strings as h5py reads them into null-padded memory:
    a null-padded file type is copied as it is; a null-terminated one
    ends at its first null, a space-padded one loses its trailing spaces
    (libhdf5's ``H5T__conv_s_s``)."""
    if pad == 1:
        return raw
    out = raw.copy()
    flat = out.reshape(-1)
    for i, s in enumerate(raw.reshape(-1).tolist()):
        flat[i] = s.rstrip(b" ") if pad == 2 else s.split(b"\0", 1)[0]
    return out


def _decode(data: bytes, t: _Type, shape: Tuple[int, ...], f: _Store
            ) -> np.ndarray:
    """Element bytes → the array h5py returns (vlen strings as ``str``)."""
    n = int(np.prod(shape, dtype=np.int64))
    if t.vlen:
        out = np.empty(n, object)
        c = _message_cursor(data, f)
        for i in range(n):
            size, addr, index = c.uint(4), c.addr(), c.uint(4)
            s = _global_object(f, addr, index)[:size] if size else b""
            out[i] = s.split(b"\0", 1)[0].decode("utf-8")
        return out.reshape(shape)
    if len(data) < n * t.size:
        raise PretrainedWeightsError(
            f"HDF5: {len(data)} bytes for {n} elements of {t.size}")
    arr = np.frombuffer(data, t.dtype, n).reshape(shape).copy()
    return _strings(arr, t.pad) if t.pad is not None else arr


def _attribute(data: bytes, f: _Store) -> Tuple[str, bytes]:
    """An attribute message → (name, its message bytes)."""
    version = data[0]
    if version not in (1, 2, 3):
        _refuse(f"attribute message version {version}")
    if version > 1 and data[1] & 0x03:
        _refuse("a shared datatype or dataspace in an attribute")
    n = struct.unpack_from("<H", data, 2)[0]
    start = 8 if version < 3 else 9
    return data[start:start + n].split(b"\0", 1)[0].decode("utf-8"), data


def _attribute_value(data: bytes, f: _Store):
    version = data[0]
    n, tsize, ssize = struct.unpack_from("<HHH", data, 2)
    pad = (lambda k: k + (-k % 8)) if version == 1 else (lambda k: k)
    pos = (8 if version < 3 else 9) + pad(n)
    t = _Type(data[pos:pos + tsize])
    pos += pad(tsize)
    shape = _dataspace(data[pos:pos + ssize], f)
    pos += pad(ssize)
    arr = _decode(data[pos:], t, shape, f)
    return arr[()] if not shape else arr


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------

def _unshuffle(data: bytes, size: int) -> bytes:
    n = len(data) // size
    body = np.frombuffer(data, np.uint8, n * size).reshape(size, n)
    return body.T.tobytes() + data[n * size:]


def _fletcher32(data: bytes) -> int:
    """libhdf5's ``H5_checksum_fletcher32``: the sum of the big-endian
    16-bit words and the sum of their running sums, each folded to a value
    in 1..65535 (0 only when every word is 0).  The weights are taken
    modulo 65535 so that the products' sum stays within 64 bits."""
    if len(data) % 2:
        data = data + b"\0"
    words = np.frombuffer(data, ">u2").astype(np.uint64)
    if not words.any():
        return 0
    weights = np.arange(len(words), 0, -1, dtype=np.uint64) % 0xFFFF
    s1, s2 = int(words.sum()), int((words * weights).sum())
    return ((s2 - 1) % 0xFFFF + 1) << 16 | ((s1 - 1) % 0xFFFF + 1)


def _filters(data: bytes) -> List[Tuple[int, List[int]]]:
    """A filter pipeline message → [(filter id, client data)]."""
    version, count = data[0], data[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(count):
        fid, = struct.unpack_from("<H", data, pos)
        name_len = 0
        if version == 1 or fid >= 256:
            name_len, = struct.unpack_from("<H", data, pos + 2)
            pos += 2
        _, nvalues = struct.unpack_from("<HH", data, pos + 2)
        pos += 6
        pos += name_len + (-name_len % 8 if version == 1 else 0)
        values = list(struct.unpack_from(f"<{nvalues}I", data, pos))
        pos += 4 * nvalues + (4 * (nvalues % 2) if version == 1 else 0)
        if fid not in (1, 2, 3):
            _refuse(f"the {_FILTERS.get(fid, f'filter {fid} (a plugin)')} "
                    f"filter")
        out.append((fid, values))
    return out


def _defilter(raw: bytes, pipeline, mask: int, path: str) -> bytes:
    for i in range(len(pipeline) - 1, -1, -1):
        if mask >> i & 1:
            continue
        fid, values = pipeline[i]
        if fid == 1:
            raw = zlib.decompress(raw)
        elif fid == 2:
            raw = _unshuffle(raw, values[0])
        else:
            body, stored = raw[:-4], int.from_bytes(raw[-4:], "little")
            sum_ = _fletcher32(body)
            swapped = ((sum_ & 0xFF) << 24 | (sum_ & 0xFF00) << 8
                       | (sum_ >> 8) & 0xFF00 | sum_ >> 24)
            if stored not in (sum_, swapped):
                raise PretrainedWeightsError(
                    f"HDF5: {path}: a chunk fails its fletcher32 checksum")
            raw = body
    return raw


def _fill_value(msgs: Dict[int, bytes], size: int) -> bytes:
    data = msgs.get(_FILL)
    if data is not None:
        version = data[0]
        if version in (1, 2):
            defined = data[3]
            if version == 1 or defined:
                n = int.from_bytes(data[4:8], "little")
                return data[8:8 + n] if n else bytes(size)
            return bytes(size)
        if data[1] & 0x20:
            n = int.from_bytes(data[2:6], "little")
            return data[6:6 + n] if n else bytes(size)
        return bytes(size)
    data = msgs.get(_FILL_OLD)
    if data is not None and int.from_bytes(data[:4], "little"):
        return data[4:4 + size]
    return bytes(size)


def _dataset(f: _Store, msgs: Dict[int, bytes], name: str) -> np.ndarray:
    if _EXTERNAL in msgs:
        _refuse("external storage")
    shape = _dataspace(msgs[_DATASPACE], f)
    t = _Type(msgs[_DATATYPE])
    if t.vlen:
        _refuse("a variable-length string dataset")
    n = int(np.prod(shape, dtype=np.int64))
    layout = msgs[_LAYOUT]
    c = _message_cursor(layout, f)
    version, cls = c.uint(1), c.uint(1)
    if version not in (3, 4):
        _refuse(f"layout message version {version}")
    if cls == 0:
        return _decode(c.take(c.uint(2)), t, shape, f)
    if cls == 1:
        addr, size = c.addr(), c.length()
        if addr is None:
            return _decode(_fill_value(msgs, t.size) * n, t, shape, f)
        return _decode(f.read(f.base + addr, size), t, shape, f)
    if cls == 3:
        _refuse("virtual storage")
    if cls != 2:
        _refuse(f"layout class {cls}")
    if version == 4:
        c.take(1)
        rank, width = c.uint(1), c.uint(1)
        c.take(rank * width)
        kind = c.uint(1)
        _refuse("the v4 chunk index ("
                + {1: "single chunk", 2: "implicit", 3: "fixed array",
                   4: "extensible array", 5: "v2 B-tree"}.get(kind, str(kind))
                + ")")
    rank = c.uint(1)
    btree = c.addr()
    dims = [c.uint(4) for _ in range(rank)]
    chunk = tuple(dims[:-1])
    pipeline = _filters(msgs[_FILTER_PIPELINE]) if _FILTER_PIPELINE in msgs \
        else []
    out = np.frombuffer(_fill_value(msgs, t.size) * n, t.dtype, n) \
        .reshape(shape).copy()
    if btree is not None:
        key_size = 8 + 8 * rank
        for key, addr in _btree1(f, btree, 1, key_size):
            size, mask = struct.unpack_from("<II", key)
            origin = struct.unpack_from(f"<{rank - 1}Q", key, 8)
            raw = _defilter(f.read(f.base + addr, size), pipeline, mask,
                            name)
            block = np.frombuffer(raw, t.dtype, int(np.prod(chunk))) \
                .reshape(chunk)
            dst = tuple(slice(o, min(o + k, s))
                        for o, k, s in zip(origin, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
    return _strings(out, t.pad) if t.pad is not None else out


# --------------------------------------------------------------------------
# groups, attributes, the file
# --------------------------------------------------------------------------

def _link(data: bytes, f: _Store) -> Tuple[str, Optional[int]]:
    """A link message → (name, object header address); soft and external
    links are refused when followed (address None)."""
    c = _message_cursor(data, f)
    c.uint(1)
    flags = c.uint(1)
    kind = c.uint(1) if flags & 0x08 else 0
    if flags & 0x04:
        c.take(8)
    if flags & 0x10:
        c.take(1)
    name = c.take(c.uint(1 << (flags & 3))).decode("utf-8")
    return name, (c.addr() if kind == 0 else None)


class Attributes(Mapping):
    """An object's attributes; each value decoded when it is read."""

    def __init__(self, f: _Store, raw: Dict[str, bytes]):
        self._f, self._raw = f, raw

    def __getitem__(self, name: str):
        return _attribute_value(self._raw[name], self._f)

    def __iter__(self) -> Iterator[str]:
        return iter(self._raw)

    def __len__(self) -> int:
        return len(self._raw)


class Group:
    """An HDF5 group: its links by name, its attributes."""

    def __init__(self, f: _Store, msgs: List[Tuple[int, bytes]]):
        self._f = f
        self._links: Dict[str, Optional[int]] = {}
        attrs: Dict[str, bytes] = {}
        for mtype, data in msgs:
            if mtype == _SYMBOL_TABLE:
                c = _message_cursor(data, f)
                self._symbol_table(c.addr(), c.addr())
            elif mtype == _LINK:
                name, addr = _link(data, f)
                self._links[name] = addr
            elif mtype == _LINK_INFO:
                self._dense(data, 5, lambda rec: rec[4:], _link,
                            self._links)
            elif mtype == _ATTRIBUTE:
                name, raw = _attribute(data, f)
                attrs[name] = raw
            elif mtype == _ATTRIBUTE_INFO:
                self._dense(data, 8, self._attribute_id, _attribute, attrs)
        self.attrs = Attributes(f, attrs)

    @staticmethod
    def _attribute_id(rec: bytes) -> bytes:
        if rec[8] & 0x02:
            _refuse("a shared attribute")
        return rec[:8]

    def _dense(self, data: bytes, record_type: int, heap_id, parse,
               into: dict) -> None:
        """Links or attributes in a fractal heap indexed by name (a link
        info or attribute info message)."""
        c = _message_cursor(data, self._f)
        c.uint(1)
        flags = c.uint(1)
        if flags & 1:
            c.take(8 if record_type == 5 else 2)
        heap, names = c.addr(), c.addr()
        if heap is None or names is None:
            return
        h = _heap(self._f, heap)
        for rec in _btree2(self._f, names, record_type):
            name, value = parse(h.get(heap_id(rec)), self._f)
            into[name] = value

    def _symbol_table(self, btree: int, heap: int) -> None:
        f = self._f
        c = f.at(heap)
        c.signature(b"HEAP")
        c.take(4)
        size = c.length()
        c.length()                     # free list
        names = f.read(f.base + c.addr(), size)
        for _, node in _btree1(f, btree, 0, f.sl):
            s = f.at(node)
            s.signature(b"SNOD")
            s.take(2)
            for _ in range(s.uint(2)):
                start, header = s.length(), s.addr()
                s.take(24)             # cache type, reserved, scratch pad
                end = names.find(b"\0", start)
                if end < 0:
                    raise PretrainedWeightsError(
                        f"HDF5: a link name at {start} runs past its heap")
                self._links[names[start:end].decode("utf-8")] = header

    def _child(self, name: str, read: bool = True):
        """The group or dataset linked as ``name``; with ``read`` false,
        None for a dataset."""
        addr = self._links[name]
        if addr is None:
            _refuse(f"the soft or external link {name!r}")
        msgs = self._f.messages(addr)
        if any(t == _LAYOUT for t, _ in msgs):
            return _dataset(self._f, dict(msgs), name) if read else None
        return Group(self._f, msgs)

    def _parent(self, path: str) -> Tuple[Optional["Group"], str]:
        """The group holding the last part of ``path``, and that part;
        None when a part before it is missing or is no group."""
        parts = [p for p in path.split("/") if p]
        node: Optional[Group] = self
        for part in parts[:-1]:
            if part not in node._links:
                return None, ""
            node = node._child(part, read=False)
            if node is None:
                return None, ""
        return node, parts[-1] if parts else ""

    def __contains__(self, path: str) -> bool:
        group, name = self._parent(path)
        return group is not None and name in group._links

    def __getitem__(self, path: str):
        group, name = self._parent(path)
        if group is None or name not in group._links:
            raise KeyError(f"{path!r} is not in the group")
        return group._child(name)


class File(Group):
    """An HDF5 file's root group.  Use as a context manager (the file is
    memory-mapped until it is closed); arrays read from it stay valid
    after."""

    def __init__(self, path: str):
        store = _Store(path)
        try:
            root = store.superblock()
            super().__init__(store, store.messages(root))
        except BaseException:
            store.close()
            raise

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
