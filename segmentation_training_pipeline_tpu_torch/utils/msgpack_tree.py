"""The msgpack subset of flax checkpoints, without msgpack or flax.

The JAX package writes a checkpoint with ``flax.serialization.to_bytes``:
``msgpack.packb(tree, strict_types=True)`` of nested dicts whose array
leaves are msgpack **ext type 1**, the payload itself a msgpack array
``[shape, dtype name, C-order bytes]`` packed with ``use_bin_type=True``.
This module reads and writes exactly that subset:

  * maps with str keys, str, bin, int, nil, bool (and, inside an ext
    payload, arrays);
  * ext type 1 ↔ a CPU ``torch.Tensor`` (numpy arrays are accepted on the
    way in); ``bfloat16`` ↔ ``torch.bfloat16``;
  * flax's chunked form of a leaf over 2³⁰ bytes (a map holding
    ``__msgpack_chunked_array__``) is read; writing one raises, naming the
    leaf.

Every header takes the smallest width, as msgpack-python picks it, so that
``packb(unpackb(b)) == b`` for a file flax wrote.  Anything outside the
subset raises.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch

EXT_NDARRAY = 1
MAX_LEAF_BYTES = 2 ** 30      # flax's MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
DTYPES: Dict[str, torch.dtype] = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------

def _sized(out: List[bytes], n: int, fix: Optional[int], fix_max: int,
           wide: tuple) -> None:
    """Header of a str/bin/array/map of length ``n``: the fix form when
    ``fix`` is set and ``n <= fix_max``, else the first of ``wide``
    ((tag, struct format, max), …) that holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for tag, fmt, top in wide:
        if n <= top:
            out.append(struct.pack(">B" + fmt, tag, n))
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0x80 <= v <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0xFF < v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < -0x80:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"int {v} does not fit in 64 bits")


def _pack_str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    _sized(out, len(b), 0xA0, 0x1F,
           ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF)))
    out.append(b)


def _pack_bin(out: List[bytes], b: bytes) -> None:
    _sized(out, len(b), None, 0,
           ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF)))
    out.append(b)


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixext:
        out.append(struct.pack(">Bb", fixext[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _array_payload(x, path: str) -> bytes:
    """flax's ``_ndarray_to_bytes``: packb([shape, dtype name, bytes])."""
    if isinstance(x, np.ndarray):
        name, shape = x.dtype.name, x.shape
        if name not in DTYPES:
            raise TypeError(f"{path}: dtype {name!r} is not supported")
        raw = x.tobytes("C")
    else:
        t = x.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"{path}: dtype {t.dtype} is not supported")
        name, shape = _NAMES[t.dtype], t.shape
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    if len(raw) > MAX_LEAF_BYTES:
        raise ValueError(
            f"{path}: {len(raw)} bytes is over the {MAX_LEAF_BYTES}-byte "
            "leaf limit; flax's chunked form is read but not written here")
    out: List[bytes] = []
    _pack(out, [list(shape), name, raw], path)
    return b"".join(out)


def _pack(out: List[bytes], x: Any, path: str) -> None:
    # exact types, as msgpack's strict_types: bool before int, no tuples
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(out, x)
    elif t is str:
        _pack_str(out, x)
    elif t is bytes:
        _pack_bin(out, x)
    elif t is dict:
        _sized(out, len(x), 0x80, 0x0F,
               ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF)))
        for k, v in x.items():
            if type(k) is not str:
                raise TypeError(f"{path}: map key {k!r} is not a str")
            _pack_str(out, k)
            _pack(out, v, f"{path}/{k}" if path else k)
    elif t is list:
        _sized(out, len(x), 0x90, 0x0F,
               ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF)))
        for i, v in enumerate(x):
            _pack(out, v, f"{path}[{i}]")
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(x, path or "<root>"))
    else:
        raise TypeError(f"{path or '<root>'}: {t.__name__} is outside the "
                        "flax checkpoint subset")


def packb(tree: Any) -> bytes:
    """A tree of dicts with str keys and tensor / numpy leaves → the bytes
    ``flax.serialization.msgpack_serialize`` writes for it."""
    out: List[bytes] = []
    _pack(out, tree, "")
    return b"".join(out)


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_LENGTH = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
           0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
           0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
           0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
           0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _tensor(payload: bytes, path: str) -> torch.Tensor:
    shape, name, raw = _unpack(_Reader(payload), path)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name not in DTYPES:
        raise ValueError(f"{path}: dtype {name!r} is not supported")
    dtype = DTYPES[name]
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def _unchunk(d: Dict[str, Any], path: str) -> torch.Tensor:
    """flax's ``_unchunk``: ``{"shape": {"0": …}, "chunks": {"0": …}}``."""
    try:
        shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    except (KeyError, TypeError) as e:
        raise ValueError(f"{path}: malformed chunked leaf ({e!r})") from None
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)


def _unpack(r: _Reader, path: str) -> Any:
    tag = r.unpack(">B")
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if tag == 0xC0:
        return None
    if tag in (0xC2, 0xC3):
        return tag == 0xC3
    if tag in _INTS:
        return r.unpack(_INTS[tag])
    kind, n = None, 0
    if 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif tag in _FIXEXT:
        kind, n = "ext", _FIXEXT[tag]
    elif tag in _LENGTH:
        kind, fmt = _LENGTH[tag]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"{path or '<root>'}: msgpack type 0x{tag:02x} is "
                         "outside the flax checkpoint subset")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "array":
        return [_unpack(r, f"{path}[{i}]") for i in range(n)]
    if kind == "ext":
        code = r.unpack(">b")
        data = bytes(r.take(n))
        if code != EXT_NDARRAY:
            raise ValueError(f"{path or '<root>'}: msgpack ext type {code} "
                             "is outside the flax checkpoint subset")
        return _tensor(data, path or "<root>")
    out: Dict[str, Any] = {}
    for _ in range(n):
        k = _unpack(r, path)
        if not isinstance(k, str):
            raise ValueError(f"{path or '<root>'}: map key {k!r} is not a str")
        out[k] = _unpack(r, f"{path}/{k}" if path else k)
    return _unchunk(out, path) if _CHUNKED in out else out


def unpackb(data: bytes) -> Any:
    """Bytes flax wrote (``msgpack_serialize``) → the tree, array leaves as
    CPU tensors, chunked leaves joined."""
    r = _Reader(data)
    tree = _unpack(r, "")
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack tree")
    return tree
