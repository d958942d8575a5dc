"""Minimal TensorBoard ``tfevents`` scalar writer and reader, with no
TensorFlow.

Counterpart of ``segmentation_training_pipeline_tpu/utils/tfevents.py``
(stdlib only), kept as the PyTorch package's own copy:

* **TFRecord framing**: ``uint64 length · uint32 masked-crc32c(length) ·
  payload · uint32 masked-crc32c(payload)``, little-endian; the mask is
  ``((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32`` over CRC-32C
  (Castagnoli polynomial, not zlib's CRC-32/IEEE).
* **Event protos**, hand-encoded: ``Event{wall_time(1,double),
  step(2,varint), file_version(3,string) | summary(5,msg)}``;
  ``Summary{value(1,msg)}``; ``Summary.Value{tag(1,string),
  simple_value(2,float)}``.

:func:`read_scalars` reads a file back and checks every CRC.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, List, Tuple

# --- CRC-32C (Castagnoli), table-driven -----------------------------------

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire helpers -------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    msg = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        msg += _varint(2 << 3 | 0) + _varint(step)
    if file_version:
        msg += _field_bytes(3, file_version.encode())
    if summary:
        msg += _field_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + \
        _varint(2 << 3 | 5) + struct.pack("<f", value)
    return _field_bytes(1, val)


class EventFileWriter:
    """Append-only scalar event file, one per training run."""

    _seq = 0  # per-process uniquifier (several writers per second)

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        # pid + sequence suffix: same-second writers (two stages, or two
        # processes on one host) must NOT share a file — interleaved
        # appends splice bytes mid-record and corrupt the TFRecord
        # stream (TF's own writer appends pid+uid for the same reason)
        EventFileWriter._seq += 1
        name = "events.out.tfevents.%010d.%s.%d.%d" % (
            int(time.time()), socket.gethostname(), os.getpid(),
            EventFileWriter._seq)
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr + struct.pack("<I", _masked_crc(hdr)) + payload
                      + struct.pack("<I", _masked_crc(payload)))

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        summary = b"".join(_scalar_summary(tag, float(v))
                           for tag, v in scalars.items())
        self._write(_event(time.time(), step=step, summary=summary))
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None  # type: ignore[assignment]


# --- reader (tests / TF-free post-processing) ------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def read_scalars(path: str) -> List[Tuple[int, str, float]]:
    """Parse a tfevents file → ``[(step, tag, value), …]``, verifying both
    masked CRCs of every record."""
    out: List[Tuple[int, str, float]] = []
    data = open(path, "rb").read()
    pos = 0
    while pos < len(data):
        hdr = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", hdr)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if hcrc != _masked_crc(hdr):
            raise ValueError(f"bad header crc at byte {pos}")
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack("<I",
                                data[pos + 12 + length:pos + 16 + length])
        if pcrc != _masked_crc(payload):
            raise ValueError(f"bad payload crc at byte {pos}")
        pos += 16 + length

        step, summary = 0, b""
        i = 0
        while i < len(payload):
            key, i = _read_varint(payload, i)
            num, wire = key >> 3, key & 7
            if wire == 1:
                i += 8
            elif wire == 5:
                i += 4
            elif wire == 0:
                v, i = _read_varint(payload, i)
                if num == 2:
                    step = v
            elif wire == 2:
                ln, i = _read_varint(payload, i)
                if num == 5:
                    summary = payload[i:i + ln]
                i += ln
            else:
                raise ValueError(f"unexpected wire type {wire}")
        j = 0
        while j < len(summary):
            key, j = _read_varint(summary, j)
            ln, j = _read_varint(summary, j)
            val = summary[j:j + ln]
            j += ln
            tag, value = "", float("nan")
            k = 0
            while k < len(val):
                vkey, k = _read_varint(val, k)
                vnum, vwire = vkey >> 3, vkey & 7
                if vwire == 2:
                    vln, k = _read_varint(val, k)
                    if vnum == 1:
                        tag = val[k:k + vln].decode()
                    k += vln
                elif vwire == 5:
                    if vnum == 2:
                        (value,) = struct.unpack("<f", val[k:k + 4])
                    k += 4
                elif vwire == 1:
                    k += 8
                else:
                    _, k = _read_varint(val, k)
            if tag:
                out.append((step, tag, value))
    return out
