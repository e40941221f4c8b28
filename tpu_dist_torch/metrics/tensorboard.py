"""Minimal TensorBoard event-file writer with no TensorFlow dependency: the
port's own copy of ``tpu_dist/metrics/tensorboard.py``.

It hand-encodes the two protobuf messages TensorBoard's scalar dashboard
reads (``Event`` and ``Summary.Value.simple_value``) and frames them in the
TFRecord format (length + masked CRC32C), producing
``events.out.tfevents.*`` files any TensorBoard reads. The bytes are the
JAX package's writer's for the same scalars, clock and host.

Host side, rank 0 only (the trainer opens it there); stdlib only.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# -- CRC32C (Castagnoli, reflected poly 0x82F63B78) — software table ---------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire encoding (just the fields the scalar dashboard reads) -----


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # two's-complement int64, protobuf-style
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_double(num: int, v: float) -> bytes:
    return bytes([(num << 3) | 1]) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return bytes([(num << 3) | 5]) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return bytes([(num << 3) | 0]) + _varint(v)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return bytes([(num << 3) | 2]) + _varint(len(payload)) + payload


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    value_msg = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, value_msg)          # Summary.value (repeated)
    return (
        _field_double(1, wall_time)               # Event.wall_time
        + _field_varint(2, int(step))             # Event.step
        + _field_bytes(5, summary)                # Event.summary
    )


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class SummaryWriter:
    """Append-only scalar event writer for one run directory:
    ``SummaryWriter(logdir).add_scalar("train/loss", 1.23, step)``, the call
    shape of ``torch.utils.tensorboard`` for scalars."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}"
        )
        self.path = os.path.join(logdir, name)
        # tpu-dist: ignore[TD002] — the writer is only constructed on the primary rank (the trainer guards it)
        self._f = open(self.path, "ab")
        self._record(_version_event(time.time()))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(
            header
            + struct.pack("<I", _masked_crc(header))
            + payload
            + struct.pack("<I", _masked_crc(payload))
        )

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._record(
            _scalar_event(
                tag, value, step,
                time.time() if wall_time is None else wall_time,
            )
        )
        # flushed a scalar: a live TensorBoard sees the run as it goes
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- reading an event file back (tests, the smoke) ---------------------------


def _read_varint(buf: bytes, i: int):
    shift = out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return out, i


def _fields(buf: bytes):
    """``(field number, wire type, value)`` of a protobuf message: ints for
    varints, bytes for 64-bit, 32-bit and length-delimited fields."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield num, wire, val


def read_scalars(path: str) -> list:
    """The scalar events of an event file, in order: ``[(tag, step,
    value)]``, every record's two masked CRCs checked (``ValueError`` on a
    mismatch); the version record is skipped."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
        payload = data[i + 12:i + 12 + n]
        (pcrc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if hcrc != _masked_crc(header) or pcrc != _masked_crc(payload):
            raise ValueError(f"{path}: record at byte {i} fails its CRC")
        i += 16 + n
        step, summary = 0, None
        for num, _wire, val in _fields(payload):
            if num == 2:
                step = val - (1 << 64) if val >> 63 else val  # an int64
            elif num == 5:
                summary = val
        if summary is None:
            continue
        for num, _wire, value_msg in _fields(summary):
            if num != 1:
                continue
            tag, value = None, None
            for vnum, _w, v in _fields(value_msg):
                if vnum == 1:
                    tag = v.decode()
                elif vnum == 2:
                    (value,) = struct.unpack("<f", v)
            out.append((tag, step, value))
    return out
