"""Minimal TensorBoard event-file writer (no TF/tensorboard dependency).

A copy of ``deepqlearning_tpu.utils.tb_writer``, so the port imports
nothing of the JAX package: the TFRecord/Event wire format, where each
record is ``len(u64) | masked_crc32(len) | payload | masked_crc32(payload)``
and the payload is a hand-encoded ``Event`` protobuf carrying a scalar
``Summary``. Only the varint/fixed encodings of the few fields needed.
"""
from __future__ import annotations

import os
import struct
import time
import zlib


# ---- masked CRC32c (TFRecord framing) --------------------------------
_CRC_TABLE = []


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            _CRC_TABLE.append(crc)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---- tiny protobuf encoder -------------------------------------------
def _varint(n: int) -> bytes:
    out = b""
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out += bytes([bits | 0x80])
        else:
            return out + bytes([bits])


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _pb_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _pb_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _pb_int(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value { tag = 1 (string), simple_value = 2 (float) }
    sv = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
    # Summary { value = 1 (repeated message) }
    summary = _pb_bytes(1, sv)
    # Event { wall_time = 1 (double), step = 2 (int64), summary = 5 (message) }
    return _pb_double(1, wall_time) + _pb_int(2, int(step)) + _pb_bytes(5, summary)


class TBWriter:
    """Append-only scalar writer compatible with TensorBoard."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        fname = f"events.out.tfevents.{int(time.time())}.dqn_tpu"
        self._f = open(os.path.join(logdir, fname), "ab")
        # initial file-version event
        self._write(_pb_double(1, time.time()) + _pb_bytes(3, b"brain.Event:2"))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def log_value(self, tag: str, value: float, step: int):
        self._write(_scalar_event(tag, value, step, time.time()))

    def close(self):
        self._f.close()
