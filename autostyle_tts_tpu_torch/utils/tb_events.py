"""Minimal TensorBoard event-file writer and reader (no tensorflow or
tensorboard needed).

The port's own copy of the JAX ``utils/tb_events.py``: TFRecord framing
(length + masked CRC32C) around hand-encoded Event / Summary protobufs. A
file either package writes, the other's ``read_scalars`` reads.

  w = EventWriter(logdir)
  w.scalar("train/loss", 0.73, step=100)
  w.close()
"""

from __future__ import annotations

import os
import struct
import time
from pathlib import Path
from typing import Optional

# ----------------------------------------------------------------- crc32c

_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------------- protobuf


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fno: int, wt: int, payload: bytes) -> bytes:
    head = _varint((fno << 3) | wt)
    if wt == 2:
        return head + _varint(len(payload)) + payload
    return head + payload


def _event(wall_time: float, step: int, summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    msg = _field(1, 1, struct.pack("<d", wall_time))       # double wall_time
    msg += _field(2, 0, _varint(step))                     # int64 step
    if file_version is not None:
        msg += _field(3, 2, file_version.encode())         # string
    if summary is not None:
        msg += _field(5, 2, summary)                       # Summary
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field(1, 2, tag.encode()) + _field(2, 5, struct.pack("<f", value))
    return _field(1, 2, val)  # Summary.value (repeated)


class EventWriter:
    """Append-only scalar event writer, one events file per instance."""

    def __init__(self, logdir, filename_suffix: str = ""):
        Path(logdir).mkdir(parents=True, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{os.uname().nodename}.{os.getpid()}{filename_suffix}"
        )
        self.path = Path(logdir) / name
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), 0, file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(
            _event(time.time(), int(step), _scalar_summary(tag, float(value)))
        )

    def scalars(self, values: dict, step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


def read_scalars(path) -> list:
    """Parse an events file back into [(step, tag, value)] — used by tests
    and as a sanity check that the framing/proto bytes are right."""
    buf = Path(path).read_bytes()
    out = []
    i = 0
    while i < len(buf):
        (ln,) = struct.unpack_from("<Q", buf, i)
        i += 8
        (lcrc,) = struct.unpack_from("<I", buf, i)
        i += 4
        assert lcrc == _masked_crc(struct.pack("<Q", ln)), "length crc"
        payload = buf[i : i + ln]
        i += ln
        (dcrc,) = struct.unpack_from("<I", buf, i)
        i += 4
        assert dcrc == _masked_crc(payload), "data crc"
        step, tag, value = 0, None, None
        j = 0
        while j < len(payload):
            key = payload[j]
            fno, wt = key >> 3, key & 7
            j += 1
            if wt == 0:
                v = 0
                shift = 0
                while True:
                    b = payload[j]
                    j += 1
                    v |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                if fno == 2:
                    step = v
            elif wt == 1:
                j += 8
            elif wt == 5:
                j += 4
            elif wt == 2:
                ln2 = 0
                shift = 0
                while True:
                    b = payload[j]
                    j += 1
                    ln2 |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                sub = payload[j : j + ln2]
                j += ln2
                if fno == 5:  # summary
                    k = 0
                    while k < len(sub):
                        sk = sub[k]
                        k += 1
                        sl = sub[k]
                        k += 1
                        val = sub[k : k + sl]
                        k += sl
                        if sk >> 3 == 1:  # Summary.value
                            m = 0
                            while m < len(val):
                                vk = val[m]
                                vf, vw = vk >> 3, vk & 7
                                m += 1
                                if vw == 2:
                                    vl = val[m]
                                    m += 1
                                    if vf == 1:
                                        tag = val[m : m + vl].decode()
                                    m += vl
                                elif vw == 5:
                                    if vf == 2:
                                        (value,) = struct.unpack_from(
                                            "<f", val, m)
                                    m += 4
                                elif vw == 1:
                                    m += 8
                                else:
                                    break
        if tag is not None:
            out.append((step, tag, value))
    return out
