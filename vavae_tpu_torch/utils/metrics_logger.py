"""Training-metrics sinks: TensorBoard event files and JSONL (port of
``vavae_tpu/utils/metrics_logger.py``).

``MetricsLogger`` appends one JSON line a ``log_scalars`` call to
``{log_dir}/metrics.jsonl`` and writes the same scalars, and ``log_text``'s
text, to a TensorBoard event file in ``log_dir``. The event file is encoded
here, with no ``tensorboard`` package: TFRecord framing (length, masked
CRC-32C of the length, the record, masked CRC-32C of the record) around
hand-encoded ``Event`` protobufs, the records
``torch.utils.tensorboard.SummaryWriter`` writes: a first ``file_version``
"brain.Event:2" event, scalars as ``simple_value``, text as the text
plugin's one-element string tensor under ``{tag}/text_summary``.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict

# -- CRC-32C (Castagnoli) and the TFRecord framing ---------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: length, masked CRC of the length, data, masked CRC of the data."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


# -- protobuf wire format ---------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 two's complement, as protobuf encodes negatives
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: str = "", summary: bytes = b"") -> bytes:
    """``tensorflow.Event``: wall_time (1, double), step (2, int64),
    file_version (3) or summary (5); proto3 leaves zero fields out."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _varint(2 << 3 | 0) + _varint(int(step))
    if file_version:
        out += _bytes_field(3, file_version.encode())
    if summary:
        out += _bytes_field(5, summary)
    return out


def scalar_summary(tag: str, value: float) -> bytes:
    """``Summary`` with one ``Value``: tag (1), simple_value (2, float32)."""
    value_msg = _bytes_field(1, tag.encode()) + _varint(2 << 3 | 5) + struct.pack("<f", value)
    return _bytes_field(1, value_msg)


def text_summary(tag: str, text: str) -> bytes:
    """``Summary`` with one ``Value``: tag ``{tag}/text_summary`` (1), a
    ``TensorProto`` (8: dtype DT_STRING = 7, shape [1], the UTF-8 text in
    string_val) and ``SummaryMetadata`` (9: plugin "text", empty content)."""
    shape = _bytes_field(2, _varint(1 << 3 | 0) + _varint(1))  # TensorShapeProto.dim {size: 1}
    tensor = _varint(1 << 3 | 0) + _varint(7) + _bytes_field(2, shape) + _bytes_field(8, text.encode())
    metadata = _bytes_field(1, _bytes_field(1, b"text"))  # plugin_data {plugin_name: "text"}
    value_msg = (_bytes_field(1, f"{tag}/text_summary".encode()) + _bytes_field(8, tensor)
                 + _bytes_field(9, metadata))
    return _bytes_field(1, value_msg)


class EventFileWriter:
    """A TensorBoard event file in ``log_dir``, named as SummaryWriter names
    its files; every record is flushed as it is written."""

    _count = 0

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        EventFileWriter._count += 1
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}."
                f"{os.getpid()}.{EventFileWriter._count}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "wb")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._f.write(tfrecord(event))
        self._f.flush()

    def add_summary(self, summary: bytes, step: int) -> None:
        self._write(_event(time.time(), step=step, summary=summary))

    def close(self) -> None:
        self._f.close()


class MetricsLogger:
    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.log_dir = log_dir
        self._jsonl = self._tb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = EventFileWriter(log_dir)

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time(), **{k: float(v) for k, v in scalars.items()}}
        for k, v in scalars.items():
            self._tb.add_summary(scalar_summary(k, float(v)), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_text(self, tag: str, text: str, step: int = 0) -> None:
        if self.enabled:
            self._tb.add_summary(text_summary(tag, text), int(step))

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._tb.close()
            self._jsonl = self._tb = None


def read_events(path: str) -> list[bytes]:
    """The records of a TFRecord file, each CRC checked (raises on a bad one)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        length = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", length)
        (len_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        record = data[pos + 12:pos + 12 + n]
        (crc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        if len_crc != masked_crc32c(length) or crc != masked_crc32c(record):
            raise ValueError(f"{path}: record at byte {pos} fails its CRC")
        out.append(record)
        pos += 16 + n
    return out
