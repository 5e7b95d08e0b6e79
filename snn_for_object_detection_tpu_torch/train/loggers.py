"""Experiment-tracker back ends: the port of the JAX package's loggers.

Counterpart of ``snn_for_object_detection_tpu/train/loggers.py``. The
config surface is the same: ``trainer.logger`` with ``class_path`` /
``init_args`` (``config/logger.yaml``) builds one or more of these; the
trainer fans every metrics payload it logs out to each of them (scalars
only), beside the ``metrics.jsonl`` it always writes.

A back end is anything with ``log_metrics(step, payload)`` and
``close()`` (and, optionally, ``set_out_dir(out_dir)``).

``TensorBoardLogger`` writes the event file itself (TFRecord framing,
the ``Event`` protocol buffer encoded by hand) and needs neither
``tensorboardX`` nor ``tensorboard`` nor protobuf; :func:`read_events`
reads such a file back. TensorBoard reads it as any other::

    tensorboard --logdir <trainer.out_dir>/tb
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple


def _scalars(payload: Dict) -> Dict[str, float]:
    return {
        k: float(v)
        for k, v in payload.items()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    }


# ---- TFRecord framing: CRC32C (Castagnoli), masked as TensorFlow does ----

def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(data: bytes) -> bytes:
    """One TFRecord: length, masked CRC of the length, data, masked CRC
    of the data (little-endian)."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


def read_records(path: str) -> Iterator[bytes]:
    """The records of a TFRecord file; raises ``ValueError`` on a CRC
    that does not match or a record cut short."""
    with open(path, "rb") as f:
        blob = f.read()
    pos = 0
    while pos < len(blob):
        if pos + 12 > len(blob):
            raise ValueError(f"{path}: record header cut short at {pos}")
        header = blob[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", blob[pos + 8:pos + 12])
        data = blob[pos + 12:pos + 12 + n]
        end = pos + 12 + n + 4
        if crc != masked_crc32c(header) or end > len(blob):
            raise ValueError(f"{path}: bad record header at {pos}")
        (crc,) = struct.unpack("<I", blob[end - 4:end])
        if crc != masked_crc32c(data):
            raise ValueError(f"{path}: bad record data at {pos}")
        yield data
        pos = end


# ---- the Event protocol buffer (tensorboard/compat/proto/event.proto) ----
# Event: wall_time double = 1, step int64 = 2, file_version string = 3,
# summary Summary = 5; Summary: repeated Value value = 1; Value: tag
# string = 1, simple_value float = 2.

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 two's complement, as protobuf writes it
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint((number << 3) | wire)


def _bytes_field(number: int, data: bytes) -> bytes:
    return _field(number, 2) + _varint(len(data)) + data


def encode_event(wall_time: float, step: int = 0,
                 file_version: Optional[str] = None,
                 scalars: Optional[Dict[str, float]] = None) -> bytes:
    """An ``Event`` as protobuf serializes it (proto3: a zero step is
    left out)."""
    out = _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _field(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalars is not None:
        summary = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode())
                         + _field(2, 5) + struct.pack("<f", value))
            for tag, value in scalars.items())
        out += _bytes_field(5, summary)
    return out


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        byte = data[pos]
        pos += 1
        n |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return n, pos


def _fields(data: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of a message: ints for varints, bytes for
    fixed and length-delimited fields."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value, pos = data[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = data[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, value


def decode_event(data: bytes) -> Dict[str, object]:
    """``{"wall_time", "step", "file_version", "scalars": [(tag, value)]}``
    of an encoded ``Event`` (other fields are skipped)."""
    event = {"wall_time": 0.0, "step": 0, "file_version": None,
             "scalars": []}
    for number, value in _fields(data):
        if number == 1:
            event["wall_time"] = struct.unpack("<d", value)[0]
        elif number == 2:
            event["step"] = value - (1 << 64) if value >> 63 else value
        elif number == 3:
            event["file_version"] = value.decode()
        elif number == 5:
            for n, v in _fields(value):
                if n != 1:
                    continue
                tag, simple = None, None
                for vn, vv in _fields(v):
                    if vn == 1:
                        tag = vv.decode()
                    elif vn == 2:
                        simple = struct.unpack("<f", vv)[0]
                if simple is not None:
                    event["scalars"].append((tag, simple))
    return event


def read_events(path: str) -> List[Dict[str, object]]:
    """Every event of an event file, decoded (:func:`decode_event`)."""
    return [decode_event(r) for r in read_records(path)]


def read_scalars(path: str) -> List[Tuple[str, int, float]]:
    """The (tag, step, value) triples of an event file, in file order
    (values are float32, as stored)."""
    return [(tag, e["step"], value) for e in read_events(path)
            for tag, value in e["scalars"]]


class TensorBoardLogger:
    """TensorBoard event-file writer (scalars), with no dependency.

    :param log_dir: Event-file directory. Relative paths are resolved
        under the Trainer's ``out_dir`` (so the default "tb" lands next
        to metrics.jsonl and the checkpoints).

    The file is ``events.out.tfevents.<time>.<host>``, as tensorboardX
    names it; it starts with a ``brain.Event:2`` version event and holds
    one event a logged payload, flushed at once.
    """

    def __init__(self, log_dir: str = "tb"):
        self.log_dir = log_dir
        self._file = None
        self.path: Optional[str] = None

    def set_out_dir(self, out_dir: str) -> None:
        """Called by the Trainer before the first log."""
        if not os.path.isabs(self.log_dir):
            self.log_dir = os.path.join(out_dir, self.log_dir)

    def _get_file(self):
        if self._file is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self.path = os.path.join(
                self.log_dir, "events.out.tfevents." + str(time.time())[:10]
                + "." + socket.gethostname())
            self._file = open(self.path, "ab")
            self._file.write(frame_record(encode_event(
                time.time(), file_version="brain.Event:2")))
        return self._file

    def log_metrics(self, step: int, payload: Dict) -> None:
        f = self._get_file()
        for key, value in _scalars(payload).items():
            f.write(frame_record(encode_event(time.time(), step,
                                              scalars={key: value})))
        f.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class CSVLogger:
    """Append-only CSV of every logged payload (the Lightning CSVLogger
    analogue): a column per scalar seen so far, the header rewritten
    when a payload brings new ones."""

    def __init__(self, filename: str = "metrics.csv"):
        self.filename = filename
        self._path: Optional[str] = None
        self._columns = None

    def set_out_dir(self, out_dir: str) -> None:
        if not os.path.isabs(self.filename):
            self._path = os.path.join(out_dir, self.filename)
        else:
            self._path = self.filename

    def log_metrics(self, step: int, payload: Dict) -> None:
        assert self._path is not None, "set_out_dir() not called"
        row = {"step": step, **_scalars(payload)}
        if self._columns is None:
            self._columns = list(row)
            with open(self._path, "w") as f:
                f.write(",".join(self._columns) + "\n")
        new_cols = [c for c in row if c not in self._columns]
        if new_cols:
            self._columns.extend(new_cols)
            with open(self._path) as f:
                lines = f.read().splitlines()[1:]
            # the new header through a temporary file: a crash part way
            # must not lose the rows written so far
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                f.write(",".join(self._columns) + "\n")
                pad = "," * len(new_cols)
                f.writelines(line + pad + "\n" for line in lines)
            os.replace(tmp, self._path)
        with open(self._path, "a") as f:
            f.write(
                ",".join(
                    str(row.get(c, "")) if row.get(c, "") != "" else ""
                    for c in self._columns
                )
                + "\n"
            )

    def close(self) -> None:
        pass
