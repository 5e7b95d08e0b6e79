"""Prophesee ``.dat`` event decoder (host side).

The port's copy of ``snn_for_object_detection_tpu/data/psee.py``, byte
for byte the same file format. It replaces the reference's
``prophesee_toolbox`` submodule (the ``PSEELoader`` API used at the
reference's utils/datasets.py:249, 321-326, 387, 413; format spec in
SURVEY.md §2.6):

- ASCII header lines starting with ``%``;
- one byte event type + one byte event size (8);
- packed little-endian records of 2 x uint32:
  word0 = timestamp in µs; word1 = x (bits 0-13), y (bits 14-27),
  p (bit 28).

The file is ``np.memmap``-ed once and timestamp lookups use
``searchsorted`` (events are time-sorted), so ``load_delta_t`` is
O(log N) page touches + one contiguous slice — versus the reference
toolbox's sequential chunked scanning. This keeps the host data path
fast enough to feed the device (SURVEY.md §7.3).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from snn_for_object_detection_tpu_torch.native import decode_events

_EV_SIZE_BYTES = 8


def _parse_header(path: str) -> Tuple[int, int, int]:
    """Return (data_offset_bytes, ev_type, ev_size)."""
    with open(path, "rb") as f:
        offset = 0
        while True:
            pos = f.tell()
            line = f.readline()
            if not line.startswith(b"%"):
                f.seek(pos)
                break
            offset = f.tell()
        header_tail = f.read(2)
        if len(header_tail) < 2:
            # Empty data section (no type/size bytes): treat as 0 events
            return offset, 0, _EV_SIZE_BYTES
        ev_type, ev_size = header_tail[0], header_tail[1]
        return offset + 2, ev_type, ev_size


class EventReader:
    """Streaming reader over a ``.dat`` event file.

    API mirrors ``PSEELoader`` (``done``, ``current_time``,
    ``reset()``, ``load_delta_t(µs)``) so dataset code maps 1:1, but
    returns a dict of column arrays (``t``, ``x``, ``y``, ``p``) —
    columnar, zero-copy-sliced, rasterizer-friendly.
    """

    def __init__(self, path: str):
        self.path = path
        offset, ev_type, ev_size = _parse_header(path)
        if ev_size not in (0, _EV_SIZE_BYTES):
            raise ValueError(f"Unsupported event size {ev_size} in {path}")
        nbytes = os.path.getsize(path) - offset
        n_events = max(nbytes // _EV_SIZE_BYTES, 0)
        if n_events:
            raw = np.memmap(
                path, dtype="<u4", mode="r", offset=offset,
                shape=(n_events * 2,),
            )
            self._records = raw.reshape(-1, 2)
        else:
            self._records = np.zeros((0, 2), dtype="<u4")
        self._cursor = 0  # index of next unread event

    @property
    def n_events(self) -> int:
        return self._records.shape[0]

    @property
    def done(self) -> bool:
        return self._cursor >= self.n_events

    @property
    def current_time(self) -> int:
        """Timestamp (µs) of the next unread event; total duration at EOF."""
        if self.done:
            return int(self._records[-1, 0]) if self.n_events else 0
        return int(self._records[self._cursor, 0])

    def reset(self) -> None:
        self._cursor = 0

    def load_delta_t_records(self, delta_t_us: int) -> np.ndarray:
        """Consume events in ``[current_time, current_time + Δt)`` and
        return the RAW ``[M, 2]`` uint32 record slice (zero-copy view of
        the memmap) — input for the fused native rasterizer."""
        if self.done:
            return self._records[0:0]
        start_t = self._records[self._cursor, 0]
        end_t = start_t + np.uint64(delta_t_us)
        times = self._records[:, 0]
        end_idx = int(np.searchsorted(times, end_t, side="left"))
        chunk = self._records[self._cursor : end_idx]
        self._cursor = end_idx
        return chunk

    def load_delta_t(self, delta_t_us: int) -> Dict[str, np.ndarray]:
        """Consume all events in ``[current_time, current_time + Δt)``.

        :return: Columns ``t`` (uint32 µs), ``x``, ``y`` (uint16),
            ``p`` (uint8, 0/1).
        """
        return decode_events(self.load_delta_t_records(delta_t_us))

    def seek_time(self, t_us: int) -> None:
        """Position the cursor at the first event with timestamp >= t_us."""
        self._cursor = int(np.searchsorted(self._records[:, 0], t_us, "left"))

    @property
    def total_time(self) -> int:
        return int(self._records[-1, 0]) if self.n_events else 0


def write_dat(
    path: str,
    t: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    p: np.ndarray,
    width: int = 304,
    height: int = 240,
) -> None:
    """Write events to a ``.dat`` file (synthetic data / golden tests)."""
    order = np.argsort(t, kind="stable")
    t, x, y, p = (np.asarray(a)[order] for a in (t, x, y, p))
    word = (
        (x.astype(np.uint32) & 0x3FFF)
        | ((y.astype(np.uint32) & 0x3FFF) << 14)
        | ((p.astype(np.uint32) & 0xF) << 28)
    )
    records = np.empty((len(t), 2), dtype="<u4")
    records[:, 0] = t.astype(np.uint32)
    records[:, 1] = word
    header = (
        b"% Data file containing CD events (synthetic)\n"
        b"% Version 2\n"
        + f"% Width {width}\n".encode()
        + f"% Height {height}\n".encode()
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(bytes([0x0C, _EV_SIZE_BYTES]))  # ev type, ev size
        f.write(records.tobytes())
