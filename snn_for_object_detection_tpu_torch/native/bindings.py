"""ctypes bindings for the C++ event kernels, built at first use.

``event_ops.cc`` (a copy of the JAX package's source) is compiled with
``g++ -O3 -shared -fPIC -std=c++17`` into ``build/native/`` at the
repository root (listed in ``.gitignore``) the first time a kernel is
called, and again whenever the source is newer than the library. A
failed build or load raises: there is no silent numpy fallback. The
numpy versions, ``decode_events_reference`` and
``rasterize_records_reference``, are the kernels' plain versions for
the tests.

``COUNTS`` counts the library's loads and each kernel's calls, so a run
can show that its data went through the native rasterizer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "event_ops.cc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "build", "native",
)
LIBRARY = os.path.join(BUILD_DIR, "libevent_ops.so")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
FRAME_DTYPES = (np.dtype(np.float32), np.dtype(np.uint8))

COUNTS: Dict[str, int] = {"loads": 0, "decode_events": 0,
                          "rasterize_records": 0}

_lock = threading.Lock()
_lib = None


def build_library(source: str = SOURCE, target: str = LIBRARY) -> str:
    """Compile ``source`` into ``target`` unless ``target`` is at least
    as new. Several processes may build at once: each writes its own
    temporary file and renames it into place. Raises ``RuntimeError``
    with the compiler's output if the build fails."""
    if (os.path.exists(target)
            and os.path.getmtime(target) >= os.path.getmtime(source)):
        return target
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, source, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ {source} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def _count(name: str) -> None:
    with _lock:  # loader threads call the kernels at once
        COUNTS[name] += 1


def _records(records: np.ndarray) -> np.ndarray:
    """``records`` as the contiguous ``[N, 2]`` uint32 array the kernels
    read, or ``ValueError``."""
    records = np.ascontiguousarray(records, dtype=np.uint32)
    if records.ndim != 2 or records.shape[1] != 2:
        raise ValueError(f"records must be [N, 2] uint32 words, got shape "
                         f"{records.shape}")
    return records


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_library())
        lib.decode_events.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.decode_events.restype = None
        for fname in ("rasterize_records", "rasterize_records_u8"):
            fn = getattr(lib, fname)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int64
        COUNTS["loads"] += 1  # under _lock
        _lib = lib
        return _lib


def decode_events(records: np.ndarray) -> Dict[str, np.ndarray]:
    """Decode ``[N, 2]`` uint32 records into the columns ``t`` (uint32
    µs), ``x``, ``y`` (uint16) and ``p`` (uint8, 0/1)."""
    records = _records(records)
    lib = _load()
    n = records.shape[0]
    t = np.empty(n, np.uint32)
    x = np.empty(n, np.uint16)
    y = np.empty(n, np.uint16)
    p = np.empty(n, np.uint8)
    lib.decode_events(
        records.ctypes.data, n,
        t.ctypes.data, x.ctypes.data, y.ctypes.data, p.ctypes.data,
    )
    _count("decode_events")
    return {"t": t, "x": x, "y": y, "p": p}


def decode_events_reference(records: np.ndarray) -> Dict[str, np.ndarray]:
    """The plain version of :func:`decode_events` (numpy)."""
    word = np.ascontiguousarray(records[:, 1])
    return {
        "t": np.ascontiguousarray(records[:, 0]),
        "x": (word & 0x3FFF).astype(np.uint16),
        "y": ((word >> 14) & 0x3FFF).astype(np.uint16),
        # CD polarity is 0/1; mask to one bit so a record with spare
        # header bits set can never index past the 2 polarity channels
        # (matches the native rasterizer's & 0x1)
        "p": ((word >> 28) & 0x1).astype(np.uint8),
    }


def rasterize_records(
    records: np.ndarray,
    t_min_us: int,
    step_us: int,
    num_steps: int,
    height: int,
    width: int,
    clip_x: bool = False,
    dtype=np.float32,
) -> Tuple[np.ndarray, int]:
    """Fused decode and scatter of ``[N, 2]`` records into binary frames
    ``[T, H, W, 2]`` (channel 0 = negative polarity) of ``dtype``
    (float32 or uint8). An event at ``t >= t_min_us`` goes to frame
    ``(t - t_min_us) // step_us`` if that is below ``num_steps``; x is
    clipped into ``[0, W)`` with ``clip_x``; events outside the frame are
    dropped. Returns ``(frames, n)``, ``n`` the events in the time window
    (counted before the spatial check)."""
    dtype = np.dtype(dtype)
    if dtype not in FRAME_DTYPES:
        raise ValueError(f"unsupported frame dtype {dtype}")
    if step_us <= 0:
        raise ValueError(f"step_us must be positive, got {step_us}")
    records = _records(records)
    lib = _load()
    fn = (lib.rasterize_records if dtype == np.float32
          else lib.rasterize_records_u8)
    out = np.zeros((num_steps, height, width, 2), dtype)
    n = fn(
        records.ctypes.data, records.shape[0],
        int(t_min_us), int(step_us),
        int(num_steps), int(height), int(width), int(bool(clip_x)),
        out.ctypes.data,
    )
    _count("rasterize_records")
    return out, int(n)


def rasterize_records_reference(
    records: np.ndarray,
    t_min_us: int,
    step_us: int,
    num_steps: int,
    height: int,
    width: int,
    clip_x: bool = False,
    dtype=np.float32,
) -> Tuple[np.ndarray, int]:
    """The plain version of :func:`rasterize_records`: the JAX package's
    numpy path (decode, the time window, the x clip, ``data.rasterize``),
    with events outside the frame dropped as the kernel drops them."""
    # imported here: the data package imports this module
    from snn_for_object_detection_tpu_torch.data.rasterize import rasterize

    if np.dtype(dtype) not in FRAME_DTYPES:
        raise ValueError(f"unsupported frame dtype {np.dtype(dtype)}")
    events = decode_events_reference(
        np.asarray(records, np.uint32).reshape(-1, 2))
    t = events["t"].astype(np.int64)
    time_idx = (t - int(t_min_us)) // int(step_us)
    sel = (t >= t_min_us) & (time_idx < num_steps)
    events = {k: v[sel] for k, v in events.items()}
    time_idx = time_idx[sel]
    if clip_x:
        events["x"] = np.clip(events["x"], 0, width - 1)
    inside = (events["x"] < width) & (events["y"] < height)
    frames = rasterize({k: v[inside] for k, v in events.items()},
                       time_idx[inside], num_steps, height, width,
                       dtype=dtype)
    return frames, int(sel.sum())
