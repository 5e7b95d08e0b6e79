"""Native (C++) host kernels: event decoding and rasterization.

The port's counterpart of ``snn_for_object_detection_tpu/native``:
``event_ops.cc`` is built with g++ at first use and loaded with ctypes.
Unlike the JAX package's bindings, a failed build raises instead of
falling back to numpy; the numpy versions are the kernels' plain
versions (``*_reference``).
"""

from snn_for_object_detection_tpu_torch.native.bindings import (
    COUNTS,
    decode_events,
    decode_events_reference,
    rasterize_records,
    rasterize_records_reference,
)

__all__ = [
    "COUNTS",
    "decode_events",
    "decode_events_reference",
    "rasterize_records",
    "rasterize_records_reference",
]
