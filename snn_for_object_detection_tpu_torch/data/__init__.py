"""Host-side data pipeline: event decoding, rasterization, streaming.

The port's copy of ``snn_for_object_detection_tpu/data``: numpy, and the
native rasterizer of ``native/``."""

from snn_for_object_detection_tpu_torch.data.psee import EventReader, write_dat
from snn_for_object_detection_tpu_torch.data.prophesee import (
    DATASET_GEOMETRY,
    PropheseeDataModule,
    STStream,
    MTStream,
)

__all__ = [
    "DATASET_GEOMETRY",
    "EventReader",
    "MTStream",
    "PropheseeDataModule",
    "STStream",
    "write_dat",
]
