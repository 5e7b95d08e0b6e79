"""Training orchestration: loop, metrics, checkpointing, loggers."""

from snn_for_object_detection_tpu_torch.train.loggers import (
    CSVLogger,
    TensorBoardLogger,
)
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from snn_for_object_detection_tpu_torch.train.metrics import (
    MeanAveragePrecision,
)

__all__ = [
    "CSVLogger",
    "MeanAveragePrecision",
    "TensorBoardLogger",
    "Trainer",
]
