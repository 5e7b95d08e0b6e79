"""Model DSL, spec compiler, detector core and TinyYolo."""

from snn_for_object_detection_tpu_torch.models.detector import SODa
from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo

__all__ = ["SODa", "TinyYolo"]
