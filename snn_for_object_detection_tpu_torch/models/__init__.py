"""Model DSL, spec compiler, detector core and the model zoo: TinyYolo,
YoloSNN and VggSNN."""

from snn_for_object_detection_tpu_torch.models.detector import SODa
from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo
from snn_for_object_detection_tpu_torch.models.vgg import VggSNN
from snn_for_object_detection_tpu_torch.models.yolo import YoloSNN

__all__ = ["SODa", "TinyYolo", "VggSNN", "YoloSNN"]
