"""The config system (the port's YAML reader, overrides, class paths),
visualization and the model summary."""

from snn_for_object_detection_tpu_torch.utils.config import (
    instantiate,
    load_config,
    parse_overrides,
)
from snn_for_object_detection_tpu_torch.utils.plotter import Plotter

__all__ = [
    "Plotter",
    "instantiate",
    "load_config",
    "parse_overrides",
]
