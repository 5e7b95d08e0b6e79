"""The config system: the port's YAML reader, overrides, class paths."""

from snn_for_object_detection_tpu_torch.utils.config import (
    instantiate,
    load_config,
    parse_overrides,
)

__all__ = [
    "instantiate",
    "load_config",
    "parse_overrides",
]
