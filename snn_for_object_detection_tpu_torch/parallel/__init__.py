"""Mesh construction, sharding helpers and multi-process wiring."""

from snn_for_object_detection_tpu_torch.parallel import distributed
from snn_for_object_detection_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    data_extent,
    feature_sharding,
    make_mesh,
    prefetch_to_device,
    replicated,
    shard_batch,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "data_extent",
    "distributed",
    "feature_sharding",
    "make_mesh",
    "prefetch_to_device",
    "replicated",
    "shard_batch",
]
