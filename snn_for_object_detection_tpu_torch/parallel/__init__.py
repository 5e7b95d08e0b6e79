"""Mesh construction, sharding helpers, halo exchanges and multi-process
wiring."""

from snn_for_object_detection_tpu_torch.parallel import distributed, halo
from snn_for_object_detection_tpu_torch.parallel.halo import (
    Space,
    fetch_rows,
    gather_rows,
    row_blocks,
)
from snn_for_object_detection_tpu_torch.parallel.mesh import (
    Mesh,
    MeshShape,
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
    "MeshShape",
    "Space",
    "batch_sharding",
    "data_extent",
    "distributed",
    "feature_sharding",
    "fetch_rows",
    "gather_rows",
    "halo",
    "make_mesh",
    "prefetch_to_device",
    "replicated",
    "row_blocks",
    "shard_batch",
]
