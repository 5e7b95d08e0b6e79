"""Device mesh for data-parallel and spatially sharded training, and
mesh serving.

Counterpart of ``snn_for_object_detection_tpu/parallel/mesh.py``. The
JAX package's mesh is every device of every host under one program, and
GSPMD inserts the collectives. Here a :class:`Mesh` is this process's
devices and the process groups its ranks form:

- training holds one device a rank (``make_mesh()``: the device
  ``distributed.initialize`` set, over the default group); each rank's
  batch is its block of the global batch, which is the ranks' batches
  concatenated in rank order; the Trainer all-reduces the gradients and
  hands the group to the model, whose BatchNorm moments and loss counts
  it makes global;
- ``make_mesh(spatial=k)`` lays the ranks out as a ``(data, space)``
  grid: rank ``r`` at data index ``r // k`` and space index ``r % k``
  (JAX's ``devs.reshape(-1, spatial)``, the ``space`` ranks adjacent).
  The ``k`` ranks of a data block load the same batch and each holds a
  block of the rows of every map (``parallel/halo.py``: the split, the
  halo rows a 3x3 conv reads, the heads gathered before the loss);
  BatchNorm's moments span the whole grid and the gradients are summed
  over it;
- serving holds several devices in one process (``make_mesh(devices=
  ["cuda:0", "cuda:1"])``, or ``["cpu"] * 4`` on the CPU): the engine
  keeps a replica of the model on each, and the slot rows split into
  contiguous blocks (:func:`batch_sharding`); no collectives. With
  ``spatial=k`` the devices form ``len(devices) / k`` data rows of ``k``
  (JAX's engine shards its slots over ``data`` and replicates them over
  ``space``): a replica a data row, on the row's first device
  (:attr:`Mesh.data_devices`), a block of slots each.

:class:`MeshShape` is a mesh's extents without its groups: what a
Trainer queues for a live reshape (``new_group`` is collective, so no
one rank's thread may build a mesh).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from snn_for_object_detection_tpu_torch.parallel import distributed as dist
from snn_for_object_detection_tpu_torch.parallel.halo import Space

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's ``devices`` and the process ``group`` whose ranks
    hold the rest of the mesh (``None``: this process alone).

    On a ``(data, space)`` grid (``space > 1``, one device a rank):
    ``space_group`` holds the ``space`` ranks of this rank's data block,
    ``space_rank`` is this rank's index among them, and ``data_group``
    holds the ranks of its space index across the data blocks. Without
    a space axis ``data_group`` is ``group``."""

    devices: Tuple[torch.device, ...]
    group: Any = None
    axis: str = DATA_AXIS
    space: int = 1
    space_group: Any = None
    data_group: Any = None
    space_rank: int = 0

    def __post_init__(self):
        if self.space == 1 and self.data_group is None:
            object.__setattr__(self, "data_group", self.group)

    @property
    def ranks(self) -> int:
        return 1 if self.group is None else dist.world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.rank(self.group)

    @property
    def size(self) -> int:
        return len(self.devices) * self.ranks

    @property
    def shape(self):
        if self.space == 1:
            return {self.axis: self.size}
        return {self.axis: self.size // self.space, SPACE_AXIS: self.space}

    @property
    def data_index(self) -> int:
        """This rank's block of the global batch."""
        return self.rank // self.space

    @property
    def space_ctx(self) -> Optional[Space]:
        """The ``space`` axis as the model takes it (``None``: no axis)."""
        if self.space == 1:
            return None
        return Space(self.space_group, self.space, self.space_rank)

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """This process's first device of each of its data rows: every
        device without a ``space`` axis; on a one-process serving mesh
        with one, a data row's ``space`` devices hold the same slots."""
        return self.devices[::self.space] if self.group is None \
            else self.devices

    @property
    def device(self) -> torch.device:
        """The device of a training mesh (one a rank)."""
        if len(self.devices) != 1:
            raise ValueError(
                f"a training mesh holds one device a rank, this one "
                f"{len(self.devices)}: {self.devices}")
        return self.devices[0]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """The extents of a mesh, ``data`` x ``space``, and nothing of its
    groups (JAX's ``mesh.shape``)."""

    data: int
    space: int = 1
    axis: str = DATA_AXIS

    @property
    def size(self) -> int:
        return self.data * self.space

    @property
    def shape(self):
        if self.space == 1:
            return {self.axis: self.data}
        return {self.axis: self.data, SPACE_AXIS: self.space}


def _grid(dev: torch.device, axis: str, spatial: int) -> Mesh:
    """The ``(data, space)`` grid over every rank. Every rank creates
    every group, in the same order (``new_group`` is collective)."""
    world, rank = dist.world_size(), dist.rank()
    if world % spatial:
        raise ValueError(
            f"{world} ranks not divisible by spatial={spatial}")
    blocks = world // spatial
    space_groups = [tdist.new_group(list(range(d * spatial,
                                               (d + 1) * spatial)))
                    for d in range(blocks)]
    data_groups = [tdist.new_group(list(range(j, world, spatial)))
                   for j in range(spatial)]
    return Mesh((dev,), tdist.group.WORLD, axis, spatial,
                space_groups[rank // spatial], data_groups[rank % spatial],
                rank % spatial)


def make_mesh(devices: Optional[Sequence] = None, axis: str = DATA_AXIS,
              spatial: int = 1) -> Mesh:
    """The training or serving mesh.

    ``devices=None``: this rank's device over every rank
    (``distributed.initialize()`` first, which joins a group of one
    process when nothing says otherwise). ``spatial=k``: those ranks as
    a ``(data, space)`` grid with ``k`` ranks along ``space`` (the world
    size must divide by ``k``). A list of devices: those, in this
    process (serving; several ranks take one each, and then ``spatial``
    builds the grid as above). In one process ``spatial=k`` lays the
    devices out as ``len(devices) / k`` data rows of ``k`` (a serving
    mesh: :attr:`Mesh.data_devices`)."""
    if spatial < 1:
        raise ValueError(f"spatial must be at least 1, got {spatial}")
    if devices is None:
        dev = dist.initialize()
        if spatial > 1:
            return _grid(dev, axis, spatial)
        return Mesh((dev,), tdist.group.WORLD, axis)
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if dist.is_distributed():
        if len(devs) != 1:
            raise ValueError(
                f"under {dist.world_size()} ranks a mesh holds one device "
                f"a rank, got {len(devs)}")
        if spatial > 1:
            return _grid(devs[0], axis, spatial)
        return Mesh(devs, tdist.group.WORLD, axis)
    if len(devs) % spatial:
        raise ValueError(
            f"{len(devs)} devices not divisible by spatial={spatial}")
    return Mesh(devs, None, axis, spatial)


def same_device(a, b) -> bool:
    """Whether two devices are one (``cuda`` is the current card)."""
    def resolved(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return resolved(a) == resolved(b)


def data_extent(mesh: Mesh) -> int:
    """Devices along the batch (``data``) axis of ``mesh``."""
    return mesh.size // mesh.space


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where an array's blocks live on ``mesh``: dimension ``dim``
    split into one contiguous block a device (in rank, then device
    order), or the whole array on every device (``dim=None``)."""

    mesh: Mesh
    dim: Optional[int]

    def blocks(self, size: int) -> List[slice]:
        """This process's blocks of a dimension of ``size``, one a
        device, or with ``dim=None`` the whole dimension a device. On a
        one-process mesh with a ``space`` axis, one a data row (of
        :attr:`Mesh.data_devices`): its ``space`` devices share it."""
        mesh = self.mesh
        if self.dim is None:
            return [slice(0, size)] * len(mesh.devices)
        if mesh.space > 1 and mesh.group is not None:
            raise ValueError("a grid's batch blocks are its data blocks: "
                             "each rank's batch is its data block's")
        n, here = data_extent(mesh), len(mesh.data_devices)
        if size % n:
            raise ValueError(
                f"{size} rows must divide by the {n} data rows of the mesh")
        per = size // n
        first = mesh.rank * here
        return [slice((first + i) * per, (first + i + 1) * per)
                for i in range(here)]


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def batch_sharding(mesh: Mesh, batch_axis_index: int) -> Sharding:
    """Rows along ``batch_axis_index`` (0 for ``[B, ...]`` labels and
    slot frames, 1 for time-major ``[T, B, ...]`` features)."""
    return Sharding(mesh, batch_axis_index)


def feature_sharding(mesh: Mesh, batch_axis_index: int = 1,
                     height_axis_index: int = 2) -> Sharding:
    """Feature maps ``[T, B, H, W, C]``: B along ``data``. On a
    ``(data, space)`` grid H is also split along ``space``: a rank keeps
    its block ``mesh.space_ctx.block(H)`` (:func:`shard_batch`)."""
    del height_axis_index
    return Sharding(mesh, batch_axis_index)


def _to_device(x, dev: torch.device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x))
    if dtype is not None:
        t = t.to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def shard_batch(mesh: Mesh, features: Any, labels: Any):
    """This rank's batch on its device: ``features`` [T, B_local, H, W,
    C] as they come (uint8 frames stay uint8), ``labels`` [B_local, N,
    5] as fp32. A rank's batch is its data block of the global batch,
    the blocks concatenated in data-index order (DDP's semantics, as
    ``jax.make_array_from_process_local_data`` in the JAX package); on a
    ``(data, space)`` grid the ranks of a block load the same batch and
    each keeps its block of the rows of H, the labels whole.
    On the card the copies go up from pinned memory without blocking
    the host; they are ordered on the current stream."""
    dev = mesh.device
    space = mesh.space_ctx
    if space is not None:
        features = np.asarray(features)
        lo, hi = space.block(features.shape[2], "the input frames")
        features = np.ascontiguousarray(features[:, :, lo:hi])
    return (_to_device(features, dev),
            _to_device(labels, dev, torch.float32))


def prefetch_to_device(iterator, mesh: Mesh, size: int = 2):
    """Wrap a host batch iterator with background device placement.

    A daemon thread pulls ``(features, labels)`` from ``iterator`` up to
    ``size`` batches ahead of the consumer, stages them in pinned memory
    and copies them to the mesh's device without blocking, on a stream
    of its own; the consumer's stream waits on an event recorded after
    the copies, so rasterization and the host-to-device transfer overlap
    the previous train step. ``size <= 0`` places each batch
    synchronously (:func:`shard_batch`).

    Worker exceptions re-raise at the consumer's ``next()``. The
    generator's ``close()`` stops the worker after its in-flight batch:
    the worker OWNS the wrapped iterator and closes it itself on exit
    (closing a generator from another thread while it runs ``next()``
    raises "generator already executing")."""
    if size <= 0:
        try:
            for features, labels in iterator:
                yield shard_batch(mesh, features, labels)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
        return

    dev = mesh.device
    on_card = dev.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def worker():
        try:
            stream = torch.cuda.Stream(dev) if on_card else None
            for features, labels in iterator:
                if stop.is_set():
                    return
                if on_card:
                    with torch.cuda.device(dev), torch.cuda.stream(stream):
                        batch = shard_batch(mesh, features, labels)
                        done = torch.cuda.Event()
                        done.record(stream)
                else:
                    batch, done = shard_batch(mesh, features, labels), None
                q.put(("ok", (batch, done)))
                if stop.is_set():
                    return
            q.put(("end", None))
        except BaseException as e:  # re-raised by the consumer
            q.put(("err", e))
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    t = threading.Thread(target=worker, daemon=True, name="device-prefetch")
    t.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "end":
                return
            if kind == "err":
                raise payload
            batch, done = payload
            if done is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(done)
                for x in batch:
                    # made on the worker's stream, used on this one: the
                    # allocator must not reuse them before this stream
                    # is done with them
                    x.record_stream(current)
            yield batch
    finally:
        stop.set()
        # unblock the worker if it is parked on a full queue, then let
        # it finish its in-flight batch and close the source iterator
        try:
            q.get_nowait()
        except Exception:
            pass
        t.join(timeout=30.0)
