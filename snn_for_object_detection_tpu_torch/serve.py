"""Multi-camera streaming inference engine (the serving path).

Counterpart of ``snn_for_object_detection_tpu/serve.py``: N independent
event-camera streams share one batched ``SODa.predict`` per step. The
engine owns a fixed-capacity slot array, so every step runs the same
shapes whatever the cameras do; a camera's recurrent state is its slot's
batch row, and adding, removing or resetting a stream touches only that
row. Frames of empty slots are zeros and their outputs are dropped on
the host. (A single camera at the lowest latency is
``ops/megakernel.py::StreamingMegakernel``.)

Example::

    engine = StreamingEngine(model, capacity=32)
    engine.add_stream("cam0")
    engine.add_stream("cam1")
    while True:
        dets = engine.step({"cam0": f0, "cam1": f1})
        # dets: {"cam0": np.ndarray [k, 6] (class, conf, x1..y2), ...}

Detections of a stream are suppressed for its first ``model.time_window``
frames (state warm-up). int8 weights (``ops/quantize.py``) serve as any
other.

Over a device mesh (``mesh=parallel.make_mesh(devices=[...])``) one
process holds a replica of the model on each device, and the slot rows
split into one contiguous block of ``capacity / mesh.size`` rows a
device (``batch_sharding(mesh, 0)``): every block's step is launched
first, then the detections are read back. No collectives: the rows are
independent. A mesh with a ``space`` axis (``make_mesh(devices=[...],
spatial=k)``) is JAX's ``(data, space)`` serving mesh, whose engine
shards the slots over ``data`` and replicates them over ``space``: here a
replica a data row, on that row's first device, so its results are those
of the same engine on the data rows' devices alone.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from snn_for_object_detection_tpu_torch.models.convert import (
    load_jax_params,
    model_stats,
)
from snn_for_object_detection_tpu_torch.ops.nms import filter_detections
from snn_for_object_detection_tpu_torch.parallel.mesh import (
    batch_sharding,
    same_device,
)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return list(tree)


class StreamingEngine:
    """Batched stateful inference over up to ``capacity`` camera
    streams with per-stream add / remove / reset."""

    def __init__(
        self,
        model,
        capacity: int = 32,
        max_out: int = 300,
        threshold: float = 0.0,
        mesh: Optional[Any] = None,
        frame_dtype: str = "uint8",
        pipelined: bool = False,
    ):
        """
        :param model: A :class:`SODa` detector holding its weights; the
            engine runs on its device.
        :param capacity: Maximum simultaneous streams: the batch of every
            step.
        :param max_out: Detection rows per stream and frame before the
            host drops the empty ones.
        :param threshold: Confidence floor applied on the host (0 keeps
            every foreground row).
        :param mesh: A mesh of this process's devices
            (``parallel.make_mesh(devices=..., spatial=...)``; one device
            may appear more than once): a replica of the model on each
            device (each data row's first device with ``spatial > 1``),
            a block of the slots each. ``capacity`` must divide by the
            mesh's size, as JAX's.
        :param frame_dtype: Host staging dtype of the slot frames:
            ``uint8`` (the default, 4x less host-to-device traffic,
            exact for event counts below 256) or ``float32``. The step
            casts to the model's compute dtype on the device.
        :param pipelined: ``step()`` returns the detections of the
            PREVIOUS frame batch while the current one runs on the card
            (one frame of added latency; :meth:`flush` drains the last
            one; the first ``step()`` returns ``{}``). On a card the
            frames go up from pinned host buffers without blocking, and
            only the previous step's detections are read back.
        """
        self.model = model
        self.capacity = int(capacity)
        if mesh is not None:
            if mesh.ranks != 1:
                raise ValueError("a serving mesh is one process's devices")
            if self.capacity % mesh.size:
                raise ValueError(
                    f"capacity {self.capacity} must divide by the mesh "
                    f"size {mesh.size}")
            rows = batch_sharding(mesh, 0).blocks(self.capacity)
            self._replicas = [(self._replica(model, dev, i), rows[i])
                              for i, dev in enumerate(mesh.data_devices)]
        else:
            self._replicas = [(model, slice(0, self.capacity))]
        self.max_out = int(max_out)
        self.threshold = float(threshold)
        self.pipelined = bool(pipelined)
        self._device = model.device
        self._h, self._w = model.in_hw
        self._c = model.in_channels
        # one state a replica, over its block of slots
        self._states = [m.init_state(r.stop - r.start)
                        for m, r in self._replicas]
        self._slots: Dict[str, int] = {}
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._age: Dict[str, int] = {}
        cuda = self._device.type == "cuda"
        shape = (self.capacity, self._h, self._w, self._c)
        dtype = getattr(torch, np.dtype(frame_dtype).name)
        # two staging buffers in pipelined mode: one may still be on its
        # way to the card while the caller's next frames fill the other
        self._bufs = [torch.zeros(shape, dtype=dtype, pin_memory=cuda)
                      for _ in range(2 if self.pipelined else 1)]
        self._flip = 0
        # pipelined mode: (host detections, copy-done event, slot/age
        # snapshot) of the step in flight
        self._pending: Optional[tuple] = None

    @staticmethod
    def _replica(model, device: torch.device, index: int):
        """The model on ``device``: itself for the first block on its own
        device, else a copy."""
        if index == 0 and same_device(device, model.device):
            return model
        replica = copy.deepcopy(model)
        if not same_device(device, model.device):
            replica.to(device)
            replica.device = device
        return replica

    # ----- stream lifecycle -----

    @property
    def streams(self) -> List[str]:
        return list(self._slots)

    def _reset_row(self, slot: int) -> None:
        """Zero one batch row of every state leaf (the cells' initial
        state: ``v_leak = 0`` and no current)."""
        per = self.capacity // len(self._replicas)
        for leaf in _leaves(self._states[slot // per]):
            leaf[slot % per].zero_()

    def add_stream(self, stream_id: str) -> int:
        """Attach a camera; returns its slot. Raises when full."""
        if stream_id in self._slots:
            raise KeyError(f"stream {stream_id!r} already attached")
        if not self._free:
            raise RuntimeError(
                f"engine at capacity ({self.capacity} streams); "
                "remove_stream() one or build with a larger capacity"
            )
        slot = self._free.pop()
        self._slots[stream_id] = slot
        self._age[stream_id] = 0
        self._reset_row(slot)
        return slot

    def remove_stream(self, stream_id: str) -> None:
        """Detach a camera and free its slot."""
        slot = self._slots.pop(stream_id)  # KeyError for an unknown id
        self._age.pop(stream_id)
        self._free.append(slot)

    def reset_stream(self, stream_id: str) -> None:
        """Zero a camera's recurrent state (e.g. on a stream gap)."""
        slot = self._slots[stream_id]
        self._age[stream_id] = 0
        self._reset_row(slot)

    # ----- inference -----

    def step(self, frames: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Advance every attached stream by one frame.

        :param frames: stream_id -> event frame [H, W, C]. Streams missing
            from the dict get an all-zero frame (their state still
            advances: an event camera sends no events for a static
            scene).
        :return: stream_id -> filtered detections [k, 6] (class, conf, x1,
            y1, x2, y2), empty during the stream's first
            ``model.time_window`` frames. In pipelined mode they belong
            to the PREVIOUS ``step()``'s frames.
        """
        unknown = set(frames) - set(self._slots)
        if unknown:
            raise KeyError(f"unattached streams: {sorted(unknown)}")
        # validate every frame before touching the staging buffers: a
        # raise after the flip would desync the pipelined double buffer
        staged = {
            self._slots[sid]: self._check_frame(sid, frame)
            for sid, frame in frames.items()
        }
        buf = self._bufs[self._flip]
        self._flip = (self._flip + 1) % len(self._bufs)
        host = buf.numpy()
        host[:] = 0
        for slot, frame in staged.items():
            host[slot] = frame
        # every block's step is queued before any detections are read
        dets = []
        for i, (model, rows) in enumerate(self._replicas):
            x = buf[rows].to(model.device, non_blocking=True)
            d, self._states[i] = model.predict(x, self._states[i],
                                               max_out=self.max_out)
            dets.append(d)
        for sid in self._slots:
            self._age[sid] += 1
        snapshot = (dict(self._slots), dict(self._age))
        if self._device.type == "cuda":
            # read back this step's detections only: the copies queue
            # behind this step, not behind the next one
            out = torch.empty((self.capacity, *dets[0].shape[1:]),
                              dtype=dets[0].dtype, pin_memory=True)
            done = []
            for (model, rows), d in zip(self._replicas, dets):
                with torch.cuda.device(model.device):
                    out[rows].copy_(d, non_blocking=True)
                    done.append(torch.cuda.Event())
                    done[-1].record()
        else:
            out = dets[0] if len(dets) == 1 else torch.cat(dets)
            done = []
        pending, self._pending = self._pending, (out, done, snapshot)
        if not self.pipelined:
            return self.flush()
        return self._fan_out(*pending) if pending is not None else {}

    def _check_frame(self, sid: str, frame) -> np.ndarray:
        """Validate one frame against the engine geometry and staging
        dtype. With integer staging a cast would truncate normalized
        float inputs to 0 and wrap counts past the dtype's range: fail
        loud on the former, saturate the latter."""
        frame = np.asarray(frame)
        if frame.shape != (self._h, self._w, self._c):
            raise ValueError(
                f"stream {sid!r}: frame shape {frame.shape} != "
                f"({self._h}, {self._w}, {self._c})"
            )
        dt = self._bufs[0].numpy().dtype
        if np.issubdtype(dt, np.integer):
            if np.issubdtype(frame.dtype, np.floating) and not np.all(
                frame == np.rint(frame)
            ):
                raise ValueError(
                    f"stream {sid!r}: non-integral frame values with "
                    f"{dt.name} staging would be truncated; event-count "
                    "frames are integral: construct the engine with "
                    "frame_dtype='float32' for arbitrary-valued inputs"
                )
            info = np.iinfo(dt)
            if frame.size and (frame.max() > info.max
                               or frame.min() < info.min):
                # saturate both ends: 300 -> 255 and -1 -> 0, no wrap
                frame = np.clip(frame, info.min, info.max)
        return frame

    def flush(self) -> Dict[str, np.ndarray]:
        """Fetch and fan out the step in flight (pipelined mode: the
        final frames of a stream); ``{}`` when nothing is pending."""
        if self._pending is None:
            return {}
        pending, self._pending = self._pending, None
        return self._fan_out(*pending)

    def _fan_out(self, dets, done, snapshot) -> Dict[str, np.ndarray]:
        """Split one step's detections per stream, with the slot and
        age snapshot taken when it was dispatched."""
        for event in done:
            event.synchronize()
        slots, ages = snapshot
        dets_np = dets.numpy()
        out: Dict[str, np.ndarray] = {}
        for sid, slot in slots.items():
            if ages[sid] <= self.model.time_window:
                out[sid] = np.zeros((0, 6), np.float32)
                continue
            rows = filter_detections(dets_np[slot])
            if self.threshold > 0.0:
                rows = rows[rows[:, 1] >= self.threshold]
            out[sid] = rows
        return out

    def update_weights(self, params: Any, stats: Optional[Any] = None
                       ) -> None:
        """Swap in JAX-layout ``(params, stats)`` without disturbing the
        stream states (a live model refresh); ``stats=None`` keeps the
        BatchNorm statistics. JAX's int8 conv leaves
        (``ops/quantize.py``) turn their convs int8, and ``w`` leaves
        turn int8 convs back to float (``load_jax_params``). On a mesh,
        every replica."""
        if stats is None:
            stats = model_stats(self.model)
        for model, _ in self._replicas:
            load_jax_params(model, params, stats)

