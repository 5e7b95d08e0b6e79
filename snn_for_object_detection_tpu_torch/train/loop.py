"""Training and evaluation loop: the port of the JAX package's ``Trainer``.

Counterpart of ``snn_for_object_detection_tpu/train/loop.py``.

Training (``fit`` -> ``train_step``), each step:

1. draws a random truncation start ``r`` in ``[0, time_window)`` from
   the trainer's ``torch.Generator``;
2. runs the model's forward with ``start_step=r, train=True`` (BatchNorm
   on batch statistics, activations recomputed in the backward);
3. computes ``model.loss`` and its gradient (on the card every LIF/LI
   cell's backward is the ``temporal_cell_seq`` backward kernel);
4. updates the weights as the JAX step's optax chain does: gradients
   averaged over ``accumulate_grad_batches`` micro-batches
   (``optax.MultiSteps``), clipped by their global norm, then the named
   optimizer (Adamax by default) at the scheduled learning rate, and
   the EMA blended on a real update.

``fit`` runs epochs of ``limit_train_batches`` steps, validates every
``check_val_every_n_epoch`` epochs (on the EMA weights when EMA is on),
stops early on ``monitor``, logs JSONL to ``out_dir`` (and to the
tracker back ends of ``logger``, ``train/loggers.py``) and checkpoints
there (``train/checkpoint.py``), and resumes from ``ckpt_path``. With
``debug_nans`` it raises on a NaN in a step's outputs; with
``profile_dir`` it traces train steps 3-5, as the JAX trainer does.

Evaluation (``validate`` / ``test``), each batch: a start ``r``, the
forward, ``model.loss``, ``model.detect`` (softmax + NMS) and COCO mAP
on the host.

The schedule (``time_batched``): ``False`` -> ``model.forward``, ``True``
-> ``model.forward_seq``, ``"hybrid"`` -> ``model.forward_hybrid``: one
function, three orders of work. ``"auto"`` times the three on a copy of
the model at the first batch's geometry, once for the train step and
once for the eval step, and keeps the fastest for the life of the
trainer; only ``torch.OutOfMemoryError`` disqualifies a schedule.

Batches are any iterable of numpy ``(X [T, B, H, W, C], labels [B, N,
5])`` pairs (``data.PropheseeDataModule``'s loaders give uint8 frames,
which the model casts on the device); ``fit`` takes an object with
``train_loader()`` and ``val_loader()`` returning such iterables, and
``predict`` one with ``predict_loader()`` and ``get_labels()``. Every
loop closes the iterator it reads (its ``close()``, where it has one),
so a loader's worker threads stop with the loop.

``predict`` (streaming visualization): sample 0 of each batch frame by
frame through ``SODa.predict``, each frame handed to a plotter.

Data parallel (``mesh``, or any run under ``torch.distributed`` of
several ranks): one rank a device, each on its own rows of the global
batch (``parallel/``). The train step hands the ranks' group to the
forward and the loss (``group=``), so BatchNorm's moments and the loss's
counts are the global batch's and the loss is this rank's share of it;
the gradients and the shares are all-reduced (summed) before the
optimizer chain, which every rank then runs alike. Every rank draws the
same truncation starts from the same seed. Evaluation scores each
rank's rows and folds the mAP accumulators across ranks; only rank 0
logs and writes checkpoints. Batches reach the device through
``prefetch_to_device`` (``prefetch_batches`` ahead, 2 by default).

Spatial sharding (``spatial_devices=k``, or ``mesh=make_mesh(
spatial=k)``): the ranks form a ``(data, space)`` grid; the ``k`` ranks
of a data block load the same batch (the data module's shard is the
data index's) and each keeps its rows of H. The forward takes the grid's
``space`` axis (``space=``) and the whole grid as BatchNorm's group; the
loss counts over the ``data`` group, since the ranks of a block hold the
same gathered predictions; the gradients are summed over the grid and
the loss over the data blocks, once each. Evaluation folds the mAP
accumulators over the ``data`` group, so each image counts once.

Live mesh reshape (``request_mesh_reshape``, or the file
``out_dir/reshape_request`` holding a device count), polled before each
epoch of ``fit``: under several ranks the request is dropped with JAX's
multi-host message ("use checkpoint + relaunch") and the file is left
for the supervisor that relaunches; in one process the file is claimed,
read and removed as JAX's single-process path does, and a rank holds
one device, so the only shape a request can name is the current one.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import itertools
import json
import math
import os
import socket
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Tuple,
                    Union)

import numpy as np
import torch

from snn_for_object_detection_tpu_torch.parallel import distributed as dist
from snn_for_object_detection_tpu_torch.parallel.mesh import (
    MeshShape,
    data_extent,
    make_mesh,
    prefetch_to_device,
    same_device,
    shard_batch,
)
from snn_for_object_detection_tpu_torch.train import optax_rules
from snn_for_object_detection_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from snn_for_object_detection_tpu_torch.train.metrics import (
    MeanAveragePrecision,
    detections_to_map_inputs,
)


class MetricsLogger:
    """JSONL + stdout metrics sink (``out_dir/metrics.jsonl``), fanning
    every payload out to tracker back ends (``train/loggers.py``)."""

    def __init__(self, out_dir: str, backends=()):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.backends = list(backends)
        for b in self.backends:
            set_out_dir = getattr(b, "set_out_dir", None)
            if set_out_dir is not None:
                set_out_dir(out_dir)

    def log(self, step: int, payload: Dict[str, float]) -> None:
        if not dist.is_primary():
            # several ranks: the metrics are already folded; one writer
            return
        rec = {"step": step, "time": time.time(), **payload}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        printable = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in payload.items()
        )
        print(f"[step {step}] {printable}", flush=True)
        for b in self.backends:
            b.log_metrics(step, payload)

    def close(self) -> None:
        for b in self.backends:
            b.close()


def nan_outputs(outputs: Dict[str, List[torch.Tensor]],
                device: torch.device) -> List[str]:
    """The names of the outputs that hold a NaN: a NaN-propagating norm
    of each tensor (``torch._foreach_norm``, a few launches a device and
    dtype), one flag an output on ``device``, read back at once."""
    flags = []
    for tensors in outputs.values():
        groups: Dict[Any, List[torch.Tensor]] = {}
        for t in tensors:
            if t.is_floating_point() and t.numel():
                groups.setdefault((t.device, t.dtype), []).append(t)
        flag = torch.zeros((), dtype=torch.bool, device=device)
        for ts in groups.values():
            norms = torch.stack(torch._foreach_norm(ts))
            flag = flag | norms.isnan().any().to(device)
        flags.append(flag)
    read = torch.stack(flags).tolist() if flags else []
    return [name for name, bad in zip(outputs, read) if bad]


def _say(msg: str) -> None:
    """Print ``msg`` once a run: on the rank that logs (every rank
    reaches the same line)."""
    if dist.is_primary():
        print(msg, flush=True)


# ---- optax's optimizers, schedules and wrappers in torch ----

# optax factory -> torch.optim class (optax's update for every option
# it takes; every other factory is written out in optax_rules)
_OPTIMIZERS = {"adamax": torch.optim.Adamax}
_TORCH_OPTIONS = {"adamax": ("b1", "b2", "eps")}  # the optax keywords


def make_torch_optimizer(name: str, params, lr: float,
                         kwargs: Dict[str, Any]) -> torch.optim.Optimizer:
    """The ``torch.optim`` optimizer whose update is optax's ``name``
    with ``kwargs`` (optax's names: ``b1``, ``b2``, ``eps``)."""
    unknown = sorted(set(kwargs) - set(_TORCH_OPTIONS[name]))
    if unknown:
        raise TypeError(f"{name}() got unexpected keyword arguments "
                        f"{unknown}")
    kw = {}
    kwargs = dict(kwargs)
    if "b1" in kwargs or "b2" in kwargs:
        kw["betas"] = (kwargs.pop("b1", 0.9), kwargs.pop("b2", 0.999))
    kw.update(kwargs)
    return _OPTIMIZERS[name](params, lr=lr, **kw)


def make_schedule(lr: float, cfg: Optional[Dict[str, Any]]
                  ) -> Union[float, Callable[[int], float]]:
    """Learning rate by optimizer update count (0 for the first update),
    by optax's formulas, peaking at ``lr``: ``warmup_cosine``
    (``warmup_cosine_decay_schedule``), ``cosine``
    (``cosine_decay_schedule``), ``exponential`` (``exponential_decay``);
    without ``cfg``, the float ``lr`` itself (optax's constant rate)."""
    if not cfg:
        return lr
    cfg = dict(cfg)
    kind = cfg.pop("name", "warmup_cosine")

    def cosine(init, decay_steps, alpha=0.0, exponent=1.0):
        if not decay_steps > 0:
            raise ValueError("cosine decay needs positive decay_steps")

        def f(count):
            c = min(count, decay_steps)
            decay = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return init * ((1 - alpha) * decay ** exponent + alpha)
        return f

    if kind == "warmup_cosine":
        init = cfg.pop("init_value", 0.0)
        warmup = cfg.pop("warmup_steps", 0)
        end = cfg.pop("end_value", 0.0)
        after = cosine(lr, cfg.pop("decay_steps") - warmup,
                       0.0 if lr == 0.0 else end / lr,
                       cfg.pop("exponent", 1.0))
        _no_options(kind, cfg)

        def warmup_cosine(count):
            if count < warmup:
                return init + (lr - init) * count / warmup
            return after(count - warmup)
        return warmup_cosine
    if kind == "cosine":
        f = cosine(lr, cfg.pop("decay_steps"), cfg.pop("alpha", 0.0),
                   cfg.pop("exponent", 1.0))
        _no_options(kind, cfg)
        return f
    if kind == "exponential":
        steps = cfg.pop("transition_steps")
        rate = cfg.pop("decay_rate")
        begin = max(cfg.pop("transition_begin", 0), 0)
        staircase = cfg.pop("staircase", False)
        end = cfg.pop("end_value", None)
        _no_options(kind, cfg)
        if steps <= 0 or rate == 0:
            return lambda count: lr

        def exponential(count):
            p = (count - begin) / steps
            if staircase:
                p = math.floor(p)
            value = lr if count - begin <= 0 else lr * rate ** p
            if end is not None:
                value = max(value, end) if rate < 1 else min(value, end)
            return value
        return exponential
    raise ValueError(f"unknown lr_schedule name {kind!r} "
                     "(warmup_cosine | cosine | exponential)")


def _no_options(kind: str, cfg: Dict[str, Any]) -> None:
    """optax's schedules take no other keyword."""
    if cfg:
        raise TypeError(f"{kind} schedule got unexpected keyword "
                        f"arguments {sorted(cfg)}")


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax ``clip_by_global_norm``: ``(g / norm) * max_norm`` for every
    leaf when the global norm is at least ``max_norm``, else ``g``."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    if bool(norm < max_norm):
        return grads
    return [(g / norm.to(g.dtype)) * max_norm for g in grads]


class Optimizer:
    """The JAX step's optax chain on a list of parameters:
    ``MultiSteps(chain(clip_by_global_norm, <name>(schedule)), k)``.

    :meth:`step` takes one micro-batch's gradients and returns whether it
    updated the parameters (every ``k``-th call, with the mean of the k
    gradients, as ``MultiSteps``). The schedule's step is the count of
    real updates. ``schedule``: a float (a constant rate) or a function
    of that count, as optax's ``learning_rate``. ``names``: the
    parameters' names, which the factories' mask options read.
    """

    def __init__(self, params: List[torch.nn.Parameter], optimizer: Any,
                 schedule: Union[float, Callable[[int], float]],
                 clip_norm: Optional[float] = None, every_k: int = 1,
                 names: Optional[List[str]] = None):
        if isinstance(optimizer, str):
            name, kwargs = optimizer, {}
        else:
            kwargs = dict(optimizer)
            name = kwargs.pop("name")
        self.params = list(params)
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.every_k = max(int(every_k), 1)
        if name in _OPTIMIZERS:
            self.torch = make_torch_optimizer(name, self.params,
                                              self.lr_at(0), kwargs)
            self.rule = None
        else:
            self.torch = None
            self.rule = optax_rules.Rule(name, self.params, kwargs,
                                         schedule, names)
        self.count = 0
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] \
            if self.every_k > 1 else None

    def lr_at(self, count: int) -> float:
        """The learning rate of update ``count`` (0 for the first)."""
        return self.schedule(count) if callable(self.schedule) \
            else self.schedule

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]]) -> bool:
        if self.rule is not None:
            # MultiSteps traces the inner update at every micro-batch:
            # an update optax cannot run fails at the first
            self.rule.check()
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if self.acc is not None:
            n = self.mini_step
            self.acc = [a + (g - a) / (n + 1)
                        for a, g in zip(self.acc, grads)]
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return False
            grads, self.acc = self.acc, [torch.zeros_like(a)
                                         for a in self.acc]
        if self.clip_norm:
            grads = clip_by_global_norm(grads, self.clip_norm)
        lr = self.lr_at(self.count)
        if self.rule is not None:
            self.rule.step(self.params, grads, lr)
        else:
            for group in self.torch.param_groups:
                group["lr"] = lr
            for p, g in zip(self.params, grads):
                p.grad = g
            self.torch.step()
            for p in self.params:
                p.grad = None
        self.count += 1
        return True

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the optimizer's state (the chain's output
        beside the weights)."""
        if self.rule is not None:
            out = self.rule.tensors()
        else:
            out = [v for s in self.torch.state.values() for v in s.values()
                   if torch.is_tensor(v)]
        return out + list(self.acc or [])

    def state_dict(self) -> Dict[str, Any]:
        inner = {"rule": self.rule.state_dict()} if self.rule is not None \
            else {"torch": self.torch.state_dict()}
        return {**inner, "count": self.count, "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if self.rule is not None:
            self.rule.load_state_dict(state["rule"])
        else:
            self.torch.load_state_dict(state["torch"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        if self.acc is not None and state["acc"] is not None:
            self.acc = [a.to(p.device) for a, p in
                        zip(state["acc"], self.params)]


# the order in which "auto" times the schedules (JAX's)
SCHEDULES = (False, "hybrid", True)


def time_call(fn: Callable[[], Any], device: torch.device,
              reps: int = 2) -> float:
    """Seconds per call of ``fn``: one warm call (which also builds the
    kernels on their first use), then ``reps`` calls between CUDA events
    on the card, on ``time.perf_counter`` on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _stats(model) -> Dict[str, torch.Tensor]:
    return {name: buf for name, buf in model.named_buffers()
            if name.endswith((".mean", ".var"))}


class Trainer:
    """Training and evaluation orchestrator.

    :param time_batched: ``False`` runs through ``model.forward``
        (per-step, each step checkpointed in training), ``True`` through
        ``model.forward_seq`` (every cell one ``temporal_cell_seq`` call
        over the sequence, conv -> norm -> cell segments checkpointed in
        training), ``"hybrid"`` through ``model.forward_hybrid`` (the
        backbone time-batched, the neck and heads per step). All three
        compute the same function. ``"auto"`` picks one by measurement
        (:meth:`_schedule_for`). A model built with ``fuse_seq=True``
        runs its fused triples in evaluation on the time-batched
        schedule only, and there only at ``time_window == 0``: the JAX
        eval step passes a traced start whenever the window is open,
        even when the draw is 0, and a traced start never fuses.
    :param seed: Seed of the ``torch.Generator`` that draws each batch's
        truncation start. ``fit`` draws from one generator over the run;
        every ``validate`` / ``test`` call starts the draw anew from the
        seed, as the JAX trainer restarts its key.
    :param optimizer: An optax 0.2.6 factory name (``"adamax"``,
        ``"adam"``, ``"sgd"``, any of ``optax_rules.FACTORIES``) or
        ``{"name": ..., **optax_kwargs}`` (:class:`Optimizer`).
    :param lr_schedule: ``{"name": "warmup_cosine" | "cosine" |
        "exponential", ...}`` with the model's ``learning_rate`` as the
        peak (:func:`make_schedule`).
    :param ema_decay: Keep an average of the weights, blended on every
        real update; validation and checkpoints use it.
    :param mesh: A data-parallel mesh (``parallel.make_mesh()``: this
        rank's device over every rank) or a ``(data, space)`` grid
        (``make_mesh(spatial=k)``), taken as it is. Default: the model's
        device alone, or the grid :meth:`mesh_for` sizes from
        ``spatial_devices`` when ``torch.distributed`` runs several
        ranks.
    :param spatial_devices: Ranks along the ``space`` axis of the grid
        :meth:`mesh_for` builds (JAX's ``mesh_for_batch``): ``k > 1``
        splits H over ``k`` ranks of one host; refused across hosts, for
        a world that ``k`` does not divide, and in one process of one
        device.
    :param prefetch_batches: Batches ``fit`` keeps on their way to the
        device ahead of the train step (``prefetch_to_device``, a
        thread; 0 places each batch when it is needed).
    :param logger: Tracker back ends (``train/loggers.py``): a
        ``class_path`` / ``init_args`` dict, a list of them, or built
        objects with ``log_metrics(step, payload)`` and ``close()``.
        Every payload ``fit`` logs goes to each (rank 0 only); ``fit``
        closes them when it ends.
    :param debug_nans: ``jax_debug_nans`` of the JAX trainer: in ``fit``,
        each train step's outputs (weights, optimizer state, running
        statistics, EMA, loss) and each eval step's (loss, detections)
        are checked for a NaN (one reduction on the device, one read on
        the host), and a NaN raises ``FloatingPointError`` naming the
        output. An infinity is not a NaN.
    :param profile_dir: Trace ``fit``'s train steps 3, 4 and 5 (counted
        from 0 over the run) with ``torch.profiler`` (the CPU, and the
        card's kernels on the card) into a Chrome trace
        ``<host>.<pid>.pt.trace.json`` there. A trace on the card with no
        CUDA kernel in it raises. A run that ends inside the window
        writes nothing, as the JAX trainer's (whose trace is written
        when it stops).
    """

    def __init__(
        self,
        max_epochs: int = -1,
        min_epochs: int = 0,
        limit_train_batches: int = 100,
        limit_val_batches: int = 100,
        limit_test_batches: int = 1000,
        check_val_every_n_epoch: int = 20,
        early_stopping_patience: int = 30,
        monitor: str = "map",
        save_top_k: int = 4,
        log_every_n_steps: int = 20,
        out_dir: str = "log/run",
        seed: int = 0,
        mesh=None,
        debug_nans: bool = False,
        profile_dir: Optional[str] = None,
        gradient_clip_norm: Optional[float] = None,
        accumulate_grad_batches: int = 1,
        fast_dev_run: bool = False,
        limit_predict_batches: int = 1,
        prefetch_batches: int = 2,
        spatial_devices: int = 1,
        time_batched: Any = False,
        ema_decay: Optional[float] = None,
        optimizer: Any = "adamax",
        lr_schedule: Optional[Dict[str, Any]] = None,
        logger: Any = None,
    ):
        if time_batched not in (False, True, "hybrid", "auto"):
            raise ValueError(
                f"time_batched must be False, True, 'hybrid' or 'auto', "
                f"got {time_batched!r}"
            )
        if int(spatial_devices) < 1:
            raise ValueError(
                f"spatial_devices must be at least 1, got {spatial_devices}")
        if ema_decay is not None and not 0.0 <= float(ema_decay) <= 1.0:
            raise ValueError(f"ema_decay must be in [0, 1], got {ema_decay}")
        if fast_dev_run:
            # one-batch smoke run (the Lightning flag)
            max_epochs = limit_train_batches = limit_val_batches = 1
            limit_test_batches = check_val_every_n_epoch = 1
            min_epochs = 0
        self.max_epochs = max_epochs
        self.min_epochs = min_epochs
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.limit_predict_batches = limit_predict_batches
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.early_stopping_patience = early_stopping_patience
        self.monitor = monitor
        self.save_top_k = save_top_k
        self.log_every_n_steps = log_every_n_steps
        self.out_dir = out_dir
        self.seed = seed
        self._mesh = mesh
        self.spatial_devices = int(spatial_devices)
        # a MeshShape queued by request_mesh_reshape
        self._pending_mesh: Optional[MeshShape] = None
        self.prefetch_batches = int(prefetch_batches)
        self.gradient_clip_norm = gradient_clip_norm
        self.accumulate_grad_batches = max(accumulate_grad_batches, 1)
        self.time_batched = time_batched
        # "auto": the schedule picked for "train" and "eval", and every
        # schedule's measurement ({"ms", "peak_gb", "oom"}) by mode
        self._auto_schedule: Dict[str, Any] = {}
        self.schedule_timings: Dict[str, Dict[Any, Dict[str, Any]]] = {}
        self.ema_decay = None if ema_decay is None else float(ema_decay)
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.opt: Optional[Optimizer] = None
        self.ema: Optional[List[torch.Tensor]] = None
        self.debug_nans = bool(debug_nans)
        self._check_nans = False  # on while fit runs with debug_nans
        self.profile_dir = profile_dir
        self.loggers = self._build_loggers(logger)

    @staticmethod
    def _build_loggers(logger) -> List[Any]:
        if logger is None:
            return []
        if not isinstance(logger, (list, tuple)):
            logger = [logger]
        from snn_for_object_detection_tpu_torch.utils.config import (
            instantiate,
        )

        return [instantiate(item) if isinstance(item, dict) else item
                for item in logger]

    # ---- the mesh ----

    def mesh_for(self, device):
        """The mesh of a run on ``device`` (JAX's ``mesh_for_batch``):
        the one given, as it is; else under several ranks ``make_mesh(
        spatial=spatial_devices)`` over every rank, a ``(data, space)``
        grid when ``spatial_devices > 1``; else ``device`` alone. A rank
        holds one device, the model's, and its batch is its data block's
        (DDP's semantics), so the data extent divides the global batch
        whatever its size: JAX's shrinking of the mesh to a divisor of
        the batch has no counterpart. As JAX refuses, a ``space`` axis
        that crosses hosts (ranks on several hosts: ``LOCAL_WORLD_SIZE``
        is not ``WORLD_SIZE``), a world that ``spatial_devices`` does not
        divide, and ``spatial_devices > 1`` in one process (one device)
        raise ``ValueError``."""
        s = self.spatial_devices
        if self._mesh is None and dist.is_distributed():
            world = dist.world_size()
            if s > 1 and dist.local_world_size() != world:
                # a space axis across hosts would put every halo exchange
                # on the network between them
                raise ValueError(
                    "spatial_devices > 1 is single-host only; pass an "
                    "explicit mesh to shard spatially across hosts")
            if world % s:
                raise ValueError(
                    f"{world} devices not divisible by spatial_devices={s}")
            self._mesh = make_mesh(spatial=s)
        if self._mesh is None:
            if s > 1:
                raise ValueError(
                    f"1 devices not divisible by spatial_devices={s}")
            return make_mesh(devices=[device])
        mesh = self._mesh
        if not same_device(mesh.device, device):
            raise ValueError(f"the mesh's device {mesh.device} is not the "
                             f"model's ({device})")
        return mesh

    # ---- live mesh reshape ----

    def request_mesh_reshape(self, devices=None, num_devices=None) -> None:
        """Queue a mesh of ``num_devices`` devices (or of ``devices``, a
        sequence of them) with this trainer's ``spatial_devices`` along
        ``space``, for the next epoch boundary of a running ``fit``
        (JAX's). Callable from another thread or before ``fit``: it
        queues a :class:`MeshShape` and builds no process group. A rank
        holds one device, so a count lies in ``[1, ranks]``; it must
        divide by ``spatial_devices``. The alternative trigger: the
        count written to ``out_dir/reshape_request``
        (:meth:`_poll_mesh_reshape`)."""
        avail = dist.world_size()
        if devices is None:
            if num_devices is None:
                raise ValueError("pass devices or num_devices")
            n = int(num_devices)
        else:
            n = len(devices)
        if not 1 <= n <= avail:
            raise ValueError(f"num_devices must be in [1, {avail}], got {n}")
        s = self.spatial_devices
        if n % s:
            raise ValueError(
                f"{n} devices not divisible by spatial_devices={s}")
        self._pending_mesh = MeshShape(n // s, s)

    def _poll_mesh_reshape(self) -> None:
        """Take a queued reshape (JAX's ``_poll_mesh_reshape``, before
        each epoch of ``fit``).

        Under several ranks: a queued shape is dropped and rank 0 says
        to checkpoint and relaunch (each rank's file and queue could not
        stay coherent, and diverged meshes hang collectives); the
        ``reshape_request`` file is left unread, for the supervisor that
        relaunches. In one process: the file is claimed by an atomic
        rename (a supervisor that writes it again meanwhile lands as a
        fresh file, read at the next epoch), its count queued as
        :meth:`request_mesh_reshape` would, a bad count ignored with a
        message, and the claimed file removed. One process holds one
        rank of one device: the only shape it can queue is its own, so
        the mesh stays (JAX's batch check, against a data extent of 1,
        always passes)."""
        if dist.is_distributed():
            if self._pending_mesh is not None:
                _say("[trainer] live reshape ignored under multi-host; use "
                     "checkpoint + relaunch")
                self._pending_mesh = None
            return
        req = os.path.join(self.out_dir, "reshape_request")
        if self._pending_mesh is None and os.path.exists(req):
            claimed = req + ".claimed"
            try:
                os.rename(req, claimed)
            except OSError:
                claimed = None  # the supervisor removed it meanwhile
            if claimed is not None:
                try:
                    with open(claimed) as f:
                        n = int(f.read().strip())
                    self.request_mesh_reshape(num_devices=n)
                except (ValueError, IndexError, OSError) as e:
                    print(f"[trainer] bad reshape_request ignored: {e}",
                          flush=True)
                finally:
                    try:
                        os.remove(claimed)
                    except OSError:
                        pass
        self._pending_mesh = None

    @property
    def _group(self):
        """The process group of the data axis; ``None`` in one process."""
        return None if self._mesh is None else self._mesh.group

    @property
    def _peers(self):
        """The mesh's group (every rank of a grid) when it spans several
        ranks, else ``None``."""
        group = self._group
        return group if group is not None and \
            dist.world_size(group) > 1 else None

    @property
    def _space(self):
        """The grid's ``space`` axis (``halo.Space``), or ``None``."""
        return None if self._mesh is None else self._mesh.space_ctx

    @property
    def _data_peers(self):
        """The ``data`` group when it spans several ranks, else
        ``None``: the ranks whose predictions are distinct rows of the
        global batch (on a grid, one rank of each data block)."""
        group = None if self._mesh is None else self._mesh.data_group
        return group if group is not None and \
            dist.world_size(group) > 1 else None

    def _sync_data_sharding(self, data) -> None:
        """Point the data module at this rank's shard of the dataset
        (``host_id`` / ``num_hosts`` from the data index and extent: on
        a grid the space ranks of a block load the same batch; else the
        rank and the world size), unless they were set."""
        if not dist.is_distributed():
            return
        if getattr(data, "num_hosts", 1) == 1:
            mesh = self._mesh
            data.host_id = dist.rank() if mesh is None else mesh.data_index
            data.num_hosts = (dist.world_size() if mesh is None
                              else data_extent(mesh))

    @staticmethod
    def draw_start(model, generator: torch.Generator) -> int:
        """Truncation start r in ``[0, model.time_window)``; 0 when the
        window is 0."""
        if not model.time_window:
            return 0
        return int(torch.randint(0, model.time_window, (),
                                 generator=generator))

    # ---- training ----

    # ---- schedules ----

    def _schedule_for(self, model, X: torch.Tensor, labels: torch.Tensor,
                      train: bool):
        """The schedule of a train (``train``) or eval step on ``X``.
        Other values pass through; ``"auto"`` is measured at ``X``'s and
        ``labels``' geometry, separately for the train and the eval step
        (the winner can differ), and kept for the life of the trainer."""
        if self.time_batched != "auto":
            return self.time_batched
        mode = "train" if train else "eval"
        if mode not in self._auto_schedule:
            self._auto_schedule[mode] = self._measure_schedules(
                model, X, labels, train)
        return self._auto_schedule[mode]

    @staticmethod
    def _eval_preds(model, schedule, X: torch.Tensor, start_step: int,
                    space=None):
        fwd = model.forward_fn(schedule)
        if fwd == model.forward_seq and model.time_window:
            return fwd(X, start_step=start_step, fuse=False,
                       space=space)[0]
        return fwd(X, start_step=start_step, space=space)[0]

    def _measure_schedules(self, model, X: torch.Tensor,
                           labels: torch.Tensor, train: bool):
        """Time one step of each schedule, in :data:`SCHEDULES`' order,
        and return the fastest. The train step is the loss and its
        gradients (no optimizer update, which every schedule shares),
        the eval step the forward and the loss; both from start 0 on
        zero frames of ``X``'s shape and dtype and labels of -1 of
        ``labels``' shape, on a deep copy of ``model`` made for each
        schedule, so that neither its weights nor its BatchNorm
        statistics move. A schedule that runs out of device memory is
        disqualified; any other error propagates.

        Data parallel, the probe runs outside the global batch (no
        collectives), so a rank that fails cannot leave the others
        waiting in one. On a ``(data, space)`` grid a rank's rows cannot
        run alone (they read their neighbours' halos): the probe runs on
        the grid with its collectives (the halo rows, BatchNorm over the
        grid, the loss's counts over ``data``). Before each schedule the
        ranks agree over the grid that every rank placed its copy; a
        schedule out of memory on any rank is disqualified on all
        (:meth:`_merge_timings`). As JAX's probe, this one assumes that a
        failure inside the step surfaces on every rank alike: nothing
        agrees on it beforehand. When it strikes one rank alone between
        two collectives of the step, that rank goes on to the ranks' next
        comparison of notes while the others wait in the step's next
        collective; both collectives fail when the group times out (or
        when a peer's process ends), and every rank then raises
        ``RuntimeError`` naming the schedules that failed on it, the
        step's own collective error included: no rank pins a schedule.
        (``tests/test_torch_spatial_layers.py``, a rank that fails inside
        the grid's step.)"""
        mode = "train" if train else "eval"
        device = X.device
        on_card = device.type == "cuda"
        X0 = torch.zeros_like(X)
        labels0 = torch.full_like(labels, -1.0)
        group, space = self._peers, self._space
        grid = space is not None
        # on the grid the probe is the grid's step; else this rank's rows
        # alone
        batch_group = group if grid else None
        loss_group = self._data_peers if grid else None
        errors: Dict[Any, str] = {}
        results: Dict[Any, Dict[str, Any]] = {}

        def compared(notes_of, when):
            """``notes_of()``, a comparison of notes over ``group``; when
            its collective fails, a ``RuntimeError`` that names the
            schedules out of the running on this rank and why."""
            try:
                return notes_of()
            except RuntimeError as e:  # a peer left, or the group timed out
                why = [f"{s!r}: {r['oom']}" for s, r in results.items()
                       if r["oom"]]
                why += [f"{s!r}: {err}" for s, err in errors.items()]
                raise RuntimeError(
                    f"time_batched='auto': the ranks could not compare "
                    f"notes {when} ({type(e).__name__}: {str(e)[:200]}); "
                    f"schedules out of the running on rank "
                    f"{dist.rank(group)}: {'; '.join(why) or 'none'}") from e

        def step_fn(probe, schedule):
            params = list(probe.parameters())
            if train:
                def step():
                    preds, _ = probe.forward_fn(schedule)(
                        X0, start_step=0, train=True, group=batch_group,
                        space=space)
                    loss = probe.loss(preds, labels0, group=loss_group)
                    torch.autograd.grad(loss, params, allow_unused=True)
            else:
                def step():
                    with torch.inference_mode():
                        probe.loss(self._eval_preds(probe, schedule, X0, 0,
                                                    space),
                                   labels0, group=loss_group)
            return step

        for schedule in SCHEDULES:
            probe, oom = None, None
            try:
                probe = copy.deepcopy(model)
            except torch.OutOfMemoryError as e:
                oom = f"{type(e).__name__}: {e}"[:200]
            if grid and not all(compared(
                    lambda: dist.allgather_pickle(probe is not None, group),
                    f"before schedule {schedule!r}")):
                probe = None
                oom = oom or "another rank could not place its copy"
            if probe is not None:
                if on_card:
                    torch.cuda.reset_peak_memory_stats(device)
                try:
                    seconds = time_call(step_fn(probe, schedule), device)
                except torch.OutOfMemoryError as e:
                    oom = f"{type(e).__name__}: {e}"[:200]
                except Exception as e:
                    if group is None:
                        raise
                    # raised on every rank once the ranks have compared
                    # notes
                    errors[schedule] = f"{type(e).__name__}: {e}"[:200]
                    results[schedule] = {"ms": None, "peak_gb": None,
                                         "oom": None}
                    continue
                finally:
                    probe = None
            if oom is not None:
                # the traceback that held the failed attempt's tensors
                # went with the except clause; free them before the
                # next schedule
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
                results[schedule] = {"ms": None, "peak_gb": None, "oom": oom}
                _say(f"[trainer] schedule {schedule!r} disqualified: {oom}")
                continue
            peak = (torch.cuda.max_memory_allocated(device) / 1e9
                    if on_card else None)
            results[schedule] = {"ms": seconds * 1e3, "peak_gb": peak,
                                 "oom": None}
            _say(f"[trainer] schedule {schedule!r}: {seconds * 1e3:.0f} "
                 f"ms/step" + (f", peak {peak:.2f} GB" if on_card else ""))
        if group is not None:
            results = self._merge_timings(compared(
                lambda: dist.allgather_pickle((results, errors), group),
                "after the last schedule"))
        self.schedule_timings[mode] = results
        timed = {s: r["ms"] for s, r in results.items() if r["ms"] is not None}
        if not timed:
            T, B, H, W = X.shape[:4]
            raise RuntimeError(
                "time_batched='auto': no schedule compiled at "
                f"T={T} B={B} {H}x{W}"
            )
        best = min(timed, key=timed.get)
        _say(f"[trainer] time_batched='auto' -> {best!r} ({mode} step)")
        return best

    @staticmethod
    def _merge_timings(gathered):
        """Every rank's measurement of the schedules (``gathered``: each
        rank's ``(results, errors)`` in rank order), folded alike on
        every rank (else the ranks would pin different schedules and
        their collectives hang): a schedule out of memory on any rank is
        disqualified on all, the others take the sum of the ranks' ms
        and the largest peak. An error other than out of memory on any
        rank raises on every rank."""
        for r, (_, errs) in enumerate(gathered):
            for schedule, err in errs.items():
                raise RuntimeError(f"time_batched='auto': schedule "
                                   f"{schedule!r} failed on rank {r}: {err}")
        merged = {}
        for schedule in gathered[0][0]:
            runs = [res[schedule] for res, _ in gathered]
            oom = next((run["oom"] for run in runs if run["oom"]), None)
            if oom is not None:
                merged[schedule] = {"ms": None, "peak_gb": None, "oom": oom}
                continue
            peaks = [run["peak_gb"] for run in runs
                     if run["peak_gb"] is not None]
            merged[schedule] = {"ms": sum(run["ms"] for run in runs),
                                "peak_gb": max(peaks) if peaks else None,
                                "oom": None}
        return merged

    def configure(self, model) -> None:
        """Fresh optimizer state (and EMA at the current weights) for
        ``model``'s parameters."""
        named = list(model.named_parameters())
        params = [p for _, p in named]
        self.opt = Optimizer(
            params, self.optimizer,
            make_schedule(model.learning_rate, self.lr_schedule),
            self.gradient_clip_norm, self.accumulate_grad_batches,
            names=[n for n, _ in named],
        )
        if self._peers is not None:
            # every rank starts from rank 0's weights and statistics
            dist.broadcast_([*params, *_stats(model).values()], self._group)
        self.ema = None if self.ema_decay is None else \
            [p.detach().clone() for p in params]

    def train_step(self, model, X: torch.Tensor, labels: torch.Tensor,
                   start_step: int) -> torch.Tensor:
        """One micro-batch: forward from ``start_step`` in training mode,
        loss, gradients and the optimizer chain. Returns the loss
        (detached, on the model's device). Needs :meth:`configure`.

        On a mesh, ``X`` and ``labels`` are this rank's rows (on a grid,
        its data block's labels and its rows of H): the loss returned is
        the global batch's, and the gradients the optimizer sees are the
        global batch's, the same on every rank."""
        if self.opt is None:
            raise RuntimeError("call configure(model) before train_step")
        schedule = self._schedule_for(model, X, labels, train=True)
        group, peers, space = self._group, self._peers, self._space
        preds, _ = model.forward_fn(schedule)(X, start_step=start_step,
                                              train=True, group=peers,
                                              space=space)
        loss = model.loss(preds, labels, group=self._data_peers)
        grads = list(torch.autograd.grad(loss, self.opt.params,
                                         allow_unused=True))
        if group is not None:
            # the ranks' shares of the loss and their gradients, summed
            # (a parameter no path reaches has a zero gradient); the
            # space ranks of a data block hold the same share, which
            # counts once
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self.opt.params, grads)]
            share = loss.detach().reshape(1)
            if space is not None and space.index:
                share = torch.zeros_like(share)
            *grads, loss = dist.all_reduce_sum([*grads, share], group)
            loss = loss[0]
        if self.opt.step(grads) and self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                self.ema = [d * e + (1.0 - d) * p
                            for e, p in zip(self.ema, self.opt.params)]
        loss = loss.detach()
        if self._check_nans:
            self._raise_on_nan("train", model.device, {
                "params": self.opt.params,
                "opt_state": self.opt.state_tensors(),
                "stats": list(_stats(model).values()),
                "ema": self.ema or [],
                "loss": [loss]})
        return loss

    @staticmethod
    def _raise_on_nan(what: str, device, outputs) -> None:
        bad = nan_outputs(outputs, device)
        if bad:
            raise FloatingPointError(
                f"debug_nans: NaN in the {what} step's output "
                f"{', '.join(map(repr, bad))}")

    @contextlib.contextmanager
    def _ema_weights(self, model):
        """The model with the EMA weights in place (if EMA is on)."""
        if self.ema is None:
            yield
            return
        saved = [p.detach().clone() for p in self.opt.params]
        with torch.no_grad():
            for p, e in zip(self.opt.params, self.ema):
                p.copy_(e)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, s in zip(self.opt.params, saved):
                    p.copy_(s)

    def _payload(self, model, **counters) -> Dict[str, Any]:
        payload = {
            "params": {n: p.detach() for n, p in model.named_parameters()},
            "stats": {n: b.detach() for n, b in _stats(model).items()},
            "opt_state": self.opt.state_dict(),
            **counters,
        }
        if self.ema is not None:
            payload["ema_params"] = {
                n: e for (n, _), e in zip(model.named_parameters(),
                                          self.ema)}
        return payload

    def _restore(self, model, restored: Dict[str, Any]) -> None:
        with torch.no_grad():
            named = dict(model.named_parameters())
            for n, value in restored["params"].items():
                named[n].copy_(value)
            stats = _stats(model)
            for n, value in restored.get("stats", {}).items():
                stats[n].copy_(value)
        if self.ema is not None:
            # an EMA-less checkpoint restarts the average at its weights
            ema = restored.get("ema_params") or restored["params"]
            self.ema = [ema[n].to(p.device).clone()
                        for n, p in model.named_parameters()]
        if "opt_state" in restored:
            self.opt.load_state_dict(restored["opt_state"])
        else:
            _say("[trainer] no optimizer state in the checkpoint; the "
                 "optimizer starts fresh")

    def fit(self, model, data, ckpt_path: Optional[str] = None
            ) -> Dict[str, Any]:
        """Train until early stopping or ``max_epochs``; returns the run's
        counters. ``ckpt_path="auto"`` resumes from this run's ``last``
        checkpoint if there is one.

        Under several ranks every rank calls it; each reads its data
        block's shard of ``data`` (``host_id`` / ``num_hosts`` from the
        data index and extent) and the ranks leave together."""
        mesh = self.mesh_for(model.device)
        self._sync_data_sharding(data)
        logger = MetricsLogger(self.out_dir, self.loggers)
        ckpt = CheckpointManager(
            os.path.join(self.out_dir, "checkpoints"),
            save_top_k=self.save_top_k, monitor=self.monitor)
        self.configure(model)
        generator = torch.Generator().manual_seed(self.seed)
        step = epoch = checks_since_best = 0
        best_metric = -np.inf
        if ckpt_path == "auto":
            last = os.path.join(self.out_dir, "checkpoints", "last")
            ckpt_path = last if os.path.exists(last) else None
        if ckpt_path:
            restored = ckpt.restore(ckpt_path)
            self._restore(model, restored)
            step = int(restored.get("step", 0))
            epoch = int(restored.get("epoch", 0))
            best_metric = float(restored.get("best_metric", -np.inf))
            checks_since_best = int(restored.get("checks_since_best", 0))
            _say(f"resumed from {ckpt_path} at step {step}")

        # rasterization and the host-to-device copy of the next batches
        # overlap the current train step
        train_iter = prefetch_to_device(data.train_loader(), mesh,
                                        self.prefetch_batches)
        # the JAX trainer's profiling hook: train steps 3-5 of the run
        profile_at = 3 if self.profile_dir else -1
        profiler = None
        self._check_nans = self.debug_nans
        try:
            t_epoch = time.time()
            while self.max_epochs < 0 or epoch < self.max_epochs:
                # before the epoch, as JAX's: a request queued during the
                # last epoch starts nothing
                self._poll_mesh_reshape()
                losses = []
                for _ in range(self.limit_train_batches):
                    X, labels = next(train_iter)
                    if step == profile_at and profiler is None:
                        profiler = start_profiler(model.device)
                    loss = self.train_step(model, X, labels,
                                           self.draw_start(model, generator))
                    if profiler is not None and step >= profile_at + 2:
                        write_profile(profiler, self.profile_dir,
                                      model.device)
                        profiler = None
                        print(f"[trainer] profile written to "
                              f"{self.profile_dir}", flush=True)
                    step += 1
                    losses.append(float(loss))
                    if step % self.log_every_n_steps == 0:
                        logger.log(step, {"train_loss": float(np.mean(
                            losses[-self.log_every_n_steps:]))})
                epoch += 1
                logger.log(step, {"epoch": epoch,
                                  "epoch_train_loss": float(np.mean(losses)),
                                  "epoch_time_s": time.time() - t_epoch})
                t_epoch = time.time()

                if epoch % self.check_val_every_n_epoch == 0:
                    with self._ema_weights(model):
                        metrics = self.validate(model, data.val_loader())
                    logger.log(step, metrics)
                    metric = metrics.get(self.monitor, 0.0)
                    # the early-stopping state is updated before the save, so
                    # a resume sees this validation's outcome
                    if metric > best_metric:
                        best_metric, checks_since_best = metric, 0
                    else:
                        checks_since_best += 1
                    ckpt.save(step, self._payload(
                        model, step=step, epoch=epoch,
                        best_metric=best_metric,
                        checks_since_best=checks_since_best),
                        metric=metric,
                        meta={"metrics": metrics, "epoch": epoch})
                    # patience counts validation checks, as Lightning's
                    patience = self.early_stopping_patience
                    if (epoch >= self.min_epochs and patience > 0
                            and checks_since_best >= patience):
                        _say(f"early stopping at epoch {epoch} (best "
                             f"{self.monitor}={best_metric:.4f})")
                        break
        finally:
            self._check_nans = False
            if profiler is not None:
                # the run ended inside the window: like the JAX trace that
                # is never stopped, nothing is written
                profiler.stop()
            # stop the prefetch thread, and with it the loader's worker
            # threads, even when a step raises; close the back ends (their
            # files flushed) even when that raises
            try:
                _close(train_iter)
            finally:
                logger.close()
        dist.barrier("fit_end")
        return {"step": step, "epoch": epoch, "best_metric": best_metric}

    # ---- evaluation ----

    def eval_step(self, model, X: torch.Tensor, labels: torch.Tensor,
                  start_step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward from ``start_step``, loss and detections: ``(loss,
        dets [B, 300, 6])``, both on the model's device. On a mesh, ``X``
        is this rank's rows and the loss is the global batch's; on a
        grid the detections are the data block's, the same on each of
        its space ranks."""
        schedule = self._schedule_for(model, X, labels, train=False)
        group = None if self._mesh is None else self._mesh.data_group
        with torch.inference_mode():
            preds = self._eval_preds(model, schedule, X, start_step,
                                     self._space)
            if group is None:
                loss = model.loss(preds, labels)
            else:
                loss = model.loss(preds, labels, group=self._data_peers)
                loss = dist.all_reduce_sum([loss.reshape(1)], group)[0][0]
            dets = model.detect(preds)
            if self._check_nans:
                self._raise_on_nan("eval", model.device,
                                   {"loss": [loss], "dets": [dets]})
            return loss, dets

    def _run_eval(self, model, batches: Iterable, limit: int,
                  prefix: str) -> Dict[str, float]:
        """Each rank scores its rows; the ranks' mAP accumulators are
        folded over the ``data`` group (``allgather_pickle``), so every
        rank computes the same metrics (and early stopping decides
        alike) and each image counts once. The losses are the global
        batches' already."""
        mesh = self.mesh_for(model.device)
        generator = torch.Generator().manual_seed(self.seed)
        map_metric = MeanAveragePrecision()
        losses = []
        try:
            for X, labels in itertools.islice(batches, limit):
                r = self.draw_start(model, generator)
                loss, dets = self.eval_step(
                    model, *shard_batch(mesh, X, labels), r)
                losses.append(float(loss))
                preds, targets = detections_to_map_inputs(
                    dets.cpu().numpy(), np.asarray(labels)
                )
                map_metric.update(preds, targets)
        finally:
            # islice alone would leave a loader's threads running
            _close(batches)
        if self._data_peers is not None:
            gathered = dist.allgather_pickle(map_metric, self._data_peers)
            map_metric = gathered[0]
            for other in gathered[1:]:
                map_metric.merge(other)
        out = {f"{prefix}_loss": float(np.mean(losses)) if losses else 0.0}
        out.update({k: float(v) for k, v in map_metric.compute().items()})
        return out

    def validate(self, model, batches: Iterable) -> Dict[str, float]:
        return self._run_eval(model, batches, self.limit_val_batches, "val")

    def test(self, model, batches: Iterable) -> Dict[str, float]:
        return self._run_eval(model, batches, self.limit_test_batches,
                              "test")

    def predict(self, model, data, plotter, limit: Optional[int] = None
                ) -> None:
        """Streaming visualization (the reference's soda.py:191-200): run
        sample 0 of each batch frame by frame through ``model.predict``
        and hand the frames to ``plotter`` (anything with ``labels``,
        ``apply(frame, dets, gt)`` and ``__call__(video, time_step,
        name)``). Detections are shown from frame ``time_window`` on; the
        last frame is drawn again with the ground truth. MT labels
        ``(frame_idx, class, x1..y2)`` lose their frame index first.
        Under several ranks each rank runs its own shard's sample 0 and
        rank 0 renders every data block's, named ``<batch>_<block>``.

        :param limit: Batches to render; default ``limit_predict_batches``;
            ``limit <= 0`` renders every batch the loader yields.
        """
        if limit is None:
            limit = self.limit_predict_batches
        plotter.labels = data.get_labels()
        self.mesh_for(model.device)
        group = self._data_peers
        batches = data.predict_loader()
        try:
            for batch_idx, (X, labels) in enumerate(itertools.islice(
                    batches, limit if limit > 0 else None)):
                frames = np.asarray(X)[:, 0]  # [T, H, W, 2]
                state = model.init_state(1)
                shown = []
                dets = None
                for t in range(frames.shape[0]):
                    dets, state = model.predict(
                        torch.as_tensor(frames[t], device=model.device),
                        state)
                    shown.append(None if t < model.time_window
                                 else dets.cpu().numpy())
                gt = np.asarray(labels[0])
                if gt.ndim == 2 and gt.shape[1] == 6:
                    gt = gt[:, 1:]
                rows = [(frames, shown, dets.cpu().numpy(), gt)]
                if group is not None:
                    # every rank's sample 0, rendered by rank 0
                    rows = dist.allgather_pickle(rows[0], group)
                    if not dist.is_primary():
                        continue
                for r, (frames, shown, last, gt) in enumerate(rows):
                    video = [plotter.apply(f, d, None)
                             for f, d in zip(frames, shown)]
                    video.append(plotter.apply(frames[-1], last, gt))
                    name = str(batch_idx) if group is None \
                        else f"{batch_idx}_{r}"
                    plotter(video, data.time_step, name)
        finally:
            _close(batches)


def start_profiler(device: torch.device):
    """A running ``torch.profiler`` over the CPU, and the card's kernels
    when ``device`` is a card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def write_profile(profiler, profile_dir: str, device: torch.device) -> str:
    """Stop ``profiler`` once the device has finished the traced work
    and write its Chrome trace under ``profile_dir``; returns the path.
    On the card a trace without a CUDA kernel raises (the profiler
    records the CPU alone where CUPTI is missing)."""
    from torch.autograd import DeviceType

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    if device.type == "cuda" and not any(
            e.device_type == DeviceType.CUDA for e in profiler.events()):
        raise RuntimeError("profile_dir: the profiler recorded no CUDA "
                           "kernel (is CUPTI available?)")
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{socket.gethostname()}."
                        f"{os.getpid()}.pt.trace.json")
    profiler.export_chrome_trace(path)
    return path


def _close(batches) -> None:
    """Close an iterator that has ``close()`` (a loader's generator)."""
    close = getattr(batches, "close", None)
    if close is not None:
        close()
