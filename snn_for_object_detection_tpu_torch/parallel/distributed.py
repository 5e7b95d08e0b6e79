"""Multi-process wiring over ``torch.distributed``: one rank per device.

Counterpart of ``snn_for_object_detection_tpu/parallel/distributed.py``.
The JAX package runs one program over every device of every host; the
port runs one process per device, as PyTorch does it: the JAX package's
single-process 8-device mesh is eight ranks here. Every rank calls
:func:`initialize` once (``torchrun`` sets the environment it reads),
then builds the same model from the same seed and trains it on its own
rows of each global batch:

- each rank feeds its own slice of the dataset
  (``PropheseeDataModule(host_id=..., num_hosts=...)``; the Trainer
  fills these in from the rank and the world size);
- reductions over the batch are global: the Trainer hands the group to
  the model (``forward(..., group=)``, ``loss(..., group=)``), whose
  train-mode BatchNorm moments and loss counts are then all-reduced, so
  the ranks' loss contributions sum to the loss of the global batch and
  the gradients are their all-reduced sum (:func:`all_reduce_sum`);
- host-side metric accumulators are folded with :func:`allgather_pickle`;
- only rank 0 writes logs and checkpoints.

Backends: NCCL on the card, gloo on the CPU (gloo on CUDA tensors only
where the caller names it). A failed initialisation raises; nothing
carries on in one process.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as tdist

# this rank's device, set by ``initialize``
_DEVICE: List[Optional[torch.device]] = [None]


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[str] = None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join the process group (idempotent); returns this rank's device.

    Unset arguments come from torchrun's environment: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.
    ``coordinator_address`` is ``host:port`` (JAX's form, read as
    ``tcp://host:port``) or an init URL (``tcp://...``, ``file://...``).
    One process with no address joins a group of its own.

    :param device: ``"cuda"`` (the default where a card is present:
        ``cuda:{LOCAL_RANK}``, made the current device) or ``"cpu"``.
    :param backend: Default ``nccl`` on CUDA, ``gloo`` on the CPU.
    """
    if tdist.is_initialized():
        return current_device()
    rank = process_id if process_id is not None else _env_int("RANK")
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    rank, world = rank or 0, world or 1
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:  # one host: a card a rank
        local_rank = rank % max(torch.cuda.device_count(), 1)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        if world != 1:
            raise ValueError(
                f"{world} processes need a coordinator_address (or torchrun's "
                "MASTER_ADDR / MASTER_PORT)")
        tdist.init_process_group(backend, store=tdist.HashStore(), rank=0,
                                 world_size=1, timeout=timeout)
    else:
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        tdist.init_process_group(backend, init_method=url, rank=rank,
                                 world_size=world, timeout=timeout)
    _DEVICE[0] = dev
    return dev


def current_device() -> torch.device:
    """This rank's device: the one :func:`initialize` set."""
    if _DEVICE[0] is None:
        return torch.device("cuda", torch.cuda.current_device()) \
            if tdist.is_initialized() and tdist.get_backend() == "nccl" \
            else torch.device("cpu")
    return _DEVICE[0]


def world_size(group=None) -> int:
    return tdist.get_world_size(group) if tdist.is_initialized() else 1


def rank(group=None) -> int:
    return tdist.get_rank(group) if tdist.is_initialized() else 0


def local_world_size() -> int:
    """The ranks on this host: torchrun's ``LOCAL_WORLD_SIZE``; without
    it every rank is taken to share one host (a launcher that starts
    the ranks itself and says nothing)."""
    return _env_int("LOCAL_WORLD_SIZE") or world_size()


def is_distributed() -> bool:
    return world_size() > 1


def is_primary() -> bool:
    """True on the rank that owns logging and checkpoint writes."""
    return rank() == 0


def barrier(name: str = "barrier") -> None:
    """Block until every rank reaches this point (``name`` says which
    point, for a reader of a hang). Used at the end of ``Trainer.fit``
    and around checkpoint writes."""
    del name
    if is_distributed():
        tdist.barrier()


def local_rows(arr, batch_axis: int = 0, group=None):
    """This rank's rows of a global batch ``arr`` (numpy or torch): the
    contiguous block ``[r * B / n, (r + 1) * B / n)`` along
    ``batch_axis``, in global row order; the whole array on one rank."""
    n = world_size(group)
    if n == 1:
        return arr
    size = arr.shape[batch_axis]
    if size % n:
        raise ValueError(f"batch {size} does not divide over {n} ranks")
    per, r = size // n, rank(group)
    index = [slice(None)] * arr.ndim
    index[batch_axis] = slice(r * per, (r + 1) * per)
    return arr[tuple(index)]


def allgather_pickle(obj: Any, group=None) -> List[Any]:
    """One picklable object per rank, gathered onto every rank in rank
    order. Used to fold per-rank metric accumulators."""
    if world_size(group) == 1:
        return [obj]
    out: List[Any] = [None] * world_size(group)
    tdist.all_gather_object(out, obj, group=group)
    return out


def broadcast_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Overwrite ``tensors`` with rank 0's, in place."""
    if world_size(group) == 1:
        return
    src = tdist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():  # parameters are leaves that require grad
        for t in tensors:
            tdist.broadcast(t, src=src, group=group)


class _SumInRankOrder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        send = t.detach().contiguous()
        parts = [torch.empty_like(send) for _ in range(world_size(group))]
        tdist.all_gather(parts, send, group=group)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    @staticmethod
    def backward(ctx, grad):
        # every rank's sum reads every rank's t once
        g = grad.contiguous().clone()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


def sum_in_rank_order(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group``'s ranks of ``t``, added in rank order in
    ``t``'s dtype after an all-gather, so that every rank gets the same
    bits whatever order a collective would add in (NCCL's ring, tree
    or in-switch reductions each add in their own). Differentiable: the
    backward all-reduces the gradient."""
    return _SumInRankOrder.apply(t, group)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None
                   ) -> List[torch.Tensor]:
    """The sum over ranks of each tensor, one collective per dtype (the
    tensors of a dtype travel flattened in one buffer); new tensors, in
    order. On a group of one rank the collective still runs (and
    returns the tensors' values); without a group they come back as they
    are."""
    tensors = list(tensors)
    if not tdist.is_initialized():
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        tdist.all_reduce(flat, group=group)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view_as(tensors[i])
            offset += n
    return out

