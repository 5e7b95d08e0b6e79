"""Feature maps split along H over the ``space`` axis: the split rule,
the halo exchange and the gather.

The JAX package shards H over a ``space`` mesh axis and lets GSPMD add
the halo exchanges at shard edges (``parallel/mesh.py``); here every
rank of a ``space`` group holds one block of the rows of every map, and
the layers that read rows beyond their own ask for them:

- :func:`row_blocks` is the split: balanced blocks in rank order, whose
  sizes differ by at most one row (the larger first). It applies to the
  input, to every map and to every state;
- :func:`fetch_rows` gives a rank rows ``[lo, hi)`` of the global map:
  its own rows in place, rows outside ``[0, H)`` as zeros and the rest
  from the ranks that own them (one ``all_to_all_single`` over the
  group). Every rank computes who sends what to whom from the shapes
  alone. Its backward sends each fetched row's gradient back to its
  owner, which adds it to its own rows' gradient;
- :func:`gather_rows` gathers the blocks of a map into the whole map on
  every rank of the group (the heads, before the loss and ``detect``).

Both collectives take device tensors on NCCL and on gloo (several ranks
on one card can only use gloo, which moves CUDA tensors through the
host itself; torch 2.11 on an H100). A failed collective raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as tdist

Range = Tuple[int, int]


@functools.lru_cache(maxsize=1024)
def row_blocks(rows: int, k: int) -> Tuple[Range, ...]:
    """The split of ``rows`` rows over ``k`` ranks: ``(lo, hi)`` a rank,
    in rank order, balanced (the first ``rows % k`` blocks one row
    longer). Never empty while ``rows >= k``; ``ValueError`` otherwise."""
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if rows < k:
        raise ValueError(f"{rows} rows do not split over {k} ranks")
    base, extra = divmod(rows, k)
    out, lo = [], 0
    for j in range(k):
        hi = lo + base + (1 if j < extra else 0)
        out.append((lo, hi))
        lo = hi
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Space:
    """This rank's place on the ``space`` axis: the ``group`` of the
    ``size`` ranks that split the rows of one data block's maps, and its
    ``index`` among them (its block of every map)."""

    group: Any
    size: int
    index: int

    def blocks(self, rows: int, what: str = "a map") -> Tuple[Range, ...]:
        try:
            return row_blocks(rows, self.size)
        except ValueError:
            raise ValueError(
                f"{what}: {rows} rows do not split over {self.size} space "
                "ranks") from None

    def block(self, rows: int, what: str = "a map") -> Range:
        """This rank's rows ``(lo, hi)`` of a map of ``rows`` rows."""
        return self.blocks(rows, what)[self.index]

    def rows(self, rows: int, what: str = "a map") -> int:
        return _size(self.block(rows, what))


def _size(r: Range) -> int:
    return r[1] - r[0]


def _overlap(a: Range, b: Range) -> Range:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else (lo, lo)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What rank ``me`` keeps, sends and receives for one fetch."""

    want: Range  # the rows this rank gets
    block: Range  # the rows it owns
    own: Range  # of them, the ones it wants itself
    send: Tuple[Range, ...]  # a peer: its rows that peer wants
    recv: Tuple[Range, ...]  # a peer: the peer's rows this rank wants
    traffic: bool  # any rank sends any row


@functools.lru_cache(maxsize=4096)
def _plan(rows: int, wants: Tuple[Range, ...], me: int) -> _Plan:
    k = len(wants)
    blocks = row_blocks(rows, k)
    empty = (0, 0)
    send = tuple(empty if i == me else _overlap(blocks[me], wants[i])
                 for i in range(k))
    recv = tuple(empty if i == me else _overlap(blocks[i], wants[me])
                 for i in range(k))
    traffic = any(_size(_overlap(blocks[i], wants[j]))
                  for i in range(k) for j in range(k) if i != j)
    return _Plan(wants[me], blocks[me], _overlap(blocks[me], wants[me]),
                 send, recv, traffic)


def _all_to_all_rows(send: torch.Tensor, send_rows: List[int],
                     recv_rows: List[int], group) -> torch.Tensor:
    """``all_to_all_single`` of row-major buffers ``[rows, ...]``: this
    rank sends ``send_rows[i]`` rows to peer ``i`` and receives
    ``recv_rows[i]`` from it, in peer order."""
    out = send.new_empty((sum(recv_rows),) + tuple(send.shape[1:]))
    tdist.all_to_all_single(out, send, output_split_sizes=list(recv_rows),
                            input_split_sizes=list(send_rows), group=group)
    return out


def _rows_first(x: torch.Tensor, r: Range, base: int) -> torch.Tensor:
    return x[:, r[0] - base:r[1] - base].movedim(1, 0)


def _exchange(x, send: Sequence[Range], recv: Sequence[Range],
              send_base: int, group) -> List[torch.Tensor]:
    """Rows ``send[i]`` of ``x`` (global row ``send_base`` at its row 0)
    to each peer ``i``; returns the ``[N, rows, ...]`` chunk each peer
    sent, in peer order (empty where it sent none)."""
    n_send = [_size(r) for r in send]
    n_recv = [_size(r) for r in recv]
    parts = [_rows_first(x, r, send_base) for r in send if _size(r)]
    buf = (torch.cat(parts) if parts else
           x.new_empty((0, x.shape[0]) + tuple(x.shape[2:])))
    out = _all_to_all_rows(buf.contiguous(), n_send, n_recv, group)
    chunks, offset = [], 0
    for n in n_recv:
        chunks.append(out[offset:offset + n].movedim(0, 1))
        offset += n
    return chunks


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan: _Plan, group):
        ctx.plan, ctx.group = plan, group
        ctx.local_rows = x.shape[1]
        lo, hi = plan.want
        out = x.new_zeros((x.shape[0], hi - lo) + tuple(x.shape[2:]))
        a, b = plan.own
        if b > a:
            out[:, a - lo:b - lo] = x[:, a - plan.block[0]:b - plan.block[0]]
        if plan.traffic:
            chunks = _exchange(x, plan.send, plan.recv, plan.block[0], group)
            for (a, b), chunk in zip(plan.recv, chunks):
                if b > a:
                    out[:, a - lo:b - lo] = chunk
        return out

    @staticmethod
    def backward(ctx, grad):
        plan, group = ctx.plan, ctx.group
        lo = plan.want[0]
        base = plan.block[0]
        g = grad.new_zeros((grad.shape[0], ctx.local_rows)
                           + tuple(grad.shape[2:]))
        a, b = plan.own
        if b > a:
            g[:, a - base:b - base] = grad[:, a - lo:b - lo]
        if plan.traffic:
            # the gradients of the rows this rank received go back to
            # their owners; it gets those of the rows it sent
            chunks = _exchange(grad.contiguous(), plan.recv, plan.send, lo,
                               group)
            for (a, b), chunk in zip(plan.send, chunks):
                if b > a:
                    g[:, a - base:b - base] += chunk
        return g, None, None


def fetch_rows(x: torch.Tensor, rows: int,
               want: Callable[[int], Range], space: Space,
               what: str = "a map") -> torch.Tensor:
    """Rows ``want(space.index)`` of the global map of ``rows`` rows whose
    block this rank holds in ``x [N, rows_local, ...]`` (the split of
    :func:`row_blocks`): ``[N, hi - lo, ...]``, zeros outside ``[0,
    rows)``. ``want(j)`` is the range rank ``j`` asks for: every rank of
    the group calls this with the same ``want``, and the ranks that own
    a wanted row send it (a collective whenever any row crosses ranks).
    Differentiable: a fetched row's gradient is added to its owner's."""
    blocks = space.blocks(rows, what)
    me = space.index
    if x.shape[1] != blocks[me][1] - blocks[me][0]:
        raise ValueError(
            f"{what}: this rank holds {x.shape[1]} rows of a map of {rows}, "
            f"its block is {blocks[me]}")
    wants = tuple(tuple(int(v) for v in want(j)) for j in range(space.size))
    plan = _plan(rows, wants, me)
    if not plan.traffic and plan.want == plan.block:
        return x  # every rank wants its own rows: nothing moves
    return _Fetch.apply(x, plan, space.group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows: int, space: Space):
        blocks = row_blocks(rows, space.size)
        ctx.block = blocks[space.index]
        tallest = max(hi - lo for lo, hi in blocks)
        pad = tallest - x.shape[1]
        padded = x if pad == 0 else torch.cat(
            [x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))], 1)
        send = padded.contiguous()
        parts = [torch.empty_like(send) for _ in range(space.size)]
        tdist.all_gather(parts, send, group=space.group)
        return torch.cat([p[:, :hi - lo] for p, (lo, hi) in
                          zip(parts, blocks)], 1)

    @staticmethod
    def backward(ctx, grad):
        # every rank of the group computes the same function of the
        # whole map (the loss of its data block), so the gradient of one
        # copy is the one each holds: a rank takes its own rows' (a sum
        # over the ranks would count the loss once a rank)
        lo, hi = ctx.block
        return grad[:, lo:hi], None, None


def gather_rows(x: torch.Tensor, rows: int, space: Space) -> torch.Tensor:
    """The whole map ``[N, rows, ...]`` on every rank of the group from
    each rank's block ``x [N, rows_local, ...]``. Its backward gives a
    rank its own rows of the gradient it holds: the ranks of a group
    compute the same loss on the gathered map, once each, so their
    gradients are copies of one. A group of one rank holds the whole
    map already."""
    if space.size == 1:
        return x
    return _Gather.apply(x, rows, space)
