"""Whole-network B=1 streaming step: one kernel launch per frame.

Counterpart of ``snn_for_object_detection_tpu/ops/megakernel.py``. At
batch 1 a TinyYolo frame is 3.8 G multiply-adds spread over 48 convs and
their BatchNorm, cell, residual and concat glue; run layer by layer it
is bound by launches, not by math. Here the compiled detector is walked
once, at construction, into a *plan*: a list of ops over buffers of one
preallocated workspace, with every conv weight packed as ``[k*k, Cin,
Cout]`` taps and every folded BatchNorm ``(k, b)`` in one weight buffer
of the compute dtype, and the neuron states as ``[H, W, C]`` slots.
Every op has a phase on the card (:func:`op_phases`), and buffers whose
live phases do not overlap share memory (:func:`allocate`), so a
frame's live activations stay in L2. The plan runs two ways:

- on the card, ``ops/cuda_kernels.py::streaming_megakernel`` launches
  ``csrc/megakernel.cu`` once: a persistent cooperative kernel that walks
  the op table phase by phase with a grid-wide barrier between phases
  (the table splits the convs that would leave the grid idle along K);
- :func:`streaming_megakernel_reference`, the plain PyTorch version,
  walks the same ops with the JAX body's arithmetic. The CPU tests hold
  it against JAX, and ``chip_smoke.py`` holds the kernel against it.

The walk uses the traversal and naming of JAX ``_emit_cfg`` /
``_emit_leaf`` over the port's compiled ``Block`` tree (so it reads the
weights where ``load_jax_params`` put them). A conv absorbs the Norm,
LIF/LI and ReLU/SiLU/Tanh that directly follow it into its epilogue
(without the Norm, a cell or activation starts its own elementwise op);
Pool and Up are ops of their own. A two-branch Residual sum runs in the
epilogue of the op that made one branch (its ``res``), and every branch
of a Dense concatenation is a channel slice of the concatenation, which
its producer writes in place; an ``add`` or ``copy`` op is left only
where that cannot be (more branches, or a value that already lives in
another buffer). The plain version runs the ops in the order they were
emitted; on the card every op takes the phase after the last phase that
wrote into one of its inputs, so independent branches (Dense branches,
the heads) share phases.

Arithmetic (the JAX body's, ``megakernel.py:105-306``): a conv is k*k
tap matmuls of fp32-upcast operands summed in fp32 in ``(dy, dx)`` order
and rounded to the compute dtype; the affine is ``neurons.fma`` at fp32
(XLA contracts it). In bf16 the product is rounded to bf16 and the sum
is handed to a following cell or activation in fp32: inside the jitted
JAX body XLA removes that bf16 round trip (measured on the CPU with
exact convs, ROADMAP.md Queue 3). Cells run ``neurons.lif_step`` /
``li_step`` in fp32, store the state in its dtype and round their
output to the compute dtype; ReLU, SiLU and Tanh run in fp32;
Pool ``M`` is a max and ``A`` / ``S`` fp32 sums; Up is a repeat;
Residual and Dense sum and concatenate in the compute dtype. With
``exact_sums`` the plain version sums each conv in float64 instead and
rounds it once to fp32: the reference of the witness
(:func:`run_distance`, :func:`witness_passes`), which tells a kernel
that sums its convs in another order from one with a fault.

Eval only (folded BatchNorm, no surrogate gradient). Layers outside the
menu raise :class:`UnsupportedLayer`; callers use ``SODa.predict``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from snn_for_object_detection_tpu_torch.models import compile as C
from snn_for_object_detection_tpu_torch.ops import cuda_kernels, neurons

ALIGN = 64  # buffer and weight offsets, in elements: 128 bytes or more


class UnsupportedLayer(ValueError):
    """The model holds a layer the megakernel cannot express."""


@dataclasses.dataclass
class StateSlot:
    path: Tuple[str, ...]   # e.g. ("backbone", "b0", "l2")
    field: int              # 0 = v, 1 = i
    shape: Tuple[int, int, int]  # [H, W, C] (B = 1, squeezed)
    dtype: torch.dtype
    cell: str = "lif"       # "lif" | "li"


@dataclasses.dataclass
class Buffer:
    """An ``[H, W, C]`` activation: the frame, a workspace region (compute
    dtype) or a region of the fp32 prediction output. A buffer with a
    ``parent`` is channels ``ch_off`` onward of that buffer (a branch of
    a Dense concatenation, written in place); a workspace buffer without
    one gets its ``offset`` from the liveness allocator."""

    space: str  # "frame" | "ws" | "preds"
    offset: Optional[int]
    shape: Tuple[int, int, int]
    parent: int = -1
    ch_off: int = 0

    @property
    def numel(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]


@dataclasses.dataclass
class Op:
    """One op of the plan. ``kind``: conv, ew (a standalone epilogue
    chain), pool, up, add or copy. The epilogue chain of conv and ew:
    ``norm`` (offsets of ``k`` and ``b``), then ``cell`` with its state
    ``slots`` (v, i), then ``act``, then, with a ``res`` buffer, the
    Residual sum ``round(y + res)``."""

    kind: str
    src: int
    dst: int
    res: int = -1
    k: int = 1
    stride: int = 1
    w: int = -1
    norm: Optional[Tuple[int, int]] = None
    cell: Optional[str] = None
    slots: Tuple[int, int] = (-1, -1)
    act: Optional[str] = None
    pool: str = "M"

    @property
    def inputs(self) -> List[int]:
        return [self.src] + ([self.res] if self.res >= 0 else [])


class Plan:
    """The compiled B=1 program of one detector (see the module note)."""

    def __init__(self, compute_dtype, state_dtype, device):
        self.compute_dtype = compute_dtype
        self.state_dtype = state_dtype
        self.device = device
        self.buffers: List[Buffer] = []
        self.ops: List[Op] = []
        self.phases: List[int] = []  # of each op (op_phases)
        self.slots: List[StateSlot] = []
        self.weights: List[torch.Tensor] = []
        self.weight_numel = 0
        self.ws_numel = 0
        self.weight_buf: Optional[torch.Tensor] = None
        self.num_anchors = 0
        self.num_classes = 0

    # ---- building ----

    def add_buffer(self, space: str, shape, offset: Optional[int] = None,
                   parent: int = -1, ch_off: int = 0) -> int:
        self.buffers.append(Buffer(space, offset, tuple(shape), parent,
                                   ch_off))
        return len(self.buffers) - 1

    def can_place(self, buf: int) -> bool:
        """Whether ``buf`` may become a channel slice of a wider buffer:
        a workspace buffer that lives nowhere else yet."""
        b = self.buffers[buf]
        return b.space == "ws" and b.parent < 0

    def add_weight(self, value: torch.Tensor) -> int:
        off = self.weight_numel
        value = value.detach().reshape(-1).to(self.compute_dtype)
        self.weights.append(value)
        self.weight_numel += -(-value.numel() // ALIGN) * ALIGN
        pad = self.weight_numel - off - value.numel()
        if pad:
            self.weights.append(torch.zeros(pad, dtype=self.compute_dtype,
                                            device=value.device))
        return off

    def add_op(self, op: Op) -> Op:
        self.ops.append(op)
        return op

    def finish(self) -> None:
        self.phases = op_phases(self)
        self.ws_numel = allocate(self, self.phases)
        self.weight_buf = (torch.cat(self.weights) if self.weights else
                           torch.zeros(ALIGN, dtype=self.compute_dtype))
        self.weight_buf = self.weight_buf.to(self.device).contiguous()
        self.weights = []

    # ---- reading ----

    def locate(self, buf: int) -> Tuple[int, int]:
        """``(root, ch_off)``: the buffer that holds ``buf`` and the
        channel where ``buf`` starts in it."""
        off = 0
        while self.buffers[buf].parent >= 0:
            off += self.buffers[buf].ch_off
            buf = self.buffers[buf].parent
        return buf, off

    @property
    def preds_numel(self) -> int:
        return self.num_anchors * (self.num_classes + 1 + 4)

    def weight(self, off: int, n: int) -> torch.Tensor:
        return self.weight_buf[off:off + n]


def op_phases(plan: Plan) -> List[int]:
    """The phase of every op on the card: the one after the last phase
    that wrote any of its inputs (a buffer is written when it or any
    slice of it is), so independent branches share phases."""
    ready: Dict[int, int] = {}
    phases = []
    for op in plan.ops:
        p = 1 + max(ready.get(b, -1) for b in op.inputs)
        phases.append(p)
        b = op.dst
        while b >= 0:
            ready[b] = max(ready.get(b, -1), p)
            b = plan.buffers[b].parent
    return phases


def allocate(plan: Plan, phases: List[int]) -> int:
    """Give every workspace root buffer its offset so that two buffers
    whose live phases (first write to last read, slices included)
    overlap share no element: largest first, each at the lowest offset
    (a multiple of ``ALIGN``) that fits. Returns the workspace size."""
    live: Dict[int, Tuple[int, int]] = {}
    for op, p in zip(plan.ops, phases):
        for b in op.inputs + [op.dst]:
            root, _ = plan.locate(b)
            if plan.buffers[root].space == "ws":
                lo, hi = live.get(root, (p, p))
                live[root] = (min(lo, p), max(hi, p))
    placed: List[Tuple[int, int, int]] = []  # (offset, end, root)
    for root in sorted(live, key=lambda r: (-plan.buffers[r].numel, r)):
        n = -(-plan.buffers[root].numel // ALIGN) * ALIGN
        lo, hi = live[root]
        busy = sorted((o, e) for o, e, other in placed
                      if live[other][0] <= hi and lo <= live[other][1])
        off = 0
        for o, e in busy:
            if off + n <= o:
                break
            off = max(off, e)
        placed.append((off, off + n, root))
    offsets = {root: off for off, _, root in placed}
    for n, buf in enumerate(plan.buffers):
        if buf.space == "ws" and buf.parent < 0:
            buf.offset = offsets.get(n, 0)  # 0: no op touches it
    return max((e for _, e, _ in placed), default=0)


def _slot_state(b: Plan, path, shape, cell: str) -> Tuple[int, int]:
    ids = []
    for field in (0, 1):
        b.slots.append(StateSlot(tuple(path), field, tuple(shape),
                                 b.state_dtype, cell))
        ids.append(len(b.slots) - 1)
    return tuple(ids)


def _act_name(layer) -> Optional[str]:
    if isinstance(layer, C.Tanh):
        return "tanh"
    if isinstance(layer, C.ReLU):
        return "relu"
    if isinstance(layer, C.SiLU):
        return "silu"
    return None


def _absorb_chain(b: Plan, op: Op, layers, li: int, path) -> int:
    """Absorb ``Norm`` -> ``LIF/LI`` -> activation, each optional but in
    that order, from ``layers[li:]`` into ``op``; returns the index of
    the first layer not absorbed."""
    if li < len(layers) and isinstance(layers[li], C.Norm):
        k, bias = layers[li].coeffs()
        op.norm = (b.add_weight(k), b.add_weight(bias))
        li += 1
    if li < len(layers) and isinstance(layers[li], C.Cell):
        cell = layers[li]
        op.cell = cell.kind
        op.slots = _slot_state(
            b, path + (f"l{li}",), (*cell.out_hw, cell.out_channels),
            cell.kind)
        li += 1
    if li < len(layers) and _act_name(layers[li]) is not None:
        op.act = _act_name(layers[li])
        li += 1
    return li


def _fuse_residual(b: Plan, outs: List[int], taps: List[int]) -> int:
    """A two-branch Residual sum taken into the epilogue of the op that
    made one branch, when that op was the last one emitted (so the other
    branch is ready before it) and nothing else reads its output; returns
    the sum's buffer, or -1 where an ``add`` op is needed."""
    if len(outs) != 2 or not b.ops:
        return -1
    last = b.ops[-1]
    if (last.kind not in ("conv", "ew") or last.res >= 0
            or last.dst not in outs or outs[0] == outs[1]
            or last.dst in taps or b.buffers[last.dst].space != "ws"):
        return -1
    last.res = outs[1] if last.dst == outs[0] else outs[0]
    return last.dst


def _emit_block(b: Plan, block: C.Block, src: int, path, taps) -> int:
    """Emit the ops of a compiled ``Block`` reading buffer ``src``;
    returns the buffer of its output (JAX ``_emit_cfg``)."""
    outs = []
    for bi in range(block.num_branches):
        branch = getattr(block, f"b{bi}")
        layers = list(branch.values())
        bpath = path + (f"b{bi}",)
        y, li = src, 0
        while li < len(layers):
            layer = layers[li]
            lpath = bpath + (f"l{li}",)
            h, w, c = b.buffers[y].shape
            if isinstance(layer, C.Block):
                y = _emit_block(b, layer, y, lpath, taps)
                li += 1
            elif isinstance(layer, C.Pass):
                li += 1
            elif isinstance(layer, C.Return):
                taps.append(y)
                li += 1
            elif isinstance(layer, C.Conv):
                k = layer.k
                if k not in (1, 3) or layer.stride not in (1, 2):
                    raise UnsupportedLayer(
                        f"Conv k={k} s={layer.stride} at {'/'.join(lpath)}")
                cout = layer.out_channels
                # an int8 conv's weight dequantized at build time, an s2d
                # conv's unpacked (JAX megakernel.py:201-219)
                taps_w = layer.float_weight().permute(2, 3, 1, 0).reshape(
                    k * k, c, cout)
                dst = b.add_buffer("ws", (*layer.out_hw, cout))
                op = Op("conv", y, dst, k=k, stride=layer.stride,
                        w=b.add_weight(taps_w))
                li = _absorb_chain(b, op, layers, li + 1, bpath)
                b.add_op(op)
                y = dst
            elif isinstance(layer, (C.Norm, C.Cell)) or _act_name(layer):
                dst = b.add_buffer("ws", (h, w, c))
                op = Op("ew", y, dst)
                li = _absorb_chain(b, op, layers, li, bpath)
                b.add_op(op)
                y = dst
            elif isinstance(layer, C.Pool):
                k = layer.k
                if h % k or w % k:
                    raise UnsupportedLayer(
                        f"Pool k={k} on {(h, w)} at {'/'.join(lpath)}")
                dst = b.add_buffer("ws", (h // k, w // k, c))
                b.add_op(Op("pool", y, dst, k=k, pool=layer.kind))
                y, li = dst, li + 1
            elif isinstance(layer, C.Up):
                s = layer.scale
                dst = b.add_buffer("ws", (h * s, w * s, c))
                b.add_op(Op("up", y, dst, k=s))
                y, li = dst, li + 1
            else:
                raise UnsupportedLayer(
                    f"{type(layer).__name__} at {'/'.join(lpath)}")
        outs.append(y)
    if block.mode == "residual":
        y = _fuse_residual(b, outs, taps)
        if y >= 0:
            return y
        y = outs[0]
        for o in outs[1:]:
            dst = b.add_buffer("ws", b.buffers[y].shape)
            b.add_op(Op("add", y, dst, res=o))
            y = dst
        return y
    if block.mode == "dense":
        # each branch output lives in its channels of the concatenation;
        # a value that already lives elsewhere is copied there
        h, w, _ = b.buffers[outs[0]].shape
        dst = b.add_buffer("ws", (h, w, block.out_channels))
        off = 0
        for o in outs:
            c = b.buffers[o].shape[2]
            if b.can_place(o):
                b.buffers[o].parent, b.buffers[o].ch_off = dst, off
            else:
                part = b.add_buffer("ws", (h, w, c), parent=dst, ch_off=off)
                b.add_op(Op("copy", o, part))
            off += c
        return dst
    return outs[0]


def _to_preds(b: Plan, buf: int, offset: int) -> None:
    """Send a head map into the fp32 prediction buffer at ``offset``:
    the op that made it writes there directly when nothing else reads
    it, else a copy does."""
    pbuf = b.add_buffer("preds", b.buffers[buf].shape, offset=offset)
    producers = [op for op in b.ops if op.dst == buf]
    readers = [op for op in b.ops if buf in op.inputs]
    if (b.can_place(buf) and len(producers) == 1
            and producers[0].kind in ("conv", "ew") and not readers
            and not any(x.parent == buf for x in b.buffers)):
        producers[0].dst = pbuf
    else:
        b.add_op(Op("copy", buf, pbuf))


def build_plan(model) -> Plan:
    """Walk a compiled :class:`SODa` into a :class:`Plan` (JAX
    ``StreamingMegakernel.__init__``)."""
    b = Plan(model.compute_dtype, model.state_dtype, model.device)
    b.num_classes = model.num_classes
    b.num_anchors = model.num_anchors
    with torch.no_grad():
        frame = b.add_buffer("frame", (*model.in_hw, model.in_channels),
                             offset=0)
        taps: List[int] = []
        y = _emit_block(b, model.backbone, frame, ("backbone",), taps)
        _emit_block(b, model.neck, y, ("neck",), taps)
        if len(taps) != model.num_heads:
            # as detector._trunk: a stray Return must not misalign scales
            raise RuntimeError(
                f"spec emitted {len(taps)} Return taps but the model "
                f"defines {model.num_heads} heads")
        cls_off, box_off = 0, model.num_anchors * (model.num_classes + 1)
        for idx, (head, fmap) in enumerate(zip(model.heads(), taps)):
            hp = (f"head{idx}",)
            base = _emit_block(b, head["base"], fmap, hp + ("base",), [])
            box = _emit_block(b, head["box"], base, hp + ("box",), [])
            cls = _emit_block(b, head["cls"], base, hp + ("cls",), [])
            _to_preds(b, box, box_off)
            _to_preds(b, cls, cls_off)
            box_off += b.buffers[box].numel
            cls_off += b.buffers[cls].numel
        b.finish()
    return b


# ---- the plain PyTorch version ----

def _epilogue(plan: Plan, op: Op, y: torch.Tensor, s_in, s_out
              ) -> torch.Tensor:
    """The conv / ew epilogue on ``y`` (fp32 values; the conv sum or the
    op's input), returning the op's output in the compute dtype (before
    the Residual sum)."""
    cdt = plan.compute_dtype
    y = y.to(cdt)
    if op.norm is not None:
        c = y.shape[-1]
        kv, bv = plan.weight(op.norm[0], c), plan.weight(op.norm[1], c)
        if cdt == torch.float32:
            y = neurons.fma(y, kv, bv)
        else:  # bf16 product; the sum stays fp32 into a cell or act
            y = (y * kv).float() + bv.float()
            if op.cell is None and op.act is None:
                y = y.to(cdt)
    if op.cell is not None:
        step = neurons.lif_step if op.cell == "lif" else neurons.li_step
        vi, ii = op.slots
        out, (v, i) = step(y.float(), (s_in[vi].float(), s_in[ii].float()))
        s_out[vi] = neurons.to_state(v, plan.state_dtype)
        s_out[ii] = neurons.to_state(i, plan.state_dtype)
        y = out.to(cdt)
    if op.act is not None:
        fn = {"tanh": torch.tanh, "relu": torch.relu, "silu": F.silu}[op.act]
        y = fn(y.float())
    return y.to(cdt)


def _conv_taps(x: torch.Tensor, w: torch.Tensor, k: int, stride: int,
               out_hw, exact: bool = False) -> torch.Tensor:
    """k x k conv as k*k tap matmuls of fp32-upcast operands, summed in
    fp32 in ``(dy, dx)`` order; x is ``[H, W, Cin]``, w ``[k*k, Cin,
    Cout]``. With ``exact`` the taps and channels are summed in float64
    and the sum is rounded once to fp32 (the products of fp32 values are
    exact in float64)."""
    ho, wo = out_hw
    pad = k // 2
    dt = torch.float64 if exact else torch.float32
    x = F.pad(x.to(dt), (0, 0, pad, pad, pad, pad))
    acc = None
    for dy in range(k):
        for dx in range(k):
            patch = x[dy:dy + (ho - 1) * stride + 1:stride,
                      dx:dx + (wo - 1) * stride + 1:stride]
            m = patch.reshape(ho * wo, -1) @ w[dy * k + dx].to(dt)
            acc = m if acc is None else acc + m
    return acc.reshape(ho, wo, -1).float()


def streaming_megakernel_reference(plan: Plan, x: torch.Tensor,
                                   state_vals: List[torch.Tensor],
                                   exact_sums: bool = False):
    """Plain PyTorch version of the megakernel: one frame ``x [H, W,
    Cin]`` (uint8, fp32 or bf16) and the state slots -> ``(cls [1, A,
    C+1], box [1, A, 4], new state slots)``, predictions in fp32. The
    inputs are not written.

    ``exact_sums`` sums every conv in float64 and rounds it once to
    fp32 (``_conv_taps``); everything after the sum rounds where the
    plain version does. The run then differs from the plain version only
    in the conv sums: the reference of the witness (``run_distance``)."""
    cdt = plan.compute_dtype
    roots: Dict[int, torch.Tensor] = {0: x.to(cdt)}
    preds = torch.zeros(plan.preds_numel, dtype=torch.float32,
                        device=x.device)
    s_out = list(state_vals)

    def read(buf: int) -> torch.Tensor:
        root, off = plan.locate(buf)
        return roots[root][..., off:off + plan.buffers[buf].shape[2]]

    def write(buf: int, value: torch.Tensor) -> None:
        b = plan.buffers[buf]
        if b.space == "preds":
            preds[b.offset:b.offset + b.numel] = value.reshape(-1)
            return
        root, off = plan.locate(buf)
        if root == buf:  # the whole buffer: written once
            roots[root] = value
            return
        if root not in roots:
            roots[root] = torch.zeros(plan.buffers[root].shape, dtype=cdt,
                                      device=x.device)
        roots[root][..., off:off + b.shape[2]] = value

    for op in plan.ops:
        src = read(op.src)
        out_hw = plan.buffers[op.dst].shape[:2]
        if op.kind == "conv":
            c = src.shape[-1]
            cout = plan.buffers[op.dst].shape[2]
            w = plan.weight(op.w, op.k * op.k * c * cout).reshape(
                op.k * op.k, c, cout)
            acc = _conv_taps(src, w, op.k, op.stride, out_hw, exact_sums)
            y = _epilogue(plan, op, acc, state_vals, s_out)
        elif op.kind == "ew":
            y = _epilogue(plan, op, src.float(), state_vals, s_out)
        elif op.kind == "pool":
            (oh, ow), k = out_hw, op.k
            yr = src.reshape(oh, k, ow, k, src.shape[-1])
            if op.pool == "M":
                y = yr.amax(dim=(1, 3))
            else:
                y = yr.float().sum(dim=(1, 3))
                y = (y / (k * k) if op.pool == "A" else y).to(cdt)
        elif op.kind == "up":
            y = src.repeat_interleave(op.k, 0).repeat_interleave(op.k, 1)
        else:  # add, copy
            y = src
        if op.res >= 0:  # a Residual sum: add, or a conv / ew epilogue's
            y = y + read(op.res)
        write(op.dst, y)
    a = plan.num_anchors
    cls = preds[:a * (plan.num_classes + 1)].reshape(1, a, -1)
    box = preds[a * (plan.num_classes + 1):].reshape(1, a, 4)
    return cls, box, s_out


# ---- the witness: how far one run is from another ----

# A build passes the witness when, on every seed, it is no further from
# the exact-sum run than the plain version is, give or take this slack
# (PERF.md, "the witness"; tests/test_torch_megakernel.py fixes it).
WITNESS_AGREEMENT_SLACK = 0.02
WITNESS_L2_FACTOR = 1.5
WITNESS_L2_SLACK = 0.03


@dataclasses.dataclass(frozen=True)
class RunDistance:
    """How far one run of frames is from another from the same start:
    per LIF cell the share of neurons that spiked at the last frame (v ==
    0) in both runs or in neither; per LI state tensor the relative L2
    distance; the largest difference of the predictions."""

    agreement: Tuple[float, ...]
    li_rel_l2: Tuple[float, ...]
    max_pred_diff: float

    def __str__(self) -> str:
        return (f"spike agreement min {min(self.agreement, default=1.0):.6f}"
                f" over {len(self.agreement)} LIF cells, LI relative L2 max "
                f"{max(self.li_rel_l2, default=0.0):.3e}, max |pred diff| "
                f"{self.max_pred_diff:.3g}")


def run_distance(preds_a, cells_a, preds_b, cells_b) -> RunDistance:
    """Distance of run a from run b. ``preds_*``: sequences of prediction
    tensors; ``cells_*``: ``(kind, v, i)`` of every cell at the end of
    the run, in one order (``plan_cells``, ``model_cells``). The relative
    L2 distances and the prediction difference are over the elements
    finite in both runs (an e4m3 state that overflowed is NaN)."""
    agree, rel = [], []
    for (kind, va, ia), (_, vb, ib) in zip(cells_a, cells_b):
        if kind == "lif":
            agree.append(float(((va == 0) == (vb == 0)).float().mean()))
        else:
            for a, b in ((va, vb), (ia, ib)):
                a, b = a.float(), b.float()
                fin = a.isfinite() & b.isfinite()
                a, b = a[fin], b[fin]
                rel.append(float((a - b).norm()
                                 / b.norm().clamp_min(1e-30)))
    diff = 0.0
    for a, b in zip(preds_a, preds_b):
        d = (a.float() - b.float()).abs()
        d = d[d.isfinite()]
        if d.numel():
            diff = max(diff, float(d.max()))
    return RunDistance(tuple(agree), tuple(rel), diff)


def witness_passes(build: RunDistance, plain: RunDistance) -> bool:
    """Whether a build, at distance ``build`` from the exact-sum run, is
    no further from it than the plain version (at ``plain``), within the
    witness's slack."""
    agree_ok = (min(build.agreement, default=1.0)
                >= min(plain.agreement, default=1.0)
                - WITNESS_AGREEMENT_SLACK)
    l2_ok = (max(build.li_rel_l2, default=0.0)
             <= WITNESS_L2_FACTOR * max(plain.li_rel_l2, default=0.0)
             + WITNESS_L2_SLACK)
    return agree_ok and l2_ok


def plan_cells(plan: Plan, state_vals: List[torch.Tensor]):
    """``(kind, v, i)`` of every cell from a plan's flat state slots."""
    return [(plan.slots[n].cell, state_vals[n], state_vals[n + 1])
            for n in range(0, len(plan.slots), 2)]


def model_cells(model, state):
    """``(kind, v, i)`` of every cell from a model's state tree, in the
    order of the plan's slots."""
    cells = []

    def walk(block, st):
        for bi in range(block.num_branches):
            for name, layer in getattr(block, f"b{bi}").items():
                if isinstance(layer, C.Block):
                    walk(layer, st[f"b{bi}"][name])
                elif isinstance(layer, C.Cell):
                    v, i = st[f"b{bi}"][name]
                    cells.append((layer.kind, v, i))

    walk(model.backbone, state["backbone"])
    walk(model.neck, state["neck"])
    for idx, head in enumerate(model.heads()):
        for part in ("base", "box", "cls"):
            walk(head[part], state[f"head{idx}"][part])
    return cells


# ---- the user-facing step ----

class StreamingMegakernel:
    """One-frame, batch-1 fused forward of a :class:`SODa` detector.

    ``step(x, state) -> ((cls [1, A, C+1], box [1, A, 4]), new state)``
    with the shapes and state tree of ``model.step`` at B = 1. On a CUDA
    model every step is one launch of ``csrc/megakernel.cu``; on a CPU
    model it is the plain version. The step is functional, as in JAX:
    the new state is new tensors and the caller's state is never
    written, so one state may be fed twice. One instance runs one frame
    at a time (it owns the workspace), on the current stream.

    The plan reads the model's weights when it is built: rebuild after
    loading new weights.
    """

    def __init__(self, model):
        self.model = model
        self.plan = build_plan(model)
        if self.plan.device.type == "cuda":
            # the op table, workspace and barrier, once
            cuda_kernels.prepare_megakernel(self.plan)

    # ---- state tree <-> flat slots ----

    def _state_leaves(self, state) -> List[torch.Tensor]:
        vals = []
        for slot in self.plan.slots:
            node = state
            for p in slot.path:
                node = node[p]
            vals.append(node[slot.field].reshape(slot.shape))
        return vals

    def _rebuild_state(self, state, new_vals):
        def copy(tree):
            return ({k: copy(v) for k, v in tree.items()}
                    if isinstance(tree, dict) else tree)

        state = copy(state)
        for slot, val in zip(self.plan.slots, new_vals):
            node = state
            for p in slot.path[:-1]:
                node = node[p]
            leaf = node[slot.path[-1]]
            node[slot.path[-1]] = type(leaf)(*(
                val[None] if f == slot.field else leaf[f]
                for f in range(len(leaf))))
        return state

    def _flat_state(self, state) -> List[torch.Tensor]:
        """None / model state tree / flat slot list -> flat slot list."""
        if state is None:
            state = self.model.init_state(1)
        if isinstance(state, list):
            return state
        return self._state_leaves(state)

    # ---- execution ----

    @staticmethod
    def _frame(x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:
            if x.shape[0] != 1:
                raise ValueError(
                    f"megakernel is batch-1 only, got batch {x.shape[0]}")
            x = x[0]
        return x

    def _run(self, x, state_vals):
        return cuda_kernels.streaming_megakernel(self.plan, x, state_vals)

    @torch.no_grad()
    def step(self, x: torch.Tensor, state=None):
        """One frame ``[H, W, C]`` (or ``[1, H, W, C]``; uint8, fp32 or
        bf16) -> ((cls [1, A, C+1], box [1, A, 4]) in fp32, new state
        tree, the ``model.step`` contract)."""
        x = self._frame(x)
        tree = state if isinstance(state, dict) else self.model.init_state(1)
        cls, box, new_vals = self._run(x, self._flat_state(state))
        return (cls, box), self._rebuild_state(tree, new_vals)

    @torch.no_grad()
    def predict(self, x: torch.Tensor, state=None, max_out: int = 300):
        """Streaming predict: the step, then ``model.detect`` and boxes
        clamped to [0, 1]. The carried state is an opaque flat list: pass
        it straight back in; :meth:`to_model_state` converts it."""
        squeeze = x.dim() == 3
        x = self._frame(x)
        cls, box, new_vals = self._run(x, self._flat_state(state))
        dets = self.model.detect((cls, box), max_out=max_out)
        dets = torch.cat([dets[..., :2], dets[..., 2:].clamp(0.0, 1.0)],
                         dim=-1)
        return (dets[0] if squeeze else dets), new_vals

    def to_model_state(self, state_vals: List[torch.Tensor]):
        """Flat slot list (from :meth:`predict`) -> model state tree."""
        return self._rebuild_state(self.model.init_state(1), state_vals)
