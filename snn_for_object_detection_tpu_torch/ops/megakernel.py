"""Whole-network B=1 streaming step: one kernel launch per frame.

Counterpart of ``snn_for_object_detection_tpu/ops/megakernel.py``. At
batch 1 a TinyYolo frame is 3.8 G multiply-adds spread over 48 convs and
their BatchNorm, cell, residual and concat glue; run layer by layer it
is bound by launches, not by math. Here the compiled detector is walked
once, at construction, into a *plan*: a list of ops over buffers of one
preallocated workspace, with every conv weight packed as ``[k*k, Cin,
Cout]`` taps and every folded BatchNorm ``(k, b)`` in one weight buffer
of the compute dtype, and the neuron states as ``[H, W, C]`` slots.
The plan runs two ways:

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
Pool, Up, Residual sums and Dense concatenations are ops of their own.
The plain version runs the ops in the order they were emitted; on the
card (``cuda_kernels.megakernel_op_table``) every op takes the phase
after the last phase that wrote one of its inputs, so independent
branches (Dense branches, the heads) share phases.

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
Residual and Dense sum and concatenate in the compute dtype.

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


@dataclasses.dataclass
class Buffer:
    """An ``[H, W, C]`` activation: the frame, a workspace region (compute
    dtype) or a region of the fp32 prediction output."""

    space: str  # "frame" | "ws" | "preds"
    offset: int
    shape: Tuple[int, int, int]

    @property
    def numel(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]


@dataclasses.dataclass
class Op:
    """One op of the plan. ``kind``: conv, ew (a standalone epilogue
    chain), pool, up, add or copy (into channels ``ch_off`` onward of
    ``dst``). The epilogue chain of conv and ew: ``norm`` (offsets of
    ``k`` and ``b``), then ``cell`` with its state ``slots`` (v, i), then
    ``act``."""

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
    ch_off: int = 0


class Plan:
    """The compiled B=1 program of one detector (see the module note)."""

    def __init__(self, compute_dtype, state_dtype, device):
        self.compute_dtype = compute_dtype
        self.state_dtype = state_dtype
        self.device = device
        self.buffers: List[Buffer] = []
        self.ops: List[Op] = []
        self.slots: List[StateSlot] = []
        self.weights: List[torch.Tensor] = []
        self.weight_numel = 0
        self.ws_numel = 0
        self.weight_buf: Optional[torch.Tensor] = None
        self.num_anchors = 0
        self.num_classes = 0

    # ---- building ----

    def add_buffer(self, space: str, shape, offset: Optional[int] = None
                   ) -> int:
        if offset is None:
            offset = self.ws_numel
            n = shape[0] * shape[1] * shape[2]
            self.ws_numel += -(-n // ALIGN) * ALIGN
        self.buffers.append(Buffer(space, offset, tuple(shape)))
        return len(self.buffers) - 1

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
        self.weight_buf = (torch.cat(self.weights) if self.weights else
                           torch.zeros(ALIGN, dtype=self.compute_dtype))
        self.weight_buf = self.weight_buf.to(self.device).contiguous()
        self.weights = []

    @property
    def preds_numel(self) -> int:
        return self.num_anchors * (self.num_classes + 1 + 4)

    def weight(self, off: int, n: int) -> torch.Tensor:
        return self.weight_buf[off:off + n]


def _slot_state(b: Plan, path, shape) -> Tuple[int, int]:
    ids = []
    for field in (0, 1):
        b.slots.append(StateSlot(tuple(path), field, tuple(shape),
                                 b.state_dtype))
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
            b, path + (f"l{li}",), (*cell.out_hw, cell.out_channels))
        li += 1
    if li < len(layers) and _act_name(layers[li]) is not None:
        op.act = _act_name(layers[li])
        li += 1
    return li


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
                k = layer.w.shape[-1]
                if k not in (1, 3) or layer.stride not in (1, 2):
                    raise UnsupportedLayer(
                        f"Conv k={k} s={layer.stride} at {'/'.join(lpath)}")
                cout = layer.out_channels
                taps_w = layer.w.permute(2, 3, 1, 0).reshape(k * k, c, cout)
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
        y = outs[0]
        for o in outs[1:]:
            dst = b.add_buffer("ws", b.buffers[y].shape)
            b.add_op(Op("add", y, dst, res=o))
            y = dst
        return y
    if block.mode == "dense":
        h, w, _ = b.buffers[outs[0]].shape
        dst = b.add_buffer("ws", (h, w, block.out_channels))
        off = 0
        for o in outs:
            b.add_op(Op("copy", o, dst, ch_off=off))
            off += b.buffers[o].shape[2]
        return dst
    return outs[0]


def _to_preds(b: Plan, buf: int, offset: int) -> None:
    """Send a head map into the fp32 prediction buffer at ``offset``:
    the op that made it writes there directly when nothing else reads
    it, else a copy does."""
    pbuf = b.add_buffer("preds", b.buffers[buf].shape, offset=offset)
    producers = [op for op in b.ops if op.dst == buf]
    readers = [op for op in b.ops if buf in (op.src, op.res)]
    if (b.buffers[buf].space == "ws" and len(producers) == 1
            and producers[0].kind in ("conv", "ew") and not readers):
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
    op's input), returning the op's output in the compute dtype."""
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
        s_out[vi] = v.to(plan.state_dtype)
        s_out[ii] = i.to(plan.state_dtype)
        y = out.to(cdt)
    if op.act is not None:
        fn = {"tanh": torch.tanh, "relu": torch.relu, "silu": F.silu}[op.act]
        y = fn(y.float())
    return y.to(cdt)


def _conv_taps(x: torch.Tensor, w: torch.Tensor, k: int, stride: int,
               out_hw) -> torch.Tensor:
    """k x k conv as k*k tap matmuls of fp32-upcast operands, summed in
    fp32 in ``(dy, dx)`` order; x is ``[H, W, Cin]``, w ``[k*k, Cin,
    Cout]``."""
    ho, wo = out_hw
    pad = k // 2
    x = F.pad(x.float(), (0, 0, pad, pad, pad, pad))
    acc = None
    for dy in range(k):
        for dx in range(k):
            patch = x[dy:dy + (ho - 1) * stride + 1:stride,
                      dx:dx + (wo - 1) * stride + 1:stride]
            m = patch.reshape(ho * wo, -1) @ w[dy * k + dx].float()
            acc = m if acc is None else acc + m
    return acc.reshape(ho, wo, -1)


def streaming_megakernel_reference(plan: Plan, x: torch.Tensor,
                                   state_vals: List[torch.Tensor]):
    """Plain PyTorch version of the megakernel: one frame ``x [H, W,
    Cin]`` (uint8, fp32 or bf16) and the state slots -> ``(cls [1, A,
    C+1], box [1, A, 4], new state slots)``, predictions in fp32. The
    inputs are not written."""
    cdt = plan.compute_dtype
    vals: Dict[int, torch.Tensor] = {0: x.to(cdt)}
    preds = torch.zeros(plan.preds_numel, dtype=torch.float32,
                        device=x.device)
    s_out = list(state_vals)

    def store(dst: int, value: torch.Tensor, ch_off: int = 0) -> None:
        buf = plan.buffers[dst]
        if buf.space == "preds":
            preds[buf.offset:buf.offset + buf.numel] = value.reshape(-1)
            return
        if value.shape[-1] == buf.shape[2]:
            vals[dst] = value
            return
        if dst not in vals:
            vals[dst] = torch.zeros(buf.shape, dtype=cdt, device=x.device)
        vals[dst][..., ch_off:ch_off + value.shape[-1]] = value

    for op in plan.ops:
        src = vals[op.src]
        out_hw = plan.buffers[op.dst].shape[:2]
        if op.kind == "conv":
            c = src.shape[-1]
            cout = plan.buffers[op.dst].shape[2]
            w = plan.weight(op.w, op.k * op.k * c * cout).reshape(
                op.k * op.k, c, cout)
            acc = _conv_taps(src, w, op.k, op.stride, out_hw)
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
        elif op.kind == "add":
            y = src + vals[op.res]
        else:  # copy
            y = src
        store(op.dst, y, op.ch_off)
    a = plan.num_anchors
    cls = preds[:a * (plan.num_classes + 1)].reshape(1, a, -1)
    box = preds[a * (plan.num_classes + 1):].reshape(1, a, 4)
    return cls, box, s_out


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
