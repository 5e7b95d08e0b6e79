"""Spec compiler: DSL config lists -> ``nn.Module`` trees.

Counterpart of ``snn_for_object_detection_tpu/models/compile.py``:
``Conv``, ``Norm``, the cells ``LIF``, ``LI``, ``PLIF``, ``ALIF``,
``SLI``, ``Synapse`` and the conv ``LSTM``, ``ReLU``, ``SiLU``,
``Tanh``, ``Pool`` (any stride), ``Up`` (nearest and the interpolating
modes), ``Pass``, ``Return`` taps, and ``Residual`` / ``Dense`` blocks.
Shape inference runs once at build time, as in the JAX compiler. Each
layer has two forms:

- ``step(x, state, ctx)`` for one frame ``x [B, H, W, C]``;
- ``seq(X, state, ctx)`` for a whole sequence ``X [T, B, H, W, C]``:
  stateless layers fold T into the batch, LIF/LI cells run the whole
  time loop in one ``temporal_cell_seq`` call and PLIF in one
  ``plif_cell_seq`` call, with the truncation start ``ctx.start_step``;
  ALIF, SLI, Synapse and the LSTM loop over T in plain PyTorch (JAX runs
  them as a per-layer ``lax.scan``, which no Pallas kernel replaces).
  With ``ctx.fuse`` and no truncation, a block runs each ``[Conv k x k
  -> Norm -> LIF/LI]`` triple of a branch as one ``spiking_conv_seq``
  call instead (the JAX compiler's fused plan).

Under ``ctx.train`` Norm normalises with per-step batch statistics and
hands its new running statistics on as its state (the model writes them
to its buffers once the forward is done), blocks never fuse, and with
``ctx.remat`` a sequence call runs each branch as checkpointed segments
(``torch.utils.checkpoint``), one per conv -> norm -> cell run, as the
JAX compiler's ``_segment_plan``.

Activations are NHWC at every boundary (the JAX layout). Submodules are
named after the JAX pytree keys (``b0.l3.w`` for ``["b0"]["l3"]["w"]``),
so ``models/convert.py`` maps weights one to one.

Under a ``space`` axis (``ctx.space``, a ``parallel.halo.Space``) every
map is split along H over the ranks of the space group, each holding
the balanced block of ``halo.row_blocks``, and so is every state: a Conv
(float or int8) computes its own output rows from the input rows they
read (``halo.fetch_rows``: the halo from the neighbouring blocks, zeros
beyond the map's edge) with padding along W only; Pool (any stride), Up
(any mode) and the conv LSTM (every step, the halo of ``[x, h]``) read
the rows of their outputs' blocks the same way; a train Norm takes its
moments over the whole grid; a fused triple fetches its sequence's rows
once and runs ``spiking_conv_seq``'s fetched-rows form (``pad_h=0``).

Beside the plain forms: ``Conv(s2d=True)`` runs the space-to-depth plan
(the same function, another layout of the sums); a Conv in its int8 form
(``ops/quantize.py``) runs int8 x int8 -> int32 sums between a per-tensor
input scale and per-channel weight scales; ``ctx.calibrate`` has every
Conv report its input's absmax; and with ``ctx.record`` every
``state_storage=True`` cell adds ``(state, out)`` to ``ctx.records``
under its JAX name (``backbone/b0/l2``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from snn_for_object_detection_tpu_torch.models import spec as S
from snn_for_object_detection_tpu_torch.ops import neurons, quantize
from snn_for_object_detection_tpu_torch.ops.cuda_kernels import (
    full_fp32_conv,
    plif_cell_seq,
    spiking_conv_seq,
    temporal_cell_seq,
)
from snn_for_object_detection_tpu_torch.parallel import distributed as dist
from snn_for_object_detection_tpu_torch.parallel.halo import fetch_rows


@dataclasses.dataclass
class Ctx:
    """Per-call context: ``taps`` collects ``Return`` outputs in config
    order; ``start_step`` is the truncation start r of a sequence call
    (state frozen for t < r); ``fuse`` lets a sequence call run its
    fused triples (only at ``start_step == 0`` and not in training: the
    fused kernel has no truncation gate and no backward; the per-step
    ``step`` never fuses); ``train`` selects batch statistics in Norm;
    ``remat`` checkpoints a sequence call's segments.

    ``record``: every cell built with ``state_storage=True`` puts
    ``(state, out)`` in ``records`` under its name (a step: the new
    state and the fp32 output; a sequence call: both stacked over T, the
    state held for ``t < start_step``, the output in the input's dtype).
    ``calibrate``: every float Conv puts its input's fp32 absmax in
    ``absmax``, keyed by the layer (``ops/quantize.calibrate``).

    ``batch_group``: in training, the process group of several ranks
    whose rows form the global batch (data parallel): Norm takes the
    global batch's moments (:func:`global_moments`), as GSPMD makes
    JAX's batch means. ``None``: this batch is the global batch.

    ``space``: a ``parallel.halo.Space`` when the maps are split along
    H over the ranks of a space group (each layer computes its block of
    rows); ``batch_group`` then spans every rank of the grid."""

    taps: List[torch.Tensor] = dataclasses.field(default_factory=list)
    start_step: int = 0
    fuse: bool = False
    train: bool = False
    remat: bool = False
    record: bool = False
    records: Dict[str, Any] = dataclasses.field(default_factory=dict)
    calibrate: bool = False
    absmax: Dict[Any, torch.Tensor] = dataclasses.field(default_factory=dict)
    batch_group: Any = None
    space: Any = None

    def step_mask(self, steps: int) -> List[bool]:
        """Step t of a sequence call is active iff ``t >= start_step``."""
        return [t >= self.start_step for t in range(steps)]


class Layer(nn.Module):
    """A compiled layer with static output shape. ``has_tap``: a
    ``Return`` is in it, so a remat segment must not hold it.
    ``closes_segment``: it carries state (a cell or a block), so a remat
    segment ends after it."""

    has_tap = False
    closes_segment = False
    name = ""

    def __init__(self, out_channels: int, out_hw: Tuple[int, int]):
        super().__init__()
        self.out_channels = out_channels
        self.out_hw = tuple(out_hw)

    def init_state(self, batch: int, device, space=None) -> Any:
        return ()

    def local_shape(self, batch: int, channels: int, space=None):
        """``[batch, H, W, channels]`` of this layer's output map, H this
        rank's block of rows under a space axis."""
        h, w = self.out_hw
        if space is not None:
            h = space.rows(h, f"{self.name}: its output map "
                              f"{self.out_hw}")
        return (batch, h, w, channels)

    def step(self, x, state, ctx: Ctx):
        raise NotImplementedError

    def seq(self, X, state, ctx: Ctx):
        """Default for stateless layers: fold T into the batch."""
        t, b = X.shape[0], X.shape[1]
        y, state = self.step(X.reshape((t * b,) + X.shape[2:]), state, ctx)
        return y.reshape((t, b) + y.shape[1:]), state


class Pass(Layer):
    def step(self, x, state, ctx):
        return x, state


class Tanh(Layer):
    def step(self, x, state, ctx):
        return torch.tanh(x), state


class ReLU(Layer):
    def step(self, x, state, ctx):
        return torch.relu(x), state


class SiLU(Layer):
    def step(self, x, state, ctx):
        return F.silu(x), state


class Pool(Layer):
    """Pooling with ``kernel_size == stride`` (compile.py:485-493): the
    map is cropped to ``(oh * k, ow * k)`` and reduced over each k x k
    window: ``M`` max, ``A`` mean, ``S`` sum."""

    def __init__(self, ch, in_hw, k: int, kind: str):
        super().__init__(ch, (in_hw[0] // k, in_hw[1] // k))
        self.k, self.kind = k, kind
        self.in_hw = tuple(in_hw)

    def step(self, x, state, ctx):
        (oh, ow), k = self.out_hw, self.k
        b, c = x.shape[0], x.shape[-1]
        space = None if ctx is None else ctx.space
        if space is not None:
            # the input rows of this rank's output rows (the cropped tail
            # of the global map is no block's)
            out = space.blocks(oh, f"{self.name}: its output map")
            x = fetch_rows(x, self.in_hw[0],
                           lambda j: (out[j][0] * k, out[j][1] * k), space,
                           f"{self.name}: its input map")
            oh = x.shape[1] // k
        y = x[:, :oh * k, :ow * k].reshape(b, oh, k, ow, k, c)
        if self.kind == "M":
            return y.amax(dim=(2, 4)), state
        y = y.sum(dim=(2, 4))
        return (y / (k * k) if self.kind == "A" else y), state


class Up(Layer):
    """Nearest upsampling by an integer scale: a repeat (compile.py:
    533-538)."""

    def __init__(self, ch, in_hw, scale: int):
        super().__init__(ch, (in_hw[0] * scale, in_hw[1] * scale))
        self.scale = scale

    def step(self, x, state, ctx):
        s = self.scale
        space = None if ctx is None else ctx.space
        if space is not None:
            # output rows [o0, o1) repeat input rows o0 // s .. (o1-1) // s
            out = space.blocks(self.out_hw[0], f"{self.name}: its output map")
            o0, o1 = out[space.index]
            x = fetch_rows(x, self.out_hw[0] // s,
                           lambda j: (out[j][0] // s, (out[j][1] - 1) // s + 1),
                           space, f"{self.name}: its input map")
            y = x.repeat_interleave(s, dim=1)
            y = y[:, o0 - (o0 // s) * s:o1 - (o0 // s) * s]
        else:
            y = x.repeat_interleave(s, dim=1)
        return y.repeat_interleave(s, dim=2), state


class StridedPool(Layer):
    """Pooling with ``stride != kernel_size`` (compile.py:494-521), on
    the uncropped map, no padding: ``A`` / ``S`` a depthwise conv of
    ones in the activation dtype (``A`` divided by k * k), ``M`` the
    elementwise max of the k * k strided slices."""

    def __init__(self, ch, in_hw, k: int, s: int, kind: str):
        super().__init__(ch, ((in_hw[0] - k) // s + 1,
                              (in_hw[1] - k) // s + 1))
        self.k, self.s, self.kind = k, s, kind
        self.in_hw = tuple(in_hw)

    def step(self, x, state, ctx):
        (oh, ow), k, s = self.out_hw, self.k, self.s
        space = None if ctx is None else ctx.space
        if space is not None:
            # output rows [o0, o1) read input rows [o0 s, (o1 - 1) s + k)
            # of the uncropped map
            out = space.blocks(oh, f"{self.name}: its output map")
            x = fetch_rows(x, self.in_hw[0],
                           lambda j: (out[j][0] * s, (out[j][1] - 1) * s + k),
                           space, f"{self.name}: its input map")
            oh = out[space.index][1] - out[space.index][0]
        if self.kind == "M":
            y = None
            for di in range(k):
                for dj in range(k):
                    sl = x[:, di:di + (oh - 1) * s + 1:s,
                           dj:dj + (ow - 1) * s + 1:s]
                    y = sl if y is None else torch.maximum(y, sl)
            return y, state
        c = x.shape[-1]
        w = torch.ones((c, 1, k, k), dtype=x.dtype, device=x.device)
        with full_fp32_conv():
            y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=s, groups=c)
        y = y.permute(0, 2, 3, 1).contiguous()
        return (y / (k * k) if self.kind == "A" else y), state


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """JAX's Keys cubic kernel (a = -0.5) of ``jax.image.resize``, its
    multiply-adds contracted as XLA contracts them."""
    fma = neurons.fma
    out = fma(fma(x, 1.5, torch.full_like(x, -2.5)) * x, x,
              torch.ones_like(x))
    far = fma(fma(fma(x, -0.5, torch.full_like(x, 2.5)), x,
                  torch.full_like(x, -4.0)), x, torch.full_like(x, 2.0))
    out = torch.where(x >= 1.0, far, out)
    return torch.where(x >= 2.0, 0.0, out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def resize_weights(in_size: int, out_size: int,
                   kernel: Callable) -> torch.Tensor:
    """``[in_size, out_size]`` fp32 interpolation weights of one axis, as
    ``jax.image.resize`` computes them (``compute_weight_mat``): half-
    pixel centres, each output's weights divided by their sum (so the
    edges renormalise), zero where the sample falls outside the input.
    Upsampling only, where JAX's antialiasing changes nothing."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]
         ).abs()
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


class Resize(Layer):
    """Up in the modes ``linear`` / ``bilinear`` / ``trilinear`` (all
    bilinear on a 2-D map) and ``bicubic``: ``jax.image.resize``
    (compile.py:539-545) by an integer scale, the triangle or Keys
    cubic kernel (a = -0.5; torch's ``bicubic`` takes a = -0.75) as the
    two weight matrices of :func:`resize_weights`, applied to H and
    then W in the activation dtype, the weights rounded to it. Under a
    space axis a block of output rows reads the input rows where its
    columns of ``wh`` are nonzero (2 a row for the triangle kernel, 4
    for Keys cubic) and applies those weights."""

    def __init__(self, ch, in_hw, scale: int, mode: str):
        super().__init__(ch, (in_hw[0] * scale, in_hw[1] * scale))
        kernel = _keys_cubic if mode == "bicubic" else _triangle
        self.mode = mode
        wh = resize_weights(in_hw[0], in_hw[0] * scale, kernel)
        self.register_buffer("wh", wh, persistent=False)
        self.register_buffer("ww", resize_weights(
            in_hw[1], in_hw[1] * scale, kernel), persistent=False)
        # the input rows (first, last + 1) each output row reads
        self._reads = tuple(
            (int(col.nonzero().min()), int(col.nonzero().max()) + 1)
            for col in (wh != 0).t())

    def _rows_read(self, o0: int, o1: int) -> Tuple[int, int]:
        spans = self._reads[o0:o1]
        return min(a for a, _ in spans), max(b for _, b in spans)

    def step(self, x, state, ctx):
        wh = self.wh
        space = None if ctx is None else ctx.space
        if space is not None:
            out = space.blocks(self.out_hw[0], f"{self.name}: its output map")
            o0, o1 = out[space.index]
            lo, hi = self._rows_read(o0, o1)
            x = fetch_rows(x, wh.shape[0],
                           lambda j: self._rows_read(*out[j]), space,
                           f"{self.name}: its input map")
            wh = wh[lo:hi, o0:o1]
        y = torch.einsum("bhwc,hH->bHwc", x, wh.to(x.dtype))
        return torch.einsum("bHwc,wW->bHWc", y, self.ww.to(x.dtype)), state


class Return(Layer):
    """Pyramid tap; in sequence mode the tap is the whole sequence."""

    has_tap = True

    def step(self, x, state, ctx):
        ctx.taps.append(x)
        return x, state

    seq = step


def _full_fp32_backward(node) -> None:
    """Run ``node``, a conv's backward, with cuDNN's TF32 off: autograd
    reads the flag when it runs the node, outside any context the
    forward was called in. A hook just before the node turns it off, one
    just after gives the process's value back. (The node stays autograd's
    own: a custom ``autograd.Function`` would run each checkpointed
    segment's last conv again in the recompute.)"""
    saved = []

    def before(grad_outputs):
        saved.append(torch.backends.cudnn.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False

    def after(grad_inputs, grad_outputs):
        torch.backends.cudnn.allow_tf32 = saved.pop()

    node.register_prehook(before)
    node.register_hook(after)


def _conv_nhwc(x, w, stride: int, padding: int):
    """``x`` NHWC conv OIHW ``w``, NHWC out."""
    # fp32 convs sum in full fp32, as JAX's, whatever the process's
    # torch.backends.cudnn.allow_tf32: forward and backward
    with full_fp32_conv():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride,
                     padding=padding)
    if y.grad_fn is not None:
        _full_fp32_backward(y.grad_fn)
    # cuDNN and oneDNN answer a channels-last input in channels-last,
    # so this is a view; a backend that answers NCHW pays one copy
    return y.permute(0, 2, 3, 1).contiguous()


def _kaiming_(w: nn.Parameter, generator: torch.Generator) -> None:
    """Kaiming normal, fan_out mode, relu gain (compile.py:236-241), of
    an OIHW weight."""
    out, _, kh, kw = w.shape
    std = (2.0 / (kh * kw * out)) ** 0.5
    with torch.no_grad():
        w.copy_(std * torch.randn(w.shape, generator=generator))


def s2d_pack_x(x: torch.Tensor) -> torch.Tensor:
    """``[..., H, W, C] -> [..., H/2, W/2, 4C]``: 2x2 space-to-depth, the
    row phase ``a`` outermost in the packed channel index ``a*2C + b*C +
    c`` (JAX ``_s2d_pack_x``)."""
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h // 2, 2, w // 2, 2, c).transpose(-4, -3)
    return x.reshape(*lead, h // 2, w // 2, 4 * c)


def s2d_pack_w(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[O, C, 3, 3] -> [O, 4C, 2, 2]`` (JAX ``_s2d_pack_w``): the
    3x3 stride-2 taps scattered onto a kernel-2 stride-1 conv of the
    packed grid with top/left padding 1. Output row i reads raw rows 2i-1,
    2i, 2i+1 at (packed tap 0, phase 1), (1, 0), (1, 1); the (0, 0) slot
    is never read and stays zero. Columns the same. Differentiable: the
    gradient reaches the 3x3 weight."""
    o, c = w.shape[:2]
    wp = w.new_zeros(o, 2, 2, c, 2, 2)  # [O, a, b, C, packed row, col]
    taps = {(0, 1): 0, (1, 0): 1, (1, 1): 2}  # (packed tap, phase) -> raw
    for (di_p, a), di in taps.items():
        for (dj_p, b), dj in taps.items():
            wp[:, a, b, :, di_p, dj_p] = w[:, :, di, dj]
    return wp.reshape(o, 4 * c, 2, 2)


class Conv(Layer):
    """Bias-free conv, symmetric padding ``k // 2``. The weight is kept
    OIHW; activations stay NHWC (a channels-last view for the conv).

    ``s2d`` (JAX ``Conv(s2d=True)``, k = 3, stride 2, even input dims):
    the execution plan of a 2x2 space-to-depth input and the packed
    kernel-2 stride-1 conv (padding 1 on top and left), packed at apply
    time from the same ``[O, C, 3, 3]`` weight; the fused plan and the
    megakernel read that weight unpacked, as JAX's do.

    The int8 form (``set_int8``: ``ops/quantize.quantize``,
    ``load_jax_params`` of JAX's ``{w_q, w_scale, x_scale}`` leaves) holds
    the buffers ``w_q`` (int8 OIHW), ``w_scale`` (fp32 ``[O]``) and
    ``x_scale`` (fp32 scalar) in place of ``w`` and computes JAX's chain
    (compile.py:340-376) in the activation dtype: ``q = clip(round(x *
    (1 / x_scale)), -127, 127)`` as int8, the int32 sums of
    ``quantize.int8_conv`` (packed when ``s2d``), then ``y * (x_scale *
    w_scale)``. It has no gradient: a train forward raises, as JAX's
    ``grad`` does on int8 leaves. Under a space axis both forms
    compute their block of output rows from the input rows those read
    (:meth:`rows_read`)."""

    def __init__(self, in_ch, out_ch, k, s, in_hw, s2d: bool = False,
                 name: str = ""):
        pad = k // 2
        super().__init__(
            out_ch, tuple((d + 2 * pad - k) // s + 1 for d in in_hw)
        )
        if s2d:
            if k != 3 or s != 2:
                raise ValueError(
                    f"{name}: Conv(s2d=True) requires kernel_size=3 "
                    f"stride=2, got k={k} s={s}")
            if in_hw[0] % 2 or in_hw[1] % 2:
                raise ValueError(f"{name}: Conv(s2d=True) needs even input "
                                 f"dims, got {tuple(in_hw)}")
        self.k, self.s2d = k, s2d
        self.stride, self.padding = s, pad
        self.in_hw = tuple(in_hw)
        self.name = name
        self.w = nn.Parameter(torch.empty(out_ch, in_ch, k, k))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _kaiming_(self.w, generator)

    @property
    def quantized(self) -> bool:
        return "w_q" in self._buffers

    def set_int8(self, w_q: torch.Tensor, w_scale: torch.Tensor,
                 x_scale: torch.Tensor) -> None:
        """Turn this conv into its int8 form (``w`` goes)."""
        if "w" in self._parameters:
            del self.w
        self.register_buffer("w_q", w_q.to(torch.int8))
        self.register_buffer("w_scale", w_scale.float())
        self.register_buffer("x_scale", x_scale.float().reshape(()))

    def set_float(self, w: torch.Tensor) -> None:
        """Turn an int8 conv back into its float form with weight ``w``."""
        for name in ("w_q", "w_scale", "x_scale"):
            self._buffers.pop(name, None)
        self.w = nn.Parameter(w.float())

    def float_weight(self) -> torch.Tensor:
        """The fp32 OIHW weight: ``w``, or ``w_q * w_scale`` (JAX's
        ``dequantize`` and megakernel build)."""
        if self.quantized:
            return self.w_q.float() * self.w_scale[:, None, None, None]
        return self.w

    def step(self, x, state, ctx):
        space = None if ctx is None else ctx.space
        if self.quantized:
            if ctx is not None and ctx.train:
                raise TypeError(
                    "int8 conv weights (w_q) cannot be trained: grad "
                    "requires real- or complex-valued inputs, but got int8")
            return self._int8_conv(x, space), state
        if ctx is not None and ctx.calibrate:
            ctx.absmax[self] = x.float().abs().amax()
        return self._conv(x, self.w.to(x.dtype), space), state

    def _conv(self, x, w, space=None):
        if space is not None:
            return self._conv_rows(x, w, space)
        if self.s2d:
            return _conv_nhwc(F.pad(s2d_pack_x(x), (0, 0, 1, 0, 1, 0)),
                              s2d_pack_w(w), 1, 0)
        return _conv_nhwc(x, w, self.stride, self.padding)

    def rows_read(self, x, space, s2d=None):
        """The input rows this rank's block of output rows reads, fetched
        from their owners (``halo.fetch_rows``; zeros above and below
        the map): ``[o0 s - p, (o1 - 1) s - p + k)``, which the conv
        takes with padding along W only. ``s2d`` (default: the layer's
        plan; the fused plan reads the unpacked conv's rows): the raw rows
        ``[2 o0 - 1, 2 o1)`` with the zero row of the packed grid's top
        padding above them (it meets the packed kernel's zero tap only),
        so that each packed row holds a row pair. ``x [N, rows, W, C]``."""
        what = f"{self.name}: its input map {self.in_hw}"
        out = space.blocks(self.out_hw[0],
                           f"{self.name}: its output map {self.out_hw}")
        if self.s2d if s2d is None else s2d:
            rows = fetch_rows(x, self.in_hw[0],
                              lambda j: (2 * out[j][0] - 1, 2 * out[j][1]),
                              space, what)
            return F.pad(rows, (0, 0, 0, 0, 1, 0))
        s, p, k = self.stride, self.padding, self.k
        return fetch_rows(
            x, self.in_hw[0],
            lambda j: (out[j][0] * s - p, (out[j][1] - 1) * s - p + k),
            space, what)

    def _conv_rows(self, x, w, space):
        """This rank's block of output rows, from :meth:`rows_read`."""
        rows = self.rows_read(x, space)
        if self.s2d:
            return _conv_nhwc(F.pad(s2d_pack_x(rows), (0, 0, 1, 0)),
                              s2d_pack_w(w), 1, 0)
        return _conv_nhwc(rows, w, self.stride, (0, self.padding))

    def _int8_conv(self, x, space=None):
        """JAX's int8 chain; under a space axis on the rows of
        :meth:`rows_read`, quantized with the same fixed ``x_scale`` (the
        fetched zeros stay zeros), padded along W only."""
        inv = (1.0 / self.x_scale).to(x.dtype)
        if space is not None:
            x = self.rows_read(x, space)
        q = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
        top = 0 if space is not None else 1
        if self.s2d:
            y = quantize.int8_conv(s2d_pack_x(q), s2d_pack_w(self.w_q), 1,
                                   (top, 0, 1, 0))
        else:
            p = self.padding
            ph = 0 if space is not None else p
            y = quantize.int8_conv(q, self.w_q, self.stride, (ph, ph, p, p))
        return y.to(x.dtype) * (self.x_scale * self.w_scale).to(x.dtype)

    def step_unrounded(self, x, space=None):
        """The conv of x's values and the weight rounded to x's dtype,
        summed and kept in fp32: what jitted JAX's per-step train
        forward hands a Norm that follows in bf16 (XLA keeps the sums in
        fp32 in front of the Norm's fp32 cast; with
        ``--xla_allow_excess_precision=false`` it rounds them, as eager
        JAX does). ``space``: this rank's rows, as :meth:`step`."""
        return self._conv(x.float(), self.w.to(x.dtype).float(), space)


def global_moments(x: torch.Tensor, dims, group, n: int):
    """Mean and biased variance of fp32 ``x`` over ``dims`` of the
    global batch of ``group``'s ranks (keepdim), where ``n`` is the
    element count of each moment over every rank (the caller takes it
    from the global shape: blocks of rows need not be equal): the mean
    from the ranks' sums, the variance from their sums of squared
    deviations from it (two passes, as ``jnp.var``). Each rank's fp32
    sums are added in fp64, in rank order after an all-gather
    (``distributed.sum_in_rank_order``), so the moments are the same
    bits on every rank and do not depend on the order a collective adds
    in: a sum of fp32 values in fp64 is exact only while their exponents
    lie close, and a spiking net turns the last bit of a moment into
    flipped spikes. The backward all-reduces the gradients: each rank's
    rows get the gradient of every rank's loss share through the
    moments. Four collectives a call, two forward and two backward."""

    def summed(t):
        return dist.sum_in_rank_order(
            t.sum(dim=tuple(dims), keepdim=True).double(), group).float()

    mean = summed(x) / n
    var = summed((x - mean) ** 2) / n
    return mean, var


class Norm(Layer):
    """BatchNorm.

    Eval: the folded affine ``x * k + b`` applied in the activation
    dtype (compile.py:143-158). JAX runs it under ``jit``, where XLA
    contracts it at fp32 into one fused multiply-add (``neurons.fma``)
    and rounds each of the two ops in bf16, except in front of a cell,
    where the bf16 sum stays fp32 (``step_into_cell``). The fused plan
    hands the same fp32 ``(k, b)`` to ``spiking_conv_seq``.

    Train (compile.py:408-468): per-step batch statistics over (B, H,
    W) in fp32, ``y = (x - mean) * rsqrt(var + eps) * scale (+ bias)``
    rounded once to x's dtype. The running statistics fold in the
    unbiased variance with ``momentum``, once per active step; they
    travel as the layer's state (``(mean, var)``; ``()`` means the
    buffers), so a checkpointed recompute cannot fold them twice.
    """

    def __init__(self, ch, hw, bias: bool, eps: float,
                 momentum: float = 0.1):
        super().__init__(ch, hw)
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(ch))
        if bias:
            self.bias = nn.Parameter(torch.zeros(ch))
        else:
            self.bias = None
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def coeffs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The folded fp32 ``(k, b)`` of ``y = x * k + b``
        (``_bn_eval_coeffs``), for this layer and the fused plan."""
        k = torch.rsqrt(self.var + self.eps) * self.scale
        b = -self.mean * k
        if self.bias is not None:
            b = b + self.bias
        return k, b

    def _fold(self, running, mean, unbiased):
        m = self.momentum
        mean0, var0 = running if running else (self.mean, self.var)
        return ((1 - m) * mean0 + m * mean, (1 - m) * var0 + m * unbiased)

    def _normalize(self, x, mean, var, dtype=None):
        y = (x.float() - mean) * torch.rsqrt(var + self.eps) * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(dtype or x.dtype)

    @staticmethod
    def _moments(x, dims, group, n):
        """Mean and biased variance over ``dims`` of fp32 ``x`` (keepdim),
        ``n`` elements each: over the global batch of ``group``'s ranks
        (``ctx.batch_group``), else over this batch."""
        if group is not None:
            return global_moments(x, dims, group, n)
        var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
        return mean, var

    def _count(self, x, dims, ctx):
        """The group over which a train forward takes its moments, and
        the element count of each moment over it: the rows of this
        layer's global map under a space axis (its blocks can differ by
        a row), times the data blocks of the group."""
        group, space = ctx.batch_group, ctx.space
        if group is None and space is not None:
            group = space.group
        n = 1
        for d in dims:
            n *= x.shape[d]
        if space is not None:
            n = n // x.shape[dims[1]] * self.out_hw[0]
        if group is not None:
            n *= dist.world_size(group) // (1 if space is None
                                            else space.size)
        return group, n

    @staticmethod
    def _unbiased(n, var):
        return var.detach().flatten() * (n / max(n - 1, 1))

    def step(self, x, state, ctx, dtype=None):
        """``dtype``: train mode's output dtype, if not x's."""
        if ctx is not None and ctx.train:
            # batch mean and biased variance over (B, H, W), in fp32
            group, n = self._count(x, (0, 1, 2), ctx)
            mean, var = self._moments(x.float(), (0, 1, 2), group, n)
            return self._normalize(x, mean, var, dtype), self._fold(
                state, mean.detach().flatten(), self._unbiased(n, var))
        k, b = self.coeffs()
        if x.dtype == torch.float32:
            return neurons.fma(x, k, b), state
        return x * k.to(x.dtype) + b.to(x.dtype), state

    def seq(self, X, state, ctx):
        if not ctx.train:
            return super().seq(X, state, ctx)
        # every step's moments in one batched reduction, as JAX's
        # apply_seq: the same values as the step form's, summed in
        # another order
        group, n = self._count(X, (1, 2, 3), ctx)
        mean, var = self._moments(X.float(), (1, 2, 3), group, n)
        for t, keep in enumerate(ctx.step_mask(X.shape[0])):
            if keep:
                state = self._fold(state, mean[t].detach().flatten(),
                                   self._unbiased(n, var[t]))
        return self._normalize(X, mean, var), state

    def step_into_cell(self, x):
        """The eval affine as jitted JAX feeds it to a cell that follows
        directly: in bf16 the product ``x * k`` is rounded to bf16 but
        the sum with the bf16 ``b`` reaches the cell in fp32 (XLA drops
        the round trip in front of the cell's fp32 cast). fp32 as
        ``step``."""
        if x.dtype == torch.float32:
            return self.step(x, (), None)[0]
        k, b = self.coeffs()
        return (x * k.to(x.dtype)).float() + b.to(x.dtype).float()


def commit_norm_stats(block: "Block", state):
    """Write the running statistics a train forward left in ``state``
    into each Norm's buffers; returns ``state`` with those entries
    back to ``()``."""
    out = {}
    for bi, branch in enumerate(block._branches()):
        st_b = dict(state[f"b{bi}"])
        for name, layer in branch.items():
            if isinstance(layer, Norm) and st_b[name]:
                with torch.no_grad():
                    layer.mean.copy_(st_b[name][0])
                    layer.var.copy_(st_b[name][1])
                st_b[name] = ()
            elif isinstance(layer, Block):
                st_b[name] = commit_norm_stats(layer, st_b[name])
        out[f"b{bi}"] = st_b
    return out


def _recording(layer, ctx) -> bool:
    return layer.record and ctx is not None and ctx.record


def _record_step(layer, x, state, ctx, step):
    """A cell's step that records: ``step(x, state) -> (out, new)`` on
    the input widened to fp32, so ``out`` is the cell's fp32 output, as
    JAX records it; the layer's output is ``out`` in x's dtype."""
    out, new = step(x.float(), state)
    ctx.records[layer.name] = (new, out)
    return out.to(x.dtype), new


def _record_seq(layer, X, state, ctx, step):
    """A cell's sequence form when it records (JAX's ``_cell_apply_seq``,
    which then runs a ``lax.scan``): ``step(x_t, state) -> (out, new)``
    a step at a time, the state held for ``t < ctx.start_step``; the
    record is every step's (held) state and output, stacked."""
    outs, states = [], []
    for t, keep in enumerate(ctx.step_mask(X.shape[0])):
        out, new = step(X[t], state)
        if keep:
            state = new
        outs.append(out)
        states.append(state)
    out_seq = torch.stack(outs)
    ctx.records[layer.name] = (
        type(state)(*(torch.stack(f) for f in zip(*states))), out_seq)
    return out_seq, state


class Cell(Layer):
    """LIF or LI layer. Both forms go through ``temporal_cell_seq``
    (the step form with T = 1), so on the card no plain cell math runs;
    a recording sequence call runs it a step at a time."""

    closes_segment = True

    def __init__(self, kind: str, ch, hw, state_dtype, record: bool = False,
                 name: str = ""):
        super().__init__(ch, hw)
        self.kind = kind
        self.state_dtype = state_dtype
        self.record, self.name = record, name

    def init_state(self, batch, device, space=None):
        init = neurons.lif_init if self.kind == "lif" else neurons.li_init
        return init(self.local_shape(batch, self.out_channels, space),
                    dtype=self.state_dtype, device=device)

    def _step(self, x, state):
        z, v, i = temporal_cell_seq(x[None], state.v, state.i, self.kind)
        return z[0], type(state)(v, i)

    def step(self, x, state, ctx):
        if _recording(self, ctx):
            return _record_step(self, x, state, ctx, self._step)
        return self._step(x, state)

    def seq(self, X, state, ctx):
        if _recording(self, ctx):
            return _record_seq(self, X, state, ctx, self._step)
        z, v, i = temporal_cell_seq(
            X, state.v, state.i, self.kind, start=ctx.start_step
        )
        return z, type(state)(v, i)


class PLIF(Layer):
    """Parametric LIF (compile.py:570-601): LIF with learnable per-channel
    time constants, the parameters ``raw_tau_syn`` and ``raw_tau_mem``
    (``[C]``, softplus of each is the inverse time constant). Both forms
    go through ``plif_cell_seq`` with the factors ``dt * softplus(raw)``
    (the step form with T = 1), so on the card no plain cell math runs;
    autograd carries the factors' gradients back to the raw parameters.
    Not fused into ``spiking_conv_seq`` (JAX's fused plan takes LIF/LI
    only)."""

    closes_segment = True

    def __init__(self, ch, hw, state_dtype, record: bool = False,
                 name: str = ""):
        super().__init__(ch, hw)
        self.state_dtype = state_dtype
        self.record, self.name = record, name
        init = neurons.plif_params_init(ch)
        self.raw_tau_syn = nn.Parameter(init.raw_tau_syn)
        self.raw_tau_mem = nn.Parameter(init.raw_tau_mem)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init = neurons.plif_params_init(self.out_channels)
        with torch.no_grad():
            self.raw_tau_syn.copy_(init.raw_tau_syn)
            self.raw_tau_mem.copy_(init.raw_tau_mem)

    def init_state(self, batch, device, space=None):
        return neurons.lif_init(
            self.local_shape(batch, self.out_channels, space),
            dtype=self.state_dtype, device=device)

    def factors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return neurons.plif_factors(
            neurons.PLIFParams(self.raw_tau_syn, self.raw_tau_mem))

    def _step(self, x, state):
        z, v, i = plif_cell_seq(x[None], state.v, state.i, *self.factors())
        return z[0], neurons.LIFState(v, i)

    def step(self, x, state, ctx):
        if _recording(self, ctx):
            return _record_step(self, x, state, ctx, self._step)
        return self._step(x, state)

    def seq(self, X, state, ctx):
        if _recording(self, ctx):
            return _record_seq(self, X, state, ctx, self._step)
        z, v, i = plif_cell_seq(X, state.v, state.i, *self.factors(),
                                start=ctx.start_step)
        return z, neurons.LIFState(v, i)


class PlainCell(Layer):
    """ALIF, SLI or Synapse (compile.py:603-678): the cell's step in fp32
    on the state widened from its dtype, the new state rounded back to
    it and the output to the input's dtype. The sequence form is a loop
    over T with the state frozen for ``t < ctx.start_step`` (JAX's
    ``_cell_apply_seq`` scan, ``_masked_state``); the state is carried
    in its dtype, so autograd rounds its cotangent there, as JAX's
    ``astype`` pair does. Plain PyTorch on the card too: JAX runs these
    cells as ``lax.scan``, which no Pallas kernel replaces."""

    closes_segment = True

    def __init__(self, ch, hw, state_dtype, init: Callable,
                 step_fn: Callable, record: bool = False, name: str = ""):
        super().__init__(ch, hw)
        self.state_dtype = state_dtype
        self._init, self._step_fn = init, step_fn
        self.record, self.name = record, name

    def init_state(self, batch, device, space=None):
        return self._init(self.local_shape(batch, self.out_channels, space),
                          dtype=self.state_dtype, device=device)

    def _step(self, x, state):
        out, new = self._step_fn(x.float(), type(state)(
            *(neurons.from_state(a) for a in state)))
        return out.to(x.dtype), type(state)(
            *(neurons.to_state(a, self.state_dtype) for a in new))

    def step(self, x, state, ctx):
        if _recording(self, ctx):
            return _record_step(self, x, state, ctx, self._step)
        return self._step(x, state)

    def seq(self, X, state, ctx):
        if _recording(self, ctx):
            return _record_seq(self, X, state, ctx, self._step)
        return _step_loop(self, X, state, ctx)


def _step_loop(layer, X, state, ctx):
    """A stateful layer's sequence form as a loop of its step, the state
    held for ``t < ctx.start_step`` (the output still emitted)."""
    outs = []
    for t, keep in enumerate(ctx.step_mask(X.shape[0])):
        out, new = layer.step(X[t], state, ctx)
        outs.append(out)
        if keep:
            state = new
    return torch.stack(outs), state


class ConvLSTM(Layer):
    """Convolutional LSTM (compile.py:680-737): the conv of ``[x, h]``
    with same padding gives the gates i, f, o, g in fp32;
    ``c' = sigmoid(f) c + sigmoid(i) tanh(g)``, ``h' = sigmoid(o)
    tanh(c')``; the output is h' in the input's dtype and (h', c') is
    the state in its dtype. The conv runs in the activation dtype (full
    fp32 at fp32); the weight ``w`` is OIHW ``[4 hidden, in + hidden, k,
    k]``. The sequence form loops over T (the conv reads the carried h),
    the state frozen for ``t < ctx.start_step``. Under a space axis each
    step fetches the halo rows of ``[x, h]`` (h is a block of rows, as
    every state) and convolves with padding along W only."""

    closes_segment = True

    def __init__(self, in_ch, hidden, k, hw, state_dtype):
        super().__init__(hidden, hw)
        self.hidden, self.padding = hidden, k // 2
        self.state_dtype = state_dtype
        self.w = nn.Parameter(torch.empty(4 * hidden, in_ch + hidden, k, k))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _kaiming_(self.w, generator)

    def init_state(self, batch, device, space=None):
        shape = self.local_shape(batch, self.hidden, space)
        return (torch.zeros(shape, dtype=self.state_dtype, device=device),
                torch.zeros(shape, dtype=self.state_dtype, device=device))

    def step(self, x, state, ctx):
        h_prev, c_prev = state
        combined = torch.cat([x, neurons.from_state(h_prev).to(x.dtype)],
                             dim=-1)
        space, p = None if ctx is None else ctx.space, self.padding
        if space is None:
            gates = _conv_nhwc(combined, self.w.to(x.dtype), 1, p)
        else:
            rows = space.blocks(self.out_hw[0],
                                f"{self.name}: its output map")
            combined = fetch_rows(
                combined, self.out_hw[0],
                lambda j: (rows[j][0] - p, rows[j][1] + p), space,
                f"{self.name}: its input map")
            gates = _conv_nhwc(combined, self.w.to(x.dtype), 1, (0, p))
        gates = gates.float()
        i_g, f_g, o_g, g_g = gates.split(self.hidden, dim=-1)
        c_new = neurons.fma(torch.sigmoid(f_g), neurons.from_state(c_prev),
                            torch.sigmoid(i_g) * torch.tanh(g_g))
        h_new = torch.sigmoid(o_g) * torch.tanh(c_new)
        sd = self.state_dtype
        return h_new.to(x.dtype), (neurons.to_state(h_new, sd),
                                   neurons.to_state(c_new, sd))

    def seq(self, X, state, ctx):
        return _step_loop(self, X, state, ctx)


def _plain_cell(layer, in_ch, in_hw, state_dtype, name) -> PlainCell:
    if isinstance(layer, S.ALIF):
        p = neurons.ALIFParams(beta=layer.beta,
                               tau_adapt_inv=layer.tau_adapt_inv)
        init = lambda shape, dtype, device: neurons.alif_init(  # noqa: E731
            shape, dtype, device, p)
        step = lambda x, st: neurons.alif_step(x, st, p)  # noqa: E731
    elif isinstance(layer, S.SLI):
        init, step = neurons.sli_init, neurons.sli_step
    else:
        p = neurons.SynapseParams(sigma_inhibition=layer.sigma_inhibition)
        init = lambda shape, dtype, device: neurons.synapse_init(  # noqa: E731
            shape, dtype, device, p)
        step = lambda x, st: neurons.synapse_step(x, st, p)  # noqa: E731
    return PlainCell(in_ch, in_hw, state_dtype, init, step,
                     getattr(layer, "state_storage", False), name)


def _compile_leaf(layer: S.LayerSpec, in_ch: int, in_hw, state_dtype,
                  name: str = ""):
    if isinstance(layer, S.Pass):
        return Pass(in_ch, in_hw)
    if isinstance(layer, S.Tanh):
        return Tanh(in_ch, in_hw)
    if isinstance(layer, S.ReLU):
        return ReLU(in_ch, in_hw)
    if isinstance(layer, S.SiLU):
        return SiLU(in_ch, in_hw)
    if isinstance(layer, S.Pool):
        k = layer.kernel_size
        s = layer.stride if layer.stride is not None else k
        if s != k:
            return StridedPool(in_ch, in_hw, k, s, layer.type)
        return Pool(in_ch, in_hw, k, layer.type)
    if isinstance(layer, S.Up):
        if layer.mode == "nearest":
            return Up(in_ch, in_hw, layer.scale)
        if layer.mode in ("linear", "bilinear", "trilinear", "bicubic"):
            return Resize(in_ch, in_hw, layer.scale, layer.mode)
        raise NotImplementedError(f"Up mode {layer.mode!r}")
    if isinstance(layer, S.Return):
        return Return(in_ch, in_hw)
    if isinstance(layer, S.Conv):
        out = in_ch if layer.out_channels is None else layer.out_channels
        return Conv(in_ch, out, layer.kernel_size, layer.stride, in_hw,
                    layer.s2d, name)
    if isinstance(layer, S.Norm):
        return Norm(in_ch, in_hw, layer.bias, layer.eps, layer.momentum)
    if isinstance(layer, (S.LIF, S.LI)):
        kind = "lif" if isinstance(layer, S.LIF) else "li"
        return Cell(kind, in_ch, in_hw, state_dtype, layer.state_storage,
                    name)
    if isinstance(layer, S.PLIF):
        return PLIF(in_ch, in_hw, state_dtype, layer.state_storage, name)
    if isinstance(layer, (S.ALIF, S.SLI, S.Synapse)):
        return _plain_cell(layer, in_ch, in_hw, state_dtype, name)
    if isinstance(layer, S.LSTM):
        hidden = in_ch if layer.hidden_size is None else layer.hidden_size
        return ConvLSTM(in_ch, hidden, layer.kernel_size, in_hw,
                        state_dtype)
    raise TypeError(f"Unknown layer spec: {layer!r}")


def _fused_groups(layers: List[Layer]) -> List[int]:
    """Start indices of the ``[Conv k x k (k in {1, 3}, stride in {1,
    2}) -> Norm -> LIF/LI]`` triples of a branch that the fused plan
    runs as one ``spiking_conv_seq`` call (JAX ``_fused_groups``)."""
    starts, li = [], 0
    while li + 2 < len(layers):
        conv, norm, cell = layers[li:li + 3]
        if (isinstance(conv, Conv) and conv.k in (1, 3)
                and conv.stride in (1, 2) and isinstance(norm, Norm)
                and isinstance(cell, Cell)):
            starts.append(li)
            li += 3
        else:
            li += 1
    return starts


# cells that widen their input to fp32 first: jitted JAX hands them an
# eval Norm's sum in fp32 on the step path (Norm.step_into_cell)
_FP32_INPUT_CELLS = (Cell, PLIF, PlainCell)
# the leaves that carry state from step to step
STATEFUL_LAYERS = _FP32_INPUT_CELLS + (ConvLSTM,)


class Block(Layer):
    """A config list: one sequential branch, or ``Residual`` (branch
    outputs summed) / ``Dense`` (concatenated on the channel axis)
    branches. Branch ``bi`` is the child ``b{bi}``; its layer ``li`` is
    ``b{bi}.l{li}``."""

    closes_segment = True

    def __init__(self, cfgs, in_ch, in_hw, returns=None,
                 state_dtype=torch.float32, name: str = ""):
        if isinstance(cfgs, S.Residual):
            mode, branch_cfgs = "residual", list(cfgs)
        elif isinstance(cfgs, S.Dense):
            mode, branch_cfgs = "dense", list(cfgs)
        else:
            mode, branch_cfgs = "plain", [list(cfgs)]
        branches = []
        out_channels, out_hw = 0, None
        for bi, branch_cfg in enumerate(branch_cfgs):
            layers = []
            ch, hw = in_ch, tuple(in_hw)
            for li, element in enumerate(branch_cfg):
                lname = f"{name}/b{bi}/l{li}" if name else f"b{bi}/l{li}"
                if isinstance(element, S.LayerSpec):
                    layer = _compile_leaf(element, ch, hw, state_dtype, lname)
                    if isinstance(element, S.Return) and returns is not None:
                        returns.append((ch, hw))
                elif isinstance(element, (list, tuple)):
                    layer = Block(element, ch, hw, returns, state_dtype,
                                  lname)
                else:
                    raise TypeError(f"Bad config element: {element!r}")
                if not layer.name:
                    layer.name = lname
                layers.append(layer)
                ch, hw = layer.out_channels, layer.out_hw
            if mode == "residual" and out_channels and out_channels != ch:
                raise ValueError(
                    f"Residual branch channel mismatch: {out_channels} vs {ch}"
                )
            if mode != "plain" and out_hw is not None and out_hw != hw:
                raise ValueError(f"Branch spatial mismatch: {out_hw} vs {hw}")
            out_channels = out_channels + ch if mode == "dense" else ch
            out_hw = hw
            branches.append(layers)
        super().__init__(out_channels, out_hw)
        self.mode = mode
        for bi, layers in enumerate(branches):
            self.add_module(f"b{bi}", nn.ModuleDict(
                {f"l{li}": layer for li, layer in enumerate(layers)}
            ))
        self.num_branches = len(branches)
        self.fused_plan = [_fused_groups(layers) for layers in branches]
        self.segment_plan = [_segment_plan(layers) for layers in branches]
        self.has_tap = any(layer.has_tap for layers in branches
                           for layer in layers)

    def _branches(self):
        return [getattr(self, f"b{bi}") for bi in range(self.num_branches)]

    def init_state(self, batch, device, space=None):
        return {
            f"b{bi}": {
                name: layer.init_state(batch, device, space)
                for name, layer in branch.items()
            }
            for bi, branch in enumerate(self._branches())
        }

    def _run(self, x, state, ctx, seq: bool):
        fuse = seq and ctx.fuse and ctx.start_step == 0 and not ctx.train
        outs, new_state = [], {}
        for bi, branch in enumerate(self._branches()):
            y, st_b, new_b = x, state[f"b{bi}"], {}
            layers = list(branch.values())
            if seq and ctx.remat:
                outs.append(self._run_segments(
                    layers, self.segment_plan[bi], y, st_b, new_b, ctx))
                new_state[f"b{bi}"] = new_b
                continue
            fused = self.fused_plan[bi] if fuse else []
            li = 0
            while li < len(layers):
                # an int8 conv or a recording cell takes its triple off the
                # fused plan, as in JAX's _make_apply
                if li in fused and not layers[li].quantized and not (
                        ctx.record and layers[li + 2].record):
                    y = self._run_fused(layers[li:li + 3], li, y, st_b,
                                        new_b, ctx.space)
                    li += 3
                    continue
                if (not seq and ctx.train and y.dtype != torch.float32
                        and isinstance(layers[li], Conv)
                        and not layers[li].quantized
                        and li + 1 < len(layers)
                        and isinstance(layers[li + 1], Norm)):
                    # [Conv -> Norm] of a train step in bf16: the Norm
                    # reads the conv's fp32 sums and rounds its output,
                    # as in jitted JAX (Conv.step_unrounded)
                    new_b[f"l{li}"] = st_b[f"l{li}"]
                    y, new_b[f"l{li + 1}"] = layers[li + 1].step(
                        layers[li].step_unrounded(y, ctx.space),
                        st_b[f"l{li + 1}"], ctx, y.dtype)
                    li += 2
                    continue
                if (not seq and not ctx.train and isinstance(layers[li], Norm)
                        and li + 1 < len(layers)
                        and isinstance(layers[li + 1], _FP32_INPUT_CELLS)):
                    # [Norm -> cell] of a step: the cell takes the fp32
                    # sum and its output is rounded once, as in JAX
                    dtype = y.dtype
                    new_b[f"l{li}"] = st_b[f"l{li}"]
                    y, new_b[f"l{li + 1}"] = layers[li + 1].step(
                        layers[li].step_into_cell(y), st_b[f"l{li + 1}"], ctx)
                    y = y.to(dtype)
                    li += 2
                    continue
                fn = layers[li].seq if seq else layers[li].step
                y, new_b[f"l{li}"] = fn(y, st_b[f"l{li}"], ctx)
                li += 1
            outs.append(y)
            new_state[f"b{bi}"] = new_b
        if self.mode == "residual":
            y = outs[0]
            for o in outs[1:]:
                y = y + o
        elif self.mode == "dense":
            y = torch.cat(outs, dim=-1)
        else:
            y = outs[0]
        return y, new_state

    @staticmethod
    def _run_segments(layers, plan, y, st_b, new_b, ctx):
        """A branch of a sequence call as checkpointed segments (JAX
        ``_apply_branch_remat``): each segment's layers run again in the
        backward instead of keeping their activations. Layers with a tap
        run bare, outside any segment: a recompute would append their
        taps again. Inside a segment nested blocks do not checkpoint
        again (one recompute per layer)."""
        inner = dataclasses.replace(ctx, remat=False)
        for bare, idxs in plan:
            if bare:
                li = idxs[0]
                y, new_b[f"l{li}"] = layers[li].seq(y, st_b[f"l{li}"], ctx)
                continue

            def run(y, states, idxs=idxs):
                out = []
                for li, st in zip(idxs, states):
                    y, st = layers[li].seq(y, st, inner)
                    out.append(st)
                return y, out

            y, states = checkpoint(run, y, [st_b[f"l{li}"] for li in idxs],
                                   use_reentrant=False)
            for li, st in zip(idxs, states):
                new_b[f"l{li}"] = st
        return y

    @staticmethod
    def _run_fused(triple, li, X, st_b, new_b, space=None):
        """One fused ``[Conv -> Norm -> cell]`` over the sequence ``X``
        (JAX ``_run_fused``): the Conv and Norm states pass through and
        the cell state comes from the kernel. Under a space axis the
        rows of this rank's output block are fetched once for the whole
        ``[T N]`` sequence (``Conv.rows_read``) and the kernel runs its
        fetched-rows form, ``pad_h=0``."""
        conv, norm, cell = triple
        a, b = norm.coeffs()
        st = st_b[f"l{li + 2}"]
        rows = {}
        if space is not None:
            T, N = X.shape[:2]
            X = conv.rows_read(X.reshape((T * N,) + X.shape[2:]), space,
                               s2d=False)
            X = X.reshape((T, N) + X.shape[1:]).contiguous()
            rows = {"pad_h": 0}
        # the unpacked weight and stride, an s2d conv's too (JAX's meta)
        z, v, i = spiking_conv_seq(
            X, conv.w.permute(2, 3, 1, 0), a, b, st.v, st.i,
            cell.kind, conv.stride, **rows,
        )
        new_b[f"l{li}"] = st_b[f"l{li}"]
        new_b[f"l{li + 1}"] = st_b[f"l{li + 1}"]
        new_b[f"l{li + 2}"] = type(st)(v, i)
        return z

    def step(self, x, state, ctx):
        return self._run(x, state, ctx, seq=False)

    def seq(self, X, state, ctx):
        return self._run(X, state, ctx, seq=True)


def _segment_plan(layers: List[Layer]) -> List[Tuple[bool, List[int]]]:
    """``(bare, layer indices)`` runs of a branch for sequence-mode
    remat (JAX ``_segment_plan``): a segment closes after each cell or
    nested block (JAX's closes after LIF/LI only, not after the other
    cells: the recompute gives the same values either way, and shorter
    segments hold less at once); a layer with a tap runs bare."""
    plan, cur = [], []
    for li, layer in enumerate(layers):
        if layer.has_tap:
            if cur:
                plan.append((False, cur))
                cur = []
            plan.append((True, [li]))
            continue
        cur.append(li)
        if layer.closes_segment:
            plan.append((False, cur))
            cur = []
    if cur:
        plan.append((False, cur))
    return plan


def compile_block(cfgs, in_ch: int, in_hw, returns: Optional[list] = None,
                  state_dtype=torch.float32, name: str = "") -> Block:
    """Compile a config list into a :class:`Block`. ``Return`` leaf
    ``(channels, hw)`` pairs are appended to ``returns`` in config
    order. ``name`` prefixes the layers' names (JAX's: ``backbone/b0/l2``
    for a leaf of the block named ``backbone``), which recording uses."""
    return Block(cfgs, in_ch, in_hw, returns, state_dtype, name)
