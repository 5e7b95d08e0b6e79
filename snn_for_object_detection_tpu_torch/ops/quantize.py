"""Post-training int8 quantization for the inference path.

Counterpart of ``snn_for_object_detection_tpu/ops/quantize.py``: conv
weights go to per-output-channel symmetric int8, conv inputs to a
per-tensor symmetric int8 scale from a short calibration run, and every
quantized conv sums int8 x int8 products in int32 (:func:`int8_conv`)
before it scales back (the Conv leaf's int8 form, ``models/compile.py``).
BatchNorm, the cells and the decode stay in floating point. Usage::

    absmax = calibrate(model, frames)    # {("backbone", "b0", "l0"): a}
    qmodel = quantize(model, absmax)     # a new model, int8 convs
    qmodel.forward_seq(X)

The keys are JAX's parameter paths, so the dicts of the two packages
compare key by key, and ``load_jax_params`` takes JAX's quantized
``{"w_q", "w_scale", "x_scale"}`` leaves. As in JAX, the fused schedule
runs a quantized conv's triple layer by layer, the megakernel
dequantizes at build time, and training raises.

JAX computes the int8 conv in XLA, outside any Pallas kernel, so on the
card :func:`int8_conv` is a library call: an im2col of the int8 input and
``torch._int_mm`` (cuBLASLt's int8 product, int32 sums, exact). Its plain
version, on the CPU, is the same conv in float64 on the int values,
exact for every depth up to 2**53 / 127**2 products.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, Tuple

import torch
import torch.nn.functional as F

# calls of int8_conv since the last reset, by route: "int_mm" on the card,
# "plain" on the CPU
CALLS: Dict[str, int] = {"int_mm": 0, "plain": 0}


def int8_conv_reference(x: torch.Tensor, w: torch.Tensor, stride: int,
                        pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """Plain version of :func:`int8_conv`: the conv of the int values in
    float64 (every sum exact), as int32."""
    xd = F.pad(x.double(), (0, 0, pads[2], pads[3], pads[0], pads[1]))
    y = F.conv2d(xd.permute(0, 3, 1, 2), w.double(), stride=stride)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
              pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """The int32 sums of an int8 conv: ``x`` NHWC int8, ``w`` OIHW int8,
    zero padding ``pads = (top, bottom, left, right)``; NHWC int32 out.

    On a CPU tensor this is :func:`int8_conv_reference`. On a CUDA
    tensor: the k x k taps of the padded input side by side (an im2col,
    ``[N*Ho*Wo, k*k*C]``) times the weight as ``[k*k*C, O]`` in one
    ``torch._int_mm``, with K and O padded with zeros to multiples of 8
    and at least 17 rows, as cuBLASLt's int8 product takes them. No
    fallback: a failure raises."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 tensors, not {x.dtype}, "
                        f"{w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] != x.shape[3]:
        raise ValueError(f"x {tuple(x.shape)} NHWC, w {tuple(w.shape)} OIHW")
    if x.device.type == "cpu":
        CALLS["plain"] += 1
        return int8_conv_reference(x, w, stride, pads)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, _, _, c = x.shape
    o, _, kh, kw = w.shape
    xp = F.pad(x, (0, 0, pads[2], pads[3], pads[0], pads[1]))
    ho = (xp.shape[1] - kh) // stride + 1
    wo = (xp.shape[2] - kw) // stride + 1
    cols = [xp[:, di:di + (ho - 1) * stride + 1:stride,
               dj:dj + (wo - 1) * stride + 1:stride]
            for di in range(kh) for dj in range(kw)]
    k = kh * kw * c
    kp, op = _round_up(k, 8), _round_up(o, 8)
    if kp > k:
        cols.append(x.new_zeros((n, ho, wo, kp - k)))
    a = torch.cat(cols, dim=-1).reshape(n * ho * wo, kp)
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros((17 - m, kp))])
    # the weight as [O, K] rows in the im2col's (di, dj, c) order, padded;
    # handed over column-major, as cuBLASLt takes the second operand
    b = F.pad(w.permute(0, 2, 3, 1).reshape(o, k), (0, kp - k, 0, op - o))
    y = torch._int_mm(a, b.contiguous().t())
    CALLS["int_mm"] += 1
    return y[:m, :o].reshape(n, ho, wo, o)


def calibrate(model, sequences: Iterable[Any],
              max_batches: int | None = None) -> Dict[Tuple, float]:
    """Run eval steps with the ``calibrate`` flag and collect every
    float conv's input absmax, a running max over batches and steps:
    ``{JAX params path: absmax}`` (JAX ``calibrate``). ``sequences``
    yields ``[T, B, H, W, C]`` frames (tensors or arrays), or is one."""
    from snn_for_object_detection_tpu_torch.models import compile as C

    if hasattr(sequences, "ndim"):
        sequences = [sequences]
    paths = {m: tuple(name.split(".")) for name, m in model.named_modules()
             if isinstance(m, C.Conv)}
    ranges: Dict[Tuple, float] = {}
    for bi, X in enumerate(sequences):
        if max_batches is not None and bi >= max_batches:
            break
        X = torch.as_tensor(X, device=model.device)
        state = model.init_state(X.shape[1])
        for t in range(X.shape[0]):
            ctx = C.Ctx(calibrate=True)
            _, state = model.step(X[t], state, ctx)
            for conv, amax in ctx.absmax.items():
                path = paths[conv]
                ranges[path] = max(ranges.get(path, 0.0), float(amax))
    return ranges


def quantize(model, absmax: Dict[Tuple, float]):
    """A copy of ``model`` whose every calibrated conv is int8 (JAX
    ``quantize``): ``w_scale = max(|w| over (Cin, k, k), 1e-12) / 127``
    a channel, ``w_q = clip(round(w / w_scale), -127, 127)``, ``x_scale =
    max(absmax, 1e-12) / 127``. A conv whose absmax is 0 (its input never
    spiked in the calibration window) or that was not calibrated stays in
    floating point."""
    from snn_for_object_detection_tpu_torch.models import compile as C

    qmodel = copy.deepcopy(model)
    for name, m in qmodel.named_modules():
        amax = absmax.get(tuple(name.split(".")), 0.0)
        if isinstance(m, C.Conv) and not m.quantized and amax > 0.0:
            with torch.no_grad():
                w = m.w.detach().float()
                w_scale = torch.clamp(w.abs().amax(dim=(1, 2, 3)),
                                      min=1e-12) / 127.0
                w_q = torch.clamp(torch.round(w / w_scale[:, None, None, None]),
                                  -127, 127).to(torch.int8)
            x_scale = torch.tensor(max(amax, 1e-12) / 127.0,
                                   dtype=torch.float32, device=w.device)
            m.set_int8(w_q, w_scale, x_scale)
    return qmodel


def dequantize(model):
    """A copy of ``model`` with every int8 conv back in floating point,
    ``w = w_q * w_scale`` (JAX ``dequantize``)."""
    from snn_for_object_detection_tpu_torch.models import compile as C

    fmodel = copy.deepcopy(model)
    for m in fmodel.modules():
        if isinstance(m, C.Conv) and m.quantized:
            m.set_float(m.float_weight().detach())
    return fmodel
