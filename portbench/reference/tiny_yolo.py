"""Plain PyTorch reference of TinyYolo: the forward, one frame at a time.

Independent of the measured program: it imports torch alone. The net is
the frozen spec of TinyYolo (KirillHit/snn_for_object_detection,
models/tiny_yolo.py: five stride-2 stages of (channels, depth) 64/2,
128/3 in the backbone and 256/4, 256/3, 256/2 in the neck, each neck
stage tapped; a shared-stem head per tap, Conv 1x1 -> BatchNorm -> LI ->
Tanh, then bare 1x1 box and class convs), written out here as nested
tuples so that later changes to the program's spec cannot move it.

Semantics (norse's cells, Euler steps of dt = 1e-3):

- Conv: bias-free, padding k // 2, fp32 with TF32 off (``tf32=True``
  rounds both operands to TF32's 10-bit mantissa first: the control of
  the comparison).
- BatchNorm: in eval ``x * k + b`` with ``k = scale / sqrt(var + eps)``,
  ``b = -mean * k``, one fused multiply-add; in training the step's own
  batch moments over (B, H, W), ``(x - mean) / sqrt(var + eps) * scale``.
- LIF: decay ``v += 0.1 * ((0 - v) + i)``, ``i -= 0.2 * i`` (each one
  fused multiply-add), spike ``v > 1`` with the SuperSpike surrogate
  (alpha 100) backward, reset to 0 with no gradient through the spike,
  then ``i += x``.
- LI: ``i += x`` first, then ``v += 0.1 * ((0 - v) + i)``, ``i -= 0.2 *
  i``; the output is ``v``.
- Residual sums its branches, Dense concatenates them on channels.

Activations are NHWC ``[B, H, W, C]``; weights OIHW.

Two schedules compute the same function: :func:`step` one frame at a
time, and :func:`seq` the whole sequence ``[T, B, H, W, C]`` at once,
each conv over the ``T * B`` frames folded into one batch, each training
BatchNorm's moments of all steps in one reduction, and each cell a loop
over the steps with its state held for the frames before the truncation
start (their output still emitted from the held state). On an untrained
net at BatchNorm gain 8 any change in the order of a conv's or a
moment's sums flips spikes, and flipped spikes carry through the
sequence; so the reference sums in the order of the schedule it checks,
:func:`seq` for the time-batched steps and :func:`step` for the
streaming engine.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-5
# dt * tau_mem_inv and dt * tau_syn_inv, each rounded once to fp32
C_MEM = float(torch.tensor(1e-3 * 100.0, dtype=torch.float32))
C_SYN = float(torch.tensor(1e-3 * 200.0, dtype=torch.float32))
V_TH = 1.0
ALPHA = 100.0


# ---- the frozen spec ----

def _conv(out=None, k=1, s=1):
    return ("conv", out, k, s)


_NORM, _LIF, _LI, _TANH, _PASS, _TAP = (("norm",), ("lif",), ("li",),
                                        ("tanh",), ("pass",), ("tap",))


def _spiking_conv(ch=None, k=3, s=1):
    return [_conv(ch, k, s), _NORM, _LIF]


def _csp_block(ch, depth):
    half = ch // 2
    chain = []
    for _ in range(depth):
        unit = ("residual", [_spiking_conv(), [_PASS]])
        chain = [("dense", [[unit] + chain, [_PASS]])]
    return [_conv(ch, 1), ("dense", [[_conv(half, 1), *chain],
                                     [_conv(half, 1)]]), _conv(ch, 1)]


def _stage(ch, depth, tap=False):
    return [*_spiking_conv(ch, 3, 2), *_csp_block(ch, depth)] + (
        [_TAP] if tap else [])


BACKBONE = [*_stage(64, 2), *_stage(128, 3)]
NECK = [*_stage(256, 4, True), *_stage(256, 3, True), *_stage(256, 2, True)]
HEAD_STEM = [_conv(None, 1), _NORM, _LI, _TANH]
ANCHORS_PER_PIXEL = 9  # 3 sizes x 3 ratios


# ---- shape inference: the spec compiled into nodes ----

class Net:
    """TinyYolo's nodes for ``num_classes`` and ``in_hw``: every conv's
    weight shape (in the order the weights are drawn and named), every
    BatchNorm's channels, every cell's map ``(C, H, W)``."""

    def __init__(self, num_classes: int, in_hw: Tuple[int, int],
                 in_channels: int = 2):
        self.num_classes = num_classes
        self.in_hw = tuple(in_hw)
        self.convs: List[Tuple[int, int, int, int, Tuple[int, int]]] = []
        self.norms: List[int] = []
        self.cells: List[Tuple[str, Tuple[int, int, int]]] = []
        self.taps: List[Tuple[int, Tuple[int, int]]] = []
        self.backbone, ch, hw = self._compile(BACKBONE, in_channels,
                                              self.in_hw)
        self.neck, _, _ = self._compile(NECK, ch, hw, taps=self.taps)
        box_out = ANCHORS_PER_PIXEL * 4
        cls_out = ANCHORS_PER_PIXEL * (num_classes + 1)
        self.heads = []
        for tch, thw in self.taps:
            stem, sch, shw = self._compile(HEAD_STEM, tch, thw)
            box, _, _ = self._compile([_conv(box_out, 1)], sch, shw)
            cls, _, _ = self._compile([_conv(cls_out, 1)], sch, shw)
            self.heads.append((stem, box, cls))

    def _compile(self, cfg, ch, hw, taps=None):
        nodes = []
        for el in cfg:
            kind = el[0]
            if kind == "conv":
                out = ch if el[1] is None else el[1]
                k, s = el[2], el[3]
                ohw = tuple((d + 2 * (k // 2) - k) // s + 1 for d in hw)
                nodes.append(("conv", len(self.convs), k, s))
                self.convs.append((out, ch, k, s, ohw))
                ch, hw = out, ohw
            elif kind == "norm":
                nodes.append(("norm", len(self.norms)))
                self.norms.append(ch)
            elif kind in ("lif", "li"):
                nodes.append((kind, len(self.cells)))
                self.cells.append((kind, (ch, *hw)))
            elif kind in ("tanh", "pass"):
                nodes.append((kind,))
            elif kind == "tap":
                nodes.append(("tap",))
                taps.append((ch, hw))
            elif kind in ("residual", "dense"):
                branches, outs = [], []
                for branch in el[1]:
                    b, bch, bhw = self._compile(branch, ch, hw, taps)
                    branches.append(b)
                    outs.append(bch)
                nodes.append((kind, branches))
                ch = outs[0] if kind == "residual" else sum(outs)
            else:
                raise ValueError(f"unknown spec element {el!r}")
        return nodes, ch, hw

    def weight_shapes(self) -> List[Tuple[int, int, int, int]]:
        return [(o, i, k, k) for o, i, k, _, _ in self.convs]

    def num_params(self) -> int:
        return sum(o * i * k * k for o, i, k, _, _ in self.convs) + sum(
            self.norms)

    def conv_flops_per_frame(self) -> int:
        """``2 k k Cin Cout H' W'`` summed over the convs of one frame."""
        return sum(2 * k * k * i * o * hw[0] * hw[1]
                   for o, i, k, _, hw in self.convs)

    def zero_state(self, batch: int, device) -> List[Tuple[torch.Tensor,
                                                           torch.Tensor]]:
        """Every cell's ``(v, i)``, zero, in spec order."""
        return [(torch.zeros(batch, h, w, c, device=device),
                 torch.zeros(batch, h, w, c, device=device))
                for _, (c, h, w) in self.cells]

    @property
    def num_anchors(self) -> int:
        return sum(hw[0] * hw[1] for _, hw in self.taps) * ANCHORS_PER_PIXEL


# ---- the cells ----

class _SuperSpike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x > 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / (ALPHA * x.abs() + 1.0) ** 2


_SCALARS: dict = {}


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor on ``like``'s device, made once."""
    key = (value, like.dtype, like.device)
    if key not in _SCALARS:
        _SCALARS[key] = torch.tensor(value, dtype=like.dtype,
                                     device=like.device)
    return _SCALARS[key]


def _fma(a, b: float, c):
    """``a * b + c`` rounded once."""
    return torch.addcmul(c, a, _scalar(b, a))


def lif(x, v, i):
    v_dec = _fma((0.0 - v) + i, C_MEM, v)
    i_dec = _fma(i, -C_SYN, i)
    z = _SuperSpike.apply(v_dec - V_TH)
    v_new = torch.where(z.detach() > 0, _scalar(0.0, v_dec), v_dec)
    return z, v_new, i_dec + x


def li(x, v, i):
    i_jump = i + x
    v_new = _fma((0.0 - v) + i_jump, C_MEM, v)
    i_dec = _fma(i_jump, -C_SYN, i_jump)
    return v_new, v_new, i_dec


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero, as the card's ``cvt.rna.tf32.f32``), kept in fp32."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    out = bits.view(torch.float32)
    finite = torch.isfinite(t)
    return torch.where(finite, out, t)


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return to_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return g


# ---- the forward ----

class Params:
    """The weights the reference runs: conv weights (OIHW, spec order),
    BatchNorm scales and running moments."""

    def __init__(self, weights, scales, means=None, variances=None):
        self.weights = list(weights)
        self.scales = list(scales)
        self.means = means
        self.variances = variances
        self._coeffs: dict = {}

    def coeffs(self, idx: int):
        """Eval BatchNorm ``idx``'s ``(k, b)`` of ``x * k + b``."""
        if idx not in self._coeffs:
            k = torch.rsqrt(self.variances[idx] + EPS) * self.scales[idx]
            self._coeffs[idx] = (k, -self.means[idx] * k)
        return self._coeffs[idx]


def _conv2d(x, w, k, s, tf32):
    if tf32:
        x, w = _RoundTF32.apply(x), _RoundTF32.apply(w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=s, padding=k // 2)
    return y.permute(0, 2, 3, 1)


def _norm(x, idx, p: Params, train):
    if train:
        var, mean = torch.var_mean(x, dim=(0, 1, 2), correction=0)
        return (x - mean) * torch.rsqrt(var + EPS) * p.scales[idx]
    k, b = p.coeffs(idx)
    return torch.addcmul(b, x, k)


def _run(nodes, x, state, new_state, p: Params, train, tf32, taps):
    for node in nodes:
        kind = node[0]
        if kind == "conv":
            _, idx, k, s = node
            x = _conv2d(x, p.weights[idx], k, s, tf32)
        elif kind == "norm":
            x = _norm(x, node[1], p, train)
        elif kind in ("lif", "li"):
            idx = node[1]
            v, i = state[idx]
            x, v, i = (lif if kind == "lif" else li)(x, v, i)
            new_state[idx] = (v, i)
        elif kind == "tanh":
            x = torch.tanh(x)
        elif kind == "tap":
            taps.append(x)
        elif kind in ("residual", "dense"):
            outs = [_run(b, x, state, new_state, p, train, tf32, taps)
                    for b in node[1]]
            if kind == "residual":
                x = outs[0]
                for o in outs[1:]:
                    x = x + o
            else:
                x = torch.cat(outs, dim=-1)
    return x


def _leaf_seq(node, X, state, p: Params, train, tf32, start):
    """One leaf over the sequence: ``(Y, (v, i) or None)``."""
    kind = node[0]
    if kind == "conv":
        _, idx, k, s = node
        T, B = X.shape[:2]
        y = _conv2d(X.reshape(T * B, *X.shape[2:]), p.weights[idx], k, s,
                    tf32)
        return y.reshape(T, B, *y.shape[1:]), None
    if kind == "norm":
        idx = node[1]
        if not train:
            return _norm(X, idx, p, False), None
        var, mean = torch.var_mean(X, dim=(1, 2, 3), correction=0,
                                   keepdim=True)
        return (X - mean) * torch.rsqrt(var + EPS) * p.scales[idx], None
    if kind in ("lif", "li"):
        v, i = state[node[1]]
        cell = lif if kind == "lif" else li
        outs = []
        for t in range(X.shape[0]):
            z, v_new, i_new = cell(X[t], v, i)
            outs.append(z)
            if t >= start:
                v, i = v_new, i_new
        return torch.stack(outs), (v, i)
    if kind == "tanh":
        return torch.tanh(X), None
    return X, None  # pass


def _segments(nodes):
    """Runs of leaves, each closed by a cell: what a remat recomputes at
    once (structural nodes and taps stand alone)."""
    run = []
    for node in nodes:
        if node[0] in ("residual", "dense", "tap"):
            if run:
                yield run
                run = []
            yield [node]
            continue
        run.append(node)
        if node[0] in ("lif", "li"):
            yield run
            run = []
    if run:
        yield run


def _run_seq(nodes, X, state, new_state, p: Params, train, tf32, taps,
             start, remat):
    for seg in _segments(nodes):
        kind = seg[0][0]
        if kind == "tap":
            taps.append(X)
        elif kind in ("residual", "dense"):
            outs = [_run_seq(b, X, state, new_state, p, train, tf32, taps,
                             start, remat) for b in seg[0][1]]
            if kind == "residual":
                X = outs[0]
                for o in outs[1:]:
                    X = X + o
            else:
                X = torch.cat(outs, dim=-1)
        else:
            run = lambda x, seg=seg: _flat(_leaves_seq(seg, x, state, p,
                                                       train, tf32, start))
            out = checkpoint(run, X, use_reentrant=False) if remat \
                else run(X)
            X = out[0]
            if len(out) > 1:
                new_state[seg[-1][1]] = (out[1], out[2])
    return X


def _leaves_seq(seg, X, state, p: Params, train, tf32, start):
    vi = None
    for node in seg:
        X, vi = _leaf_seq(node, X, state, p, train, tf32, start)
    return X, vi


def _flat(out):
    y, vi = out
    return (y,) if vi is None else (y, *vi)


def seq(net: Net, X, p: Params, start: int = 0, train=False, tf32=False,
        remat=False):
    """The whole sequence ``X [T, B, H, W, 2]`` from zero state, the
    state held for ``t < start``: the head stems' outputs at the last
    step, one a tap. ``remat``: each run of leaves up to a cell is
    recomputed in the backward (the same values, less memory)."""
    state = net.zero_state(X.shape[1], X.device)
    new_state = list(state)
    taps: list = []
    Y = _run_seq(net.backbone, X.float(), state, new_state, p, train, tf32,
                 taps, start, remat)
    _run_seq(net.neck, Y, state, new_state, p, train, tf32, taps, start,
             remat)
    return [_run_seq(stem, t, state, new_state, p, train, tf32, [], start,
                     remat)[-1] for (stem, _, _), t in zip(net.heads, taps)]


def step(net: Net, x, state, p: Params, train=False, tf32=False):
    """One frame ``[B, H, W, 2]`` -> (the head stems' outputs, one a tap,
    and the new state)."""
    new_state = list(state)
    taps: list = []
    y = _run(net.backbone, x.float(), state, new_state, p, train, tf32, taps)
    _run(net.neck, y, state, new_state, p, train, tf32, taps)
    stems = [_run(stem, t, state, new_state, p, train, tf32, [])
             for (stem, _, _), t in zip(net.heads, taps)]
    return stems, new_state


def readout(net: Net, stems, p: Params, tf32=False):
    """The box and class convs on the last step's stems: ``(cls [B, A,
    C+1], box [B, A, 4])``, flattened in (h, w, anchor) order and
    concatenated over the taps."""
    cls_outs, box_outs = [], []
    for (_, box, cls), s in zip(net.heads, stems):
        b = s.shape[0]
        box_outs.append(_run(box, s, [], [], p, False, tf32, [])
                        .reshape(b, -1, 4))
        cls_outs.append(_run(cls, s, [], [], p, False, tf32, [])
                        .reshape(b, -1, net.num_classes + 1))
    return torch.cat(cls_outs, dim=1), torch.cat(box_outs, dim=1)


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN and matmuls while the reference runs."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
