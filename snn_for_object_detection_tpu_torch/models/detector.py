"""Detector core: backbone/neck/head composition, forwards, loss, decode.

Counterpart of ``snn_for_object_detection_tpu/models/detector.py``
(``SODa``, after the reference's models/soda.py). The module owns its
parameters and BatchNorm running stats; the recurrent neuron state is a
nested dict the caller passes in and gets back, in the JAX pytree
layout. ``forward`` and ``forward_seq`` take ``train=True`` for
training: BatchNorm on batch statistics (the running statistics are
written to the buffers when the forward returns) and, with ``remat``,
activations recomputed in the backward: per step on the per-step
schedule, per segment on the time-batched one.

Three schedules give the same predictions:

- :meth:`forward` runs one frame at a time; steps ``t < start_step``
  are skipped entirely (the reference's ``X[r:]`` truncation);
- :meth:`forward_seq` runs every stateless layer once over the folded
  ``T*B`` batch and every LIF/LI cell as one ``temporal_cell_seq`` call
  over the whole sequence, whose state commits only for ``t >= r``.
  With ``fuse_seq=True`` and no truncation it runs each ``[Conv -> Norm
  -> LIF/LI]`` triple as one ``spiking_conv_seq`` call instead; that
  sums the convs in another order, so spikes near the threshold can
  flip against the unfused schedule;
- :meth:`forward_hybrid` runs the backbone as :meth:`forward_seq` does
  (never fused) and the neck and head stems as :meth:`forward` does,
  one step at a time on the backbone's output.

Light head box/cls tails (no state and no BatchNorm, TinyYolo's bare
1x1 convs) run once, on the last step's stem activations (JAX's
``_head_tails_light``); tails with a cell or a Norm run at every step
of every schedule, their state and statistics carried like the rest.

Spatial sharding: each forward takes ``space=`` (a
``parallel.halo.Space``, the Trainer's ``make_mesh(spatial=k)``), and
then ``X`` holds this rank's block of rows of H: every layer computes its
block (``models/compile.py``), the states are the blocks' rows, and the
head outputs are gathered over the space group into the whole maps
before the predictions are flattened, so that every rank of a data
block holds the same predictions (:func:`parallel.halo.gather_rows`,
whose backward keeps a rank's own rows: :meth:`loss` on them counts the
gradient once). The fused schedule runs there too: each triple fetches
its sequence's rows once and launches ``spiking_conv_seq``'s
fetched-rows form, whose rows are the whole map's bit for bit.

:meth:`forward_with_records` runs the per-step schedule and returns, for
every cell built with ``state_storage=True``, its state and output at
every step (``utils/analysis.py`` reads them). ``s2d_stem=True`` runs the
stem conv on the space-to-depth plan; int8 weights come from
``ops/quantize.py`` or ``load_jax_params``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from snn_for_object_detection_tpu_torch.models import compile as C
from snn_for_object_detection_tpu_torch.models import spec as S
from snn_for_object_detection_tpu_torch.ops import anchors as anchor_ops
from snn_for_object_detection_tpu_torch.ops import matching, nms
from snn_for_object_detection_tpu_torch.ops.cuda_kernels import (
    STATE_DTYPES,
    X_DTYPES,
)
from snn_for_object_detection_tpu_torch.parallel.halo import gather_rows

Preds = Tuple[torch.Tensor, torch.Tensor]


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name ("bfloat16", ...)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype.split(".")[-1])
    return dtype


class SODa(nn.Module):
    """Abstract stateful-recurrent anchor detector.

    Subclasses provide ``backbone_cfgs`` / ``neck_cfgs`` / ``head_cfgs``
    DSL lists. Construction compiles the network for a static input
    geometry, initializes it from ``seed`` and places it on ``device``.

    :param num_classes: Number of foreground classes.
    :param in_hw: Input frame geometry (H, W); (240, 304) for GEN1.
    :param loss_ratio: GT-vs-background loss weighting.
    :param time_window: Max random truncation of the sequence start.
    :param iou_threshold: Anchor-assignment IoU threshold.
    :param learning_rate: The optimizer's (peak) learning rate.
    :param compute_dtype: Activation dtype, fp32 or bf16.
    :param state_dtype: Neuron state storage dtype: fp32, bf16, or fp8
        e5m2 or e4m3fn (stored as JAX stores it: ``neurons.to_state``).
    :param remat: In training, recompute activations in the backward
        instead of keeping them (``torch.utils.checkpoint``), as the JAX
        package's ``jax.checkpoint``.
    :param state_storage: The cells record their state and output in
        :meth:`forward_with_records` (every zoo model passes it to its
        cells).
    :param fuse_seq: :meth:`forward_seq` fuses each ``[Conv -> Norm ->
        LIF/LI]`` triple into one ``spiking_conv_seq`` call when no
        truncation is in play and it is not training (opt-in, as in the
        JAX package).
    :param s2d_stem: Run the first backbone layer, which must be a 3x3
        stride-2 Conv, on the space-to-depth plan (``Conv(s2d=True)``):
        the same weights and function, the sums in another order.
    :param device: Where the model lives. ``"cuda"`` needs a card: there
        is no fallback to the CPU.
    :param seed: Seed of the ``torch.Generator`` that draws the weights.
    """

    def __init__(
        self,
        num_classes: int,
        in_hw: Tuple[int, int] = (240, 304),
        in_channels: int = 2,
        loss_ratio: float = 0.04,
        time_window: int = 16,
        iou_threshold: float = 0.4,
        learning_rate: float = 1e-3,
        state_storage: bool = False,
        compute_dtype=torch.float32,
        state_dtype=torch.float32,
        remat: bool = True,
        fuse_seq: bool = False,
        s2d_stem: bool = False,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions"
            )
        self.num_classes = num_classes
        self.in_hw = tuple(in_hw)
        self.in_channels = in_channels
        self.loss_ratio = loss_ratio
        self.time_window = time_window
        self.iou_threshold = iou_threshold
        self.learning_rate = learning_rate
        self.remat = remat
        self.state_storage = state_storage
        self.fuse_seq = fuse_seq
        self.s2d_stem = s2d_stem
        self.compute_dtype = as_dtype(compute_dtype)
        self.state_dtype = as_dtype(state_dtype)
        if self.compute_dtype not in X_DTYPES:
            raise ValueError(f"compute_dtype must be one of {X_DTYPES}")
        if self.state_dtype not in STATE_DTYPES:
            raise ValueError(f"state_dtype must be one of {STATE_DTYPES}")
        self.device = device

        sd = self.state_dtype
        backbone_cfgs = self.backbone_cfgs()
        if s2d_stem:
            stem = backbone_cfgs[0] if backbone_cfgs else None
            if not (isinstance(stem, S.Conv) and stem.kernel_size == 3
                    and stem.stride == 2):
                raise ValueError(
                    "s2d_stem=True requires the backbone to start with "
                    f"a Conv(kernel_size=3, stride=2); got {stem!r}"
                )
            backbone_cfgs = [dataclasses.replace(stem, s2d=True),
                             *backbone_cfgs[1:]]
        self.backbone = C.compile_block(
            backbone_cfgs, in_channels, self.in_hw, state_dtype=sd,
            name="backbone",
        )
        neck_returns: List[Tuple[int, Tuple[int, int]]] = []
        self.neck = C.compile_block(
            self.neck_cfgs(), self.backbone.out_channels,
            self.backbone.out_hw, returns=neck_returns, state_dtype=sd,
            name="neck",
        )
        if not neck_returns:
            raise ValueError("neck_cfgs must contain at least one Return()")
        self.neck_out_shape = neck_returns

        num_scales = len(neck_returns)
        sizes = anchor_ops.default_scale_sizes(num_scales)
        ratios = anchor_ops.DEFAULT_RATIOS
        # the anchor tables' parameters, checked by the reference
        # checkpoint importer
        self.scale_sizes, self.anchor_ratios = sizes, ratios
        anchors_per_pixel = sizes.shape[1] * len(ratios)
        self.num_box_out = anchors_per_pixel * 4
        self.num_class_out = anchors_per_pixel * (num_classes + 1)
        anchors = np.concatenate([
            anchor_ops.generate_anchors(hw[0], hw[1], sizes[idx], ratios)
            for idx, (_, hw) in enumerate(neck_returns)
        ])
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)
        self.num_anchors = int(anchors.shape[0])

        head_cfg = self.head_cfgs(self.num_box_out, self.num_class_out)
        if len(head_cfg) != 3:
            raise ValueError("head_cfgs must return [base, box, cls] lists")
        self.num_heads = num_scales
        for idx, (ch, hw) in enumerate(neck_returns):
            base = C.compile_block(head_cfg[0], ch, hw, state_dtype=sd,
                                   name=f"head{idx}/base")
            box = C.compile_block(head_cfg[1], base.out_channels,
                                  base.out_hw, state_dtype=sd,
                                  name=f"head{idx}/box")
            cls = C.compile_block(head_cfg[2], base.out_channels,
                                  base.out_hw, state_dtype=sd,
                                  name=f"head{idx}/cls")
            if box.out_channels != self.num_box_out:
                raise ValueError(
                    f"head box branch must end with {self.num_box_out} "
                    "channels"
                )
            if cls.out_channels != self.num_class_out:
                raise ValueError(
                    f"head cls branch must end with {self.num_class_out} "
                    "channels"
                )
            self.add_module(f"head{idx}", nn.ModuleDict(
                {"base": base, "box": box, "cls": cls}
            ))
        # tails with no state and no BatchNorm run once, after the steps
        self.head_tails_light = not any(
            isinstance(m, (C.Norm,) + C.STATEFUL_LAYERS)
            for h in self.heads() for part in ("box", "cls")
            for m in h[part].modules())
        self.init(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    # ----- config hooks -----

    def backbone_cfgs(self) -> S.ListGen:
        raise NotImplementedError

    def neck_cfgs(self) -> S.ListGen:
        raise NotImplementedError

    def head_cfgs(self, box_out: int, cls_out: int) -> S.ListGen:
        raise NotImplementedError

    def heads(self) -> List[nn.ModuleDict]:
        return [getattr(self, f"head{idx}") for idx in range(self.num_heads)]

    # ----- init -----

    def init(self, generator: torch.Generator) -> None:
        """(Re)draw every conv weight from ``generator`` (a CPU
        generator), reset PLIF's time constants to LIF's and BatchNorm
        to identity."""
        for m in self.modules():
            if isinstance(m, (C.Conv, C.ConvLSTM, C.PLIF)):
                m.reset_parameters(generator)
            elif isinstance(m, C.Norm):
                with torch.no_grad():
                    m.scale.fill_(1.0)
                    if m.bias is not None:
                        m.bias.zero_()
                    m.mean.zero_()
                    m.var.fill_(1.0)

    def init_state(self, batch_size: int, space=None) -> Dict[str, Any]:
        """Zero recurrent state for a batch, on the model's device (under
        a ``space`` axis, this rank's rows of each map)."""
        dev = self.device
        state = {
            "backbone": self.backbone.init_state(batch_size, dev, space),
            "neck": self.neck.init_state(batch_size, dev, space),
        }
        for idx, head in enumerate(self.heads()):
            state[f"head{idx}"] = {
                part: head[part].init_state(batch_size, dev, space)
                for part in ("base", "box", "cls")
            }
        return state

    # ----- per-step pieces -----

    def _trunk(self, x: torch.Tensor, state, train: bool = False,
               ctx: Optional[C.Ctx] = None, group=None,
               space=None) -> Tuple[tuple, Dict]:
        """Backbone + neck + head stems for one frame; the box/cls tails
        are left to :meth:`_tails`."""
        if ctx is None:
            ctx = C.Ctx(train=train, batch_group=group, space=space)
        y, backbone = self.backbone.step(
            x.to(self.compute_dtype), state["backbone"], ctx
        )
        base_outs, rest = self._neck_heads(y, state, ctx)
        return base_outs, {"backbone": backbone, **rest}

    def _neck_heads(self, y: torch.Tensor, state,
                    ctx: C.Ctx) -> Tuple[tuple, Dict]:
        """Neck + head stems for one backbone output ``y``: the per-step
        suffix of :meth:`_trunk` and the step of :meth:`forward_hybrid`.
        The returned state covers the neck and heads only."""
        new_state = {}
        _, new_state["neck"] = self.neck.step(y, state["neck"], ctx)
        base_outs = []
        for idx, (head, fmap) in enumerate(zip(self.heads(), ctx.taps)):
            hst = state[f"head{idx}"]
            base_out, nst = head["base"].step(fmap, hst["base"], ctx)
            new_state[f"head{idx}"] = {
                "base": nst, "box": hst["box"], "cls": hst["cls"]
            }
            base_outs.append(base_out)
        return tuple(base_outs), new_state

    def _step_out(self, x: torch.Tensor, state, train: bool = False,
                  group=None, space=None) -> Tuple[tuple, Dict]:
        """One frame of the per-step schedule: the stem activations when
        the tails are light (they run after the last step), else the
        predictions, with the tails' state; and the new state."""
        base_outs, state = self._trunk(x, state, train, group=group,
                                       space=space)
        if self.head_tails_light:
            return base_outs, state
        return self._tails(base_outs, state,
                           C.Ctx(train=train, batch_group=group, space=space))

    def _neck_heads_out(self, y: torch.Tensor, state, train: bool = False,
                        group=None, space=None) -> Tuple[tuple, Dict]:
        """:meth:`_step_out` for the neck and heads of
        :meth:`forward_hybrid` on one backbone output."""
        ctx = C.Ctx(train=train, batch_group=group, space=space)
        base_outs, state = self._neck_heads(y, state, ctx)
        if self.head_tails_light:
            return base_outs, state
        return self._tails(base_outs, state,
                           C.Ctx(train=train, batch_group=group, space=space))

    def _zero_out(self, batch: int, device, space=None) -> tuple:
        """What a per-step forward that runs no step reads out: zero stem
        activations for light tails, else zero predictions."""
        if not self.head_tails_light:
            return (torch.zeros((batch, self.num_anchors,
                                 self.num_classes + 1), device=device),
                    torch.zeros((batch, self.num_anchors, 4), device=device))
        return tuple(
            torch.zeros(h["base"].local_shape(batch, h["base"].out_channels,
                                              space),
                        dtype=self.compute_dtype, device=device)
            for h in self.heads()
        )

    def _readout(self, out, state, space=None) -> Preds:
        """The predictions of what a per-step forward carried out of its
        last step (:meth:`_step_out`)."""
        if self.head_tails_light:
            return self._tails(out, state, C.Ctx(space=space))[0]
        return out

    def _flatten_preds(self, box_outs, cls_outs, space=None) -> Preds:
        """Tail outputs flattened in (h, w, anchor) order and
        concatenated across scales, fp32. Under a ``space`` axis each
        rank's rows are gathered into the whole maps first."""
        if space is not None:
            box_outs = [gather_rows(o, h["box"].out_hw[0], space)
                        for o, h in zip(box_outs, self.heads())]
            cls_outs = [gather_rows(o, h["cls"].out_hw[0], space)
                        for o, h in zip(cls_outs, self.heads())]
        b = box_outs[0].shape[0]
        return (torch.cat([c.reshape(b, -1, self.num_classes + 1).float()
                           for c in cls_outs], dim=1),
                torch.cat([o.reshape(b, -1, 4).float() for o in box_outs],
                          dim=1))

    def _tails(self, base_outs, state, ctx: C.Ctx) -> Tuple[Preds, Dict]:
        """Box/cls tails of one step on the stem activations: the
        predictions, and the state with the tails' new state (light
        tails leave it as it is)."""
        box_outs, cls_outs = [], []
        state = dict(state)
        for idx, (head, base_out) in enumerate(zip(self.heads(), base_outs)):
            hst = dict(state[f"head{idx}"])
            box_out, hst["box"] = head["box"].step(base_out, hst["box"], ctx)
            cls_out, hst["cls"] = head["cls"].step(base_out, hst["cls"], ctx)
            state[f"head{idx}"] = hst
            box_outs.append(box_out)
            cls_outs.append(cls_out)
        return self._flatten_preds(box_outs, cls_outs, ctx.space), state

    # ----- forwards -----

    @torch.no_grad()
    def step(self, x: torch.Tensor, state=None,
             ctx: Optional[C.Ctx] = None) -> Tuple[Preds, Dict]:
        """One frame ``[B, H, W, C]`` -> ((cls_preds [B, A, C+1],
        bbox_preds [B, A, 4]), new state), in eval. ``ctx``: a
        ``C.Ctx(record=True)`` or ``C.Ctx(calibrate=True)`` (JAX's
        ``step(record=, calibrate=)`` flags) that gathers the step's
        records or its convs' input absmax."""
        if state is None:
            state = self.init_state(x.shape[0])
        ctx = C.Ctx() if ctx is None else ctx
        base_outs, state = self._trunk(x, state, ctx=ctx)
        # JAX reads light tails out after its trunk, which alone returns
        # the calibration stats: their convs report no absmax there
        return self._tails(base_outs, state, dataclasses.replace(
            ctx, taps=[], calibrate=ctx.calibrate and not
            self.head_tails_light))

    @torch.no_grad()
    def forward_with_records(self, X: torch.Tensor, state=None
                             ) -> Tuple[Preds, Dict, Dict[str, Any]]:
        """Eval forward, one :meth:`step` a frame, that also returns every
        ``state_storage=True`` cell's state and output at each step:
        ``(last predictions, state, records)``, ``records[name] =
        (state [T, ...] in the state dtype, out [T, ...] fp32)`` under
        the cell's JAX name (``backbone/b0/l2``), as JAX's
        ``forward_with_records``."""
        if state is None:
            state = self.init_state(X.shape[1])
        steps: Dict[str, list] = {}
        preds = None
        for t in range(X.shape[0]):
            ctx = C.Ctx(record=True)
            preds, state = self.step(X[t], state, ctx)
            for name, rec in ctx.records.items():
                steps.setdefault(name, []).append(rec)
        records = {}
        for name, recs in steps.items():
            sts, outs = zip(*recs)
            records[name] = (type(sts[0])(*(torch.stack(f)
                                             for f in zip(*sts))),
                             torch.stack(outs))
        return preds, state, records

    def commit_stats(self, state) -> Dict:
        """Write the running statistics a train forward carried in
        ``state`` into the BatchNorm buffers, once, outside any
        recompute; returns the state with those entries back to ``()``,
        as in eval."""
        state = dict(state)
        state["backbone"] = C.commit_norm_stats(self.backbone,
                                                state["backbone"])
        state["neck"] = C.commit_norm_stats(self.neck, state["neck"])
        for idx, head in enumerate(self.heads()):
            hst = dict(state[f"head{idx}"])
            for part in ("base", "box", "cls"):
                hst[part] = C.commit_norm_stats(head[part], hst[part])
            state[f"head{idx}"] = hst
        return state

    def forward(self, X: torch.Tensor, start_step: int = 0,
                state=None, train: bool = False,
                group=None, space=None) -> Tuple[Preds, Dict]:
        """Per-step schedule over ``X [T, B, H, W, C]``: last-step
        predictions and the final state. Steps ``t < start_step`` are
        skipped (state and BatchNorm statistics frozen), as JAX's
        ``lax.cond`` over the scan. ``train=True``: BatchNorm on batch
        statistics, each step checkpointed when ``remat``, and gradients
        on; without it the call runs under ``no_grad``. ``group``: in
        training, the process group whose ranks' rows of ``X`` form the
        global batch (``C.Ctx.batch_group``): BatchNorm on its moments.
        ``space``: ``X`` holds this rank's rows of H along a space axis
        (``C.Ctx.space``; the predictions are the whole maps'). The same
        in :meth:`forward_seq` and :meth:`forward_hybrid`."""
        T, B = X.shape[0], X.shape[1]
        if state is None:
            state = self.init_state(B, space)
        with contextlib.nullcontext() if train else torch.no_grad():
            out = self._zero_out(B, X.device, space)
            for t in range(max(int(start_step), 0), T):
                if train and self.remat:
                    out, state = checkpoint(
                        self._step_out, X[t], state, True, group, space,
                        use_reentrant=False)
                else:
                    out, state = self._step_out(X[t], state, train, group,
                                                space)
            preds = self._readout(out, state, space)
        if train:
            state = self.commit_stats(state)
        return preds, state

    def forward_seq(self, X: torch.Tensor, start_step: int = 0,
                    state=None, fuse=None, train: bool = False,
                    group=None, space=None) -> Tuple[Preds, Dict]:
        """Time-batched schedule, same results as :meth:`forward`.

        :param fuse: run the fused triples (``spiking_conv_seq``).
            Default: ``fuse_seq`` when ``start_step == 0`` and not
            training, as the JAX package fuses only for the Python int
            start 0 in eval. The fused kernel has no truncation gate and
            no backward, so ``fuse=True`` with another start or with
            ``train`` raises. Under a ``space`` axis the fused triples
            run on this rank's rows (``spiking_conv_seq(pad_h=0)`` on
            the fetched rows).
        :param train: BatchNorm on per-step batch statistics, the
            running statistics folded once per step ``t >= start_step``;
            conv -> norm -> cell segments checkpointed when ``remat``;
            gradients on. Without it the call runs under ``no_grad``.
        """
        start_step = int(start_step)
        if fuse is None:
            fuse = self.fuse_seq and start_step == 0 and not train
        elif fuse and (start_step != 0 or train):
            raise ValueError("the fused schedule has no truncation gate "
                             "and no backward: fuse=True needs start_step "
                             f"0 and eval, not start {start_step}, "
                             f"train={train}")
        B = X.shape[1]
        if state is None:
            state = self.init_state(B, space)
        ctx = C.Ctx(start_step=start_step, fuse=fuse, train=train,
                    remat=train and self.remat, batch_group=group,
                    space=space)
        with contextlib.nullcontext() if train else torch.no_grad():
            new_state = {}
            y, new_state["backbone"] = self.backbone.seq(
                X.to(self.compute_dtype), state["backbone"], ctx
            )
            _, new_state["neck"] = self.neck.seq(y, state["neck"], ctx)
            base_outs, box_outs, cls_outs = [], [], []
            for idx, (head, fmap_seq) in enumerate(
                    zip(self.heads(), ctx.taps)):
                hst = dict(state[f"head{idx}"])
                base_seq, hst["base"] = head["base"].seq(
                    fmap_seq, hst["base"], ctx)
                if self.head_tails_light:
                    base_outs.append(base_seq[-1])
                else:
                    # tails with state or statistics: every step
                    box_seq, hst["box"] = head["box"].seq(
                        base_seq, hst["box"], ctx)
                    cls_seq, hst["cls"] = head["cls"].seq(
                        base_seq, hst["cls"], ctx)
                    box_outs.append(box_seq[-1])
                    cls_outs.append(cls_seq[-1])
                new_state[f"head{idx}"] = hst
            if self.head_tails_light:
                preds = self._readout(tuple(base_outs), new_state, space)
            else:
                preds = self._flatten_preds(box_outs, cls_outs, space)
        if train:
            new_state = self.commit_stats(new_state)
        return preds, new_state

    def forward_hybrid(self, X: torch.Tensor, start_step: int = 0,
                       state=None, train: bool = False,
                       group=None, space=None) -> Tuple[Preds, Dict]:
        """Mixed schedule, same results as :meth:`forward`: the backbone
        runs time-batched over the whole sequence, as in
        :meth:`forward_seq` but never fused (its cells commit state, and
        in training its BatchNorm folds statistics, only for ``t >=
        start_step``); then the neck and head stems run one step at a
        time on the backbone's output from ``start_step`` on, as in
        :meth:`forward`. ``train=True``: BatchNorm on batch statistics;
        with ``remat`` the backbone checkpointed a segment, the neck and
        heads a step; the running statistics written once, after both
        parts. Without it the call runs under ``no_grad``."""
        start_step = int(start_step)
        T, B = X.shape[0], X.shape[1]
        if state is None:
            state = self.init_state(B, space)
        remat = train and self.remat
        ctx = C.Ctx(start_step=start_step, train=train, remat=remat,
                    batch_group=group, space=space)
        with contextlib.nullcontext() if train else torch.no_grad():
            y_seq, backbone = self.backbone.seq(
                X.to(self.compute_dtype), state["backbone"], ctx
            )
            rest = {k: v for k, v in state.items() if k != "backbone"}
            out = self._zero_out(B, X.device, space)
            for t in range(max(start_step, 0), T):
                if remat:
                    out, rest = checkpoint(
                        self._neck_heads_out, y_seq[t], rest, True, group,
                        space, use_reentrant=False)
                else:
                    out, rest = self._neck_heads_out(y_seq[t], rest, train,
                                                     group, space)
            new_state = {"backbone": backbone, **rest}
            preds = self._readout(out, new_state, space)
        if train:
            new_state = self.commit_stats(new_state)
        return preds, new_state

    def forward_fn(self, schedule):
        """``Trainer(time_batched=...)`` flag -> forward: ``False`` ->
        :meth:`forward`, ``True`` -> :meth:`forward_seq`, ``"hybrid"``
        -> :meth:`forward_hybrid`."""
        try:
            return {
                False: self.forward,
                True: self.forward_seq,
                "hybrid": self.forward_hybrid,
            }[schedule]
        except (KeyError, TypeError):
            raise ValueError(
                f"unknown schedule {schedule!r}; expected False, True or "
                "'hybrid'"
            ) from None

    # ----- loss -----

    def loss(self, preds: Preds, labels: torch.Tensor,
             group=None) -> torch.Tensor:
        """SSD loss: CE split into GT/background means weighted by
        ``loss_ratio``, plus masked L1 on box offsets averaged over all
        ``B*A*4`` elements.

        ``group``: a process group of several ranks whose rows form the
        global batch. The counts and the element count are then the
        global batch's (all-reduced, no gradient) and the result is this
        rank's share of the global batch's loss: the ranks' shares sum
        to it, as do their gradients. On a ``(data, space)`` grid it is
        the ``data`` group: the ranks of a data block hold the same
        gathered predictions and labels, and count them once.

        :param labels: [B, N, 5] (class, x1, y1, x2, y2), -1-padded.
        """
        if labels.shape[-1] != 5:
            raise ValueError(
                f"loss expects [B, N, 5] single-target labels, got "
                f"{tuple(labels.shape)}"
            )
        cls_preds, bbox_preds = preds
        bbox_offset, bbox_mask, class_labels = matching.match_targets(
            self.anchors, labels, self.iou_threshold
        )
        num_out = cls_preds.shape[-1]
        logp = torch.log_softmax(cls_preds.reshape(-1, num_out), dim=-1)
        flat_labels = class_labels.reshape(-1)
        ce = -logp.gather(1, flat_labels[:, None])[:, 0]
        pos = flat_labels > 0
        bbox_l1 = (bbox_preds * bbox_mask - bbox_offset * bbox_mask).abs()
        if group is None:
            n_pos, n_neg = pos.sum(), (~pos).sum()
            bbox_loss = bbox_l1.mean()
        else:
            counts = torch.stack([
                pos.sum(), (~pos).sum(),
                torch.tensor(bbox_l1.numel(), device=pos.device)])
            torch.distributed.all_reduce(counts, group=group)
            n_pos, n_neg, n_box = counts
            bbox_loss = bbox_l1.sum() / n_box
        gt_loss = torch.where(pos, ce, 0.0).sum() / n_pos.clamp(min=1)
        background_loss = torch.where(pos, 0.0, ce).sum() / n_neg.clamp(min=1)
        return (
            gt_loss * self.loss_ratio
            + background_loss * (1 - self.loss_ratio)
            + bbox_loss
        )

    # ----- detection post-processing -----

    def detect(self, preds: Preds, max_out: int = 300) -> torch.Tensor:
        """Softmax + NMS decode: [B, max_out, 6] (class, conf, xyxy)."""
        cls_preds, bbox_preds = preds
        probs = torch.softmax(cls_preds, dim=2)
        return nms.multibox_detection(
            probs, bbox_preds, self.anchors, max_out=max_out
        )

    @torch.no_grad()
    def predict(self, x: torch.Tensor, state=None,
                max_out: int = 300) -> Tuple[torch.Tensor, Dict]:
        """Streaming single-frame inference.

        :param x: One frame [H, W, C] (or [B, H, W, C]).
        :return: (detections [max_out, 6] with boxes clamped to [0, 1],
            new state). Padded rows have class -1.
        """
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        preds, state = self.step(x, state)
        dets = self.detect(preds, max_out=max_out)
        dets = torch.cat([dets[..., :2], dets[..., 2:].clamp(0.0, 1.0)],
                         dim=-1)
        return (dets[0] if squeeze else dets), state
