"""Plain PyTorch reference of a training step and of an eval step.

A train step: the sequence time-batched from zero state, held before
the truncation start r (BatchNorm on each step's batch moments; each
layer's activations recomputed in the backward, which changes no
value), the loss on the
last step's predictions, its gradients by autograd (the spike's
SuperSpike surrogate), and Adamax (b1 0.9, b2 0.999, eps 1e-8):
``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g| + eps)``, ``p -= lr / (1
- b1^t) * m / u``. An eval step: the same forward with the running
moments, the loss, and the decode.

Imports torch and the two reference modules beside it, nothing else.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference import detection as D
from portbench.reference import tiny_yolo as R

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def forward(net: R.Net, p: R.Params, X: torch.Tensor, start: int,
            train: bool, tf32: bool = False):
    """The predictions ``(cls, box)`` after the last frame of ``X [T, B,
    H, W, 2]``, the state held before ``start``: the time-batched
    schedule (``tiny_yolo.seq``), each layer recomputed in training's
    backward."""
    stems = R.seq(net, X, p, start, train=train, tf32=tf32, remat=train)
    return R.readout(net, stems, p, tf32=tf32)


class Adamax:
    """Adamax over a list of fp32 leaves."""

    def __init__(self, leaves: Sequence[torch.Tensor], lr: float):
        self.lr = lr
        self.m = [torch.zeros_like(x) for x in leaves]
        self.u = [torch.zeros_like(x) for x in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, leaves: List[torch.Tensor], grads: List[torch.Tensor]):
        self.t += 1
        clr = self.lr / (1 - B1 ** self.t)
        for x, g, m, u in zip(leaves, grads, self.m, self.u):
            m.mul_(B1).add_(g, alpha=1 - B1)
            torch.maximum(u * B2, g.abs() + ADAM_EPS, out=u)
            x.sub_(clr * m / u)


def train_steps(net: R.Net, weights: List[torch.Tensor],
                scales: List[torch.Tensor], batches, starts: Sequence[int],
                anc: torch.Tensor, lr: float, iou_threshold: float,
                loss_ratio: float, tf32: bool = False) -> Dict:
    """Train steps from the given weights on ``batches`` ``[(X, labels),
    ...]`` with truncation starts ``starts``. Returns each step's loss,
    the first step's gradients and the leaves after the last step, in
    the order weights then scales."""
    leaves = [w.detach().clone().requires_grad_(True) for w in weights] + \
        [s.detach().clone().requires_grad_(True) for s in scales]
    nw = len(weights)
    opt = Adamax(leaves, lr)
    losses, first_grads = [], None
    with R.fp32_exact():
        for (X, labels), r in zip(batches, starts):
            p = R.Params(leaves[:nw], leaves[nw:])
            cls, box = forward(net, p, X, r, train=True, tf32=tf32)
            loss = D.loss(cls, box, anc, labels, iou_threshold, loss_ratio)
            grads = torch.autograd.grad(loss, leaves)
            if first_grads is None:
                first_grads = [g.detach().clone() for g in grads]
            opt.step(leaves, list(grads))
            losses.append(float(loss.detach()))
    return {"losses": losses, "first_grads": first_grads,
            "leaves": [x.detach() for x in leaves]}


@torch.no_grad()
def eval_step(net: R.Net, p: R.Params, X, labels, start: int,
              anc: torch.Tensor, iou_threshold: float, loss_ratio: float,
              tf32: bool = False):
    """``(loss, detections [B, 300, 6])`` of one eval step."""
    with R.fp32_exact():
        cls, box = forward(net, p, X, start, train=False, tf32=tf32)
        loss = D.loss(cls, box, anc, labels, iou_threshold, loss_ratio)
        return float(loss), D.detect(cls, box, anc)
