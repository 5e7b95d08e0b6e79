"""Plain PyTorch reference of the SSD head's arithmetic: anchors, the
anchor-to-box assignment, the loss and the decode with NMS.

Independent of the measured program: it imports numpy and torch alone.
Written from the reference implementation's definitions
(KirillHit/snn_for_object_detection: utils/anchors.py, utils/roi.py,
utils/box.py, models/soda.py's loss):

- anchors: per pixel of each tapped map, centers ``((i + .5) / H, (j +
  .5) / W)``; sizes ``arange(0.08, 0.75, 0.67 / 9)`` in three rows (one a
  map), ratios 0.5, 1, 2; ``w = size * ratio * H / W``, ``h = size /
  ratio * W / H``; ratio-major per pixel, pixels row-major;
- assignment: each anchor takes its best box if the IoU reaches the
  threshold; then each box claims its best anchor, greedily by the
  largest IoU left, each claim removing its row and column;
- loss: cross-entropy averaged over the positive anchors (weight
  ``loss_ratio``) and over the negative ones (``1 - loss_ratio``), plus
  the L1 of the masked offsets averaged over all ``B * A * 4`` entries;
- detect: softmax, per anchor the best class (background -1), the 300
  best anchors by confidence with foreground first, greedy NMS within a
  class at IoU 0.1, confidence below 0.01 demoted to background with
  ``1 - conf``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

NMS_IOU = 0.1
POS_THRESHOLD = 0.009999999
MAX_OUT = 300
RATIOS = (0.5, 1.0, 2.0)


def anchors(taps: List[Tuple[int, Tuple[int, int]]]) -> torch.Tensor:
    """``[A, 4]`` corner anchors in [0, 1] coordinates for the tapped
    maps ``[(channels, (H, W)), ...]``."""
    n = len(taps) * 3
    sizes = np.arange(0.08, 0.75, (0.75 - 0.08) / n,
                      dtype=np.float32)[:n].reshape(len(taps), 3)
    ratios = np.asarray(RATIOS, np.float32)
    out = []
    for (_, (h, w)), sz in zip(taps, sizes):
        bw = np.concatenate([sz * r for r in ratios]) * h / w
        bh = np.concatenate([sz / r for r in ratios]) * w / h
        cy = (np.arange(h, dtype=np.float32) + 0.5) / h
        cx = (np.arange(w, dtype=np.float32) + 0.5) / w
        rows = []
        for y in cy:
            for x in cx:
                rows.append(np.stack([x - bw / 2, y - bh / 2,
                                      x + bw / 2, y + bh / 2], axis=1))
        out.append(np.concatenate(rows).astype(np.float32))
    return torch.from_numpy(np.concatenate(out))


def _center(b):
    return torch.stack(((b[..., 0] + b[..., 2]) / 2,
                        (b[..., 1] + b[..., 3]) / 2,
                        b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]), -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[N, 4] x [M, 4] -> [N, M]`` IoU of corner boxes."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def assign(anc: torch.Tensor, boxes: torch.Tensor,
           threshold: float) -> torch.Tensor:
    """One image: ``[A]`` index of the box each anchor is assigned, -1
    for background. ``boxes`` holds the valid boxes only."""
    a = anc.shape[0]
    amap = torch.full((a,), -1, dtype=torch.long, device=anc.device)
    if boxes.shape[0] == 0:
        return amap
    jac = iou(anc, boxes)
    best, arg = jac.max(dim=1)
    amap = torch.where(best >= threshold, arg, amap)
    jac = jac.clone()
    n = boxes.shape[0]
    for _ in range(n):
        flat = int(jac.argmax())
        ai, bi = flat // n, flat % n
        if float(jac[ai, bi]) < 0:
            break
        amap[ai] = bi
        jac[:, bi] = -1.0
        jac[ai, :] = -1.0
    return amap


def targets(anc: torch.Tensor, labels: torch.Tensor, threshold: float):
    """``labels [B, N, 5]`` (class, x1, y1, x2, y2; -1 rows padding) ->
    ``(offsets [B, A, 4], mask [B, A, 4], classes [B, A])``, class 0
    the background."""
    offs, masks, classes = [], [], []
    c_anc = _center(anc)
    for lab in labels:
        valid = lab[lab[:, 0] >= 0]
        amap = assign(anc, valid[:, 1:], threshold)
        pos = amap >= 0
        picked = valid[amap.clamp(min=0)] if valid.shape[0] else \
            torch.zeros((anc.shape[0], 5), device=anc.device)
        box = torch.where(pos[:, None], picked[:, 1:], 0.0)
        c_gt = _center(box)
        off = torch.cat([10.0 * (c_gt[:, :2] - c_anc[:, :2]) / c_anc[:, 2:],
                         5.0 * torch.log(1e-6 + c_gt[:, 2:] / c_anc[:, 2:])],
                        dim=1)
        mask = pos[:, None].float().expand(-1, 4)
        offs.append(off * mask)
        masks.append(mask)
        classes.append(torch.where(pos, picked[:, 0].long() + 1, 0))
    return torch.stack(offs), torch.stack(masks), torch.stack(classes)


def loss(cls_preds, box_preds, anc, labels, threshold: float,
         loss_ratio: float) -> torch.Tensor:
    """The SSD loss of one batch's predictions."""
    off, mask, cls = targets(anc, labels, threshold)
    logp = torch.log_softmax(cls_preds.reshape(-1, cls_preds.shape[-1]), -1)
    flat = cls.reshape(-1)
    ce = -logp.gather(1, flat[:, None])[:, 0]
    pos = flat > 0
    gt = torch.where(pos, ce, 0.0).sum() / pos.sum().clamp(min=1)
    bg = torch.where(pos, 0.0, ce).sum() / (~pos).sum().clamp(min=1)
    l1 = (box_preds * mask - off * mask).abs().mean()
    return gt * loss_ratio + bg * (1 - loss_ratio) + l1


def decode(anc: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Predicted corner boxes of ``offsets [..., A, 4]``."""
    c = _center(anc)
    xy = offsets[..., :2] * c[:, 2:] / 10.0 + c[:, :2]
    wh = torch.exp(offsets[..., 2:] / 5.0) * c[:, 2:]
    return torch.cat([xy - 0.5 * wh, xy + 0.5 * wh], dim=-1)


def detect(cls_preds, box_preds, anc) -> torch.Tensor:
    """``[B, 300, 6]`` rows (class, conf, x1, y1, x2, y2); suppressed and
    background rows have class -1."""
    probs = torch.softmax(cls_preds, dim=-1)
    conf, arg = probs.max(dim=-1)
    cid = arg - 1
    boxes = decode(anc, box_preds)
    out = []
    for b in range(cls_preds.shape[0]):
        rank = torch.where(cid[b] >= 0, conf[b], conf[b] - 2.0)
        k = min(MAX_OUT, rank.shape[0])
        order = torch.sort(rank, descending=True, stable=True)[1][:k]
        c, s, bx = cid[b][order], conf[b][order], boxes[b][order]
        jac = iou(bx, bx)
        keep = c >= 0
        kept = keep.clone()
        # greedy: a kept box suppresses the later boxes of its class
        sup = (jac > NMS_IOU) & (c[:, None] == c[None, :])
        sup = torch.triu(sup, diagonal=1).cpu()
        kept_list = kept.cpu().tolist()
        for i in range(k):
            if kept_list[i]:
                row = sup[i].tolist()
                for j in range(i + 1, k):
                    if row[j]:
                        kept_list[j] = False
        kept = torch.tensor(kept_list, device=cls_preds.device)
        below = s < POS_THRESHOLD
        oc = torch.where(kept & ~below, c, -1)
        os_ = torch.where(below, 1.0 - s, s)
        out.append(torch.cat([oc[:, None].float(), os_[:, None], bx], 1))
    return torch.stack(out)
