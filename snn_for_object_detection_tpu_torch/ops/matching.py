"""Anchor-to-ground-truth assignment (RoI labeling), batched.

Counterpart of ``snn_for_object_detection_tpu/ops/matching.py`` (the
reference's utils/roi.py:18-109, d2l-style two-stage assignment):

1. every anchor takes the valid GT with max IoU if it is >= threshold;
2. every GT force-claims its argmax anchor via an iterative global
   argmax with row/column discard.

Labels arrive ``-1``-padded to a static ``[B, N, 5]``; stage 2 is a
loop of N masked steps over the whole batch at once.
"""

from __future__ import annotations

from typing import Tuple

import torch

from snn_for_object_detection_tpu_torch.ops import boxes as box_ops


def assign_anchors_to_boxes(anchors: torch.Tensor, labels: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """``anchors [A, 4]``, ``labels [B, N, 5]`` (class, x1, y1, x2, y2)
    -> ``[B, A]`` int64 map anchor -> GT index, -1 for background."""
    B, N = labels.shape[0], labels.shape[1]
    A = anchors.shape[0]
    valid = labels[..., 0] >= 0
    iou = box_ops.box_iou(anchors[None], labels[..., 1:])  # [B, A, N]
    # padded GT columns can never win: -1 is below any IoU
    iou = torch.where(valid[:, None, :], iou, -1.0)

    amap = torch.where(
        iou.amax(dim=2) >= iou_threshold, iou.argmax(dim=2), -1
    )

    # stage 2: discarded and padded entries are -1, so `val >= 0` gates
    # each masked update; the loop runs the padded N times
    rows = torch.arange(B, device=labels.device)
    anchor_ids = torch.arange(A, device=labels.device)
    box_ids = torch.arange(N, device=labels.device)
    jac = iou
    for _ in range(N):
        flat = jac.reshape(B, -1).argmax(dim=1)
        anc, box = flat // N, flat % N
        do = jac[rows, anc, box] >= 0
        amap[rows, anc] = torch.where(do, box, amap[rows, anc])
        col = (box_ids[None, :] == box[:, None]) & do[:, None]
        row = (anchor_ids[None, :] == anc[:, None]) & do[:, None]
        jac = jac.masked_fill(col[:, None, :] | row[:, :, None], -1.0)
    return amap


def match_targets(
    anchors: torch.Tensor, labels: torch.Tensor, iou_threshold: float = 0.5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Label anchors with offsets / masks / classes for a whole batch.

    :param anchors: [A, 4] corner-format anchors.
    :param labels: [B, N, 5] (class, x1, y1, x2, y2), -1-padded.
    :return: ``(bbox_offset [B, A, 4], bbox_mask [B, A, 4],
        class_labels [B, A])`` with class 0 = background.
    """
    amap = assign_anchors_to_boxes(anchors, labels, iou_threshold)
    pos = amap >= 0
    idx = amap.clamp(min=0)
    picked = torch.gather(
        labels, 1, idx[..., None].expand(-1, -1, labels.shape[-1])
    )
    assigned = torch.where(pos[..., None], picked[..., 1:], 0.0)
    class_labels = torch.where(pos, picked[..., 0].long() + 1, 0)
    mask = pos[..., None].to(anchors.dtype).expand(-1, -1, 4)
    offset = box_ops.encode_offsets(anchors, assigned) * mask
    return offset, mask, class_labels
