"""Box geometry: corner/center conversion, pairwise IoU, SSD offset codec.

Counterpart of ``snn_for_object_detection_tpu/ops/boxes.py`` with the
same operation order (reference utils/box.py:9-79). Functions broadcast
over leading batch axes.
"""

from __future__ import annotations

import torch


def corner_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h). Shape [..., 4]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack(((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1), -1)


def center_to_corner(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2). Shape [..., 4]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        (cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h), -1
    )


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of corner boxes: ``[..., N, 4] x [..., M, 4] ->
    [..., N, M]``."""
    wh1 = boxes1[..., 2:] - boxes1[..., :2]
    wh2 = boxes2[..., 2:] - boxes2[..., :2]
    areas1 = wh1[..., 0] * wh1[..., 1]
    areas2 = wh2[..., 0] * wh2[..., 1]
    inter_ul = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    inter_lr = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    inters = (inter_lr - inter_ul).clamp(min=0)
    inter_areas = inters[..., 0] * inters[..., 1]
    union = areas1[..., :, None] + areas2[..., None, :] - inter_areas
    return inter_areas / union


def encode_offsets(anchors: torch.Tensor, assigned: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """SSD offsets of assigned corner boxes against corner anchors:
    ``10 * d(cxcy) / wh`` and ``5 * log(eps + wh ratio)``."""
    c_anc = corner_to_center(anchors)
    c_gt = corner_to_center(assigned)
    offset_xy = 10.0 * (c_gt[..., :2] - c_anc[..., :2]) / c_anc[..., 2:]
    offset_wh = 5.0 * torch.log(eps + c_gt[..., 2:] / c_anc[..., 2:])
    return torch.cat([offset_xy, offset_wh], dim=-1)


def decode_offsets(anchors: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_offsets`: predicted corner boxes."""
    anc = corner_to_center(anchors)
    xy = offsets[..., :2] * anc[..., 2:] / 10.0 + anc[..., :2]
    wh = torch.exp(offsets[..., 2:] / 5.0) * anc[..., 2:]
    return center_to_corner(torch.cat([xy, wh], dim=-1))
