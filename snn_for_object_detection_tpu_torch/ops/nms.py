"""Shape-static batched NMS and detection post-processing.

Counterpart of ``snn_for_object_detection_tpu/ops/nms.py`` (reference
utils/box.py:82-153): per-class greedy NMS by confidence, background =
class -1, low-confidence predictions demoted to background with
inverted confidence.

1. select the top-K anchors by confidence, foreground-argmax anchors
   ranked strictly first; ties go to the lower anchor index, as
   ``lax.top_k`` breaks them;
2. one ``[K, K]`` IoU matrix, then greedy suppression in sorted order
   restricted to equal class ids, a loop of K masked steps over the
   whole batch (under ``torch.export``, one ``scan`` of the same steps).

Anchors outside the top-K are non-keep (class -1).
"""

from __future__ import annotations

import numpy as np
import torch

from snn_for_object_detection_tpu_torch.ops import boxes as box_ops


def _greedy_nms_keep(sorted_boxes: torch.Tensor, sorted_cid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """``[B, K, 4]`` boxes sorted by confidence, ``[B, K]`` class ids ->
    ``[B, K]`` bool keep mask (background never kept)."""
    k = sorted_boxes.shape[1]
    iou = box_ops.box_iou(sorted_boxes, sorted_boxes)  # [B, K, K]
    later = torch.ones(k, k, dtype=torch.bool,
                       device=sorted_boxes.device).triu(1)  # j > i
    same_class = sorted_cid[:, :, None] == sorted_cid[:, None, :]
    valid = sorted_cid >= 0
    # row i: the boxes that box i suppresses if it is kept (a background
    # box suppresses none)
    suppress = later & same_class & (iou > iou_threshold) & valid[:, :, None]
    keep = torch.ones_like(valid)
    if torch.compiler.is_exporting():
        return _scan_keep(keep, suppress) & valid
    # keep & ~(keep_i & row_i)
    for i, row in enumerate(suppress.transpose(0, 1).unbind(0)):
        keep = keep > (keep[:, i:i + 1] & row)
    return keep & valid


# greedy steps one scan iteration runs, unrolled, in a traced program
SCAN_BLOCK = 20


def _scan_keep(keep: torch.Tensor, suppress: torch.Tensor) -> torch.Tensor:
    """The greedy loop of :func:`_greedy_nms_keep` as a ``scan`` over
    blocks of SCAN_BLOCK steps, the form ``torch.export`` traces
    (``export.py``): the program keeps the loop rolled, as JAX's lowered
    ``fori_loop`` does (unrolled, its K steps were most of a traced
    program's nodes and of its trace and load time), and a block's steps
    unrolled in the body (each iteration of a scan costs a call on the
    host). The body reads columns 0 .. SCAN_BLOCK - 1 of ``keep`` rotated
    left by the block's start, and each row of ``suppress`` comes rotated
    alike; K is padded to whole blocks with rows that suppress nothing.
    The same booleans as the loop, step for step."""
    from torch._higher_order_ops.scan import scan

    b, k = keep.shape
    blk = min(SCAN_BLOCK, k)
    n = -(-k // blk)
    kp = n * blk
    if kp != k:
        keep = torch.cat([keep, keep.new_ones(b, kp - k)], dim=1)
        suppress = torch.nn.functional.pad(suppress, (0, kp - k, 0, kp - k))
    pos = torch.arange(kp, device=keep.device)
    # rows[i][:, c] = suppress[:, i, (c + start of i's block) % kp]
    cols = (pos[None, :] + (pos // blk * blk)[:, None]) % kp
    rows = suppress.transpose(0, 1).gather(
        2, cols[:, None, :].expand(kp, b, kp)).reshape(n, blk, b, kp)

    def step(keep, block):
        for j in range(blk):
            keep = keep > (keep[:, j:j + 1] & block[j])
        return keep.roll(-blk, dims=1), keep.new_zeros(())

    # n rotations by a block: a whole turn, keep is in place again
    return scan(step, keep, rows)[0][:, :k]


def multibox_detection(
    cls_probs: torch.Tensor,
    offset_preds: torch.Tensor,
    anchors: torch.Tensor,
    nms_threshold: float = 0.1,
    pos_threshold: float = 0.009999999,
    max_out: int = 300,
) -> torch.Tensor:
    """Decode + NMS detection head outputs into final detections.

    :param cls_probs: [B, A, C+1] softmax class probabilities
        (channel 0 = background).
    :param offset_preds: [B, A, 4] predicted SSD offsets.
    :param anchors: [A, 4] corner-format anchors.
    :return: [B, max_out, 6] rows ``(class, conf, x1, y1, x2, y2)``;
        suppressed / background rows have class -1, and rows below
        ``pos_threshold`` carry ``1 - conf``.
    """
    conf = cls_probs.amax(dim=2)
    cid = cls_probs.argmax(dim=2) - 1
    decoded = box_ops.decode_offsets(anchors, offset_preds)

    # background-argmax anchors can never become detections, so they
    # must not crowd foreground anchors out of the static top-K
    rank = torch.where(cid >= 0, conf, conf - 2.0)
    k = min(max_out, conf.shape[1])
    top_idx = torch.sort(rank, dim=1, descending=True, stable=True)[1][:, :k]
    top_conf = conf.gather(1, top_idx)
    top_cid = cid.gather(1, top_idx)
    top_boxes = decoded.gather(1, top_idx[..., None].expand(-1, -1, 4))

    keep = _greedy_nms_keep(top_boxes, top_cid, nms_threshold)
    below = top_conf < pos_threshold
    out_cid = torch.where(keep & ~below, top_cid, -1)
    out_conf = torch.where(below, 1.0 - top_conf, top_conf)
    return torch.cat(
        [out_cid[..., None].to(decoded.dtype), out_conf[..., None], top_boxes],
        dim=-1,
    )


def filter_detections(dets) -> np.ndarray:
    """Host-side helper: one image's ``[max_out, 6]`` detections (numpy
    or a tensor) without the background rows (class < 0), as numpy."""
    if isinstance(dets, torch.Tensor):
        dets = dets.cpu().numpy()
    dets = np.asarray(dets)
    return dets[dets[:, 0] >= 0]
