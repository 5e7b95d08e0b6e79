"""First-party COCO-style detection mAP (host side, numpy).

The port's own copy of ``snn_for_object_detection_tpu/train/metrics.py``
(numpy only, identical code). It replaces the reference's torchmetrics
``MeanAveragePrecision`` with the ``faster_coco_eval`` C++ backend
(models/soda.py:89-96): mAP math runs on the host in every design.

Semantics follow COCO: IoU thresholds 0.50:0.95:0.05, 101-point
interpolated AP, greedy per-image per-class matching in score order,
AR at maxDets 1/10/100. Reported keys mirror soda.py:283-292:
``map``, ``map_50``, ``mar_1``, ``mar_10``, ``mar_100``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# linspace, not arange: COCOeval's exact threshold grid (arange's
# accumulated float step drifts ~1e-16 off the canonical values).
IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU for corner boxes [N,4] x [M,4]."""
    if not len(a) or not len(b):
        return np.zeros((len(a), len(b)))
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    ul = np.maximum(a[:, None, :2], b[None, :, :2])
    lr = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(lr - ul, 0, None), axis=2)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


class MeanAveragePrecision:
    """Accumulating COCO mAP over (preds, targets) image pairs.

    ``update`` takes per-image dicts:
      preds:   {"boxes": [P,4], "scores": [P], "labels": [P]}
      targets: {"boxes": [G,4], "labels": [G]}
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._preds: List[Dict[str, np.ndarray]] = []
        self._targets: List[Dict[str, np.ndarray]] = []

    def merge(self, other: "MeanAveragePrecision") -> None:
        """Fold another accumulator's images into this one (multi-host
        eval: each host accumulates its data shard, host 0 merges — the
        analogue of torchmetrics' dist sync, soda.py:95)."""
        self._preds.extend(other._preds)
        self._targets.extend(other._targets)

    def update(
        self,
        preds: List[Dict[str, np.ndarray]],
        targets: List[Dict[str, np.ndarray]],
    ) -> None:
        assert len(preds) == len(targets)
        for p, t in zip(preds, targets):
            self._preds.append(
                {k: np.asarray(v, dtype=np.float64) for k, v in p.items()}
            )
            self._targets.append(
                {k: np.asarray(v, dtype=np.float64) for k, v in t.items()}
            )

    def _match_image(
        self, pred_boxes, pred_scores, gt_boxes, max_det: int
    ):
        """Greedy match one image, one class. Returns (scores, tp-flags
        [T, D], n_gt) for all IoU thresholds at once."""
        order = np.argsort(-pred_scores, kind="stable")[:max_det]
        pred_boxes = pred_boxes[order]
        pred_scores = pred_scores[order]
        n_thr = len(IOU_THRESHOLDS)
        d = len(pred_boxes)
        g = len(gt_boxes)
        tp = np.zeros((n_thr, d), dtype=bool)
        if d and g:
            iou = _iou_matrix(pred_boxes, gt_boxes)
            for ti, thr in enumerate(IOU_THRESHOLDS):
                taken = np.zeros(g, dtype=bool)
                for di in range(d):
                    cand = np.where(~taken & (iou[di] >= thr))[0]
                    if len(cand):
                        best = cand[np.argmax(iou[di, cand])]
                        taken[best] = True
                        tp[ti, di] = True
        return pred_scores, tp, g

    def compute(self) -> Dict[str, float]:
        classes = sorted(
            set(
                int(c)
                for t in self._targets
                for c in t.get("labels", np.zeros(0))
            )
        )
        if not classes:
            return {
                "map": 0.0,
                "map_50": 0.0,
                **{f"mar_{k}": 0.0 for k in MAX_DETS},
            }

        n_thr = len(IOU_THRESHOLDS)
        ap = np.full((n_thr, len(classes)), np.nan)
        ar = {k: np.full((n_thr, len(classes)), np.nan) for k in MAX_DETS}

        for ci, cls in enumerate(classes):
            # Greedy matching in score order is prefix-stable: the
            # maxDet=k result is exactly the first k columns of the
            # maxDet=100 result — so match once per image and slice.
            per_image = []
            n_gt = 0
            for p, t in zip(self._preds, self._targets):
                p_sel = p["labels"] == cls
                t_sel = t["labels"] == cls
                scores, tp, g = self._match_image(
                    p["boxes"][p_sel], p["scores"][p_sel],
                    t["boxes"][t_sel], MAX_DETS[-1],
                )
                per_image.append((scores, tp))
                n_gt += g

            if n_gt == 0:
                continue
            scores = np.concatenate([s for s, _ in per_image])
            tps = np.concatenate([tp for _, tp in per_image], axis=1)
            if tps.shape[1] == 0:
                # GT exists but no predictions: AP/AR are 0, not NaN
                ap[:, ci] = 0.0
                for k in MAX_DETS:
                    ar[k][:, ci] = 0.0
                continue
            for k in MAX_DETS:
                tp_k = np.concatenate(
                    [tp[:, :k] for _, tp in per_image], axis=1
                )
                ar[k][:, ci] = tp_k.sum(axis=1) / n_gt
            order = np.argsort(-scores, kind="stable")
            tps = tps[:, order]
            tp_cum = np.cumsum(tps, axis=1)
            fp_cum = np.cumsum(~tps, axis=1)
            recall = tp_cum / n_gt
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            for ti in range(n_thr):
                # precision envelope + 101-point interpolation
                prec = precision[ti]
                rec = recall[ti]
                prec_env = np.maximum.accumulate(prec[::-1])[::-1]
                idx = np.searchsorted(rec, RECALL_POINTS, side="left")
                ap[ti, ci] = np.mean(
                    np.where(idx < len(prec_env), prec_env[np.minimum(idx, len(prec_env) - 1)], 0.0)
                )

        def nanmean(x):
            return float(np.nanmean(x)) if not np.isnan(x).all() else 0.0

        return {
            "map": nanmean(ap),
            "map_50": nanmean(ap[0]),
            **{f"mar_{k}": nanmean(ar[k]) for k in MAX_DETS},
        }


def detections_to_map_inputs(
    dets: np.ndarray, labels: np.ndarray
) -> tuple[List[Dict[str, np.ndarray]], List[Dict[str, np.ndarray]]]:
    """Convert batched device outputs to mAP update inputs.

    Mirrors ``SODa._map_estimate`` filtering (soda.py:294-321): rows
    with class < 0 are background/suppressed and dropped.

    :param dets: [B, K, 6] (class, conf, x1, y1, x2, y2).
    :param labels: [B, N, 5] (class, x1, y1, x2, y2), -1-padded.
    """
    preds, targets = [], []
    for det, lab in zip(np.asarray(dets), np.asarray(labels)):
        keep = det[:, 0] >= 0
        preds.append(
            {
                "boxes": det[keep, 2:],
                "scores": det[keep, 1],
                "labels": det[keep, 0].astype(np.int64),
            }
        )
        real = lab[:, 0] >= 0
        targets.append(
            {
                "boxes": lab[real, 1:],
                "labels": lab[real, 0].astype(np.int64),
            }
        )
    return preds, targets
