"""Event-frame visualization on the host (OpenCV).

Counterpart of ``snn_for_object_detection_tpu/utils/plotter.py`` (the
reference's ``Plotter``, utils/plotter.py): positive events red,
negative blue; ground-truth boxes 2 px, predictions 1 px with their
confidence and label; an optional window and an XVID ``.avi`` written at
``1000 / interval`` fps. Takes numpy ``[H, W, 2]`` frames and detection
rows ``(class, conf, x1, y1, x2, y2)``; it never touches the card.

``cv2`` is used where it imports. Without it, as in the JAX package,
frames are coloured, no box is drawn and no video is shown or written.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

try:  # headless-safe import
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

# Tableau palette in BGR (matplotlib TABLEAU_COLORS order)
_TABLEAU_BGR = [
    (180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214),
    (189, 103, 148), (75, 86, 140), (194, 119, 227), (127, 127, 127),
    (34, 189, 188), (207, 190, 23),
]


class Plotter:
    """Render event frames with prediction and ground-truth overlays."""

    def __init__(
        self,
        threshold: float = 0.8,
        show_video: bool = False,
        save_video: bool = True,
        file_path: str = "log",
        file_name: str = "out",
    ):
        self.threshold = threshold
        self.show_video = show_video
        self.save_video = save_video
        self.file_path = file_path
        self.file_name = file_name
        self.labels: Optional[List[str]] = None

    def apply(
        self,
        frame: np.ndarray,
        predictions: Optional[np.ndarray] = None,
        target: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """[H, W, 2] event frame -> BGR image with boxes drawn.

        :param predictions: [K, 6] (class, conf, x1..y2 normalized);
            rows with class < 0 or conf < threshold are skipped.
        :param target: [N, 5] (class, x1..y2 normalized), -1-padded.
        """
        frame = np.asarray(frame)
        h, w = frame.shape[:2]
        img = np.zeros((h, w, 3), dtype=np.uint8)
        img[frame[..., 1] > 0, 2] = 255  # positive -> red channel
        img[frame[..., 0] > 0, 0] = 255  # negative -> blue channel
        if target is not None:
            self._draw_targets(img, np.asarray(target), h, w)
        if predictions is not None:
            self._draw_preds(img, np.asarray(predictions), h, w)
        return img

    def _draw_targets(self, img, target, h, w):
        if not _HAS_CV2:
            return
        target = target[target[:, 0] >= 0]
        for row in target:
            cls = int(row[0])
            pt1 = (int(row[1] * w), int(row[2] * h))
            pt2 = (int(row[3] * w), int(row[4] * h))
            cv2.rectangle(
                img, pt1, pt2,
                color=_TABLEAU_BGR[cls % len(_TABLEAU_BGR)],
                thickness=2, lineType=cv2.LINE_AA,
            )

    def _draw_preds(self, img, preds, h, w):
        if not _HAS_CV2:
            return
        preds = preds[(preds[:, 0] >= 0) & (preds[:, 1] >= self.threshold)]
        for row in preds:
            cls = int(row[0])
            pt1 = (int(row[2] * w), int(row[3] * h))
            pt2 = (int(row[4] * w), int(row[5] * h))
            cv2.rectangle(
                img, pt1, pt2,
                color=_TABLEAU_BGR[cls % len(_TABLEAU_BGR)],
                thickness=1, lineType=cv2.LINE_AA,
            )
            label = self.labels[cls] if self.labels else ""
            cv2.putText(
                img,
                f"{row[1]:.2f} {label}",
                org=(pt1[0], pt1[1] - 4),
                fontFace=cv2.FONT_HERSHEY_SIMPLEX,
                fontScale=0.4,
                thickness=1,
                color=(255, 255, 255),
                lineType=cv2.LINE_AA,
            )

    def __call__(
        self, video: List[np.ndarray], interval: int, batch_idx: str = ""
    ) -> None:
        if self.show_video and _HAS_CV2:
            self._show(video, interval, batch_idx)
        if self.save_video and _HAS_CV2:
            self._save(video, interval, batch_idx)

    def _show(self, video, interval, batch_idx):  # pragma: no cover
        while True:
            for img in video:
                cv2.imshow("Res", img)
                if cv2.waitKey(interval) == ord("q"):
                    cv2.destroyAllWindows()
                    return
            if cv2.waitKey() == ord("q"):
                cv2.destroyAllWindows()
                return

    def _save(self, video, interval, batch_idx):
        h, w, _ = video[0].shape
        os.makedirs(self.file_path, exist_ok=True)
        out = cv2.VideoWriter(
            os.path.join(self.file_path, self.file_name + batch_idx + ".avi"),
            cv2.VideoWriter_fourcc(*"XVID"),
            1000 / interval,
            (w, h),
        )
        for img in video:
            out.write(img)
        out.release()
