"""Scalable YOLO-SNN family: TinyYolo's topology with width and depth
multipliers (the YOLOv8 n/s/m/l scaling convention).

The port's counterpart of ``snn_for_object_detection_tpu/models/yolo.py``:
``YoloSNN(scale="s")`` etc.; ``scale="tiny"`` is TinyYolo's channel and
depth table exactly.
"""

from __future__ import annotations

from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo

# (width multiplier against TinyYolo's 64 base, extra C2f depth)
_SCALES = {
    "tiny": (1.0, 0),
    "s": (1.5, 1),
    "m": (2.0, 2),
    "l": (3.0, 2),
}


class YoloSNN(TinyYolo):
    """Width/depth-scaled TinyYolo.

    Scaling rewrites the instance's stage plans: channels multiply by
    the width factor (rounded down to a multiple of 16, at least 16) and
    every C2f deepens by the depth increment.

    :param scale: One of ``tiny``, ``s``, ``m``, ``l``.
    """

    def __init__(self, *args, scale: str = "s", **kwargs):
        if scale not in _SCALES:
            raise ValueError(f"scale must be one of {sorted(_SCALES)}")
        self.scale = scale
        width, extra_depth = _SCALES[scale]

        def ch(base: int) -> int:
            return max(16, int(base * width) // 16 * 16)

        self.backbone_plan = tuple(
            (ch(c), d + extra_depth) for c, d in TinyYolo.backbone_plan
        )
        self.neck_plan = tuple(
            (ch(c), d + extra_depth) for c, d in TinyYolo.neck_plan
        )
        super().__init__(*args, **kwargs)
