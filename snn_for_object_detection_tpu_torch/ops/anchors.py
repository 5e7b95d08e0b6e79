"""SSD anchor-grid generation.

The port's own copy of the numpy anchor code in
``snn_for_object_detection_tpu/ops/anchors.py`` (what the detector
needs of it). Parity target: the reference's ``AnchorGenerator``
(utils/anchors.py:46-85).
Per-pixel centers at ``((i + 0.5)/H, (j + 0.5)/W)``; per-pixel box shapes
from the size x ratio cross product with the reference's aspect
correction ``w *= H/W``, ``h *= W/H`` (H, W are the *feature map* dims,
anchors.py:64-73). Ratio-major ordering (all sizes for ratio 0, then
ratio 1, ...), pixels row-major, matching anchors.py:64-85.

Anchors are a pure function of static feature-map shapes, so they are
computed once in numpy at model-build time and kept on the device as a
constant tensor (the analogue of the reference's first-call cache,
anchors.py:41-44).
"""

from __future__ import annotations

import numpy as np


def generate_anchors(
    feat_h: int, feat_w: int, sizes: np.ndarray, ratios: np.ndarray
) -> np.ndarray:
    """Generate the anchor grid for one feature map.

    :param feat_h: Feature map height.
    :param feat_w: Feature map width.
    :param sizes: Box scales in (0, 1], shape [S].
    :param ratios: Width/height ratios, shape [R].
    :return: [feat_h * feat_w * S * R, 4] float32 corner-format anchors,
        normalized to [0, 1] image coordinates.
    """
    sizes = np.asarray(sizes, dtype=np.float32)
    ratios = np.asarray(ratios, dtype=np.float32)
    boxes_per_pixel = sizes.size * ratios.size

    center_h = (np.arange(feat_h, dtype=np.float32) + 0.5) / feat_h
    center_w = (np.arange(feat_w, dtype=np.float32) + 0.5) / feat_w
    shift_y, shift_x = np.meshgrid(center_h, center_w, indexing="ij")
    shift_y, shift_x = shift_y.reshape(-1), shift_x.reshape(-1)

    # Ratio-major shape lists with the reference's aspect correction.
    w = np.concatenate([sizes * r for r in ratios]) * feat_h / feat_w
    h = np.concatenate([sizes / r for r in ratios]) * feat_w / feat_h

    manipulations = np.tile(
        np.stack((-w, -h, w, h), axis=1) / 2.0, (feat_h * feat_w, 1)
    )
    grid = np.repeat(
        np.stack([shift_x, shift_y, shift_x, shift_y], axis=1),
        boxes_per_pixel,
        axis=0,
    )
    return (grid + manipulations).astype(np.float32)


def default_scale_sizes(num_scales: int, size_per_pix: int = 3,
                        min_size: float = 0.08, max_size: float = 0.75) -> np.ndarray:
    """The reference's per-scale size table (generator.py:390-396):
    ``arange(min, max, (max-min)/(num_scales*size_per_pix))`` reshaped to
    ``[num_scales, size_per_pix]``.
    """
    sizes = np.arange(
        min_size,
        max_size,
        (max_size - min_size) / (num_scales * size_per_pix),
        dtype=np.float32,
    )
    # arange with float step can overshoot; clip to the expected count.
    sizes = sizes[: num_scales * size_per_pix]
    return sizes.reshape(num_scales, size_per_pix)


DEFAULT_RATIOS = np.array([0.5, 1.0, 2.0], dtype=np.float32)
