"""SSD anchor-grid generation.

The port's own copy of the numpy anchor code in
``snn_for_object_detection_tpu/ops/anchors.py``, with its data-driven
anchor sizes and ratios (:func:`calc_anchor_params`,
``scripts/calc_anchors_torch.py``). Parity target: the reference's ``AnchorGenerator``
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


def kmeans_1d(values: np.ndarray, k: int, iters: int = 100) -> np.ndarray:
    """Deterministic 1-D Lloyd k-means (quantile init), sorted centers.

    Quantile initialization and 1-D assignment by midpoint bisection make
    the result reproducible with no random draw, as a config-generation
    utility wants.
    """
    values = np.sort(np.asarray(values, np.float64).ravel())
    if values.size == 0:
        raise ValueError("kmeans_1d: no values")
    centers = np.quantile(values, (np.arange(k) + 0.5) / k)
    for _ in range(iters):
        edges = (centers[1:] + centers[:-1]) / 2.0
        assign = np.searchsorted(edges, values)
        new = np.array([
            values[assign == j].mean() if np.any(assign == j) else centers[j]
            for j in range(k)
        ])
        if np.allclose(new, centers):
            break
        centers = new
    return np.sort(centers).astype(np.float32)


def calc_anchor_params(
    box_wh: np.ndarray,
    num_scales: int,
    size_per_pix: int = 3,
    num_ratios: int = 3,
    feat_aspect: float = 1.0,
):
    """Anchor sizes and ratios from the ground truth (the reference's
    ``# TODO Automatic calculation``, generator.py:389).

    Inverts the generator's box math (``w = size*ratio*H_f/W_f``,
    ``h = size/ratio*W_f/H_f``): a box of normalized (w, h) is best
    covered by ``size = sqrt(w*h)`` (the aspect corrections cancel) and
    ``ratio = sqrt(w/h) * W_f/H_f``. K-means over the boxes gives the
    size table (ascending: small sizes on the high-resolution scale, as
    :func:`default_scale_sizes`) and the shared ratio list.

    :param box_wh: [N, 2] normalized GT (width, height).
    :param feat_aspect: ``W_f/H_f`` of the feature maps (the image's
        W/H, the same on every scale up to rounding).
    :return: (sizes [num_scales, size_per_pix], ratios [num_ratios]).
    """
    box_wh = np.asarray(box_wh, np.float64)
    w, h = box_wh[:, 0], box_wh[:, 1]
    good = (w > 0) & (h > 0)
    if not np.any(good):
        raise ValueError("calc_anchor_params: no valid boxes")
    w, h = w[good], h[good]
    sizes = kmeans_1d(np.sqrt(w * h), num_scales * size_per_pix)
    ratios = kmeans_1d(np.sqrt(w / h) * feat_aspect, num_ratios)
    return sizes.reshape(num_scales, size_per_pix), ratios
