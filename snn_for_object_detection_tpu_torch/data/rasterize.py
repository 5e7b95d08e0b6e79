"""Event-to-frame rasterization (host side, numpy).

The port's copy of ``snn_for_object_detection_tpu/data/rasterize.py``.
Reproduces the reference's vectorized scatter-assign (its
utils/datasets.py:331-336, 428-433): binary 0/1 frames, one channel per
polarity, in the NHWC layout ``[T, H, W, 2]`` that the port's models
take.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def rasterize(
    events: Dict[str, np.ndarray],
    time_idx: np.ndarray,
    num_steps: int,
    height: int,
    width: int,
    dtype=np.float32,
) -> np.ndarray:
    """Scatter events into binary frames.

    :param events: Column dict with ``x``, ``y``, ``p``.
    :param time_idx: Per-event frame index (precomputed by the caller,
        already window-relative), same length as the event columns.
    :param num_steps: Number of frames T.
    :return: [T, H, W, 2] array of 0/1 (channel 0 = negative polarity,
        channel 1 = positive, matching datasets.py:314-336).
    """
    frames = np.zeros((num_steps, height, width, 2), dtype=dtype)
    if time_idx.size:
        frames[
            time_idx,
            events["y"].astype(np.int64),
            events["x"].astype(np.int64),
            events["p"].astype(np.int64),
        ] = 1
    return frames
