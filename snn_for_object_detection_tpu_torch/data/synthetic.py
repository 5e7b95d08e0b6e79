"""Synthetic event-camera recordings with moving-box ground truth.

The port's copy of ``snn_for_object_detection_tpu/data/synthetic.py``:
the same ``np.random.default_rng`` draws in the same order, so one seed
writes the same files byte for byte in both packages.

The reference has no test data strategy (SURVEY.md §4); this module
generates GEN1-format recordings (paired ``*_td.dat`` + ``*_bbox.npy``)
so the full pipeline — decoder, rasterizer, sampling, training, mAP —
runs hermetically in CI and benchmarks without the (tens-of-GB) real
datasets.

Scene model: N boxes with constant velocity bounce around the frame;
each box emits events densely on its interior with polarity split by
motion direction, over a noisy background. Default densities exceed the
single-target sampler's 4000-events/frame acceptance threshold
(datasets.py:354,417-418) so ST sampling never starves. The GT ``.npy`` uses the
reference's structured dtype (datasets.py:255,264-269).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from snn_for_object_detection_tpu_torch.data.psee import write_dat


def gt_dtype(time_field: str = "ts") -> np.dtype:
    """GT structured dtype; GEN1 uses 'ts', 1Mpx uses 't'
    (datasets.py:213,217)."""
    return np.dtype(
        [
            (time_field, "<u8"),
            ("x", "<f4"),
            ("y", "<f4"),
            ("w", "<f4"),
            ("h", "<f4"),
            ("class_id", "<u4"),
            ("confidence", "<f4"),
            ("track_id", "<u4"),
        ]
    )


def generate_recording(
    duration_ms: int = 2000,
    time_step_ms: int = 16,
    height: int = 240,
    width: int = 304,
    num_objects: int = 2,
    num_classes: int = 2,
    events_per_box_frame: int = 2200,
    background_events_per_frame: int = 800,
    gt_period_ms: int = 100,
    seed: int = 0,
    time_field: str = "ts",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Generate one recording.

    :return: (t [µs], x, y, p, gt_structured_array)
    """
    rng = np.random.default_rng(seed)
    n_frames = duration_ms // time_step_ms
    step_us = time_step_ms * 1000

    # Object states: position (center), velocity (px/frame), size, class
    cx = rng.uniform(0.25 * width, 0.75 * width, num_objects)
    cy = rng.uniform(0.25 * height, 0.75 * height, num_objects)
    vx = rng.uniform(1.0, 3.0, num_objects) * rng.choice([-1, 1], num_objects)
    vy = rng.uniform(0.5, 2.0, num_objects) * rng.choice([-1, 1], num_objects)
    bw = rng.uniform(0.18 * width, 0.30 * width, num_objects)
    bh = rng.uniform(0.18 * height, 0.30 * height, num_objects)
    cls = rng.integers(0, num_classes, num_objects)

    ts_list, xs_list, ys_list, ps_list = [], [], [], []
    gt_rows = []

    for f in range(n_frames):
        t0 = f * step_us
        # background noise
        nb = background_events_per_frame
        ts_list.append(rng.integers(t0, t0 + step_us, nb).astype(np.uint32))
        xs_list.append(rng.integers(0, width, nb).astype(np.uint16))
        ys_list.append(rng.integers(0, height, nb).astype(np.uint16))
        ps_list.append(rng.integers(0, 2, nb).astype(np.uint8))

        for o in range(num_objects):
            x1 = np.clip(cx[o] - bw[o] / 2, 0, width - 2)
            y1 = np.clip(cy[o] - bh[o] / 2, 0, height - 2)
            x2 = np.clip(cx[o] + bw[o] / 2, x1 + 1, width - 1)
            y2 = np.clip(cy[o] + bh[o] / 2, y1 + 1, height - 1)
            ne = events_per_box_frame
            ex = rng.uniform(x1, x2, ne)
            ey = rng.uniform(y1, y2, ne)
            # polarity correlates with horizontal motion direction
            pol = np.full(ne, int(vx[o] > 0), np.uint8)
            flip = rng.random(ne) < 0.2
            pol[flip] = 1 - pol[flip]
            ts_list.append(rng.integers(t0, t0 + step_us, ne).astype(np.uint32))
            xs_list.append(ex.astype(np.uint16))
            ys_list.append(ey.astype(np.uint16))
            ps_list.append(pol)

            # GT at gt_period (box update 1-4 Hz in real data,
            # datasets.py:340)
            if (t0 // 1000) % gt_period_ms == 0:
                gt_rows.append(
                    (
                        t0,
                        x1,
                        y1,
                        x2 - x1,
                        y2 - y1,
                        int(cls[o]),
                        1.0,
                        o,
                    )
                )

            # integrate motion, bounce at walls
            cx[o] += vx[o]
            cy[o] += vy[o]
            if cx[o] - bw[o] / 2 < 0 or cx[o] + bw[o] / 2 >= width:
                vx[o] = -vx[o]
            if cy[o] - bh[o] / 2 < 0 or cy[o] + bh[o] / 2 >= height:
                vy[o] = -vy[o]

    t = np.concatenate(ts_list)
    x = np.concatenate(xs_list)
    y = np.concatenate(ys_list)
    p = np.concatenate(ps_list)
    order = np.argsort(t, kind="stable")
    gt = np.array(gt_rows, dtype=gt_dtype(time_field))
    return t[order], x[order], y[order], p[order], gt


def make_synthetic_dataset(
    root: str,
    dataset: str = "gen1",
    records_per_split: int = 2,
    duration_ms: int = 2000,
    height: int = 240,
    width: int = 304,
    num_classes: int = 2,
    seed: int = 0,
    splits: Tuple[str, ...] = ("train", "val", "test"),
) -> str:
    """Write a GEN1-layout synthetic dataset under ``root``.

    Produces ``root/<dataset>/<split>/rec<i>_td.dat`` +
    ``rec<i>_bbox.npy``, consumable by :class:`PropheseeDataModule`
    with ``data_dir=root``.
    """
    for split_i, split in enumerate(splits):
        d = os.path.join(root, dataset, split)
        os.makedirs(d, exist_ok=True)
        time_field = "t" if dataset == "1mpx" else "ts"
        for i in range(records_per_split):
            t, x, y, p, gt = generate_recording(
                duration_ms=duration_ms,
                height=height,
                width=width,
                num_classes=num_classes,
                seed=seed + 1000 * split_i + i,
                time_field=time_field,
            )
            write_dat(
                os.path.join(d, f"rec{i}_td.dat"), t, x, y, p, width, height
            )
            np.save(os.path.join(d, f"rec{i}_bbox.npy"), gt)
    return root
