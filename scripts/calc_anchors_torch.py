#!/usr/bin/env python3
"""Data-driven anchor sizes and ratios, from the PyTorch port alone
(the counterpart of ``scripts/calc_anchors.py``; no JAX).

Scans a dataset split's ``*_bbox.npy`` ground-truth files, inverts the
anchor generator's box math, k-means the boxes' sizes and ratios
(``ops/anchors.calc_anchor_params`` of the port) and prints a YAML
snippet to paste into the model config::

    python scripts/calc_anchors_torch.py --data_dir data --dataset gen1
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snn_for_object_detection_tpu_torch.data.prophesee import (  # noqa: E402
    DATASET_GEOMETRY,
)
from snn_for_object_detection_tpu_torch.ops.anchors import (  # noqa: E402
    calc_anchor_params,
)


def collect_box_wh(data_dir: str, dataset: str, split: str,
                   box_size_threshold: float) -> np.ndarray:
    """[N, 2] normalized (w, h) of the split's boxes whose area is at
    least ``box_size_threshold`` (the training loader's small-box
    filter)."""
    height, width = DATASET_GEOMETRY[dataset][:2]
    split_dir = os.path.join(data_dir, dataset, split)
    files = sorted(glob.glob(os.path.join(split_dir, "*_bbox.npy")))
    if not files:
        raise FileNotFoundError(f"no *_bbox.npy under {split_dir}")
    ws, hs = [], []
    for path in files:
        gt = np.load(path)
        w = np.asarray(gt["w"], np.float64) / width
        h = np.asarray(gt["h"], np.float64) / height
        keep = (w * h) >= box_size_threshold
        ws.append(w[keep])
        hs.append(h[keep])
    return np.stack([np.concatenate(ws), np.concatenate(hs)], axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--dataset", default="gen1",
                    choices=sorted(DATASET_GEOMETRY.keys()))
    ap.add_argument("--split", default="train")
    ap.add_argument("--num_scales", type=int, default=3)
    ap.add_argument("--sizes_per_scale", type=int, default=3)
    ap.add_argument("--num_ratios", type=int, default=3)
    ap.add_argument("--box_size_threshold", type=float, default=0.01)
    args = ap.parse_args(argv)

    height, width = DATASET_GEOMETRY[args.dataset][:2]
    wh = collect_box_wh(args.data_dir, args.dataset, args.split,
                        args.box_size_threshold)
    sizes, ratios = calc_anchor_params(
        wh, args.num_scales, args.sizes_per_scale, args.num_ratios,
        feat_aspect=width / height)
    print(f"# {wh.shape[0]} GT boxes from {args.split}/ "
          f"({args.dataset}, {width}x{height})")
    print("model:")
    print("  init_args:")
    print("    anchor_sizes:")
    for row in sizes:
        print(f"      - [{', '.join(f'{v:.4f}' for v in row)}]")
    print(f"    anchor_ratios: [{', '.join(f'{v:.4f}' for v in ratios)}]")


if __name__ == "__main__":
    main()
