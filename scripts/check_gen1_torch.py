#!/usr/bin/env python3
"""Validate an on-disk GEN1 / 1Mpx dataset layout before training the port.

The port's counterpart of ``scripts/check_gen1.py``: the same checks, the
same problem lines and exit codes, read with the port's own decoder and
geometry (``snn_for_object_detection_tpu_torch/data/psee.py``
``EventReader``, ``data/prophesee.py`` ``DATASET_GEOMETRY``). It answers
"will ``python -m snn_for_object_detection_tpu_torch fit --config
config/gen1_repro.yaml`` run on this disk?".

Checks per split (train/val/test):
  - every ``*_bbox.npy`` has its paired ``*_td.dat`` (and vice versa),
    the pairing that ``PropheseeDataModule`` reads;
  - the .dat header parses, the event size is 8 bytes, the payload is a
    whole number of records;
  - sampled events: timestamps non-decreasing, x/y within the dataset
    geometry (304x240 GEN1 / 1280x720 1Mpx);
  - labels: a structured dtype with the expected fields (GEN1 time field
    'ts', 1Mpx 't'), class_id within the dataset's class count,
    non-negative box sizes.

Usage:
    python scripts/check_gen1_torch.py DATA_DIR [--dataset gen1|1mpx]
                                       [--max-files N]

Exit code 0 = ready; 1 = problems found (each printed).

Host side only: numpy and the port's data modules, no torch and no
device.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snn_for_object_detection_tpu_torch.data.psee import EventReader  # noqa: E402
from snn_for_object_detection_tpu_torch.data.prophesee import (  # noqa: E402
    DATASET_GEOMETRY,
)

SPLITS = ("train", "val", "test")
LABEL_FIELDS = ("x", "y", "w", "h", "class_id")
SAMPLE_EVENTS = 50_000  # events read at each end of a recording


def check_events(tag: str, dat_path: str, height: int, width: int,
                 problems: list[str]) -> int | None:
    """Check one .dat file; returns its event count, ``None`` when its
    header cannot be read."""
    try:
        reader = EventReader(dat_path)
    except Exception as e:  # any unreadable header is a problem line
        problems.append(f"{tag}: unreadable .dat header ({e})")
        return None
    n = reader.n_events
    if n == 0:
        problems.append(f"{tag}: zero events")
        return 0
    # the head and tail slices: monotonic time, coordinates in range
    idx = np.r_[0:min(n, SAMPLE_EVENTS), max(n - SAMPLE_EVENTS, 0):n]
    recs = reader._records[np.unique(idx)]
    if np.any(np.diff(recs[:, 0].astype(np.int64)) < 0):
        problems.append(f"{tag}: timestamps not sorted")
    x = recs[:, 1] & 0x3FFF
    y = (recs[:, 1] >> 14) & 0x3FFF
    if int(x.max()) >= width or int(y.max()) >= height:
        problems.append(f"{tag}: event coords out of {width}x{height} "
                        f"(max x={int(x.max())}, y={int(y.max())})")
    return n


def check_labels(tag: str, gt_path: str, dataset: str, time_field: str,
                 classes, problems: list[str]) -> int:
    """Check one label file; returns the boxes it holds when its fields
    are whole."""
    try:
        gt = np.load(gt_path)
    except Exception as e:  # any unreadable array is a problem line
        problems.append(f"{tag}: unreadable .npy ({e})")
        return 0
    names = gt.dtype.names or ()
    for field in (time_field, *LABEL_FIELDS):
        if field not in names:
            problems.append(
                f"{tag}: missing GT field '{field}' (dataset '{dataset}' "
                f"expects time field '{time_field}'; has {list(names)})")
    if not ({time_field, *LABEL_FIELDS} <= set(names) and len(gt)):
        return 0
    cid = gt["class_id"].astype(np.int64)
    if cid.min() < 0 or cid.max() >= len(classes):
        problems.append(f"{tag}: class_id out of [0, {len(classes)}) "
                        f"(found {cid.min()}..{cid.max()})")
    if np.any(gt["w"] < 0) or np.any(gt["h"] < 0):
        problems.append(f"{tag}: negative box sizes")
    return len(gt)


def check_split(data_dir: str, dataset: str, split: str, max_files: int
                ) -> list[str]:
    height, width, time_field, classes = DATASET_GEOMETRY[dataset]
    split_dir = os.path.join(data_dir, dataset, split)
    if not os.path.isdir(split_dir):
        return [f"{split}: missing directory {split_dir}"]
    problems: list[str] = []
    gt_files = sorted(glob.glob(os.path.join(split_dir, "*_bbox.npy")))
    dat_files = sorted(glob.glob(os.path.join(split_dir, "*_td.dat")))
    if not gt_files:
        problems.append(f"{split}: no *_bbox.npy files in {split_dir}")
    expect_dat = {p.replace("_bbox.npy", "_td.dat") for p in gt_files}
    for missing in sorted(expect_dat - set(dat_files)):
        problems.append(f"{split}: label without events: {missing}")
    expect_gt = {p.replace("_td.dat", "_bbox.npy") for p in dat_files}
    for missing in sorted(expect_gt - set(gt_files)):
        problems.append(f"{split}: events without label: {missing}")

    dat_set = set(dat_files)
    pairs = [(g, g.replace("_bbox.npy", "_td.dat")) for g in gt_files
             if g.replace("_bbox.npy", "_td.dat") in dat_set]
    n_events = n_boxes = 0
    for gt_path, dat_path in pairs[:max_files]:
        tag = f"{split}/{os.path.basename(dat_path)}"
        n = check_events(tag, dat_path, height, width, problems)
        if n is None:  # no label check after a bad header
            continue
        n_events += n
        n_boxes += check_labels(f"{split}/{os.path.basename(gt_path)}",
                                gt_path, dataset, time_field, classes,
                                problems)

    print(f"[{dataset}/{split}] {len(pairs)} paired recordings"
          + (f" (checked {min(len(pairs), max_files)})" if pairs else "")
          + f", {n_events:,} events, {n_boxes:,} boxes sampled")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_dir", help="root containing <dataset>/<split>/")
    ap.add_argument("--dataset", default="gen1",
                    choices=sorted(DATASET_GEOMETRY))
    ap.add_argument("--max-files", type=int, default=16,
                    help="recordings to deep-check per split")
    args = ap.parse_args(argv)

    problems: list[str] = []
    for split in SPLITS:
        problems += check_split(args.data_dir, args.dataset, split,
                                args.max_files)
    if problems:
        print(f"\nFAIL — {len(problems)} problem(s):")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(f"\nOK — {args.dataset} layout under {args.data_dir} is "
          "ready for training")
    return 0


if __name__ == "__main__":
    sys.exit(main())
