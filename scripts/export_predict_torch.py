#!/usr/bin/env python3
"""Export a port checkpoint as a self-contained streaming-predict file
(``snn_for_object_detection_tpu_torch/export.py``; the counterpart of
``scripts/export_stablehlo.py``, no JAX).

The file bakes in the weights and the detection decode, one
``torch.export`` program per platform; a serving process loads it with
``export.load_predict`` and needs no model code, config or checkpoint
(a CUDA program needs the port's ``ops/`` with ``csrc/`` for its cell
kernels).

Usage:
  python scripts/export_predict_torch.py <ckpt_dir> <out.pt2> \\
      [--config config/config.yaml]... [--batch-size b] \\
      [--platforms cpu,cuda] [dotted overrides]
  python scripts/export_predict_torch.py nets/tiny_yolo_synth_torch/model \\
      predict.pt2 --config nets/tiny_yolo_synth_torch/config.yaml \\
      --platforms cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snn_for_object_detection_tpu_torch.cli import (  # noqa: E402
    set_model_state,
)
from snn_for_object_detection_tpu_torch.export import (  # noqa: E402
    export_predict,
)
from snn_for_object_detection_tpu_torch.train.checkpoint import (  # noqa: E402
    load_single,
)
from snn_for_object_detection_tpu_torch.utils.config import (  # noqa: E402
    instantiate,
    load_config,
)


def main():
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("ckpt")
    parser.add_argument("out")
    parser.add_argument("--config", action="append", default=None)
    # default: symbolic batch "b" — one file serves any camera count;
    # pass an integer for a fixed-shape program
    parser.add_argument("--batch-size", default="b",
                        type=lambda s: int(s) if s.isdigit() else s)
    parser.add_argument("--platforms", default="cpu,cuda",
                        help="comma-separated, of cpu and cuda (cuda needs "
                             "a card; default %(default)s)")
    args, overrides = parser.parse_known_args()

    cfg = load_config(args.config or ["config/config.yaml"], overrides)
    # built on the CPU; export_predict moves a copy to the card for the
    # CUDA program
    model = instantiate(cfg["model"], device="cpu")
    # EMA-trained checkpoints serve their averaged weights (what the
    # recorded val metrics were measured on)
    set_model_state(model, load_single(args.ckpt), args.ckpt)
    export_predict(model, args.out, batch_size=args.batch_size,
                   platforms=tuple(args.platforms.split(",")))
    size = os.path.getsize(args.out)
    print(f"exported {args.ckpt} -> {args.out} ({size / 1e6:.1f} MB; "
          f"{args.platforms})")


if __name__ == "__main__":
    main()
