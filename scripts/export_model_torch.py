#!/usr/bin/env python3
"""Export a deployable model artifact from a port training checkpoint
(the counterpart of ``scripts/export_model.py``, no JAX).

Strips the optimizer state and keeps ``params``, ``stats``, ``step``,
``epoch`` and, when present, ``ema_params``: the inference-complete
artifact that ``--ckpt_path`` and ``scripts/export_predict_torch.py``
read.

Usage:
  python scripts/export_model_torch.py <training_ckpt_dir> <out_dir>
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snn_for_object_detection_tpu_torch.train.checkpoint import (  # noqa: E402
    load_single,
    save_single,
)


def main():
    src, dst = sys.argv[1], sys.argv[2]
    state = load_single(src)
    slim = {
        "params": state["params"],
        "stats": state["stats"],
        "step": state.get("step", 0),
        "epoch": state.get("epoch", 0),
    }
    if "ema_params" in state:
        # EMA runs are deployed with their averaged weights — the
        # weights the checkpoint's val metrics were measured on
        slim["ema_params"] = state["ema_params"]
    save_single(dst, slim)
    print(f"exported {src} -> {dst} (optimizer state stripped)")


if __name__ == "__main__":
    main()
