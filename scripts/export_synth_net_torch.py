#!/usr/bin/env python3
"""Carry the JAX-trained synthetic net into the PyTorch port's format.

Reads the Orbax checkpoint ``nets/tiny_yolo_synth/model`` (full-width
GEN1 TinyYolo trained by the JAX package on synthetic recordings; see
``nets/tiny_yolo_synth/config.yaml`` and ``metrics.jsonl``) with the JAX
package's ``train/checkpoint.py::load_single``, fills a port ``TinyYolo``
of the same configuration through ``models/convert.py::load_jax_params``
(conv kernels HWIO -> OIHW, everything else as it is) and writes:

- ``nets/tiny_yolo_synth_torch/model/state.pt``: the port's checkpoint
  payload ``{params, stats, step, epoch}`` (no optimizer state, as in
  the JAX artifact), fp32, read with ``torch.load(weights_only=True)``;
- ``nets/tiny_yolo_synth_torch/config.yaml``: the run's configuration
  with the port's class paths, for ``--config`` beside ``--ckpt_path``.

The port's side needs no JAX: this script is the one place the two
meet. Run it from the repository root (it needs JAX and Orbax, which
the port does not):

    python scripts/export_synth_net_torch.py [--src DIR] [--dst DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "nets", "tiny_yolo_synth")
DST = os.path.join(ROOT, "nets", "tiny_yolo_synth_torch")


def export(src: str = SRC, dst: str = DST) -> str:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from snn_for_object_detection_tpu.train.checkpoint import load_single
    from snn_for_object_detection_tpu_torch.models.convert import (
        load_jax_params,
    )
    from snn_for_object_detection_tpu_torch.train.checkpoint import (
        save_single,
    )
    from snn_for_object_detection_tpu_torch.utils.config import (
        instantiate,
        load_config,
    )

    cfg = load_config([os.path.join(src, "config.yaml")])
    model = instantiate(cfg["model"], device="cpu")
    restored = load_single(os.path.join(src, "model"))
    load_jax_params(model, restored["params"], restored["stats"])
    state = model.state_dict()
    payload = {
        "params": {n: state[n].clone() for n, _ in model.named_parameters()},
        "stats": {n: state[n].clone() for n in state
                  if n.endswith((".mean", ".var"))},
        "step": int(restored["step"]),
        "epoch": int(restored["epoch"]),
    }
    os.makedirs(dst, exist_ok=True)
    save_single(os.path.join(dst, "model"), payload)
    # the run's config with the port's class paths
    with open(os.path.join(src, "config.yaml")) as f:
        text = f.read()
    with open(os.path.join(dst, "config.yaml"), "w") as f:
        f.write(text.replace("snn_for_object_detection_tpu.",
                             "snn_for_object_detection_tpu_torch."))
    n = sum(v.numel() for v in payload["params"].values())
    print(f"{src}/model (step {payload['step']}, epoch {payload['epoch']}, "
          f"{n} params) -> {dst}/model/state.pt")
    return dst


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=SRC)
    parser.add_argument("--dst", default=DST)
    args = parser.parse_args(argv)
    export(args.src, args.dst)


if __name__ == "__main__":
    main()
