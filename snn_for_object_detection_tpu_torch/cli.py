"""CLI: ``python -m snn_for_object_detection_tpu_torch {fit,validate,test,predict}``.

The port's counterpart of the repository's ``main.py``, over the same
config files: subcommands, default config files, ``class_path`` /
``init_args`` model and data selection (a ``class_path`` of the JAX
package names the port's class of the same name), dotted-key overrides,
the resolved-config snapshot, and checkpoints written by the port's
``Trainer.fit``.

Examples
--------
  python -m snn_for_object_detection_tpu_torch fit \\
      --config config/config.yaml --config config/synthetic.yaml
  python -m snn_for_object_detection_tpu_torch test \\
      --config config/config.yaml --config config/synthetic.yaml \\
      --ckpt_path=log/synthetic/checkpoints/last

The model runs on ``--device`` (default ``cuda``, which needs a card;
``cpu`` runs the kernels' plain versions). ``--distributed`` joins the
ranks ``torchrun`` started (``parallel.distributed.initialize``: NCCL
on the card, each rank on ``cuda:{LOCAL_RANK}``; gloo with ``--device
cpu``) and trains data-parallel, each rank on its shard of the data:

  python -m torch.distributed.run --nproc_per_node 8 \\
      -m snn_for_object_detection_tpu_torch fit --distributed \\
      --config config/config.yaml --config config/synthetic.yaml

``fit`` with no ``--config`` loads ``config/config.yaml`` and
``config/logger.yaml``, as ``main.py``: TensorBoard events under
``<trainer.out_dir>/tb`` (``tensorboard --logdir``, or
``train.loggers.read_scalars``) and ``metrics.csv`` beside
``metrics.jsonl``. ``predict`` draws with ``utils.Plotter`` (OpenCV
where ``cv2`` imports; without it the frames are coloured, no box is
drawn and no video written, as in the JAX package).
``--compile_cache`` (XLA's compilation cache) has no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Any, Dict, Optional

import torch

from snn_for_object_detection_tpu_torch.parallel import distributed as dist
from snn_for_object_detection_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from snn_for_object_detection_tpu_torch.train.loop import (
    MetricsLogger,
    Trainer,
)
from snn_for_object_detection_tpu_torch.utils.config import (
    instantiate,
    load_config,
    save_config_snapshot,
)

DEFAULT_PLOTTER = {
    "class_path": "snn_for_object_detection_tpu_torch.utils.Plotter",
    "init_args": {"save_video": True, "show_video": False},
}


@dataclasses.dataclass
class Run:
    """What one CLI call built and returned."""

    model: Any
    data: Any
    trainer: Trainer
    cfg: Dict[str, Any]
    result: Optional[Dict[str, Any]]


def build(cfg: Dict[str, Any], device: str):
    """The model (on ``device``), the data module and the trainer of a
    resolved config; the model's input geometry must be the dataset's."""
    model = instantiate(cfg["model"], device=device)
    data = instantiate(cfg["data"])
    if tuple(model.in_hw) != (data.height, data.width):
        raise ValueError(
            f"model.in_hw={tuple(model.in_hw)} does not match the "
            f"'{data.dataset}' dataset geometry "
            f"({data.height}, {data.width}) — set model.init_args.in_hw "
            "accordingly (gen1: [240, 304], 1mpx: [720, 1280])"
        )
    trainer = Trainer(**dict(cfg.get("trainer") or {}))
    return model, data, trainer


def load_model_state(model, ckpt_path: Optional[str], out_dir: str) -> str:
    """Load a checkpoint's weights and BatchNorm statistics into
    ``model``: its ``ema_params`` when it has them (a run trained with
    ``ema_decay`` is deployed with its averaged weights, on which its
    validation was measured), else its ``params``. ``None`` or
    ``"auto"``: the run's ``checkpoints/last``. Returns the path read."""
    ckpt = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    path = None if ckpt_path in (None, "auto") else ckpt_path
    set_model_state(model, ckpt.restore(path), path or "last")
    return path or os.path.join(ckpt.directory, "last")


def set_model_state(model, restored: Dict[str, Any], where: str) -> None:
    """Copy a checkpoint payload's weights (its ``ema_params`` when it has
    them, else its ``params``) and BatchNorm statistics into ``model``;
    raises when the names differ from the model's."""
    params = restored.get("ema_params") or restored["params"]
    targets = dict(model.named_parameters())
    targets.update((n, b) for n, b in model.named_buffers()
                   if n.endswith((".mean", ".var")))
    values = {**params, **restored.get("stats", {})}
    if values.keys() != targets.keys():
        raise ValueError(
            f"checkpoint {where} does not fit the model: missing "
            f"{sorted(targets.keys() - values.keys())}, unused "
            f"{sorted(values.keys() - targets.keys())}")
    with torch.no_grad():
        for name, target in targets.items():
            target.copy_(values[name])


def main(argv=None) -> Run:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="python -m snn_for_object_detection_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "subcommand", choices=["fit", "validate", "test", "predict"]
    )
    parser.add_argument(
        "--config", action="append", default=None,
        help="YAML config file(s), merged left to right "
             "(default: config/config.yaml, and config/logger.yaml for "
             "fit where it exists)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the model runs (default %(default)s; no fallback)",
    )
    parser.add_argument(
        "--distributed", action="store_true",
        help="join the ranks torchrun started and train data-parallel "
             "(NCCL on the card, gloo with --device cpu)")
    parser.add_argument("--compile_cache", help=argparse.SUPPRESS)
    args, overrides = parser.parse_known_args(argv)
    device = args.device
    if args.distributed:
        # before anything touches the card: each rank takes
        # cuda:{LOCAL_RANK}
        device = str(dist.initialize(
            device="cpu" if torch.device(device).type == "cpu" else "cuda"))
    if args.compile_cache is not None:
        parser.error("--compile_cache is XLA's compilation cache and has no "
                     "counterpart here (CUDA kernels are built once into "
                     "build/kernels/)")

    if args.config:
        config_paths = args.config
    else:
        # per-subcommand defaults, as main.py: fit also loads the
        # logger config
        config_paths = ["config/config.yaml"]
        if args.subcommand == "fit" and os.path.exists("config/logger.yaml"):
            config_paths.append("config/logger.yaml")
    cfg = load_config(config_paths, overrides)

    model, data, trainer = build(cfg, device)
    trainer._sync_data_sharding(data)
    if dist.is_primary():
        save_config_snapshot(cfg, trainer.out_dir)
    ckpt_path = cfg.get("ckpt_path")

    result = None
    if args.subcommand == "fit":
        result = trainer.fit(model, data, ckpt_path=ckpt_path)
    elif args.subcommand in ("validate", "test"):
        path = load_model_state(model, ckpt_path, trainer.out_dir)
        if dist.is_primary():
            print(f"[{args.subcommand}] weights from {path}", flush=True)
        if args.subcommand == "validate":
            result = trainer.validate(model, data.val_loader())
        else:
            result = trainer.test(model, data.test_loader())
        logger = MetricsLogger(trainer.out_dir, trainer.loggers)
        logger.log(0, result)
        logger.close()
    else:
        plotter = instantiate(cfg.get("plotter") or DEFAULT_PLOTTER)
        load_model_state(model, ckpt_path, trainer.out_dir)
        trainer.predict(model, data, plotter)
    return Run(model, data, trainer, cfg, result)
