"""What the benchmark takes from the program under test: the model built
from a configuration, the weights the benchmark made put into it, and
its carried state read back. Imported only by the drivers; the
reference never imports this module or the program.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

PACKAGE = "snn_for_object_detection_tpu_torch"


def build_model(config: Dict, weights: List[torch.Tensor],
                scales: List[torch.Tensor], device):
    """TinyYolo of ``config`` on ``device``, its conv weights and
    BatchNorm gains replaced by ``weights`` and ``scales`` (the
    reference's spec order, which is the order of the program's
    parameters). Returns ``(model, leaf_map)``: for each of the
    program's parameters in order, ``("w" | "s", index)`` into the two
    lists."""
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo

    model = TinyYolo(
        num_classes=config["num_classes"], in_hw=tuple(config["in_hw"]),
        loss_ratio=config["loss_ratio"], time_window=config["time_window"],
        iou_threshold=config["iou_threshold"],
        learning_rate=config["learning_rate"],
        compute_dtype=config["dtype"], state_dtype=config["state_dtype"],
        device=device, seed=0)
    leaf_map: List[Tuple[str, int]] = []
    nw = ns = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".w"):
                src, leaf_map_entry = weights[nw], ("w", nw)
                nw += 1
            elif name.endswith(".scale"):
                src, leaf_map_entry = scales[ns], ("s", ns)
                ns += 1
            else:
                raise ValueError(f"unexpected parameter {name}")
            if tuple(p.shape) != tuple(src.shape):
                raise ValueError(f"{name}: the program's shape "
                                 f"{tuple(p.shape)} is not the spec's "
                                 f"{tuple(src.shape)}")
            p.copy_(src)
            leaf_map.append(leaf_map_entry)
    if nw != len(weights) or ns != len(scales):
        raise ValueError(f"the program has {nw} convs and {ns} norms, the "
                         f"spec {len(weights)} and {len(scales)}")
    return model, leaf_map


def _natural(key: str):
    m = re.fullmatch(r"([a-z]+)(\d+)", key)
    return (m.group(1), int(m.group(2))) if m else (key, -1)


def _walk(tree, out):
    if isinstance(tree, dict):
        for key in sorted(tree, key=_natural):
            _walk(tree[key], out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out.append(tuple(tree))


def cell_states(state: Dict) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every cell's ``(v, i)`` of the program's state tree, in the
    reference's spec order (backbone, neck, then each head's stem)."""
    out: list = []
    for key in ("backbone", "neck"):
        _walk(state[key], out)
    heads = sorted((k for k in state if k.startswith("head")), key=_natural)
    for key in heads:
        for part in ("base", "box", "cls"):
            _walk(state[key][part], out)
    return out
