"""Carry weights from the JAX package's pytrees into the port's model.

The port names its submodules after the JAX pytree keys, so the walk is
one to one: ``params["backbone"]["b0"]["l3"]["w"]`` fills the parameter
``backbone.b0.l3.w``, and ``stats[...]["mean"]`` / ``["var"]`` fill the
BatchNorm buffers of the same path.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from snn_for_object_detection_tpu_torch.models.compile import not_ported


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def load_jax_params(model: nn.Module, params: Dict[str, Any],
                    stats: Dict[str, Any]) -> None:
    """Copy JAX ``(params, stats)`` (nested dicts of arrays) into
    ``model`` in place. Conv and ConvLSTM kernels go from HWIO to OIHW;
    Norm ``scale`` (and ``bias``), ``mean`` and ``var`` and PLIF's
    ``raw_tau_syn`` and ``raw_tau_mem`` copy as they are.

    Raises ``ValueError`` on a leaf the model lacks, a model tensor no
    leaf fills, or a shape mismatch, and ``NotImplementedError`` on the
    int8 conv leaves of ``ops/quantize.py`` (``w_q``).
    """
    flat = _flatten(params)
    quantized = sorted(k for k in flat if k.endswith(".w_q"))
    if quantized:
        raise not_ported(f"int8 conv weights ({quantized[0]})",
                         "int8 PTQ")
    flat_stats = _flatten(stats)
    both = flat.keys() & flat_stats.keys()
    if both:
        raise ValueError(f"leaves in both params and stats: {sorted(both)}")
    flat.update(flat_stats)
    targets = model.state_dict(keep_vars=True)
    missing = sorted(targets.keys() - flat.keys())
    unused = sorted(flat.keys() - targets.keys())
    if missing or unused:
        raise ValueError(f"missing leaves {missing}; unused leaves {unused}")
    with torch.no_grad():
        for name, target in targets.items():
            value = flat[name]
            if value.ndim == 4:  # conv kernel, HWIO -> OIHW
                value = value.transpose(3, 2, 0, 1)
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"{name}: JAX shape {value.shape} vs port "
                    f"{tuple(target.shape)}"
                )
            target.copy_(torch.from_numpy(np.array(value, np.float32)))


def model_stats(model: nn.Module) -> Dict[str, Any]:
    """The model's BatchNorm running statistics as a JAX-layout ``stats``
    tree (nested dicts of numpy arrays), the counterpart of the
    ``stats`` that :func:`load_jax_params` reads."""
    tree: Dict[str, Any] = {}
    for name, buf in model.state_dict().items():
        *path, leaf = name.split(".")
        if leaf not in ("mean", "var"):
            continue
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = buf.detach().cpu().numpy()
    return tree
