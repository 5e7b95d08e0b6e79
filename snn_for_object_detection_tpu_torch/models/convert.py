"""Carry weights from the JAX package's pytrees into the port's model.

The port names its submodules after the JAX pytree keys, so the walk is
one to one: ``params["backbone"]["b0"]["l3"]["w"]`` fills the parameter
``backbone.b0.l3.w``, and ``stats[...]["mean"]`` / ``["var"]`` fill the
BatchNorm buffers of the same path. A conv given JAX's int8 leaves
(``ops/quantize.py``: ``w_q``, ``w_scale``, ``x_scale``) takes its int8
form, and an int8 conv given ``w`` its float form.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from snn_for_object_detection_tpu_torch.models.compile import Conv


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

    A conv whose leaves are JAX's int8 ones (``w_q`` HWIO int8,
    ``w_scale [Cout]``, ``x_scale``) is turned into its int8 form
    (``Conv.set_int8``) and filled; an int8 conv given ``w`` is turned
    back into its float form.

    Raises ``ValueError`` on a leaf the model lacks, a model tensor no
    leaf fills, or a shape mismatch.
    """
    flat = _flatten(params)
    _match_conv_forms(model, flat)
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
            if target.dtype == torch.int8:
                value = np.array(value, np.int8)
            else:
                value = np.array(value, np.float32)
            target.copy_(torch.from_numpy(value))


def _match_conv_forms(model: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Give each Conv of ``model`` the form (int8 or float) of its leaves
    in ``flat``, with placeholder tensors of the leaves' shapes."""
    for name, m in model.named_modules():
        if not isinstance(m, Conv):
            continue
        prefix = f"{name}." if name else ""
        w_q = flat.get(prefix + "w_q")
        dev = m.float_weight().device
        if w_q is not None and not m.quantized:
            o = w_q.shape[-1]
            m.set_int8(torch.zeros(w_q.shape[::-1][:2] + w_q.shape[:2],
                                   dtype=torch.int8, device=dev),
                       torch.ones(o, device=dev), torch.ones((), device=dev))
        elif w_q is None and prefix + "w" in flat and m.quantized:
            m.set_float(torch.zeros(m.w_q.shape, device=dev))


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


def model_params(model: nn.Module) -> Dict[str, Any]:
    """The model's parameters as a JAX-layout ``params`` tree (nested
    dicts of numpy arrays; conv kernels HWIO, an int8 conv as JAX's
    ``{"w_q", "w_scale", "x_scale"}``), the counterpart of the ``params``
    that :func:`load_jax_params` reads."""
    tree: Dict[str, Any] = {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        if leaf in ("mean", "var"):
            continue
        value = t.detach().cpu()
        if value.dim() == 4:  # conv kernel, OIHW -> HWIO
            value = value.permute(2, 3, 1, 0)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value.contiguous().numpy()
    return tree

