"""Import a reference (PyTorch Lightning) checkpoint into the port's model.

The port's counterpart of the repository's ``scripts/import_torch_ckpt.py``,
on numpy and torch alone. It maps the reference SODa ``state_dict`` (torch
OIHW convs, BatchNorm gamma and running statistics, the per-scale head
trees, the anchor parameters) onto a port model's parameters and
BatchNorm buffers, and writes a checkpoint directory that the port's CLI
reads with ``--ckpt_path``.

The port names its modules after the JAX pytree paths, so the parameter
``backbone.b0.l3.w`` is the path ``["backbone", "b0", "l3", "w"]``; the
key correspondence is the JAX script's:

  port name                        reference state_dict key
  backbone.bJ.lK. ...           -> base_net.net.net.J.K ...
  neck.bJ.lK. ...               -> neck_net.net.net.J.K ...
  headI.base.bJ.lK. ...         -> head_net.model_I.base_net.net.J.K ...
  headI.box / headI.cls ...     -> head_net.model_I.box_net / cls_net ...
  nested block pair bJ.lK       -> .net.J.K (one per nesting level)
  leaf w (conv, OIHW)           -> .weight (OIHW, copied as it is)
  leaf scale / bias (BatchNorm) -> .weight / .bias
  buffer mean / var (BatchNorm) -> .running_mean / .running_var

``num_batches_tracked`` and ``head_net.anchor_gen_I.sizes/ratios`` are not
loaded; the anchor entries are checked against the model's tables.

Usage::

  python -m snn_for_object_detection_tpu_torch.import_torch_ckpt \\
      <ckpt.ckpt> <out_dir> [--config config/config.yaml] \\
      [--model.init_args.K=V ...]

The output directory holds ``state.pt`` with ``{params, stats, step,
epoch}`` (``train/checkpoint.py``), the form ``validate`` / ``test`` /
``predict`` read with ``--ckpt_path <out_dir>``.
"""

from __future__ import annotations

import re
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_LEAF_PARAM = {"w": "weight", "scale": "weight", "bias": "bias"}
_LEAF_STAT = {"mean": "running_mean", "var": "running_var"}
_IGNORABLE = re.compile(
    r"(\.num_batches_tracked$)|(^head_net\.anchor_gen_\d+\.(sizes|ratios)$)"
)


def reference_key(path: List[str], collection: str = "params") -> str:
    """The reference's state_dict key of the tensor at ``path`` (the
    port's name split on dots, the JAX pytree path); ``collection``
    ``"params"`` or ``"stats"`` (BatchNorm running statistics)."""
    head_m = re.fullmatch(r"head(\d+)", path[0])
    if head_m:
        part = {"base": "base_net", "box": "box_net", "cls": "cls_net"}[path[1]]
        prefix = f"head_net.model_{head_m.group(1)}.{part}"
        pairs = path[2:-1]
    elif path[0] == "backbone":
        prefix = "base_net.net"
        pairs = path[1:-1]
    elif path[0] == "neck":
        prefix = "neck_net.net"
        pairs = path[1:-1]
    else:
        raise KeyError(f"unmapped component {path[0]!r}")
    if len(pairs) % 2:
        raise KeyError(f"odd branch/layer nesting in {'/'.join(path)}")
    out = prefix
    for b, l in zip(pairs[::2], pairs[1::2]):
        bm = re.fullmatch(r"b(\d+)", b)
        lm = re.fullmatch(r"l(\d+)", l)
        if not (bm and lm):
            raise KeyError(
                f"unexpected path tokens {b}/{l} in {'/'.join(path)}")
        out += f".net.{bm.group(1)}.{lm.group(1)}"
    leaf_map = _LEAF_PARAM if collection == "params" else _LEAF_STAT
    leaf = path[-1]
    if leaf not in leaf_map:
        raise KeyError(f"unmapped leaf {leaf!r} in {'/'.join(path)}")
    return out + "." + leaf_map[leaf]


def _targets(model) -> Dict[str, tuple]:
    """Every tensor an import fills: ``name -> (tensor, collection)``."""
    out = {n: (p, "params") for n, p in model.named_parameters()}
    out.update((n, (b, "stats")) for n, b in model.named_buffers()
               if n.endswith((".mean", ".var")))
    return out


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def load_reference_state_dict(model, state_dict: Dict[str, Any],
                              strict: bool = True) -> Dict[str, Any]:
    """Fill ``model``'s parameters and BatchNorm statistics from a
    reference ``state_dict``, in place. Returns a report of the
    consumed, missing (model tensors without a checkpoint tensor) and
    unused checkpoint keys and of the anchor check. ``strict`` raises
    ``ValueError`` if any model tensor found no checkpoint tensor or any
    checkpoint tensor that is not ignorable went unused; a shape
    mismatch always raises."""
    targets = _targets(model)
    used: set = set()
    missing: List[tuple] = []
    values: Dict[str, np.ndarray] = {}
    for name, (target, collection) in targets.items():
        try:
            key = reference_key(name.split("."), collection)
        except KeyError as e:
            missing.append((name, f"no mapping: {e}"))
            continue
        if key not in state_dict:
            missing.append((name, f"absent torch key {key}"))
            continue
        src = _to_numpy(state_dict[key])
        if src.shape != tuple(target.shape):
            raise ValueError(
                f"shape mismatch at {name}: checkpoint {src.shape} vs model "
                f"{tuple(target.shape)} — wrong architecture config?"
            )
        used.add(key)
        values[name] = src
    unused = [k for k in state_dict
              if k not in used and not _IGNORABLE.search(k)]
    report = {
        "consumed": sorted(used),
        "missing": missing,
        "unused": sorted(unused),
        "anchors": _check_anchors(model, state_dict),
    }
    if strict and (missing or unused):
        raise ValueError(
            "import mismatch:\n  model leaves without tensors: "
            f"{missing}\n  unconsumed checkpoint keys: {unused}"
        )
    with torch.no_grad():
        for name, src in values.items():
            targets[name][0].copy_(torch.from_numpy(src.astype(np.float32)))
    return report


def _check_anchors(model, sd) -> List[Dict[str, Any]]:
    """The checkpoint's per-scale anchor sizes and ratios against the
    model's tables; a mismatch is fixed in the model's config, not in
    the import."""
    out = []
    for i in range(len(model.scale_sizes)):
        k = f"head_net.anchor_gen_{i}.sizes"
        rk = f"head_net.anchor_gen_{i}.ratios"
        if k not in sd:
            continue
        if rk not in sd:
            out.append({"scale": i, "match": False,
                        "error": f"checkpoint has {k} but no {rk}"})
            continue
        ck_sizes = _to_numpy(sd[k]).ravel()
        ck_ratios = _to_numpy(sd[rk]).ravel()
        mine_sizes = np.asarray(model.scale_sizes[i]).ravel()
        mine_ratios = np.asarray(model.anchor_ratios).ravel()
        ok = (
            ck_sizes.shape == mine_sizes.shape
            and np.allclose(ck_sizes, mine_sizes, atol=1e-6)
            and ck_ratios.shape == mine_ratios.shape
            and np.allclose(ck_ratios, mine_ratios, atol=1e-6)
        )
        out.append({
            "scale": i, "match": bool(ok),
            "ckpt_sizes": ck_sizes.tolist(),
            "model_sizes": mine_sizes.tolist(),
            "ckpt_ratios": ck_ratios.tolist(),
            "model_ratios": mine_ratios.tolist(),
        })
    return out


def load_lightning_state_dict(path: str) -> Dict[str, Any]:
    """A Lightning ``.ckpt`` (a ``torch.save`` archive) -> its flat
    ``state_dict``. The archive holds Lightning's own objects beside the
    tensors, so it is read with ``weights_only=False``: import only
    checkpoints you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        return blob["state_dict"]
    return blob


def main(argv: Optional[List[str]] = None) -> None:
    from snn_for_object_detection_tpu_torch.train.checkpoint import (
        save_single,
    )
    from snn_for_object_detection_tpu_torch.utils.config import (
        instantiate,
        load_config,
    )

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__)
        sys.exit(2)
    src, dst = argv[0], argv[1]
    configs, overrides = [], []
    rest = argv[2:]
    i = 0
    while i < len(rest):
        if rest[i] == "--config":
            configs.append(rest[i + 1])
            i += 2
        else:
            overrides.append(rest[i])
            i += 1
    cfg = load_config(configs or ["config/config.yaml"], overrides)
    model = instantiate(cfg["model"], device="cpu")
    report = load_reference_state_dict(model, load_lightning_state_dict(src),
                                       strict=True)
    for a in report["anchors"]:
        if not a["match"]:
            detail = a.get("error") or (
                f"checkpoint sizes={a.get('ckpt_sizes')} "
                f"ratios={a.get('ckpt_ratios')} vs model "
                f"sizes={a.get('model_sizes')} "
                f"ratios={a.get('model_ratios')}"
            )
            raise SystemExit(f"anchor mismatch at scale {a['scale']}: "
                             f"{detail} — fix the model's config and re-run")
    targets = _targets(model)
    save_single(dst, {
        "params": {n: t.detach().clone() for n, (t, c) in targets.items()
                   if c == "params"},
        "stats": {n: t.detach().clone() for n, (t, c) in targets.items()
                  if c == "stats"},
        "step": 0, "epoch": 0,
    })
    print(f"imported {len(report['consumed'])} tensors from {src} -> {dst} "
          f"({len(report['anchors'])} anchor scales verified)")


if __name__ == "__main__":
    main()
