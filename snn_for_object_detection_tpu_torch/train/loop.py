"""Evaluation loop: the eval half of the JAX package's ``Trainer``.

Counterpart of ``Trainer.validate`` / ``test`` in
``snn_for_object_detection_tpu/train/loop.py`` (``eval_step`` and
``_run_eval``). Each batch:

1. draws a random truncation start ``r`` in ``[0, time_window)``;
2. runs the model's forward with ``start_step=r``;
3. computes ``model.loss``;
4. decodes detections with ``model.detect`` (softmax + NMS);
5. accumulates COCO mAP on the host.

Batches are any iterable of numpy ``(X [T, B, H, W, C], labels [B, N,
5])`` pairs. Training comes with a later slice.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from snn_for_object_detection_tpu_torch.models.compile import not_ported
from snn_for_object_detection_tpu_torch.train.metrics import (
    MeanAveragePrecision,
    detections_to_map_inputs,
)


class Trainer:
    """Evaluation orchestrator.

    :param time_batched: ``False`` evaluates through ``model.forward``
        (per-step), ``True`` through ``model.forward_seq`` (every cell
        one ``temporal_cell_seq`` call over the sequence). Both give the
        same predictions. A model built with ``fuse_seq=True`` runs its
        fused triples here only at ``time_window == 0``: the JAX eval
        step passes a traced start whenever the window is open, even
        when the draw is 0, and a traced start never fuses.
    :param seed: Seed of the ``torch.Generator`` that draws each batch's
        truncation start; every ``validate`` / ``test`` call starts the
        draw anew from it, as the JAX trainer restarts its key.
    """

    def __init__(
        self,
        limit_val_batches: int = 100,
        limit_test_batches: int = 1000,
        seed: int = 0,
        time_batched: bool = False,
    ):
        if time_batched not in (False, True):
            raise not_ported(f"time_batched={time_batched!r}",
                             "other schedules")
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.seed = seed
        self.time_batched = time_batched

    @staticmethod
    def draw_start(model, generator: torch.Generator) -> int:
        """Truncation start r in ``[0, model.time_window)``; 0 when the
        window is 0."""
        if not model.time_window:
            return 0
        return int(torch.randint(0, model.time_window, (),
                                 generator=generator))

    def eval_step(self, model, X: torch.Tensor, labels: torch.Tensor,
                  start_step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward from ``start_step``, loss and detections: ``(loss,
        dets [B, 300, 6])``, both on the model's device."""
        fwd = model.forward_fn(self.time_batched)
        with torch.inference_mode():
            if self.time_batched and model.time_window:
                preds, _ = fwd(X, start_step=start_step, fuse=False)
            else:
                preds, _ = fwd(X, start_step=start_step)
            return model.loss(preds, labels), model.detect(preds)

    def _run_eval(self, model, batches: Iterable, limit: int,
                  prefix: str) -> Dict[str, float]:
        generator = torch.Generator().manual_seed(self.seed)
        map_metric = MeanAveragePrecision()
        losses = []
        for X, labels in itertools.islice(batches, limit):
            r = self.draw_start(model, generator)
            loss, dets = self.eval_step(
                model,
                torch.as_tensor(np.asarray(X), device=model.device),
                torch.as_tensor(np.asarray(labels, np.float32),
                                device=model.device),
                r,
            )
            losses.append(float(loss))
            preds, targets = detections_to_map_inputs(
                dets.cpu().numpy(), np.asarray(labels)
            )
            map_metric.update(preds, targets)
        out = {f"{prefix}_loss": float(np.mean(losses)) if losses else 0.0}
        out.update({k: float(v) for k, v in map_metric.compute().items()})
        return out

    def validate(self, model, batches: Iterable) -> Dict[str, float]:
        return self._run_eval(model, batches, self.limit_val_batches, "val")

    def test(self, model, batches: Iterable) -> Dict[str, float]:
        return self._run_eval(model, batches, self.limit_test_batches,
                              "test")
