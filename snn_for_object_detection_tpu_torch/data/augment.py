"""Training-time event-stream augmentation (beyond-reference).

The port's copy of ``snn_for_object_detection_tpu/data/augment.py``
(numpy only): the same draws from the worker's generator, so the same
seed gives the same samples in both packages.

The reference trains with no augmentation; event-camera detectors
overfit their small datasets quickly, and the standard remedies for
frame cameras translate directly to rasterized event tensors:

- **horizontal flip** — mirror the frame width and reflect the box x
  coordinates (scene statistics of driving data are left/right
  symmetric);
- **polarity swap** — exchange the ON/OFF channels (contrast-reversal
  invariance: an edge's polarity depends on the sign of the brightness
  change, which flips with the background);
- **pixel dropout** — zero a random fraction of the *active* pixels
  (sensor-noise / occlusion robustness; operates on the sparse nonzero
  set, so it is cheap on mostly-empty frames).

All transforms are pure numpy on the host data path, applied per
sample inside the loader workers before collate, train split only.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Augmenter:
    """Per-sample augmentation policy for ``(features, labels)``.

    :param hflip: Probability of mirroring width + reflecting box x.
    :param polarity_swap: Probability of exchanging the ON/OFF channels.
    :param pixel_dropout: Fraction of active (nonzero) pixels zeroed.

    Features are ``[T, H, W, 2]``; labels are the ST layout
    ``[N, 5] = (class, x1, y1, x2, y2)`` with normalized coordinates.
    """

    hflip: float = 0.0
    polarity_swap: float = 0.0
    pixel_dropout: float = 0.0

    def __call__(
        self, features: np.ndarray, labels: np.ndarray,
        rng: np.random.Generator,
    ):
        if self.hflip > 0 and rng.random() < self.hflip:
            features = features[:, :, ::-1, :]
            labels = labels.copy()
            x1 = labels[:, 1].copy()
            labels[:, 1] = 1.0 - labels[:, 3]
            labels[:, 3] = 1.0 - x1
        if self.polarity_swap > 0 and rng.random() < self.polarity_swap:
            features = features[..., ::-1]
        if self.pixel_dropout > 0:
            # copy unconditionally: ascontiguousarray aliases an already-
            # contiguous input, and the scatter below writes in place
            features = features.copy()
            nz = np.nonzero(features)
            if nz[0].size:
                drop = rng.random(nz[0].size) < self.pixel_dropout
                features[tuple(c[drop] for c in nz)] = 0
        return np.ascontiguousarray(features), labels


def make_augmenter(config) -> "Augmenter | None":
    """Build an :class:`Augmenter` from a config value: None/False ->
    no augmentation, True -> default policy (hflip=0.5), dict -> field
    overrides."""
    if not config:
        return None
    if config is True:
        return Augmenter(hflip=0.5)
    return Augmenter(**dict(config))
