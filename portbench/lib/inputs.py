"""Weights and inputs made from the seed, on the device, in a few large
calls. Both sides of a comparison get the same tensors.

The makers are frozen copies of the measured repository's own choices
(``chip_smoke.py``: ``build_model``'s BatchNorm gain 8, at which the
untrained net's LIF layers fire; ``make_batches``' Bernoulli(0.05) event
frames and 1-8 boxes a sample, corners ``xy`` in [0, 0.7), sizes in
[0.03, 0.28)), drawn with ``torch.Generator`` on the device instead of
numpy on the host.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

BN_GAIN = 8.0
EVENT_DENSITY = 0.05
MAX_BOXES = 8


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one purpose (``stream``) of a run's seed: weights,
    frames and labels never share draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def weights(shapes: List[Tuple[int, int, int, int]], seed: int,
            device) -> List[torch.Tensor]:
    """Kaiming-normal conv weights (fan out, ReLU gain) for OIHW
    ``shapes``, from one normal draw."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, 1),
                       device=device)
    out = []
    for shape, chunk in zip(shapes, flat.split(sizes)):
        o, _, kh, kw = shape
        out.append(chunk.reshape(shape) * (2.0 / (kh * kw * o)) ** 0.5)
    return out


def scales(channels: List[int], device) -> List[torch.Tensor]:
    """BatchNorm gains: BN_GAIN everywhere."""
    return [torch.full((c,), BN_GAIN, device=device) for c in channels]


def frames(n: int, shape: Tuple[int, ...], seed: int,
           device) -> torch.Tensor:
    """``[n, *shape]`` uint8 Bernoulli(EVENT_DENSITY) event frames, one
    draw an item."""
    g = generator(seed, device, 2)
    out = torch.empty((n, *shape), dtype=torch.uint8, device=device)
    for k in range(n):
        out[k] = torch.rand(shape, generator=g, device=device) < EVENT_DENSITY
    return out


def labels(n: int, batch: int, max_labels: int, num_classes: int, seed: int,
           device) -> torch.Tensor:
    """``[n, batch, max_labels, 5]`` boxes (class, x1, y1, x2, y2), 1 to
    MAX_BOXES valid rows a sample, the rest -1."""
    g = generator(seed, device, 3)
    count = torch.randint(1, MAX_BOXES + 1, (n, batch, 1), generator=g,
                          device=device)
    xy = torch.rand((n, batch, max_labels, 2), generator=g,
                    device=device) * 0.7
    wh = torch.rand((n, batch, max_labels, 2), generator=g,
                    device=device) * 0.25 + 0.03
    cls = torch.randint(0, num_classes, (n, batch, max_labels, 1),
                        generator=g, device=device).float()
    rows = torch.cat([cls, xy, xy + wh], dim=-1)
    valid = torch.arange(max_labels, device=device)[None, None, :, None] \
        < count[..., None]
    return torch.where(valid, rows, torch.full_like(rows, -1.0))


def starts(n: int, window: int, seed: int) -> List[int]:
    """``n`` truncation starts in ``[0, window)``: every value once in
    each block of ``window`` steps, in an order drawn from the seed, so
    that every seed does the same work."""
    if window <= 0:
        return [0] * n
    rng = np.random.default_rng([int(seed) % 2 ** 64, 4])
    out: List[int] = []
    while len(out) < n:
        out.extend(int(r) for r in rng.permutation(window))
    return out[:n]
