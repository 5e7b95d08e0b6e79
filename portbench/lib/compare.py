"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the reference gives on the same weights and inputs.
Each is a share, 0 where the two agree exactly."""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence

import numpy as np


def rel_gap(got: float, want: float) -> float:
    """``|got - want| / |want|``."""
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_gap(got: Sequence[float], want: Sequence[float],
             keep: Optional[Sequence[bool]] = None) -> float:
    """The worst leaf's gap of norms, ``|got - want|`` over the larger of
    the leaf's reference norm and the median leaf's. ``keep``: the
    leaves that count."""
    floor = statistics.median(want)
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if keep is not None and not keep[k]:
            continue
        worst = max(worst, abs(g - w) / max(w, floor, 1e-30))
    return worst


def moved_leaves(first_grad_norms: Sequence[float]) -> List[bool]:
    """The leaves whose first gradient in the reference reaches a
    thousandth of the median leaf's: the others move under Adamax by
    round-off alone."""
    floor = statistics.median(first_grad_norms) * 1e-3
    return [g >= floor for g in first_grad_norms]


def detection_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Two lists of detections ``[k, 6]`` (class, conf, x1, y1, x2, y2):
    the largest distance from a row of either list to the nearest row of
    the same class in the other, a distance being the largest difference
    of confidence or of a coordinate; 1 where a row has no partner."""
    worst = 0.0
    for a, b in ((got, want), (want, got)):
        for row in a:
            same = b[b[:, 0] == row[0]]
            if not len(same):
                return 1.0
            d = np.abs(same[:, 1:] - row[1:]).max(axis=1).min()
            worst = max(worst, float(d))
    return min(worst, 1.0)


def state_gap(got, want) -> float:
    """The worst leaf's relative L2 distance of two carried states,
    ``[(v, i), ...]`` of torch tensors, compared on the host in
    float64."""
    worst = 0.0
    for g_vi, w_vi in zip(got, want):
        for g, w in zip(g_vi, w_vi):
            g64 = g.detach().double().cpu()
            w64 = w.detach().double().cpu()
            num = float((g64 - w64).norm())
            den = float(w64.norm())
            worst = max(worst, num / den if den else (0.0 if not num
                                                       else 1.0))
    return worst
