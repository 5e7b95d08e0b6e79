"""Peaks, and the operations and bytes of the work, from shapes.

Frozen copies, so that later changes to the program cannot move the
yardstick:

- the peaks and the cell kernels' bounds are ``chip_smoke.py``'s
  (``HBM_BYTES_PER_S``, ``FP32_FLOPS``, ``CELL_OPS``, the forward bound
  of its phase 13 and ``cell_bwd_bound``);
- the conv operations are ``utils/summary.py``'s walk (``2 k k Cin Cout
  H' W'`` a conv and frame), done over the reference's frozen spec
  (``portbench/reference/tiny_yolo.py``, ``Net.conv_flops_per_frame``).

Peaks: NVIDIA's data sheet for the H100 SXM, dense: float32 outside the
tensor cores 67 TFLOP/s (every conv here runs in fp32 with TF32 off),
HBM3 3.35 TB/s.
"""

from __future__ import annotations

from typing import Iterable, Tuple

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# fp32 operations per element and step of the cell update (LIF: sub,
# add, fma, fma, sub, compare, select, add)
CELL_OPS = 8
CELL_BWD_OPS = {"lif": CELL_OPS + 18, "li": 8}


def cell_fwd_bound_s(steps: int, stored: int, m: int, sx: int = 4,
                     ss: int = 4) -> float:
    """Least seconds of one forward cell launch over ``m`` neurons: the
    inputs of ``steps`` frames read, the outputs of ``stored`` frames
    written, ``(v, i)`` read and written once, against ``steps * m *
    CELL_OPS`` operations."""
    nbytes = (steps + stored) * m * sx + 4 * m * ss
    return max(nbytes / HBM_BYTES_PER_S, steps * m * CELL_OPS / FP32_FLOPS)


def cell_bwd_bound_s(cell: str, steps: int, m: int, sx: int = 4,
                     ss: int = 4) -> float:
    """Least seconds of one backward cell launch over ``steps`` frames:
    gz read, gx written, the final state's cotangents read and the
    initial state's written; LIF also reads x and the initial state."""
    nbytes = 2 * steps * m * sx + 4 * m * ss
    if cell == "lif":
        nbytes += steps * m * sx + 2 * m * ss
    return max(nbytes / HBM_BYTES_PER_S,
               steps * m * CELL_BWD_OPS[cell] / FP32_FLOPS)


def cells_bound_s(cells: Iterable[Tuple[str, Tuple[int, int, int]]],
                  batch: int, steps: int, start: int, forwards: int,
                  backward: bool) -> float:
    """The cell launches of one step of a schedule that runs every cell
    over ``steps`` frames from truncation ``start``: ``forwards`` forward
    launches a cell (2 with the recompute of a checkpointed train step),
    and one backward over the ``steps - start`` frames it trains."""
    total = 0.0
    for kind, (c, h, w) in cells:
        m = batch * c * h * w
        total += forwards * cell_fwd_bound_s(steps - start, steps, m)
        if backward:
            total += cell_bwd_bound_s(kind, steps - start, m)
    return total
