"""What the per-layer readers share. Each reader (``portbench/metrics/
<name>.py``) reads one number from a traced run's record, or ``None``
where the record has nothing for it, in which case the metric is left
out of the result line. A share of a peak or a roofline is never made
up: no device events, no share.

The record (``drivers/*.py``): ``path`` (``train``, ``serve``,
``eval``), ``trace`` (``kineto.Trace``) and ``window`` (the profiled
sub-window's ``(start, end)`` in the trace's microseconds), ``spans``
(host spans over the timed window), and the work of the profiled steps
from shapes: ``conv_flops_fwd``, ``conv_flops_bwd``, ``cell_bound_s``.
"""

from __future__ import annotations

from typing import Dict, Optional

from portbench.lib import kineto, roofline

CELL_KERNELS = "temporal_cell"


def _inside(rec: Dict, events):
    lo, hi = rec["window"]
    return kineto.clip(events, lo, hi)


def _device(rec: Dict, path: str):
    if rec is None or rec.get("path") != path:
        return None
    events = _inside(rec, rec["trace"].device)
    return events or None


def mfu(rec: Dict, path: str) -> Optional[float]:
    """The conv operations of the profiled steps at the fp32 peak, as a
    share (%) of the sub-window's length."""
    if _device(rec, path) is None:
        return None
    lo, hi = rec["window"]
    flops = rec["conv_flops_fwd"] + rec.get("conv_flops_bwd", 0)
    return 100.0 * flops / roofline.FP32_FLOPS / ((hi - lo) / 1e6)


def device_idle(rec: Dict, path: str) -> Optional[float]:
    """The share (%) of the sub-window in which no device op ran."""
    events = _device(rec, path)
    if events is None:
        return None
    lo, hi = rec["window"]
    busy = kineto.union_us([(e.start, e.end) for e in events])
    return 100.0 * (1.0 - busy / (hi - lo))


def conv_roofline(rec: Dict, path: str) -> Optional[float]:
    """The convs' least time at the fp32 peak (both directions in
    training) over the device time of the kernels the aten convolution
    ops launched (%)."""
    if _device(rec, path) is None:
        return None
    convs = _inside(rec, kineto.conv_kernels(rec["trace"]))
    busy_us = kineto.union_us([(e.start, e.end) for e in convs])
    if not busy_us:
        return None
    flops = rec["conv_flops_fwd"] + rec.get("conv_flops_bwd", 0)
    return 100.0 * flops / roofline.FP32_FLOPS / (busy_us / 1e6)


def cell_roofline(rec: Dict, path: str) -> Optional[float]:
    """The cell launches' summed bound over the summed device time of
    the kernels named ``temporal_cell*`` (%)."""
    events = _device(rec, path)
    if events is None:
        return None
    cells = [e for e in events if CELL_KERNELS in e.name]
    busy_us = sum(e.end - e.start for e in cells)
    if not busy_us:
        return None
    return 100.0 * rec["cell_bound_s"] / (busy_us / 1e6)


def span_ms(rec: Dict, path: str, name: str,
            less: Optional[str] = None) -> Optional[float]:
    """Mean host milliseconds of span ``name`` a call, less span
    ``less``'s total over the same calls."""
    if rec is None or rec.get("path") != path:
        return None
    spans = rec["spans"]
    n = spans.count(name)
    if not n:
        return None
    total = spans.total(name) - (spans.total(less) if less else 0.0)
    return 1e3 * total / n
