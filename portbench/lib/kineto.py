"""The traced run's record, read from a finished ``torch.profiler`` run.

:func:`read` is a frozen copy of ``chip_smoke.py``'s ``device_events``,
the reader of the raw Kineto results: the events are read from
``prof.profiler.kineto_results`` and not ``prof.events()``,
which builds every host op's event and their tree first. Beside the
device's events it keeps the host's runtime launches (to tie a kernel
to the host op that launched it through the correlation id), the aten
convolution ops, and the benchmark's own spans (``portbench.*``).
Times are microseconds from the trace's start.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "portbench."
CONV_OPS = ("aten::convolution", "aten::convolution_backward",
            "aten::cudnn_convolution", "aten::_convolution")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


@dataclasses.dataclass
class Event:
    name: str
    start: float
    end: float
    corr: int = 0
    tid: int = 0


@dataclasses.dataclass
class Trace:
    device: List[Event]
    launches: List[Event]
    conv_ops: List[Event]
    spans: List[Event]


def read(prof) -> Trace:
    """The events of a finished profiler run that the readers need."""
    import torch
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    device, launches, convs, spans = [], [], [], []
    for e in results.events():
        hidden = getattr(e, "is_hidden_event", lambda: False)()
        name = e.name()
        start, end = (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
        if e.device_type() == DeviceType.CUDA:
            # the device-side copies of host annotations are no device work
            if hidden or name.startswith(SPAN_PREFIX) or getattr(
                    e, "is_user_annotation", lambda: False)():
                continue
            device.append(Event(
                torch._C._demangle(name) if len(name) > 1 else name,
                start, end, e.correlation_id()))
        elif name in LAUNCHES:
            launches.append(Event(name, start, end, e.correlation_id(),
                                  e.start_thread_id()))
        elif name in CONV_OPS:
            convs.append(Event(name, start, end, 0, e.start_thread_id()))
        elif name.startswith(SPAN_PREFIX):
            spans.append(Event(name[len(SPAN_PREFIX):], start, end, 0,
                               e.start_thread_id()))
    return Trace(device, launches, convs, spans)


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        busy += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    return busy


def clip(events: List[Event], lo: float, hi: float) -> List[Event]:
    """The events that overlap ``[lo, hi]``, cut to it."""
    out = []
    for e in events:
        s, t = max(e.start, lo), min(e.end, hi)
        if t > s:
            out.append(dataclasses.replace(e, start=s, end=t))
    return out


def conv_kernels(trace: Trace) -> List[Event]:
    """Device events launched from inside an aten convolution op (either
    direction), matched by the launch's correlation id and thread."""
    # per thread, the union of the conv ops' intervals (they nest)
    merged: Dict[int, List[List[float]]] = {}
    for op in sorted(trace.conv_ops, key=lambda e: e.start):
        spans = merged.setdefault(op.tid, [])
        if spans and op.start <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], op.end)
        else:
            spans.append([op.start, op.end])
    starts = {tid: [s for s, _ in v] for tid, v in merged.items()}
    conv_corr = set()
    for launch in trace.launches:
        spans = merged.get(launch.tid)
        if not spans:
            continue
        k = bisect.bisect_right(starts[launch.tid], launch.start) - 1
        if k >= 0 and spans[k][1] >= launch.start:
            conv_corr.add(launch.corr)
    return [e for e in trace.device if e.corr in conv_corr]


def idle_gaps(trace: Trace, lo: float, hi: float,
              top: int = 10) -> List[List]:
    """The device's idle time inside ``[lo, hi]``, summed by the
    innermost benchmark span open on the host when each gap began
    (``"outside"`` where none was): ``[[label, seconds], ...]``, largest
    first."""
    busy = sorted((e.start, e.end) for e in clip(trace.device, lo, hi))
    gaps, reach = [], lo
    for s, e in busy:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))
    spans = sorted(trace.spans, key=lambda e: e.start)
    totals: Dict[str, float] = {}
    for s, e in gaps:
        label: Optional[str] = None
        width = float("inf")
        for sp in spans:
            if sp.start > s:
                break
            if sp.end > s and sp.end - sp.start < width:
                label, width = sp.name, sp.end - sp.start
        key = label or "outside"
        totals[key] = totals.get(key, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def top_ops(events: List[Event], top: int = 10) -> List[List]:
    """Device time by operation name, ``[[name, seconds], ...]``."""
    totals: Dict[str, float] = {}
    for e in events:
        name = e.name[:120]
        totals[name] = totals.get(name, 0.0) + (e.end - e.start) / 1e6
    return [[k, v] for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])[:top]]
