"""One run of one cell: what a driver is given, and the helpers every
driver shares (the clock, the profiled sub-window, the device's
peak)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Tuple

from portbench.lib import kineto
from portbench.lib.spans import Spans


@dataclasses.dataclass
class Run:
    cell: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float  # time.perf_counter() at the process's start
    spans: Spans = dataclasses.field(default_factory=Spans)
    setup_s: float = 0.0

    def setup_done(self) -> None:
        """Set-up ends here: before the first timed step."""
        self.setup_s = time.perf_counter() - self.started


def synchronize(device) -> None:
    import torch

    if getattr(device, "type", device) == "cuda":
        torch.cuda.synchronize(device)


def profiled(step: Callable[[], None], n: int,
             device) -> Tuple[kineto.Trace, Tuple[float, float]]:
    """``n`` calls of ``step`` under ``torch.profiler`` inside one span,
    ``portbench.profiled``, that ends in a synchronise: the trace and
    the span's ``(start, end)`` in the trace's microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if getattr(device, "type", device) == "cuda":
        activities.append(ProfilerActivity.CUDA)
    synchronize(device)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(kineto.SPAN_PREFIX + "profiled"):
            for _ in range(n):
                step()
            synchronize(device)
    trace = kineto.read(prof)
    win = [s for s in trace.spans if s.name == "profiled"]
    if not win:
        raise RuntimeError("the profiler kept no portbench.profiled span")
    return trace, (win[0].start, win[0].end)


def device_summary(trace: kineto.Trace, window: Tuple[float, float]):
    """``(busy_s, window_s, breakdown)`` of the profiled sub-window."""
    lo, hi = window
    inside = kineto.clip(trace.device, lo, hi)
    busy = kineto.union_us([(e.start, e.end) for e in inside]) / 1e6
    return busy, (hi - lo) / 1e6, {
        "device_ops": kineto.top_ops(inside),
        "idle_gaps": kineto.idle_gaps(trace, lo, hi)}


def memory_peak(device) -> int:
    import torch

    if getattr(device, "type", device) != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    """Give the program's memory back before the reference runs."""
    import gc

    import torch

    gc.collect()
    if getattr(device, "type", device) == "cuda":
        torch.cuda.empty_cache()
