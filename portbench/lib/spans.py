"""Host spans the benchmark opens around calls into the program's layers.

In a traced run only, :func:`wrap` sets a wrapper as an attribute of one
object *instance* (the model, the engine, the optimizer), which shadows
the class's method for that instance alone: no file of the program
changes. Each call is timed on the host clock into :class:`Spans` and
opened as a ``torch.profiler.record_function`` named ``portbench.<name>``,
so that the profiler's trace carries the same spans (``kineto.read``).
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List

import torch


class Spans:
    """Host durations (seconds) by span name."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        self.durations.setdefault(name, []).append(seconds)

    def total(self, name: str) -> float:
        return sum(self.durations.get(name, ()))

    def count(self, name: str) -> int:
        return len(self.durations.get(name, ()))


def wrap(obj, attr: str, name: str, spans: Spans) -> None:
    """Time every call of ``obj.attr`` as span ``name``."""
    fn = getattr(obj, attr)

    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench." + name):
            out = fn(*args, **kwargs)
        spans.add(name, time.perf_counter() - t0)
        return out

    setattr(obj, attr, timed)


class span:
    """A span the benchmark's own code opens: ``with span("x", spans):``."""

    def __init__(self, name: str, spans: Spans):
        self.name, self.spans = name, spans
        self._rf = None

    def __enter__(self):
        self._rf = torch.profiler.record_function("portbench." + self.name)
        self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.add(self.name, time.perf_counter() - self.t0)
        return self._rf.__exit__(*exc)
