"""The harness's data: the benchmark's entries, found by name.

Nothing here lists a cell, a configuration or a metric. ``BENCHMARK.json``
at the checkout's root names them; each traffic mix's parameters are in
``portbench/traffic/<name>.json``, each cell's counts and limits in
``portbench/cells/<name>.json``, each configuration's in
``portbench/configs/<name>.json``, each driver is
``portbench/drivers/<name>.py`` and each per-layer metric's reader
``portbench/metrics/<name>.py``. A new cell, configuration or metric is
new files and new entries, with no file here edited. A metric named
``<quantity>.<qualifier>`` with nothing of that full name (an
end-to-end value the driver does not hand back, a per-layer reader with
no file) is read as its longest dotted prefix that has one: so cells
whose spread differs can carry a bound of their own, and their
per-layer metrics, which must name that bound's metric in ``moves``,
share the readers.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, known: Callable[[str], bool]) -> str:
    """``name``, or its longest dotted prefix that is ``known``."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        prefix = ".".join(parts[:n])
        if known(prefix):
            return prefix
    raise KeyError(f"nothing reads {name!r}")


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Catalog:
    """``BENCHMARK.json`` and the folders it points into."""

    benchmark: Dict
    root: str = ROOT
    # folders searched in turn for each file, this one last
    dirs: Tuple[str, ...] = (HERE,)

    @classmethod
    def load(cls, root: str = ROOT, dirs: Tuple[str, ...] = (HERE,)
             ) -> "Catalog":
        return cls(load_json(os.path.join(root, "BENCHMARK.json")), root,
                   dirs)

    def find(self, kind: str, name: str, ext: str) -> str:
        """``<dir>/<kind>/<name><ext>`` in the first folder that has it."""
        for d in self.dirs:
            path = os.path.join(d, kind, name + ext)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no {kind}/{name}{ext} under {self.dirs}")

    def workload(self, name: str) -> Dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> Dict:
        """Workload ``name``: its traffic mix's file
        (``traffic/<traffic>.json``: the driver and its parameters), its
        cell file (``cells/<name>.json``: counts and limits) and its
        entry's fields, merged in that order."""
        entry = self.workload(name)
        traffic = load_json(self.find("traffic", entry["traffic"], ".json"))
        cell = load_json(self.find("cells", name, ".json"))
        return {**traffic, **cell, **entry}

    def config(self, name: str) -> Dict:
        for c in self.benchmark["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def driver(self, name: str):
        return _module(self.find("drivers", name, ".py"),
                       f"portbench_driver_{name}")

    def metrics_for(self, workload: str, kind: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` entries that ``workload``
        reports: those listing it, and those that list none."""
        return [m for m in self.benchmark[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        def has(name):
            try:
                self.find("metrics", name, ".py")
                return True
            except FileNotFoundError:
                return False

        name = resolve(metric, has)
        return _module(self.find("metrics", name, ".py"),
                       "portbench_metric_" + name.replace(".", "_")).read


@dataclasses.dataclass
class Check:
    """One number of the comparison beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def gate(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """The numbers a cell compares (those it gives a limit), beside their
    limits; the others are readings only."""
    return [Check(name, values[name], limit) for name, limit in limits.items()]


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values it measured, the
    count of work attempted and failed, the comparison, the device's
    peak, and in a traced run the record the per-layer readers read."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    record: Optional[Dict] = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict] = None
    # every number the comparison computed, compared or not
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)
    # seconds the reference took, after the window
    reference_s: float = 0.0
    # the host seconds of each step of the window, where a driver keeps them
    step_s: List[float] = dataclasses.field(default_factory=list)
