"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its parameters, its configuration, its driver and its per-layer readers
are files under ``portbench/`` found by name (``lib/harness.py``).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from host spans around the program's layers and
a ``torch.profiler`` trace of a short sub-window after the timed one.

Every run checks what the timed path produced against the plain
reference (``portbench/reference/``) and prints each number compared
beside its limit: as the last lines on standard error, and under the
result line's last key, ``checks``. It exits non-zero, with no result
line, where no CUDA device is there or fewer than the cell asks for, or
where the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import imports  # noqa: E402
from portbench.lib.harness import Catalog, resolve  # noqa: E402
from portbench.lib.session import Run  # noqa: E402


def result_line(catalog: Catalog, cell, outcome, trace: bool, device,
                kind: str, platform: str) -> dict:
    """The contract's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, and (traced) ``breakdown``; the numbers
    compared under ``checks``, last."""
    name = cell["name"]
    metrics = {}
    if trace:
        for m in catalog.metrics_for(name, "per_layer"):
            value = catalog.reader(m["name"])(outcome.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in catalog.metrics_for(name, "end_to_end"):
            value = outcome.e2e[resolve(m["name"], outcome.e2e.__contains__)]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": platform, "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": outcome.memory_peak_bytes}
    if trace:
        dev["busy_s"] = outcome.busy_s
        dev["window_s"] = outcome.window_s
    line = {"correct": all(c.ok for c in outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": dev}
    if trace and outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return line


def run_cell(catalog: Catalog, name: str, seed: int, seconds: float,
             trace: bool, device, started: float = STARTED):
    """Run cell ``name`` on ``device``; ``(cell, outcome)``."""
    cell = catalog.cell(name)
    ctx = Run(cell=cell, config=catalog.config(cell["config"]), seed=seed,
              seconds=seconds, trace=trace, device=device, started=started)
    outcome = catalog.driver(cell["driver"]).run(ctx)
    return cell, outcome


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    catalog = Catalog.load(ROOT)
    workload = catalog.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < workload["chips"]:
        print(f"portbench: {args.workload} needs {workload['chips']} CUDA "
              f"device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    cell, outcome = run_cell(catalog, args.workload, args.seed, args.seconds,
                             bool(args.trace), device)
    return finish(catalog, cell, outcome, bool(args.trace), device,
                  torch.cuda.get_device_name(0), "gpu")


def finish(catalog: Catalog, cell, outcome, trace: bool, device, kind: str,
           platform: str) -> int:
    """Build the result line (a traced run loads its per-layer readers
    here), then look for JAX and the JAX package in ``sys.modules``, and
    only then print: the line, and the numbers compared on standard
    error. 3, with no line, where a forbidden module was loaded."""
    line = result_line(catalog, cell, outcome, trace, device, kind, platform)
    found = imports.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    if len(outcome.step_s) >= 2:
        q = statistics.quantiles(outcome.step_s, n=10)
        print(f"portbench: {len(outcome.step_s)} steps in the window, ms "
              f"first {1e3 * outcome.step_s[0]:.1f}, p10 {1e3 * q[0]:.1f}, "
              f"p50 {1e3 * q[4]:.1f}, p90 {1e3 * q[8]:.1f}, max "
              f"{1e3 * max(outcome.step_s):.1f}, last "
              f"{1e3 * outcome.step_s[-1]:.1f}", file=sys.stderr)
    print(f"portbench: set-up {outcome.e2e.get('setup_s', 0.0):.1f} s, "
          f"reference {outcome.reference_s:.1f} s", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
