"""The readings a cell's limits are set from, many seeds in one process.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \\
        [--program --seconds 5] [--steps 1500]

Without ``--program``: the control of each seed, the plain reference in
TF32 put in the program's place at the cell's own size, compared with
the reference as a run compares the program (``drivers/<driver>.py``'s
``control``); ``--steps`` is the serving traffic's length. With
``--program``: a short run of the program a seed (``--seconds`` of
window), the same comparison a run makes. One JSON line a seed on
standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib.harness import Catalog, gate  # noqa: E402
from portbench.lib.session import Run  # noqa: E402


def readings(catalog: Catalog, name: str, seeds, device, program: bool,
             seconds: float = 5.0, steps: int = 1500):
    """One dict a seed: its checks' values, and the program's end-to-end
    values where ``program``."""
    from portbench import run

    import torch

    out = []
    for seed in seeds:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        cell = catalog.cell(name)
        if program:
            _, outcome = run.run_cell(catalog, name, seed, seconds, False,
                                      device, started=time.perf_counter())
            values, e2e = outcome.readings, outcome.e2e
        else:
            ctx = Run(cell=cell, config=catalog.config(cell["config"]),
                      seed=seed, seconds=seconds, trace=False, device=device,
                      started=t0)
            values = catalog.driver(cell["driver"]).control(ctx, steps)
            e2e = {}
        checks = gate(values, cell["limits"])
        out.append({"workload": name, "side": "program" if program
                    else "control", "seed": seed, "readings": values,
                    "correct": all(c.ok for c in checks), "e2e": e2e,
                    "seconds": time.perf_counter() - t0,
                    "peak_bytes": torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--program", action="store_true")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--steps", type=int, default=1500)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    catalog = Catalog.load(ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in readings(catalog, args.workload, seeds, device, args.program,
                        args.seconds, args.steps):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
