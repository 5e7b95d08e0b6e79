"""A benchmark catalog of the real cells at a size the CPU runs in
seconds: the same drivers, readers, traffic kinds and limits, on a
32x40 frame with short sequences and a few serving slots. The program
runs its plain PyTorch versions on the CPU."""

from __future__ import annotations

import json
import os

import torch

from portbench.lib.harness import HERE, ROOT, Catalog, load_json

CONFIG = {"in_hw": [32, 40], "batch_size": 2, "num_steps": 12,
          "time_window": 3}
TRAFFIC = {"serve_c64": {"capacity": 6, "pool": 16, "churn_every": 7,
                         "warmup_steps": 3}}
CELLS = {"gen1_serve_c64": {"checked_frames": 6, "profile_steps": 3}}
DEVICE = torch.device("cpu")


def catalog(tmp: str, extra_workloads=()) -> Catalog:
    """The benchmark under ``tmp``, every configuration, traffic mix and
    cell shrunk; files not rewritten here come from ``portbench/``."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for kind in ("configs", "traffic", "cells"):
        os.makedirs(os.path.join(tmp, kind), exist_ok=True)
    for c in bench["configs"]:
        cfg = load_json(os.path.join(ROOT, c["file"]))
        cfg.update(CONFIG)
        c["file"] = os.path.join("configs", c["name"] + ".json")
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(cfg, f)
    bench["workloads"] += list(extra_workloads)
    for w in bench["workloads"]:
        for kind, name, over in (("traffic", w["traffic"], TRAFFIC),
                                 ("cells", w["name"], CELLS)):
            path = os.path.join(HERE, kind, name + ".json")
            if not os.path.exists(path):
                continue
            data = load_json(path)
            data.update(over.get(name, {}))
            with open(os.path.join(tmp, kind, name + ".json"), "w") as f:
                json.dump(data, f)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return Catalog.load(tmp, (tmp, HERE))
