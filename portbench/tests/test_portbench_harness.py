"""The harness: every entry found by name, the result line's keys, a
throwaway cell and metric added as files alone, the import rule."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.lib import imports
from portbench.lib.harness import HERE, ROOT, Catalog, resolve
from portbench.tests import tiny

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_entry_is_found_by_name():
    catalog = Catalog.load()
    bench = catalog.benchmark
    assert bench["command"][1] == "portbench/run.py"
    assert bench["paths"] == ["portbench"]
    for c in bench["configs"]:
        cfg = catalog.config(c["name"])
        assert c["file"].startswith("portbench/configs/")
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in bench["workloads"]:
        cell = catalog.cell(w["name"])
        assert cell["config"] in [c["name"] for c in bench["configs"]]
        driver = catalog.driver(cell["driver"])
        assert callable(driver.run) and callable(driver.control)
        assert set(cell["limits"]) and all(
            v > 0 for v in cell["limits"].values())
        e2e = catalog.metrics_for(w["name"], "end_to_end")
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        layer = catalog.metrics_for(w["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in [x["name"] for x in e2e]
    for m in bench["per_layer"]:
        assert callable(catalog.reader(m["name"]))
        assert catalog.reader(m["name"])(None) is None
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers <= {"trainer", "engine", "detector", "convs",
                      "cell kernels", "device"}


def test_contract_limits_on_benchmark_json():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(w["chips"] == 1 for w in bench["workloads"])
    for name in names:
        assert len(name) <= 64 and "/" not in name and " " not in name
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(tmp_path, trace):
    catalog = tiny.catalog(str(tmp_path))
    cell, outcome = run.run_cell(catalog, "gen1_train", 2 ** 33 + 1, 0.5,
                                 bool(trace), tiny.DEVICE)
    line = run.result_line(catalog, cell, outcome, bool(trace), tiny.DEVICE,
                           "cpu", "cpu")
    keys = list(line)
    assert keys[:5] == LINE_KEYS and keys[-1] == "checks"
    assert set(keys) <= set(LINE_KEYS) | {"breakdown", "checks"}
    assert set(line["device"]) == {
        "platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    wanted = catalog.metrics_for("gen1_train",
                                 "per_layer" if trace else "end_to_end")
    # on the CPU no device event exists: the device metrics are left out
    got = set(line["metrics"])
    assert got <= {m["name"] for m in wanted}
    if trace:
        assert got == {"loss_host_ms.train"}
    else:
        assert got == {"train_frames_per_s", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_a_cell_and_a_metric_are_added_as_files_alone(tmp_path):
    """A throwaway cell (its own traffic mix and cell file) and a
    throwaway per-layer metric (its own reader), found by the names in
    the benchmark's entries, with no file of ``portbench/`` edited."""
    before = {p: open(p, "rb").read() for p in _bench_files()}
    extra = {"name": "throwaway_serve", "config": "tiny_yolo_gen1",
             "traffic": "throwaway_mix", "chips": 1, "why": "a test"}
    catalog = tiny.catalog(str(tmp_path), [extra])
    for kind, name, data in (
            ("traffic", "throwaway_mix",
             {**json.load(open(os.path.join(tmp_path, "traffic",
                                            "serve_c64.json"))),
              "capacity": 4, "churn_every": 5}),
            ("cells", "throwaway_serve",
             {"profile_steps": 2, "checked_frames": 3,
              "limits": {"detections": 1e-3, "state": 1e-3}})):
        with open(os.path.join(tmp_path, kind, name + ".json"), "w") as f:
            json.dump(data, f)
    os.makedirs(tmp_path / "metrics")
    (tmp_path / "metrics" / "slots_seen.throwaway.py").write_text(
        "def read(rec):\n"
        "    return None if rec is None else float(rec['steps'])\n")
    bench_path = os.path.join(tmp_path, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    bench["per_layer"].append(
        {"name": "slots_seen.throwaway", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "engine",
         "moves": "serve_frames_per_s", "workloads": ["throwaway_serve"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("throwaway_serve")
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    catalog = Catalog.load(str(tmp_path), catalog.dirs)
    cell, outcome = run.run_cell(catalog, "throwaway_serve", 7, 0.5, True,
                                 tiny.DEVICE)
    line = run.result_line(catalog, cell, outcome, True, tiny.DEVICE, "cpu",
                           "cpu")
    assert cell["capacity"] == 4 and line["correct"]
    assert line["metrics"]["slots_seen.throwaway"]["value"] >= 1
    assert {p: open(p, "rb").read() for p in _bench_files()} == before


def _bench_files():
    return sorted(os.path.join(b, f) for b, _, fs in os.walk(HERE)
                  for f in fs if f.endswith((".py", ".json"))
                  and "__pycache__" not in b and "/tests" not in b)


def test_a_qualified_name_is_read_as_its_longest_known_prefix():
    known = {"mfu.train", "train_frames_per_s"}.__contains__
    assert resolve("mfu.train", known) == "mfu.train"
    assert resolve("mfu.train.1mpx", known) == "mfu.train"
    assert resolve("train_frames_per_s.1mpx", known) == "train_frames_per_s"
    with pytest.raises(KeyError):
        resolve("mfu.serve", known)
    catalog = Catalog.load()
    assert catalog.reader("mfu.train.1mpx").__module__ == \
        catalog.reader("mfu.train").__module__


def test_forbidden_names_are_compared_whole():
    assert imports.forbidden_modules(
        ["snn_for_object_detection_tpu_torch.serve", "numpy",
         "jaxtyping"]) == []
    assert imports.forbidden_modules(
        ["snn_for_object_detection_tpu.ops", "jax.numpy", "flax",
         "jaxlib.xla_client"]) == ["flax", "jax", "jaxlib",
                                   "snn_for_object_detection_tpu"]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    assert imports.files_importing(
        ref, imports.FORBIDDEN + (imports.PROGRAM,)) == []
    # and no file of the benchmark imports JAX or the JAX package
    assert imports.files_importing(HERE, imports.FORBIDDEN) == []


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run in a fresh process: once it has printed its line,
    ``sys.modules`` holds no forbidden top-level name."""
    catalog_dir = str(tmp_path)
    tiny.catalog(catalog_dir)
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench import run\n"
        "from portbench.lib import imports\n"
        "from portbench.lib.harness import Catalog, HERE\n"
        f"cat = Catalog.load({catalog_dir!r}, ({catalog_dir!r}, HERE))\n"
        "cell, out = run.run_cell(cat, 'gen1_serve_c64', 3, 0.3, False,\n"
        "                         torch.device('cpu'))\n"
        "print(json.dumps(imports.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=catalog_dir)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_reader_that_loads_jax_refuses_the_line(tmp_path):
    """A per-layer reader is loaded while the result line is built; one
    that imports ``jax`` (here a stub of that name) leaves it in
    ``sys.modules``, and the run exits 3 with no result line."""
    bench_dir = tmp_path / "bench"
    tiny.catalog(str(bench_dir))
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    (bench_dir / "metrics").mkdir()
    (bench_dir / "metrics" / "loads_jax.throwaway.py").write_text(
        "def read(rec):\n"
        "    import jax  # noqa: F401\n"
        "    return None if rec is None else 1.0\n")
    bench = json.load(open(bench_dir / "BENCHMARK.json"))
    bench["per_layer"].append(
        {"name": "loads_jax.throwaway", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "trainer",
         "moves": "train_frames_per_s", "workloads": ["gen1_train"]})
    (bench_dir / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{ROOT!r}, {str(tmp_path / 'stub')!r}]\n"
        "from portbench import run\n"
        "from portbench.lib.harness import Catalog, HERE\n"
        f"cat = Catalog.load({str(bench_dir)!r}, ({str(bench_dir)!r}, HERE))\n"
        "dev = torch.device('cpu')\n"
        "cell, out = run.run_cell(cat, 'gen1_train', 5, 0.3, True, dev)\n"
        "assert 'jax' not in sys.modules\n"
        "sys.exit(run.finish(cat, cell, out, True, dev, 'cpu', 'cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 3, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "loaded jax" in out.stderr


def test_run_refuses_without_a_card(tmp_path):
    """``run.py`` exits non-zero with no result line where no CUDA device
    is there."""
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "gen1_train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
