"""The dataset preflight in both packages, on the CPU.

``scripts/check_gen1_torch.py`` (the port's decoder and geometry) against
``scripts/check_gen1.py`` (the JAX package's), run as users run them, on
the same layouts: a valid synthetic GEN1 set written by the port's
``data/synthetic.py``, and copies of it with one fault each (an orphan
label, a truncated ``.dat``, an event x or y outside the geometry, a
``class_id`` past the class count, a label array without ``class_id``);
then a valid 1Mpx set and one whose labels carry GEN1's time field.
Both scripts give the same exit code and print the same lines, the
problem lines included. The port's script imports neither JAX nor torch.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import numpy.lib.recfunctions as rfn
import pytest

from snn_for_object_detection_tpu_torch.data.psee import write_dat
from snn_for_object_detection_tpu_torch.data.synthetic import (
    generate_recording,
    make_synthetic_dataset,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"jax": "scripts/check_gen1.py", "port": "scripts/check_gen1_torch.py"}


def _orphan_label(split_dir):
    shutil.copy(os.path.join(split_dir, "rec0_bbox.npy"),
                os.path.join(split_dir, "orphan_bbox.npy"))


def _truncated_dat(split_dir):
    with open(os.path.join(split_dir, "rec0_td.dat"), "r+b") as f:
        f.truncate(40)


def _coords_out(split_dir, width=304, height=240):
    t, x, y, p, _ = generate_recording(duration_ms=300, seed=7)
    x[len(x) // 2] = width  # one event a column right of the sensor
    y[-1] = height + 3      # and one in the tail below it
    write_dat(os.path.join(split_dir, "rec0_td.dat"), t, x, y, p, width,
              height)


def _class_id_past(split_dir, classes=2):
    path = os.path.join(split_dir, "rec0_bbox.npy")
    gt = np.load(path)
    gt["class_id"][0] = classes
    np.save(path, gt)


def _no_class_id(split_dir):
    path = os.path.join(split_dir, "rec0_bbox.npy")
    np.save(path, rfn.drop_fields(np.load(path), "class_id", usemask=False))


def _gen1_time_field(split_dir):
    path = os.path.join(split_dir, "rec0_bbox.npy")
    gt = np.load(path)
    gt.dtype.names = ("ts",) + gt.dtype.names[1:]
    np.save(path, gt)


# name: (dataset, split, fault, problems the scripts must name)
LAYOUTS = {
    "valid": ("gen1", None, None, ()),
    "orphan_label": ("gen1", "train", _orphan_label,
                     ("label without events",)),
    "truncated_dat": ("gen1", "val", _truncated_dat, ("zero events",)),
    "coords_out": ("gen1", "test", _coords_out,
                   ("event coords out of 304x240",)),
    "class_id_past": ("gen1", "train", _class_id_past,
                      ("class_id out of [0, 2)",)),
    "no_class_id": ("gen1", "val", _no_class_id,
                    ("missing GT field 'class_id'",)),
    "mpx_valid": ("1mpx", None, None, ()),
    "mpx_gen1_time_field": ("1mpx", "test", _gen1_time_field,
                            ("missing GT field 't'",)),
}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("preflight")
    gen1 = make_synthetic_dataset(str(root / "gen1_set"),
                                  records_per_split=1, duration_ms=1200)
    mpx = make_synthetic_dataset(str(root / "mpx_set"), dataset="1mpx",
                                 records_per_split=1, duration_ms=300,
                                 height=720, width=1280, num_classes=7)
    return {"gen1": gen1, "1mpx": mpx}


def _run(script, root, dataset):
    out = subprocess.run(
        [sys.executable, script, root, "--dataset", dataset], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    return out.returncode, out.stdout, out.stderr


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_check_gen1_torch_matches_the_jax_script(datasets, tmp_path,
                                                  layout):
    dataset, split, fault, named = LAYOUTS[layout]
    root = str(tmp_path / "data")
    shutil.copytree(datasets[dataset], root)
    if fault is not None:
        fault(os.path.join(root, dataset, split))
    runs = {name: _run(script, root, dataset)
            for name, script in SCRIPTS.items()}
    (j_rc, j_out, j_err), (rc, out, err) = runs["jax"], runs["port"]
    assert rc == j_rc == (1 if named else 0), (out + err, j_out + j_err)
    problems = {line for line in out.splitlines() if line.startswith("  - ")}
    assert problems == {line for line in j_out.splitlines()
                        if line.startswith("  - ")}
    assert out == j_out  # the per-split summaries too
    assert len(problems) == len(named)
    for what in named:
        assert any(what in line and f"{split}" in line for line in problems)
    if not named:
        assert f"OK — {dataset} layout" in out


def test_preflight_imports_neither_jax_nor_torch(tmp_path):
    """``scripts/check_gen1_torch.py`` is host-side: run on an empty
    directory it reports the missing splits having imported numpy and the
    port's data modules only."""
    code = ("import runpy, sys; sys.argv = sys.argv[1:]\n"
            "try:\n    runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "except SystemExit as e:\n    print('rc', e.code)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'torch', 'snn_for_object_detection_tpu'}))")
    out = subprocess.run(
        [sys.executable, "-c", code,
         os.path.join(REPO, SCRIPTS["port"]), str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    assert lines[-2:] == ["rc 1", "[]"], out.stdout + out.stderr
    assert "train: missing directory" in out.stdout
