"""``scripts/supervise.py`` over the port's CLI, and ``scripts/plot_metrics.py``
on the port's ``metrics.jsonl``, on the CPU.

The supervisor (unchanged, shared with ``main.py``) runs a launcher that
calls the port's ``cli.main`` in-process with ``fit`` on one synthetic
GEN1 recording (``test_torch_cli``'s small-run arguments, a narrow
TinyYolo, one train batch an epoch, 3 epochs, a checkpoint after each).
On its first attempt the launcher ends the process with exit code 3 right
after the first checkpoint is written, as a crash would. The supervisor
relaunches it with ``--ckpt_path=auto``; the relaunch resumes at the
saved step, logs its first train step at the saved step + 1, logs no
step twice, and its last checkpoint holds the full run's step and epoch,
those of an uninterrupted run of the same arguments.

Like JAX's ``Trainer.fit`` (``train/loop.py:689``, ``:703-750``), the
port's restores the weights, the optimizer, the counters and the early
stopping state, but neither its random draws (the generator restarts
from ``seed``) nor the loader's place: so the parameters after a resume
are not those of the uninterrupted run, in either package, and only the
step and epoch are compared.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from snn_for_object_detection_tpu_torch import cli
from snn_for_object_detection_tpu_torch.train.checkpoint import load_single
from test_torch_cli import common_args, synth_root  # noqa: F401 (fixture)
from test_torch_detector import PNarrow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3
TIMEOUT_S = 300

NET = """\
from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo


class Narrow(TinyYolo):
    backbone_plan = {backbone!r}
    neck_plan = {neck!r}
"""

LAUNCHER = """\
import os
import sys

sys.path[:0] = [{repo!r}, {here!r}]
import torch

from snn_for_object_detection_tpu_torch import cli
from snn_for_object_detection_tpu_torch.train import checkpoint

torch.set_num_threads(1)
out_dir = {out!r}
marker = os.path.join(out_dir, "attempts")
attempt = int(open(marker).read()) if os.path.exists(marker) else 0
with open(marker, "w") as f:
    f.write(str(attempt + 1))
metrics = os.path.join(out_dir, "metrics.jsonl")
with open(os.path.join(out_dir, f"attempt{{attempt}}_starts_at"), "w") as f:
    f.write(str(sum(1 for _ in open(metrics)) if os.path.exists(metrics)
                else 0))
if attempt == 0:
    save = checkpoint.CheckpointManager.save

    def save_then_end(self, *args, **kwargs):
        save(self, *args, **kwargs)
        sys.stdout.flush()
        os._exit(3)  # the first checkpoint is written: end as a crash does

    checkpoint.CheckpointManager.save = save_then_end
cli.main(sys.argv[1:])
"""


def _fit_args(synth_root, out_dir):
    """``test_torch_cli``'s small run on the narrow net of ``narrow_net``,
    one train batch an epoch, EPOCHS epochs, a checkpoint after each."""
    return [a for a in common_args(synth_root, out_dir)
            if not a.startswith("--model.class_path")] + [
        "--model.class_path=narrow_net.Narrow",
        "--trainer.limit_train_batches=1",
        f"--trainer.max_epochs={EPOCHS}",
    ]


@pytest.fixture(scope="module")
def supervised(tmp_path_factory, synth_root):  # noqa: F811
    """The supervised run (crashed once after its first checkpoint) and an
    uninterrupted run of the same arguments, run side by side."""
    here = tmp_path_factory.mktemp("supervise")
    (here / "narrow_net.py").write_text(NET.format(
        backbone=PNarrow.backbone_plan, neck=PNarrow.neck_plan))
    out = here / "run"
    out.mkdir()
    launcher = here / "launch_fit.py"
    launcher.write_text(LAUNCHER.format(repo=REPO, here=str(here),
                                        out=str(out)))
    cmd = [sys.executable, "scripts/supervise.py", "--out-dir", str(out),
           "--stall-timeout", "120", "--startup-grace", "240",
           "--max-restarts", "2", "--",
           sys.executable, str(launcher), "fit", *_fit_args(synth_root, out)]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    sys.path.insert(0, str(here))
    try:
        plain = cli.main(["fit", *_fit_args(synth_root, here / "plain")])
        stdout, _ = proc.communicate(timeout=TIMEOUT_S)
    finally:
        sys.path.remove(str(here))
        sys.modules.pop("narrow_net", None)
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, stdout, out, here / "plain", plain.result


def test_supervisor_restarts_and_the_cli_resumes(supervised):
    rc, stdout, out, _, _ = supervised
    assert rc == 0, stdout[-3000:]
    assert "restarting (exit=3" in stdout
    assert "training finished cleanly" in stdout
    assert (out / "attempts").read_text() == "2"
    (saved,) = [int(s) for s in re.findall(
        r"resumed from \S+ at step (\d+)", stdout)]
    assert saved == 1  # the first epoch's checkpoint
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    relaunch = records[int((out / "attempt1_starts_at").read_text()):]
    first = next(r for r in relaunch if "train_loss" in r)
    assert first["step"] == saved + 1
    steps = [r["step"] for r in records if "train_loss" in r]
    assert steps == list(range(1, EPOCHS + 1))
    assert [r["epoch"] for r in records if "epoch" in r] == list(
        range(1, EPOCHS + 1))


def test_resumed_run_ends_where_an_uninterrupted_one_does(supervised):
    """Step and epoch of the last checkpoint equal the uninterrupted
    run's (the parameters are not compared: see the module note)."""
    _, stdout, out, plain_out, plain = supervised
    last = load_single(str(out / "checkpoints" / "last"))
    want = load_single(str(plain_out / "checkpoints" / "last"))
    assert (int(last["step"]), int(last["epoch"])) == (EPOCHS, EPOCHS)
    assert (int(want["step"]), int(want["epoch"])) == (EPOCHS, EPOCHS)
    assert (plain["step"], plain["epoch"]) == (EPOCHS, EPOCHS)


def test_plot_metrics_renders_the_ports_metrics(supervised):
    _, _, out, _, _ = supervised
    proc = subprocess.run(
        [sys.executable, "scripts/plot_metrics.py", str(out)], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-500:]
    png = out / "training_graph.png"
    assert png.exists() and png.stat().st_size > 0
    assert proc.stdout.startswith("wrote ")
