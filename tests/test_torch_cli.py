"""The port's CLI (``python -m snn_for_object_detection_tpu_torch``) on
the CPU, against the JAX package where the two compute the same thing.

A narrow TinyYolo (``test_torch_detector.PNarrow``, widths 8-16) named
through ``--model.class_path``, at GEN1 geometry on one synthetic
recording per split:

- ``fit``, then ``validate`` and ``test`` from the checkpoint ``fit``
  wrote, with ``--device cpu``: the checkpoint, the config snapshot and
  the metrics file exist, every loss is finite and ``test`` restores the
  weights ``fit`` saved bit for bit;
- ``test`` on a checkpoint written from JAX weights (``load_jax_params``,
  ``save_single``) against JAX's ``Trainer.test`` on the same weights and
  data at time window 0: every metric within rtol 1e-5, atol 1e-6 (the
  bars of ``test_trainer_test_matches_jax_eval_step``);
- ``Trainer.predict`` against JAX's, with a plotter that records what it
  is handed: the same frames and ground truth, detections within the
  prediction tolerance of ``tests/test_torch_detector.py``;
- ``fit --distributed`` under ``torchrun`` (two gloo ranks on the CPU):
  rank 0 alone writes the metrics and the checkpoint;
- ``fit`` on ``main.py``'s default configs (``config/config.yaml`` and
  ``config/logger.yaml``: the event file and ``metrics.csv`` hold what
  ``metrics.jsonl`` holds) and ``predict`` on ``config/config.yaml``
  (its ``utils.Plotter`` writes the video).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.data import (
    PropheseeDataModule as JDataModule,
)
from snn_for_object_detection_tpu.train import Trainer as JTrainer
from snn_for_object_detection_tpu_torch import cli
from snn_for_object_detection_tpu_torch.data import PropheseeDataModule
from snn_for_object_detection_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
)
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.train.checkpoint import (
    load_single,
    save_single,
)
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from test_torch_detector import PRED_TOL, JNarrow, PNarrow, _jax_weights

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN1_HW = (240, 304)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clidata"))
    return make_synthetic_dataset(root, records_per_split=1, duration_ms=1200)


def common_args(synth_root, out_dir, extra=()):
    return [
        "--config", os.path.join(REPO, "config", "config.yaml"),
        "--model.class_path=test_torch_detector.PNarrow",
        f"--data.init_args.data_dir={synth_root}",
        "--data.init_args.batch_size=2",
        "--data.init_args.num_steps=4",
        "--data.init_args.num_workers=1",
        "--data.init_args.num_load_file=1",
        "--data.init_args.time_shift=2",
        "--model.init_args.time_window=2",
        "--trainer.max_epochs=1",
        "--trainer.limit_train_batches=2",
        "--trainer.limit_val_batches=1",
        "--trainer.limit_test_batches=2",
        "--trainer.check_val_every_n_epoch=1",
        "--trainer.min_epochs=0",
        "--trainer.log_every_n_steps=1",
        f"--trainer.out_dir={out_dir}",
        "--device", "cpu",
        *extra,
    ]


def _finite(metrics):
    return all(math.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("time_batched", [False, True])
def test_cli_fit_then_validate_then_test(synth_root, tmp_path, time_batched):
    args = common_args(synth_root, tmp_path / "run",
                       [f"--trainer.time_batched={str(time_batched).lower()}"])
    fit = cli.main(["fit", *args])
    assert type(fit.model) is PNarrow and fit.model.device.type == "cpu"
    assert fit.result["step"] == 2 and fit.result["epoch"] == 1
    run = tmp_path / "run"
    ckpt = run / "checkpoints" / "last"
    assert ckpt.exists() and (run / "config.yaml").exists()
    with open(run / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert any("val_loss" in r for r in records)

    saved = load_single(str(ckpt))["params"]
    for name, p in fit.model.named_parameters():
        assert torch.equal(saved[name], p.detach()), name

    val = cli.main(["validate", *args])
    assert _finite(val.result) and set(val.result) >= {"val_loss", "map"}
    test = cli.main(["test", *args, f"--ckpt_path={ckpt}"])
    assert _finite(test.result) and set(test.result) >= {"test_loss", "map"}
    for name, p in test.model.named_parameters():
        assert torch.equal(saved[name], p.detach()), name
    with open(run / "metrics.jsonl") as f:
        assert "test_loss" in json.loads(f.readlines()[-1])


def test_cli_test_matches_jax_trainer_test(synth_root, tmp_path):
    """The port's ``test`` on JAX weights against JAX's ``Trainer.test``
    on the same weights and the same loader settings, time window 0 (so
    both start every batch at r = 0), per-step schedule in both."""
    jm = JNarrow(num_classes=2, in_hw=GEN1_HW, time_window=0)
    params, stats = _jax_weights(jm, 0, 8.0)
    pm = PNarrow(num_classes=2, in_hw=GEN1_HW, time_window=0, device="cpu")
    load_jax_params(pm, params, stats)
    ckpt = str(tmp_path / "jax_weights")
    save_single(ckpt, {
        "params": {n: p.detach() for n, p in pm.named_parameters()},
        "stats": {n: b for n, b in pm.named_buffers()
                  if n.endswith((".mean", ".var"))},
    })
    run = cli.main(["test", *common_args(synth_root, tmp_path / "port"),
                    "--model.init_args.time_window=0",
                    f"--ckpt_path={ckpt}"])
    data = JDataModule(**run.cfg["data"]["init_args"])
    jt = JTrainer(out_dir=str(tmp_path / "jax"), seed=0,
                  limit_test_batches=run.trainer.limit_test_batches)
    want = jt.test(jm, data, params, stats)
    got = run.result
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert got["test_loss"] > 0


def test_load_model_state_prefers_ema_params(tmp_path):
    """A checkpoint of a run trained with ``ema_decay`` is deployed with
    its averaged weights (main.py's ``load_model_state``); one that does
    not fit the model raises."""
    pm = PNarrow(num_classes=2, in_hw=GEN1_HW, device="cpu")
    params = {n: p.detach().clone() for n, p in pm.named_parameters()}
    ema = {n: p + 1.0 for n, p in params.items()}
    stats = {n: b.clone() + 0.5 for n, b in pm.named_buffers()
             if n.endswith((".mean", ".var"))}
    ckpt = str(tmp_path / "ckpt")
    save_single(ckpt, {"params": params, "ema_params": ema, "stats": stats})
    assert cli.load_model_state(pm, ckpt, str(tmp_path)) == ckpt
    for n, p in pm.named_parameters():
        assert torch.equal(p, ema[n]), n
    for n, b in pm.named_buffers():
        if n in stats:
            assert torch.equal(b, stats[n]), n
    save_single(ckpt, {"params": params, "stats": {}})
    with pytest.raises(ValueError, match="does not fit the model"):
        cli.load_model_state(pm, ckpt, str(tmp_path))


class RecordingPlotter:
    """A plotter stub: keeps every frame it is handed."""

    def __init__(self):
        self.labels = None
        self.applied = []
        self.videos = []

    def apply(self, frame, dets, gt):
        self.applied.append(tuple(None if a is None else np.array(a)
                                  for a in (frame, dets, gt)))
        return len(self.applied) - 1

    def __call__(self, video, time_step, name):
        self.videos.append((list(video), time_step, name))


@pytest.mark.parametrize("one_label", [True, False])
def test_predict_matches_jax(synth_root, tmp_path, one_label):
    window = 2
    jm = JNarrow(num_classes=2, in_hw=GEN1_HW, time_window=window)
    params, stats = _jax_weights(jm, 0, 8.0)
    pm = PNarrow(num_classes=2, in_hw=GEN1_HW, time_window=window,
                 device="cpu")
    load_jax_params(pm, params, stats)
    kw = dict(data_dir=synth_root, batch_size=2, num_workers=1,
              num_load_file=1, num_steps=4, time_shift=2, max_labels=8,
              one_label=one_label)
    ours, theirs = RecordingPlotter(), RecordingPlotter()
    Trainer(limit_predict_batches=1).predict(
        pm, PropheseeDataModule(**kw), ours)
    JTrainer(out_dir=str(tmp_path / "jax"), prefetch_batches=0).predict(
        jm, JDataModule(**kw), params, stats, theirs, limit=1)
    assert ours.labels == theirs.labels == ["car", "person"]
    assert [v[1:] for v in ours.videos] == [v[1:] for v in theirs.videos] \
        == [(16, "0")]
    assert len(ours.applied) == len(theirs.applied) == 4 + 1
    for t, (a, b) in enumerate(zip(ours.applied, theirs.applied)):
        np.testing.assert_array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None) == (t < window)
        if a[1] is not None:
            np.testing.assert_array_equal(a[1][:, 0], b[1][:, 0])
            np.testing.assert_allclose(a[1][:, 1:], b[1][:, 1:], **PRED_TOL)
        assert (a[2] is None) == (b[2] is None) == (t < 4)
    gt = ours.applied[-1][2]
    np.testing.assert_array_equal(gt, theirs.applied[-1][2])
    assert gt.shape == (8, 5)  # MT labels lose their frame index


def test_predict_closes_its_loader(synth_root):
    pm = PNarrow(num_classes=2, in_hw=GEN1_HW, time_window=2, device="cpu")
    data = PropheseeDataModule(data_dir=synth_root, batch_size=1,
                               num_workers=2, num_load_file=1, num_steps=3,
                               time_shift=2)
    loaders = []
    make = data.predict_loader
    data.predict_loader = lambda: loaders.append(make()) or loaders[-1]
    Trainer().predict(pm, data, RecordingPlotter(), limit=1)
    with pytest.raises(StopIteration):  # closed: its threads are gone
        next(loaders[0])


NARROW = "--model.class_path=test_torch_detector.PNarrow"


def small_run(synth_root, out_dir):
    """``common_args`` without its ``--config`` (the callers name their
    configs) and one train batch."""
    return [*common_args(synth_root, out_dir)[2:],
            "--trainer.limit_train_batches=1"]


@pytest.mark.parametrize("configs", [
    ["--config", "config/config.yaml", "--config", "config/logger.yaml"],
    [],  # main.py's defaults for fit: config.yaml and logger.yaml
], ids=["explicit", "defaults"])
def test_fit_on_the_default_configs(monkeypatch, synth_root, tmp_path,
                                    configs):
    from snn_for_object_detection_tpu_torch.train.loggers import read_scalars

    monkeypatch.chdir(REPO)
    run = tmp_path / "run"
    fit = cli.main(["fit", *configs, *small_run(synth_root, run)])
    assert [type(b).__name__ for b in fit.trainer.loggers] == [
        "TensorBoardLogger", "CSVLogger"]
    with open(run / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    scalars = [(k, r["step"], float(np.float32(v))) for r in records
               for k, v in r.items() if k not in ("step", "time")]
    (events,) = (run / "tb").iterdir()
    assert read_scalars(str(events)) == scalars
    with open(run / "metrics.csv") as f:
        assert len(f.readlines()) == len(records) + 1


def test_predict_on_config_yaml(monkeypatch, synth_root, tmp_path):
    """``predict --config config/config.yaml``: its plotter
    (``utils.Plotter``, OpenCV here) writes one video."""
    monkeypatch.chdir(REPO)
    pm = PNarrow(num_classes=2, in_hw=GEN1_HW, time_window=2, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_single(ckpt, {
        "params": {n: p.detach() for n, p in pm.named_parameters()},
        "stats": {n: b for n, b in pm.named_buffers()
                  if n.endswith((".mean", ".var"))}})
    run = cli.main(["predict", "--config", "config/config.yaml",
                    *small_run(synth_root, tmp_path / "run"),
                    f"--ckpt_path={ckpt}",
                    f"--plotter.init_args.file_path={tmp_path}/video"])
    assert type(run.trainer).__name__ == "Trainer"
    video = tmp_path / "video" / "out0.avi"
    assert video.exists() and video.stat().st_size > 0


@pytest.mark.parametrize("overlay,cls", [("vgg.yaml", "VggSNN")])
def test_configs_of_the_zoo_build_their_model(monkeypatch, overlay, cls):
    """``config/vgg.yaml`` builds the port's model (PLIF VggSNN at GEN1
    width); tests/test_torch_zoo.py runs ``fit`` and ``test`` on it."""
    monkeypatch.chdir(REPO)
    cfg = cli.load_config(["config/config.yaml", f"config/{overlay}"])
    model, _, _ = cli.build(cfg, "cpu")
    assert type(model).__name__ == cls
    assert (model.neuron, model.widths) == ("plif", (64, 128, 256))


def test_cli_refuses_what_it_has_no_counterpart_for(monkeypatch, tmp_path):
    monkeypatch.chdir(REPO)
    with pytest.raises(SystemExit):
        cli.main(["explode"])
    with pytest.raises(SystemExit):
        cli.main(["test", "--compile_cache", str(tmp_path)])
    with pytest.raises(ValueError, match="does not match"):
        cli.main(["test", "--device", "cpu", NARROW,
                  "--model.init_args.in_hw=[64, 80]"])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["test", "--config", "config/config.yaml"])


def test_distributed_fit_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    snn_for_object_detection_tpu_torch fit --distributed`` (gloo ranks
    with ``--device cpu``; a rendezvous on a free localhost port): exits
    0, each step and the validation logged once, by rank 0, and rank 0's
    checkpoint written."""
    import subprocess
    import sys

    data = make_synthetic_dataset(str(tmp_path / "data"),
                                  records_per_split=2, duration_ms=1200)
    run = tmp_path / "run"
    args = common_args(data, run, [
        "--model.class_path=torch_rank_worker.MicroSODa",
        "--trainer.time_batched=true"])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "snn_for_object_detection_tpu_torch",
         "fit", "--distributed", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    with open(run / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    steps = [r["step"] for r in records if "train_loss" in r]
    assert steps == [1, 2]
    assert sum("val_loss" in r for r in records) == 1
    assert sum("epoch" in r for r in records) == 1
    assert (run / "checkpoints" / "last").exists()
    assert (run / "config.yaml").exists()
