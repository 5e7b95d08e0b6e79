"""The 1Mpx geometry (``config/1mpx.yaml``: 720x1280, 7 classes, B=2,
``time_batched: auto``) in the port against the JAX package, on the CPU.

- A narrow TinyYolo (the GEN1 stage plan at widths 8-16) at 720x1280
  with 7 classes, T=3, B=1, weights drawn by numpy in the JAX layout:
  for each schedule (per-step, time-batched, hybrid) the predictions
  and the loss within rtol 1e-5, atol 1e-6 of JAX's, the final state
  within rtol 1e-5 and 1e-6 of its scale; the anchor tables (head maps
  90x160, 45x80, 23x40) equal.
- ``config/config.yaml`` + ``config/1mpx.yaml`` read by the port's
  reader into the JAX reader's values, and built by the port's CLI into
  full-width TinyYolo at 720x1280 whose anchors are JAX's.
- A synthetic 1Mpx recording (7 classes) through the port's loader
  bit-equal to JAX's at those settings.
- The CLI's ``fit``, ``validate`` and ``test`` with ``time_batched:
  auto`` at 1Mpx
  (narrow model, T=2, 8 labels a sample, the clock stubbed so the
  measurement takes one call a schedule).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.data import (
    PropheseeDataModule as JDataModule,
)
from snn_for_object_detection_tpu.models.tiny_yolo import TinyYolo as JTiny
from snn_for_object_detection_tpu.utils.config import (
    load_config as j_load_config,
)
from snn_for_object_detection_tpu_torch import cli
from snn_for_object_detection_tpu_torch.data import PropheseeDataModule
from snn_for_object_detection_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
)
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.models.tiny_yolo import (
    TinyYolo as PTiny,
)
from snn_for_object_detection_tpu_torch.train import loop
from snn_for_object_detection_tpu_torch.utils.config import load_config
from test_torch_detector import JNarrow, PNarrow, _jax_weights, _state_leaves
from test_torch_hybrid import TOL, assert_state_close

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(REPO, "config", "config.yaml"),
           os.path.join(REPO, "config", "1mpx.yaml")]
HW, T, CLASSES = (720, 1280), 3, 7


@pytest.fixture(scope="module")
def narrow():
    jm = JNarrow(num_classes=CLASSES, in_hw=HW, time_window=2)
    params, stats = _jax_weights(jm, 0, 4.0)
    pm = PNarrow(num_classes=CLASSES, in_hw=HW, time_window=2, device="cpu")
    load_jax_params(pm, params, stats)
    rng = np.random.default_rng(0)
    X = (rng.random((T, 1, *HW, 2)) < 0.05).astype(np.float32)
    lab = np.full((1, 8, 5), -1.0, np.float32)
    lab[0, :3] = [[1, .1, .1, .3, .4], [6, .5, .5, .7, .9],
                  [3, .2, .6, .4, .8]]
    return jm, params, stats, pm, X, lab


@pytest.mark.parametrize("schedule", [False, True, "hybrid"])
def test_1mpx_schedules_match_jax(narrow, schedule):
    jm, params, stats, pm, X, lab = narrow
    assert [hw for _, hw in pm.neck_out_shape] == [(90, 160), (45, 80),
                                                   (23, 40)]
    np.testing.assert_array_equal(pm.anchors.numpy(), np.asarray(jm.anchors))
    fwd = jm.forward_fn(schedule)
    (j_cls, j_box), _, j_state = jax.jit(
        lambda x: fwd(params, stats, x, start_step=0))(jnp.asarray(X))
    j_loss = float(jax.jit(jm.loss)((j_cls, j_box), jnp.asarray(lab)))
    preds, state = pm.forward_fn(schedule)(torch.from_numpy(X))
    assert preds[0].shape == (1, 170280, CLASSES + 1)
    for got, want in zip(preds, (j_cls, j_box)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(pm.loss(preds, torch.from_numpy(lab))),
                               j_loss, **TOL)
    for j, p in zip(jax.tree.leaves(j_state), _state_leaves(state)):
        assert_state_close(p.numpy(), j)


def test_1mpx_config_reads_and_builds_as_in_jax():
    cfg = load_config(CONFIGS)
    assert cfg == j_load_config(CONFIGS)
    assert cfg["trainer"]["time_batched"] == "auto"
    model, data, trainer = cli.build(cfg, "cpu")
    assert type(model) is PTiny
    assert (model.in_hw, model.num_classes) == (HW, CLASSES)
    assert (data.dataset, data.batch_size, data.height, data.width) == (
        "1mpx", 2, *HW)
    assert trainer.time_batched == "auto"
    jm = JTiny(**cfg["model"]["init_args"])
    params, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(params)) == 4_263_104
    np.testing.assert_array_equal(model.anchors.numpy(),
                                  np.asarray(jm.anchors))


@pytest.fixture(scope="module")
def mpx_root(tmp_path_factory):
    return make_synthetic_dataset(
        str(tmp_path_factory.mktemp("mpx")), dataset="1mpx",
        records_per_split=1, duration_ms=600, height=720, width=1280,
        num_classes=CLASSES)


def test_1mpx_loader_bit_equal_to_jax(mpx_root):
    kw = dict(load_config(CONFIGS)["data"]["init_args"], data_dir=mpx_root,
              num_steps=T, time_shift=2, num_workers=1, num_load_file=1)
    ours = PropheseeDataModule(**kw)
    theirs = JDataModule(**kw)
    assert ours.get_labels() == theirs.get_labels()
    assert ours.get_labels()[0] == "pedestrians"
    a, b = ours.train_loader(), theirs.train_loader()
    try:
        (x, lab), (jx, jlab) = next(a), next(b)
    finally:
        a.close()
        b.close()
    assert x.shape == jx.shape == (T, 2, *HW, 2) and x.dtype == np.uint8
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(lab, jlab)
    assert x.any() and (lab[..., 0] >= 0).any()
    assert lab[..., 0].max() < CLASSES


def test_1mpx_cli_fit_and_test_on_auto(mpx_root, tmp_path, monkeypatch):
    """``fit`` (one train and one validation batch), then ``validate``
    and ``test`` on ``config/1mpx.yaml``'s ``time_batched: auto``,
    narrow model, B=1, T=2, 8 labels a sample (the loss matches 170,280
    anchors against each): "auto" resolves for the train and the eval step (the stubbed
    clock prefers "hybrid" for training and the time-batched schedule
    for evaluation), and the losses and mAP are finite."""
    clock = iter([3.0, 1.0, 2.0] + [3.0, 2.0, 1.0] * 3)

    def stub(fn, device, reps=2):
        fn()
        return next(clock)

    monkeypatch.setattr(loop, "time_call", stub)
    args = [
        *sum((["--config", c] for c in CONFIGS), []),
        "--model.class_path=test_torch_detector.PNarrow",
        f"--data.init_args.data_dir={mpx_root}",
        "--data.init_args.batch_size=1",
        "--data.init_args.num_steps=2",
        "--data.init_args.time_shift=1",
        "--data.init_args.num_workers=1",
        "--data.init_args.num_load_file=1",
        "--data.init_args.max_labels=8",
        "--model.init_args.time_window=1",
        "--trainer.max_epochs=1",
        "--trainer.limit_train_batches=1",
        "--trainer.limit_val_batches=1",
        "--trainer.limit_test_batches=1",
        "--trainer.check_val_every_n_epoch=1",
        "--trainer.min_epochs=0",
        f"--trainer.out_dir={tmp_path}",
        "--device", "cpu",
    ]
    fit = cli.main(["fit", *args])
    assert fit.trainer._auto_schedule == {"train": "hybrid", "eval": True}
    assert fit.result["step"] == 1
    for sub, loss in (("validate", "val_loss"), ("test", "test_loss")):
        run = cli.main([sub, *args])
        assert run.trainer._auto_schedule == {"eval": True}
        assert all(np.isfinite(v) for v in run.result.values())
        assert set(run.result) >= {loss, "map"}
