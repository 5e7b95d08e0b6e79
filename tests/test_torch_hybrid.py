"""The port's hybrid schedule against the JAX package's, on the CPU.

``SODa.forward_hybrid`` runs the backbone time-batched and the neck and
head stems one step at a time. On the narrow TinyYolo of
``tests/test_torch_detector.py`` (GEN1 stage plan at widths 8-16, 64x80
frames), with weights drawn by numpy in the JAX pytree layout and
carried into the port by ``load_jax_params``, at fp32:

- eval from start 0 and 3: predictions and the BatchNorm statistics
  within rtol 1e-5, atol 1e-6 of JAX's ``forward_hybrid``, and of the
  port's own per-step ``forward``; the final neuron state within rtol
  1e-5 and an atol of 1e-6 times the tensor's largest magnitude (the LI
  membranes reach ~80, and XLA and oneDNN sum a conv in different
  orders: measured up to 1.5e-5 apart, on every schedule);
- a train-mode forward and backward from start 0 and 3: the loss within
  rtol 1e-5, every gradient within rtol 2e-3, atol 1e-7 and the new
  running statistics within rtol 1e-5, atol 1e-6 of JAX's
  ``value_and_grad`` of its hybrid forward;
- eight Adamax steps of ``Trainer(time_batched="hybrid")`` against JAX's
  trainer on the same schedule: losses within rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu_torch.models import compile as PC
from snn_for_object_detection_tpu_torch.models.convert import _flatten
from snn_for_object_detection_tpu_torch.ops import cuda_kernels
from test_torch_detector import _frames, _labels, _state_leaves
from test_torch_train_model import (
    GRAD_TOL,
    _models,
    _port_grads,
    adamax_trajectory,
)

torch.set_num_threads(1)

T = 8
TOL = dict(rtol=1e-5, atol=1e-6)


def assert_state_close(got, want):
    """rtol 1e-5, atol 1e-6 of the tensor's scale (its largest
    magnitude): float32 round-off of sums taken in another order."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.fixture(scope="module")
def models():
    return _models(time_window=16)


@pytest.fixture(scope="module")
def jax_hybrid(models):
    jm, params, stats, _ = models
    X = _frames(1, t=T)
    fwd = jax.jit(lambda x, r: jm.forward_hybrid(params, stats, x,
                                                 start_step=r))
    return X, {r: fwd(jnp.asarray(X), jnp.int32(r)) for r in (0, 3)}


def _assert_close(preds, state, pm, j_preds, j_stats, j_state):
    for got, want in zip(preds, j_preds):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jl, pl = jax.tree.leaves(j_state), _state_leaves(state)
    assert len(jl) == len(pl) == 2 * 13
    for j, p in zip(jl, pl):
        assert_state_close(p.float().numpy(), j)
    flat = _flatten(jax.device_get(j_stats))
    bufs = {n: b for n, b in pm.named_buffers()
            if n.endswith((".mean", ".var"))}
    assert bufs.keys() == flat.keys()
    for name, b in bufs.items():
        np.testing.assert_allclose(b.numpy(), flat[name], err_msg=name, **TOL)


@pytest.mark.parametrize("start", [0, 3])
def test_hybrid_eval_matches_jax(models, jax_hybrid, start):
    _, _, _, pm = models
    X, runs = jax_hybrid
    (j_cls, j_box), j_stats, j_state = runs[start]
    preds, state = pm.forward_hybrid(torch.from_numpy(X), start_step=start)
    assert float(preds[0].abs().max()) > 0.1  # the net is not silent
    _assert_close(preds, state, pm, (j_cls, j_box), j_stats, j_state)


@pytest.mark.parametrize("start", [0, 3])
def test_hybrid_matches_forward(models, start):
    """The port's hybrid against its own per-step schedule (the
    counterpart of tests/test_forward_seq.py's hybrid-vs-forward)."""
    _, _, _, pm = models
    X = torch.from_numpy(_frames(2, t=T))
    preds_a, state_a = pm.forward(X, start_step=start)
    preds_b, state_b = pm.forward_fn("hybrid")(X, start_step=start)
    for a, b in zip(preds_a, preds_b):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)
    for a, b in zip(_state_leaves(state_a), _state_leaves(state_b)):
        assert_state_close(b.numpy(), a.numpy())


def test_hybrid_runs_the_cell_over_the_sequence_in_the_backbone_only(
        models, monkeypatch):
    """Launch pattern of one hybrid eval forward on the plain versions:
    every backbone cell once over T, every neck and head cell once a
    step from the start r; no fused triple."""
    _, _, _, pm = models
    calls = []

    def counted(x, *args, **kwargs):
        calls.append(x.shape[0])
        return cuda_kernels.temporal_cell_seq(x, *args, **kwargs)

    monkeypatch.setattr(PC, "temporal_cell_seq", counted)
    monkeypatch.setattr(PC, "spiking_conv_seq", None)
    r = 3
    pm.forward_hybrid(torch.from_numpy(_frames(3, t=T)), start_step=r)
    cells = [m for m in pm.modules() if isinstance(m, PC.Cell)]
    backbone = [m for m in pm.backbone.modules() if isinstance(m, PC.Cell)]
    rest = len(cells) - len(backbone)
    assert calls.count(T) == len(backbone)
    assert calls.count(1) == rest * (T - r)
    assert len(calls) == len(backbone) + rest * (T - r)


def _jax_hybrid_grads(jm, params, stats, X, lab, r):
    def loss_fn(p):
        preds, new_stats, _ = jm.forward_hybrid(p, stats, jnp.asarray(X),
                                                start_step=r, train=True)
        return jm.loss(preds, jnp.asarray(lab)), new_stats

    (loss, new_stats), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return (float(loss), _flatten(jax.device_get(grads)),
            _flatten(jax.device_get(new_stats)))


@pytest.mark.parametrize("r", [0, 3])
def test_hybrid_train_matches_jax(r):
    X, lab = _frames(0, t=T), _labels(1)
    jm, params, stats, pm = _models(16)
    j_loss, j_grads, j_stats = _jax_hybrid_grads(jm, params, stats, X, lab, r)
    loss, grads, new_stats = _port_grads(pm, "hybrid", X, lab, r)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert grads.keys() == j_grads.keys()
    moved = 0
    for name, g in grads.items():
        want = j_grads[name]
        if want.ndim == 4:  # HWIO -> OIHW
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(g, want, err_msg=name, **GRAD_TOL)
        moved += bool(np.abs(want).max() > 0)
    assert moved > 10
    assert new_stats.keys() == j_stats.keys()
    for name, s in new_stats.items():
        np.testing.assert_allclose(s, j_stats[name], err_msg=name, **TOL)


def test_hybrid_trainer_trajectory_matches_jax(tmp_path):
    """Eight Adamax steps of ``Trainer(time_batched="hybrid")`` against
    the JAX trainer's jitted step on the hybrid schedule (the port's
    counterpart of tests/test_train.py's schedule trajectories)."""
    adamax_trajectory(tmp_path, "hybrid")
