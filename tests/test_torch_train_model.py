"""The port's training path on a narrow TinyYolo against the JAX package,
on the CPU (the north star's gradient bars).

The narrow TinyYolo of ``tests/test_torch_detector.py`` (the GEN1 stage
plan at widths 8-16, 64x80 frames) with weights drawn by numpy in the JAX
pytree layout and carried into the port by ``load_jax_params``:

- one train-mode forward and backward from truncation start r in {0, 2}
  on each schedule (the per-step ``forward``, each step checkpointed;
  ``forward_seq``, its conv -> norm -> cell segments checkpointed):
  the loss within rtol 1e-5, every parameter gradient within rtol 2e-3,
  atol 1e-7 and the new running statistics within rtol 1e-5, atol 1e-6
  of JAX's ``value_and_grad`` of the same forward;
- the two schedules' gradients against each other;
- eight steps of the JAX ``Trainer``'s jitted train step (Adamax) and of
  the port's ``Trainer.train_step`` from the same weights on the same
  batches, with the start r the JAX step draws given to the port: the
  losses within rtol 1e-3 per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.parallel import shard_batch
from snn_for_object_detection_tpu.train import Trainer as JTrainer
from snn_for_object_detection_tpu_torch.models.convert import (
    _flatten,
    load_jax_params,
)
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from test_torch_detector import (
    HW,
    JNarrow,
    PNarrow,
    _frames,
    _jax_weights,
    _labels,
)

torch.set_num_threads(1)

T, B, GAIN = 6, 2, 4.0
GRAD_TOL = dict(rtol=2e-3, atol=1e-7)


def _models(time_window=16, compute_dtype="float32", state_dtype="float32"):
    jm = JNarrow(num_classes=2, in_hw=HW, time_window=time_window,
                 compute_dtype=compute_dtype, state_dtype=state_dtype)
    params, stats = _jax_weights(jm, 0, GAIN)
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu",
                 time_window=time_window,
                 compute_dtype=getattr(torch, compute_dtype),
                 state_dtype=getattr(torch, state_dtype))
    load_jax_params(pm, params, stats)
    return jm, params, stats, pm


def _port_grads(pm, schedule, X, lab, r):
    """Loss, gradients (zeros where no path reaches a parameter, as JAX
    has them), and the running statistics after one train forward."""
    pm.zero_grad()
    preds, _ = pm.forward_fn(schedule)(torch.from_numpy(X), start_step=r,
                                       train=True)
    loss = pm.loss(preds, torch.from_numpy(lab))
    loss.backward()
    loss = loss.detach()
    grads = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
             else p.grad.numpy().copy() for n, p in pm.named_parameters()}
    stats = {n: b.numpy().copy() for n, b in pm.named_buffers()
             if n.endswith((".mean", ".var"))}
    return loss.item(), grads, stats


def _both_runs(compute_dtype="float32", state_dtype="float32"):
    """Both schedules at r = 0 and 2, each from the initial weights and
    stats, in JAX (one jitted value_and_grad per schedule, r traced) and
    in the port."""
    X, lab = _frames(0, t=T), _labels(1)
    out = {}
    for schedule in (False, True):
        jm, params, stats, _ = _models(16, compute_dtype, state_dtype)
        fwd = jm.forward_seq if schedule else jm.forward

        def loss_fn(p, r):
            preds, new_stats, _ = fwd(p, stats, jnp.asarray(X),
                                      start_step=r, train=True)
            return jm.loss(preds, jnp.asarray(lab)), new_stats

        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        for r in (0, 2):
            (loss, new_stats), grads = step(params, jnp.int32(r))
            want = (float(loss), _flatten(jax.device_get(grads)),
                    _flatten(jax.device_get(new_stats)))
            _, _, _, pm = _models(16, compute_dtype, state_dtype)
            out[schedule, r] = (want, _port_grads(pm, schedule, X, lab, r))
    return out


@pytest.fixture(scope="module")
def runs():
    return _both_runs()


@pytest.fixture(scope="module")
def bf16_runs():
    """``_both_runs`` with bf16 activations, fp32 and bf16 states."""
    return {sd: _both_runs("bfloat16", sd) for sd in ("float32", "bfloat16")}


@pytest.mark.parametrize("r", [0, 2])
@pytest.mark.parametrize("schedule", [False, True])
def test_narrow_gradients_match_jax(runs, schedule, r):
    (j_loss, j_grads, j_stats), (loss, grads, stats) = runs[schedule, r]
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert set(grads) == set(j_grads)
    moved = 0
    for name, g in grads.items():
        want = j_grads[name]
        if want.ndim == 4:  # HWIO -> OIHW
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(g, want, err_msg=name, **GRAD_TOL)
        moved += bool(np.abs(want).max() > 0)
    assert moved >= (len(grads) * 3) // 4 if r == 0 else moved > 10
    assert set(stats) == set(j_stats)
    for name, s in stats.items():
        np.testing.assert_allclose(s, j_stats[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _hwio_to_oihw(g):
    return g.transpose(3, 2, 0, 1) if g.ndim == 4 else g


@pytest.mark.parametrize("r", [0, 2])
@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_narrow_bf16_gradients_match_jax(runs, bf16_runs, state_dtype,
                                         schedule, r):
    """bf16 activations (fp32 or bf16 states) on each schedule: the loss
    within rtol 1e-5 of jitted JAX's, so no spike flips (per step, the
    train Norm reads the conv's fp32 sums as XLA hands them to it,
    ``Conv.step_unrounded``), and every parameter gradient close to
    JAX's, measured against what bf16 itself does to it: rounding to
    bf16 moves each of JAX's gradients by D (its bf16 gradient against
    its fp32 one, same weights and data, fp32 states; 17-350% relative
    L2 here). The port rounds where JAX does, up to the order of sums
    and the cotangents XLA keeps in fp32, so its distance from JAX's
    bf16 gradient must be a small part of D: at most a quarter, in L2
    (measured: at most 0.092 of D; a tensor where D is 0 must match
    exactly). The conv weights' bf16 cotangents are summed across steps
    in fp32 here and in bf16 in JAX (its cast once a forward): casting
    once in the port moved the worst conv weight's distance from JAX
    from 1.71% to 1.68% of its gradient (L2, per step, fp32 states,
    r = 0), so the port casts a step."""
    (j_loss, j_grads, _), (loss, grads, _) = \
        bf16_runs[state_dtype][schedule, r]
    (_, f_grads, _), _ = runs[schedule, r]
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        want = _hwio_to_oihw(j_grads[name])
        bf16_shift = np.linalg.norm(want - _hwio_to_oihw(f_grads[name]))
        assert np.linalg.norm(g - want) <= 0.25 * bf16_shift, name


@pytest.mark.parametrize("r", [0, 2])
def test_schedules_give_the_same_gradients(runs, r):
    """``forward`` and ``forward_seq`` are one function: their gradients
    agree within the JAX tolerance (only the convs' summation order,
    B against T*B frames, differs)."""
    _, (l_step, g_step, s_step) = runs[False, r]
    _, (l_seq, g_seq, s_seq) = runs[True, r]
    np.testing.assert_allclose(l_step, l_seq, rtol=1e-6)
    for name in g_step:
        np.testing.assert_allclose(g_step[name], g_seq[name], err_msg=name,
                                   **GRAD_TOL)
    for name in s_step:
        np.testing.assert_allclose(s_step[name], s_seq[name], rtol=1e-6,
                                   atol=1e-7)


def test_adamax_trajectory_matches_jax_trainer(tmp_path):
    """Eight Adamax steps of the JAX Trainer's jitted train step and of
    the port's ``Trainer.train_step``, per-step schedule, time window 3:
    for each step a JAX key is taken whose draw is the start r wanted
    (0, 1, 2, 0, ...), and that r is given to the port."""
    adamax_trajectory(tmp_path, False)


def adamax_trajectory(tmp_path, schedule, state_dtype="float32"):
    """Eight Adamax steps of JAX's and the port's Trainer on
    ``schedule`` with ``state_dtype`` states: losses within rtol 1e-3 a
    step, weights after them within rtol 1e-3, atol 1e-5."""
    window, steps = 3, 8
    jm, params, stats, pm = _models(time_window=window,
                                    state_dtype=state_dtype)
    jt = JTrainer(out_dir=str(tmp_path / "jax"), seed=0, prefetch_batches=0,
                  time_batched=schedule)
    jt.mesh_for_batch(B)
    opt, jit_train, _ = jt._build_steps(jm, schedule)
    opt_state = opt.init(params)
    keys, starts, k = [], [], 0
    while len(keys) < steps:
        want = len(keys) % window
        key = jax.random.PRNGKey(k)
        k += 1
        if int(jax.random.randint(key, (), 0, window)) == want:
            keys.append(key)
            starts.append(want)
    trainer = Trainer(seed=0, time_batched=schedule)
    trainer.configure(pm)
    j_losses, losses = [], []
    for s in range(steps):
        X, lab = _frames(10 + s, t=T), _labels(20 + s)
        Xd, labd = shard_batch(jt.mesh, jnp.asarray(X), jnp.asarray(lab))
        params, opt_state, stats, _, loss = jit_train(
            params, opt_state, stats, None, Xd, labd, keys[s])
        j_losses.append(float(loss))
        losses.append(float(trainer.train_step(
            pm, torch.from_numpy(X), torch.from_numpy(lab), starts[s])))
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    assert len(set(np.round(j_losses, 4))) == steps  # the steps differ
    # and the weights went the same way
    flat = _flatten(jax.device_get(params))
    for name, p in pm.named_parameters():
        want = flat[name]
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-3,
                                   atol=1e-5, err_msg=name)
