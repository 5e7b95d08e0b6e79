"""The port's per-step layers against the JAX package, on the CPU.

- The stateless leaves the streaming megakernel can run (ReLU, SiLU,
  Pool with ``kernel_size == stride``, nearest Up) inside a
  ``StructYolo``, the layer menu of ``tests/test_megakernel.py``: the
  port's ``SODa.step`` against JAX's jitted ``model.step`` on weights
  converted from JAX, within the detector tolerances.
- Where the eval BatchNorm affine rounds at fp32: with 1 x 1 identity
  conv weights every conv is exact, so the port's ``SODa.step`` equals
  JAX's jitted ``model.step`` bit for bit in every neuron state (XLA
  contracts the affine into one fused multiply-add under ``jit``). In
  bf16 the jitted step rounds the product to bf16 but hands the sum to
  the cell in fp32, and so does the port's step: bit-equal there too,
  and equal to JAX's scanned ``forward``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.models.detector import SODa as JSODa
from snn_for_object_detection_tpu_torch.models import spec as PS
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.models.detector import SODa as PSODa
from test_torch_detector import PRED_TOL, STATE_TOL, _jax_weights, _state_leaves

torch.set_num_threads(1)

HW = (32, 40)


def struct_yolo(S, base, extra=()):
    """The ``StructYolo`` of tests/test_megakernel.py over either
    package's spec module: Residual / Dense nesting, stride-2
    downsamples, 1x1 projections, Pool and Up. ``extra`` leaves are
    inserted after the first spiking conv."""

    class StructYolo(base):
        def backbone_cfgs(self):
            return [
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), *extra,
                S.Dense([
                    [S.Conv(4, 1), S.Norm(), S.LIF(),
                     S.Residual([[S.Conv(4, 3), S.Norm(), S.LIF()], []])],
                    [S.Conv(4, 1)],
                ]),
                S.Pool("S"),
            ]

        def neck_cfgs(self):
            return [
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Up(2), S.Pool("M"),
                S.Return(),
            ]

        def head_cfgs(self, box_out, cls_out):
            return [
                [S.Conv(kernel_size=1), S.Norm(), S.LI(), S.Tanh()],
                [S.Conv(box_out, 1)],
                [S.Conv(cls_out, 1)],
            ]

    return StructYolo


def identity_yolo(S, base):
    """Two scales of 1 x 1 convs on the 2 input channels; with identity
    weights every conv is exact. ``eps=0`` with unit variance keeps the
    folded scale exact too (XLA's rsqrt is not torch's)."""

    class IdentityYolo(base):
        def backbone_cfgs(self):
            return [S.Conv(2, 1), S.Norm(eps=0.0), S.LIF()]

        def neck_cfgs(self):
            return [
                S.Conv(2, 1), S.Norm(eps=0.0), S.LIF(), S.Return(),
                S.Conv(2, 1, 2), S.Norm(eps=0.0), S.LIF(), S.Return(),
            ]

        def head_cfgs(self, box_out, cls_out):
            return [
                [S.Conv(kernel_size=1), S.Norm(eps=0.0), S.LI(), S.Tanh()],
                [S.Conv(box_out, 1)],
                [S.Conv(cls_out, 1)],
            ]

    return IdentityYolo


def identity_weights(jm, seed=0):
    """JAX-layout weights of an ``identity_yolo`` model: identity 2 -> 2
    convs, random box / cls tails, BN gains in [0.5, 8), unit variance
    and a random mean."""
    params, stats = _jax_weights(jm, seed, 1.0)
    rng = np.random.default_rng(seed + 1)

    def fix(path, leaf):
        key = getattr(path[-1], "key", None)
        if key == "w" and leaf.shape[-2:] == (2, 2):
            return np.eye(2, dtype=np.float32)[None, None]
        if key == "scale":
            return rng.uniform(0.5, 8.0, leaf.shape).astype(np.float32)
        if key == "var":
            return np.ones(leaf.shape, np.float32)
        return leaf

    return (jax.tree_util.tree_map_with_path(fix, params),
            jax.tree_util.tree_map_with_path(fix, stats))


def pair(jcls, pcls, weights, **kw):
    jm = jcls(num_classes=2, in_hw=HW, time_window=0, **kw)
    params, stats = weights(jm)
    pm = pcls(num_classes=2, in_hw=HW, time_window=0, device="cpu", **kw)
    load_jax_params(pm, params, stats)
    return jm, params, stats, pm


def roll_jax(jm, params, stats, frames):
    """Predictions and final state of JAX's jitted ``model.step`` over
    ``frames`` ([T, H, W, 2]) at B = 1."""
    step = jax.jit(lambda st, x: jm.step(params, stats, st, x)[::2])
    state, preds = jm.init_state(1), []
    for x in frames:
        (c, b), state = step(state, jnp.asarray(x)[None])
        preds.append((np.asarray(c, np.float32), np.asarray(b, np.float32)))
    return preds, jax.tree.leaves(state)


def roll_port(pm, frames):
    state, preds = None, []
    for x in frames:
        p, state = pm.step(torch.from_numpy(np.asarray(x))[None], state)
        preds.append(p)
    return preds, _state_leaves(state)


LEAVES = {
    "relu": (JS.ReLU(), PS.ReLU()),
    "silu": (JS.SiLU(), PS.SiLU()),
    "pool_max": (JS.Pool("M"), PS.Pool("M")),
    "pool_avg": (JS.Pool("A"), PS.Pool("A")),
    "pool_sum": (JS.Pool("S"), PS.Pool("S")),
    "up_nearest": (JS.Up(2), PS.Up(2)),
}


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_step_leaf_matches_jax(leaf):
    """Each new leaf after the stride-2 stem of ``StructYolo`` (which
    already holds Pool S, nearest Up and Pool M further down); a pool
    halves the map and an up doubles it, so the spec picks the tap
    geometry up through shape inference in both packages."""
    j_leaf, p_leaf = LEAVES[leaf]
    extra_j = (j_leaf,) if not leaf.startswith("up") else (j_leaf, JS.Pool("A"))
    extra_p = (p_leaf,) if not leaf.startswith("up") else (p_leaf, PS.Pool("A"))
    jm, params, stats, pm = pair(
        struct_yolo(JS, JSODa, extra_j), struct_yolo(PS, PSODa, extra_p),
        lambda m: _jax_weights(m, 0, 4.0),
    )
    frames = (np.random.default_rng(3).random((3, *HW, 2)) < 0.3).astype(
        np.float32)
    j_preds, j_state = roll_jax(jm, params, stats, frames)
    p_preds, p_state = roll_port(pm, frames)
    assert float(p_preds[-1][0].abs().max()) > 0.05  # the net is not silent
    for got, want in zip(p_preds, j_preds):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **PRED_TOL)
    assert len(p_state) == len(j_state)
    for p, j in zip(p_state, j_state):
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(j, np.float32), **STATE_TOL)


def test_identity_weights_step_bit_equal_to_jax():
    """Norm's affine rounds once at fp32, as in JAX's jitted step: every
    neuron state bit-equal over 4 frames of normal (not binary) inputs,
    so that the rounding of the affine decides spikes."""
    jm, params, stats, pm = pair(
        identity_yolo(JS, JSODa), identity_yolo(PS, PSODa), identity_weights,
    )
    frames = np.random.default_rng(4).normal(
        size=(4, *HW, 2)).astype(np.float32) * 0.5
    j_preds, j_state = roll_jax(jm, params, stats, frames)
    p_preds, p_state = roll_port(pm, frames)
    for p, j in zip(p_state, j_state):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    v_lif = p_state[0]  # backbone LIF membrane: some neurons spiked
    assert 0 < int((v_lif == 0).sum()) < v_lif.numel()
    for got, want in zip(p_preds, j_preds):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **PRED_TOL)


@pytest.mark.parametrize("state_dtype", ["bfloat16", "float8_e5m2"])
def test_identity_weights_step_bit_equal_to_jax_bf16(state_dtype):
    """The bf16 twin: jitted JAX rounds the affine's product ``x * k``
    to bf16 and hands the sum ``+ b`` to the cell in fp32, and rounds
    the cell's output once. Every neuron state of the port's
    ``SODa.step`` is bit-equal over 4 frames of normal inputs, and
    JAX's own per-step ``forward`` (its scan) ends in the same state."""
    kw = dict(compute_dtype="bfloat16", state_dtype=state_dtype)
    jm, params, stats, pm = pair(
        identity_yolo(JS, JSODa), identity_yolo(PS, PSODa), identity_weights,
        **kw,
    )
    frames = np.random.default_rng(4).normal(
        size=(4, *HW, 2)).astype(np.float32) * 0.5
    j_preds, j_state = roll_jax(jm, params, stats, frames)
    p_preds, p_state = roll_port(pm, frames)
    _, _, scan_state = jax.jit(
        lambda x: jm.forward(params, stats, x))(jnp.asarray(frames)[:, None])
    scan_state = jax.tree.leaves(scan_state)
    assert len(p_state) == len(j_state) == len(scan_state)
    for p, j, s in zip(p_state, j_state, scan_state):
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      np.asarray(s, np.float32))
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(j, np.float32))
    v_lif = p_state[0]
    assert 0 < int((v_lif == 0).sum()) < v_lif.numel()
    for got, want in zip(p_preds, j_preds):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(), w, rtol=2e-2,
                                       atol=2e-2)
