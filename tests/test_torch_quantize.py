"""int8 post-training quantization (``ops/quantize.py``) in the port
against the JAX package, on the CPU: the counterparts of
``tests/test_quantize.py``.

A narrow TinyYolo with JAX-layout weights drawn by numpy (BatchNorm gain
8, so that it spikes):

- ``calibrate`` gives JAX's dict key by key (JAX's parameter paths;
  like JAX's it skips the light head tails, which run after the step);
  the absmax of binary spike inputs is exactly 1, that of a conv fed by a
  conv within rtol 1e-6 (XLA and oneDNN sum the feeding conv in another
  order);
- ``quantize`` from the same absmax gives JAX's ``w_q``, ``w_scale`` and
  ``x_scale`` bit for bit, ``dequantize`` JAX's ``w``;
- the int8 forward on each schedule (per step, time-batched, hybrid) at
  fp32 and bf16 activations against JAX's int8 forward, at the
  detector's tolerances;
- ``load_jax_params`` of JAX's quantized params makes the same int8
  model; the megakernel's plain version built from it (dequantized at
  build, as JAX's megakernel) against JAX's megakernel;
- the fused schedule runs an int8 conv's triple layer by layer, as JAX's
  does (the same fused calls in both), and training raises ``TypeError``
  in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.ops import pallas_kernels as jpk
from snn_for_object_detection_tpu.ops import quantize as JQ
from snn_for_object_detection_tpu.ops.megakernel import (
    StreamingMegakernel as JMegakernel,
)
from snn_for_object_detection_tpu_torch.models.convert import (
    _flatten,
    load_jax_params,
    model_params,
)
from snn_for_object_detection_tpu_torch.ops import cuda_kernels
from snn_for_object_detection_tpu_torch.ops import quantize as Q
from snn_for_object_detection_tpu_torch.ops.megakernel import (
    StreamingMegakernel,
)
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from test_torch_detector import (
    HW,
    PRED_TOL,
    STATE_TOL,
    JNarrow,
    PNarrow,
    _frames,
    _jax_weights,
    _labels,
    _state_leaves,
)

torch.set_num_threads(1)


def _models(compute_dtype="float32", **kw):
    jm = JNarrow(num_classes=2, in_hw=HW, compute_dtype=compute_dtype, **kw)
    params, stats = _jax_weights(jm, 0, 8.0)
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu",
                 compute_dtype=compute_dtype, **kw)
    load_jax_params(pm, params, stats)
    return jm, params, stats, pm


@pytest.fixture(scope="module")
def calibrated():
    jm, params, stats, pm = _models()
    X = _frames(1, t=4)
    j_abs = JQ.calibrate(jm, params, stats, jnp.asarray(X))
    absmax = Q.calibrate(pm, X)
    return jm, params, stats, pm, X, j_abs, absmax


def test_calibrate_matches_jax(calibrated):
    _, _, _, pm, X, j_abs, absmax = calibrated
    assert sorted(absmax) == sorted(j_abs)
    # every conv but the light tails, which JAX reads out after the step
    # whose stats carry the absmax
    assert len(absmax) == sum(1 for n, _ in pm.named_parameters()
                              if n.endswith(".w") and ".box." not in n
                              and ".cls." not in n)
    for path, a in absmax.items():
        np.testing.assert_allclose(a, j_abs[path], rtol=1e-6, err_msg=path)
    assert absmax[("backbone", "b0", "l0")] == 1.0  # the binary frames
    assert sum(a == 0.0 for a in absmax.values()) < len(absmax) // 2


def test_calibrate_runs_a_max_over_batches(calibrated):
    _, _, _, pm, X, _, absmax = calibrated
    other = _frames(5, t=4) * 0.5
    both = Q.calibrate(pm, [other, X])
    assert both == {p: max(a, b) for (p, a), b in zip(
        Q.calibrate(pm, other).items(), absmax.values())}
    assert Q.calibrate(pm, [other, X], max_batches=1) == Q.calibrate(
        pm, other)


def test_quantize_and_dequantize_match_jax(calibrated):
    _, params, _, pm, _, j_abs, _ = calibrated
    qparams = JQ.quantize(params, j_abs)
    qm = Q.quantize(pm, j_abs)
    assert not any(m.quantized for m in pm.modules()
                   if hasattr(m, "quantized"))  # a new model
    want, got = _flatten(jax.device_get(qparams)), _flatten(model_params(qm))
    assert sorted(got) == sorted(want)
    n_q = 0
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
        n_q += name.endswith(".w_q")
    assert n_q == sum(a > 0 for a in j_abs.values()) > 0
    deq = _flatten(jax.device_get(JQ.dequantize(qparams)))
    back = _flatten(model_params(Q.dequantize(qm)))
    assert sorted(back) == sorted(deq)
    for name, w in deq.items():
        np.testing.assert_array_equal(back[name], w, err_msg=name)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", [False, True, "hybrid"])
def test_quantized_forward_matches_jax(compute_dtype, schedule):
    """JAX's int8 forward (jitted) against the port's model loaded with
    JAX's quantized params, from start 0 and 2."""
    jm, params, stats, pm = _models(compute_dtype)
    X = _frames(1, t=6)
    j_abs = JQ.calibrate(jm, params, stats, jnp.asarray(X))
    qparams = JQ.quantize(params, j_abs)
    load_jax_params(pm, jax.device_get(qparams), stats)
    assert sum(m.quantized for m in pm.modules()
               if hasattr(m, "quantized")) > 0
    fwd = jax.jit(lambda x, r, f=jm.forward_fn(schedule): f(
        qparams, stats, x, start_step=r))
    Q.CALLS.update(int_mm=0, plain=0)
    for r in (0, 2):
        (jc, jb), _, j_state = fwd(jnp.asarray(X), jnp.int32(r))
        (c, b), state = pm.forward_fn(schedule)(torch.from_numpy(X),
                                                start_step=r)
        assert float(c.abs().max()) > 0.1
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **PRED_TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), **PRED_TOL)
        for j, p in zip(jax.tree.leaves(j_state), _state_leaves(state)):
            np.testing.assert_allclose(p.float().numpy(),
                                       np.asarray(j, np.float32),
                                       **STATE_TOL)
    assert Q.CALLS["plain"] > 0 and Q.CALLS["int_mm"] == 0


def test_quantized_megakernel_matches_jax(calibrated):
    """The megakernel's plain version of the int8 net (its weights
    dequantized at build) against JAX's megakernel of the same params,
    over four frames at B=1."""
    jm, params, stats, pm, X, j_abs, _ = calibrated
    qparams = JQ.quantize(params, j_abs)
    jmk = JMegakernel(jm, qparams, stats, use_pallas=False)
    qm = Q.quantize(pm, j_abs)
    mk = StreamingMegakernel(qm)
    js, ps = None, None
    for x in X[:, 0]:
        (jc, jb), js = jmk.step(jnp.asarray(x), js)
        (c, b), ps = mk.step(torch.from_numpy(x), ps)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **PRED_TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), **PRED_TOL)
    for j, p in zip(jax.tree.leaves(js), _state_leaves(ps)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **STATE_TOL)


def test_fused_schedule_runs_int8_triples_layer_by_layer(monkeypatch):
    """JAX's fused plan skips a triple whose conv has no ``w``
    (``compile.py:865-869``); the port skips its int8 triples too: the
    same fused calls (those of the convs left in floating point), the
    same predictions."""
    jm, params, stats, pm = _models(fuse_seq=True, time_window=0)
    X = _frames(2, t=4)
    j_abs = JQ.calibrate(jm, params, stats, jnp.asarray(X))
    j_abs[("backbone", "b0", "l0")] = 0.0  # the stem stays fp and fuses
    qparams = JQ.quantize(params, j_abs)
    load_jax_params(pm, jax.device_get(qparams), stats)
    calls = {"port": 0, "jax": 0}
    port_ref = cuda_kernels.spiking_conv_seq_reference
    jax_fn = jpk.spiking_conv_seq

    def port(*args, **kw):
        calls["port"] += 1
        return port_ref(*args, **kw)

    def jax_call(*args, **kw):
        calls["jax"] += 1
        return jax_fn(*args, **kw)

    monkeypatch.setattr(cuda_kernels, "spiking_conv_seq_reference", port)
    monkeypatch.setattr(jpk, "spiking_conv_seq", jax_call)
    (jc, _), _, _ = jm.forward_seq(qparams, stats, jnp.asarray(X))
    (c, _), _ = pm.forward_seq(torch.from_numpy(X))
    n_fp = sum(1 for (p, a) in j_abs.items() if a == 0.0)
    assert calls["port"] == calls["jax"] >= 1
    assert calls["port"] < 13 and n_fp >= 1
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **PRED_TOL)


def test_training_an_int8_net_raises_as_jax(calibrated):
    jm, params, stats, pm, X, j_abs, _ = calibrated
    qparams = JQ.quantize(params, j_abs)
    lab = _labels(1)

    def loss(p):
        preds, _, _ = jm.forward(p, stats, jnp.asarray(X), train=True)
        return jm.loss(preds, jnp.asarray(lab))

    with pytest.raises(TypeError, match="int8"):
        jax.grad(loss)(qparams)
    qm = Q.quantize(pm, j_abs)
    trainer = Trainer(time_batched=False)
    trainer.configure(qm)
    for schedule in (False, True):
        with pytest.raises(TypeError, match="int8"):
            qm.forward_fn(schedule)(torch.from_numpy(X), train=True)
    with pytest.raises(TypeError, match="int8"):
        trainer.train_step(qm, torch.from_numpy(X), torch.from_numpy(lab), 0)


def test_int8_conv_sums_are_exact():
    """The plain int8 conv against an exact integer conv in numpy, on
    the largest sums an int8 conv can make (K = 9 * 256)."""
    rng = np.random.default_rng(0)
    x = rng.choice([-127, 127], (1, 5, 6, 256)).astype(np.int8)
    w = np.full((4, 256, 3, 3), 127, np.int8)
    w[1] = -127
    y = Q.int8_conv(torch.from_numpy(x), torch.from_numpy(w), 1,
                    (1, 1, 1, 1)).numpy()
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros((1, 5, 6, 4), np.int64)
    for di in range(3):
        for dj in range(3):
            want += np.einsum("nhwc,oc->nhwo", xp[:, di:di + 5, dj:dj + 6],
                              w[:, :, di, dj].astype(np.int64))
    assert y.dtype == np.int32
    np.testing.assert_array_equal(y, want)
    with pytest.raises(TypeError, match="int8"):
        Q.int8_conv(torch.from_numpy(x).float(), torch.from_numpy(w), 1,
                    (1, 1, 1, 1))
