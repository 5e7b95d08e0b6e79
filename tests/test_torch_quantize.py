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

Then the trained net at full width (GEN1 240x304, 4,228,544 params,
JAX's ``nets/tiny_yolo_synth`` and the port's ``nets/tiny_yolo_synth_
torch``, bf16 states as trained, time window 0) on the same synthetic
GEN1 batch (the port's loader on ``data/synthetic.py``'s recordings,
drawn from seed 0 with numpy; one batch of B=2 at the checkpoint's 12
steps: at 10 both packages' fp32 nets find one box, their int8 nets
none, and the mAP comparison would hold only zeros), each package's own
``calibrate`` -> ``quantize`` -> ``Trainer.test``, in this order:

- every conv's absmax within rtol 1e-6 (XLA's and oneDNN's sums of the
  analog inputs differ in their last bit), the spike inputs' exactly;
- ``quantize`` from either package's absmax gives JAX's ``w_q``,
  ``w_scale`` and ``x_scale`` bit for bit;
- the port's int8 class scores, as its test ran them, against JAX's
  ``forward`` of the same int8 parameters (its quantization of the
  port's absmax: an absmax an ulp off moves an int8 rounding, which the
  trained net turns into flipped spikes) within
  ``test_quantized_forward_matches_jax``'s bound (rtol 1e-4, atol 1e-5).
  Both Trainers run the per-step schedule, their default: at bf16
  states JAX's own time-batched int8 forward leaves this bound against
  its per-step one in a few scores, where the port's two schedules give
  the same bits;
- the fp32 and the int8 mAP of the two packages within rtol 1e-5, atol
  1e-6 (their losses within the trained net's bf16 bars, rtol 2e-2,
  atol 1e-3): the port's int8 net loses no more than JAX's.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.models.tiny_yolo import TinyYolo as JTiny
from snn_for_object_detection_tpu.ops import pallas_kernels as jpk
from snn_for_object_detection_tpu.ops import quantize as JQ
from snn_for_object_detection_tpu.ops.megakernel import (
    StreamingMegakernel as JMegakernel,
)
from snn_for_object_detection_tpu.train import Trainer as JTrainer
from snn_for_object_detection_tpu.train.checkpoint import (
    load_single as jax_load_single,
)
from snn_for_object_detection_tpu_torch.data import PropheseeDataModule
from snn_for_object_detection_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
)
from snn_for_object_detection_tpu_torch.models.convert import (
    _flatten,
    load_jax_params,
    model_params,
)
from snn_for_object_detection_tpu_torch.models.tiny_yolo import (
    TinyYolo as PTiny,
)
from snn_for_object_detection_tpu_torch.train.checkpoint import load_single
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


# ---- the trained net at full width ----

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN1_HW = (240, 304)
PTQ_T, PTQ_B, PTQ_BATCHES = 12, 2, 1
MAP_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=2e-2, atol=1e-3)  # the trained net's bf16 bars


class _Batches:
    """JAX's ``Trainer.test`` takes a data module: these batches."""
    batch_size = PTQ_B

    def __init__(self, batches):
        self.batches = batches

    def test_loader(self):
        return iter(self.batches)


@pytest.fixture(scope="module")
def trained_ptq(tmp_path_factory):
    """Both packages' int8 PTQ of the trained net on the same batch."""
    tmp = tmp_path_factory.mktemp("ptq")
    root = make_synthetic_dataset(str(tmp / "data"), records_per_split=1,
                                  duration_ms=1200)
    loader = PropheseeDataModule(
        data_dir=root, dataset="gen1", batch_size=PTQ_B, num_workers=1,
        num_load_file=1, num_steps=PTQ_T, time_step=16, time_shift=6,
        one_label=True, max_labels=64).test_loader()
    batches = [(np.asarray(x), np.asarray(lab))
               for x, lab in itertools.islice(loader, PTQ_BATCHES)]
    loader.close()
    restored = jax_load_single(os.path.join(REPO, "nets", "tiny_yolo_synth",
                                            "model"))
    params, stats = restored["params"], restored["stats"]
    jm = JTiny(num_classes=2, in_hw=GEN1_HW, time_window=0,
               state_dtype="bfloat16")
    payload = load_single(os.path.join(REPO, "nets", "tiny_yolo_synth_torch",
                                       "model"))
    pm = PTiny(num_classes=2, in_hw=GEN1_HW, time_window=0,
               state_dtype="bfloat16", device="cpu")
    with torch.no_grad():
        for name, value in payload["params"].items():
            pm.get_parameter(name).copy_(value)
        for name, value in payload["stats"].items():
            pm.get_buffer(name).copy_(value)

    out = {"j_abs": JQ.calibrate(jm, params, stats,
                                 [jnp.asarray(x) for x, _ in batches]),
           "abs": Q.calibrate(pm, [x for x, _ in batches])}
    # quantize from either package's absmax, in both
    for src in ("j_abs", "abs"):
        out["j_q", src] = JQ.quantize(params, out[src])
        out["q", src] = Q.quantize(pm, out[src])
    # the port's class scores of the first batch, from its own test
    eval_preds, seen = Trainer._eval_preds, []

    def recording(*args, **kwargs):
        seen.append(eval_preds(*args, **kwargs))
        return seen[-1]

    for tag, p, m in (("fp32", params, pm),
                      ("int8", out["j_q", "j_abs"], out["q", "abs"])):
        out["jax", tag] = JTrainer(out_dir=str(tmp / "jax"), seed=0,
                                   limit_test_batches=PTQ_BATCHES).test(
            jm, _Batches(batches), p, stats)
        Q.CALLS.update(int_mm=0, plain=0)
        Trainer._eval_preds = staticmethod(recording)
        try:
            out["port", tag] = Trainer(seed=0, limit_test_batches=PTQ_BATCHES
                                       ).test(m, iter(batches))
        finally:
            Trainer._eval_preds = staticmethod(eval_preds)
        out["calls", tag] = dict(Q.CALLS)
    out["cls"] = seen[PTQ_BATCHES][0]
    # JAX's int8 net of the port's absmax: the same parameters
    (out["j_cls"], _), _, _ = jax.jit(lambda x: jm.forward(
        out["j_q", "abs"], stats, x))(jnp.asarray(batches[0][0]))
    print("\n[trained net PTQ, CPU] " + "; ".join(
        f"{pkg} {tag}: map {out[pkg, tag]['map']:.4f}, map_50 "
        f"{out[pkg, tag]['map_50']:.4f}, loss {out[pkg, tag]['test_loss']:.6f}"
        for pkg in ("jax", "port") for tag in ("fp32", "int8")))
    return out


def test_trained_net_calibrate_matches_jax(trained_ptq):
    j_abs, absmax = trained_ptq["j_abs"], trained_ptq["abs"]
    assert sorted(absmax) == sorted(j_abs) and len(absmax) == 42
    for path, a in absmax.items():
        if j_abs[path] in (0.0, 1.0):  # silent or binary spike inputs
            assert a == j_abs[path], path
        np.testing.assert_allclose(a, j_abs[path], rtol=1e-6, err_msg=path)
    assert sum(a > 1.0 for a in absmax.values()) > 0  # analog inputs too


@pytest.mark.parametrize("src", ["j_abs", "abs"])
def test_trained_net_quantize_matches_jax_bit_for_bit(trained_ptq, src):
    """From JAX's absmax, and from the port's."""
    want = _flatten(jax.device_get(trained_ptq["j_q", src]))
    got = _flatten(model_params(trained_ptq["q", src]))
    assert sorted(got) == sorted(want)
    n_q = 0
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
        n_q += name.endswith(".w_q")
    assert n_q == sum(a > 0 for a in trained_ptq[src].values()) > 30


def test_trained_net_int8_class_scores_match_jax(trained_ptq):
    """The port's int8 net as its test ran it (per step, from start 0)
    against JAX's ``forward`` of the same int8 parameters."""
    cls, j_cls = trained_ptq["cls"], np.asarray(trained_ptq["j_cls"])
    assert float(np.abs(j_cls).max()) > 1.0  # a trained net's logits
    np.testing.assert_allclose(cls.numpy(), j_cls, **PRED_TOL)


def test_trained_net_int8_map_matches_jax(trained_ptq):
    """Each package's own calibration, quantization and test: the port's
    fp32 and int8 metrics are JAX's, so its int8 mAP is no lower."""
    for tag in ("fp32", "int8"):
        want, got = trained_ptq["jax", tag], trained_ptq["port", tag]
        assert got.keys() == want.keys()
        for k in want:
            tol = LOSS_TOL if k == "test_loss" else MAP_TOL
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{tag} {k}",
                                       **tol)
    assert trained_ptq["port", "int8"]["map"] >= \
        trained_ptq["jax", "int8"]["map"] - MAP_TOL["atol"]
    for tag in ("fp32", "int8"):  # both nets detect
        assert trained_ptq["jax", tag]["map"] > 0
    assert trained_ptq["calls", "fp32"]["plain"] == 0
    assert trained_ptq["calls", "int8"]["plain"] > 0
