"""The space-to-depth stem plan (``Conv(s2d=True)``, ``SODa(s2d_stem=True)``)
in the port against the JAX package, on the CPU: the counterparts of
``tests/test_s2d.py`` (all but its spatial-mesh test).

- the pack functions are JAX's ``_s2d_pack_x`` / ``_s2d_pack_w`` bit for
  bit (the port's weight is OIHW, JAX's HWIO);
- the s2d conv and its weight gradient against JAX's s2d conv, rtol 1e-5
  / 1e-4 as ``tests/test_s2d.py`` holds the two plans (another order of
  the same sums);
- the errors of a conv that is not 3x3 stride 2, of odd input dims, and
  of an ``s2d_stem`` net whose stem is no such conv;
- int8: the s2d plan's int32 sums equal the plain plan's exactly (the
  same products of integers);
- a narrow TinyYolo with ``s2d_stem=True``: per-step, time-batched and
  hybrid predictions and states within the detector's tolerances of
  JAX's, train gradients within the port's gradient bar (rtol 2e-3);
  the fused schedule runs the same 13 ``spiking_conv_seq`` calls on the
  unpacked stem (JAX's fused plan reads the stem's ``w`` and stride 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.models import compile as JC
from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu_torch.models import compile as PC
from snn_for_object_detection_tpu_torch.models import spec as PS
from snn_for_object_detection_tpu_torch.models.detector import SODa as PSODa
from snn_for_object_detection_tpu_torch.ops import cuda_kernels
from snn_for_object_detection_tpu_torch.ops import quantize as Q
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
from test_torch_train_model import GRAD_TOL, _port_grads

torch.set_num_threads(1)


def test_pack_x_is_jax():
    x = np.random.default_rng(0).standard_normal((3, 2, 8, 12, 5)).astype(
        np.float32)
    want = np.asarray(JC._s2d_pack_x(jnp.asarray(x)))
    got = PC.s2d_pack_x(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pack_w_is_jax():
    w = np.random.default_rng(1).standard_normal((3, 3, 5, 7)).astype(
        np.float32)  # HWIO
    want = np.asarray(JC._s2d_pack_w(jnp.asarray(w)))  # [2, 2, 4C, O]
    got = PC.s2d_pack_w(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)


def _conv_pair(s2d=True, in_ch=2, out=16, hw=(8, 12)):
    jb = JC.compile_block([JS.Conv(out, 3, 2, s2d=s2d)], in_ch, hw)
    params = jb.init(jax.random.PRNGKey(0))
    pb = PC.compile_block([PS.Conv(out, 3, 2, s2d=s2d)], in_ch, hw)
    with torch.no_grad():
        pb.b0.l0.w.copy_(torch.from_numpy(
            np.asarray(params["b0"]["l0"]["w"]).transpose(3, 2, 0, 1)))
    return jb, params, pb


def test_s2d_conv_and_gradients_match_jax():
    jb, params, pb = _conv_pair()
    x = np.random.default_rng(2).normal(size=(3, 8, 12, 2)).astype(
        np.float32)

    def jloss(p):
        y, _, _ = jb.apply(p, jb.init_stats(), jb.init_state(3),
                           jnp.asarray(x), JC.Ctx())
        return (y * y).sum(), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    y, _ = pb.step(torch.from_numpy(x), pb.init_state(3, "cpu"), PC.Ctx())
    assert y.shape == (3, 4, 6, 16) and pb.b0.l0.s2d
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    (y * y).sum().backward()
    np.testing.assert_allclose(
        pb.b0.l0.w.grad.numpy(),
        np.asarray(jg["b0"]["l0"]["w"]).transpose(3, 2, 0, 1),
        rtol=1e-4, atol=1e-5)


def test_s2d_requires_k3_s2_and_even_dims():
    with pytest.raises(ValueError, match="kernel_size=3"):
        PC.compile_block([PS.Conv(8, 1, 1, s2d=True)], 2, (8, 8))
    with pytest.raises(ValueError, match="even input dims"):
        PC.compile_block([PS.Conv(8, 3, 2, s2d=True)], 2, (7, 8))


def test_s2d_stem_requires_conv_stem():
    class BadStem(PSODa):
        def backbone_cfgs(self):
            return [PS.Norm(), PS.Conv(8, 3, 2)]

        def neck_cfgs(self):
            return [PS.Conv(8, 3, 2), PS.Return(),
                    PS.Conv(8, 3, 2), PS.Return()]

        def head_cfgs(self, box_out, cls_out):
            return [[PS.Conv(kernel_size=1)], [PS.Conv(box_out, 1)],
                    [PS.Conv(cls_out, 1)]]

    with pytest.raises(ValueError, match="s2d_stem"):
        BadStem(num_classes=2, in_hw=(32, 40), s2d_stem=True, device="cpu")


def test_s2d_int8_sums_equal_plain_int8():
    """The int8 conv of the packed plan sums the same integer products as
    the plain plan: equal int32 sums, so equal outputs (JAX's
    ``test_s2d_int8_ptq_matches_plain_int8``)."""
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 8, 12, 3))).to(
        torch.int8)
    wq = torch.from_numpy(rng.integers(-127, 128, (16, 3, 3, 3))).to(
        torch.int8)
    plain = Q.int8_conv(xq, wq, 2, (1, 1, 1, 1))
    packed = Q.int8_conv(PC.s2d_pack_x(xq), PC.s2d_pack_w(wq), 1,
                         (1, 0, 1, 0))
    assert plain.dtype == torch.int32 and plain.shape == (2, 4, 6, 16)
    assert torch.equal(plain, packed)
    outs = {}
    for s2d in (False, True):
        _, params, pb = _conv_pair(s2d=s2d, in_ch=2)
        x = torch.from_numpy(rng.normal(size=(2, 8, 12, 2)).astype(
            np.float32)) if not outs else outs["x"]
        outs["x"] = x
        conv = pb.b0.l0
        w = conv.w.detach()
        scale = w.abs().amax(dim=(1, 2, 3)) / 127.0
        conv.set_int8(torch.round(w / scale[:, None, None, None]).to(
            torch.int8), scale, x.abs().amax() / 127.0)
        outs[s2d] = pb.step(x, pb.init_state(2, "cpu"), PC.Ctx())[0]
    assert torch.equal(outs[False], outs[True])


def _stem_pair(**kw):
    jm = JNarrow(num_classes=2, in_hw=HW, s2d_stem=True, **kw)
    params, stats = _jax_weights(jm, 0, 8.0)
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu", s2d_stem=True, **kw)
    from snn_for_object_detection_tpu_torch.models.convert import (
        load_jax_params,
    )

    load_jax_params(pm, params, stats)
    return jm, params, stats, pm


@pytest.fixture(scope="module")
def stem_pair():
    return _stem_pair()


def test_s2d_stem_keeps_the_parameter_tree(stem_pair):
    jm, _, _, pm = stem_pair
    plain = PNarrow(num_classes=2, in_hw=HW, device="cpu")
    assert [(n, p.shape) for n, p in pm.named_parameters()] == [
        (n, p.shape) for n, p in plain.named_parameters()]
    assert pm.backbone.b0.l0.s2d and not plain.backbone.b0.l0.s2d
    assert jm.s2d_stem and pm.s2d_stem


@pytest.mark.parametrize("schedule", [False, True, "hybrid"])
def test_s2d_stem_narrow_tiny_yolo_matches_jax(stem_pair, schedule):
    jm, params, stats, pm = stem_pair
    X = _frames(1)
    fwd = jax.jit(lambda x, r, f=jm.forward_fn(schedule): f(
        params, stats, x, start_step=r))
    for r in (0, 3):
        (jc, jb), _, j_state = fwd(jnp.asarray(X), jnp.int32(r))
        (c, b), state = pm.forward_fn(schedule)(torch.from_numpy(X),
                                                start_step=r)
        assert float(c.abs().max()) > 0.1
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **PRED_TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), **PRED_TOL)
        for j, p in zip(jax.tree.leaves(j_state), _state_leaves(state)):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), **STATE_TOL)


@pytest.mark.parametrize("schedule", [False, True])
def test_s2d_stem_gradients_match_jax(schedule):
    """One train forward and backward from r = 2 (GAIN 4 as the training
    tests): loss within rtol 1e-5, every gradient within rtol 2e-3."""
    from snn_for_object_detection_tpu_torch.models.convert import (
        _flatten,
        load_jax_params,
    )

    jm = JNarrow(num_classes=2, in_hw=HW, s2d_stem=True)
    params, stats = _jax_weights(jm, 0, 4.0)
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu", s2d_stem=True)
    load_jax_params(pm, params, stats)
    X, lab = _frames(0, t=6), _labels(1)
    fwd = jm.forward_seq if schedule else jm.forward

    def loss_fn(p):
        preds, _, _ = fwd(p, stats, jnp.asarray(X), start_step=2, train=True)
        return jm.loss(preds, jnp.asarray(lab))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss, grads, _ = _port_grads(pm, schedule, X, lab, 2)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    flat = _flatten(jax.device_get(j_grads))
    for name, g in grads.items():
        want = flat[name]
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(g, want, err_msg=name, **GRAD_TOL)
    assert np.abs(grads["backbone.b0.l0.w"]).max() > 0


def test_s2d_stem_fused_plan_is_unchanged(monkeypatch):
    """Under ``fuse_seq=True`` the stem's triple runs ``spiking_conv_seq``
    on the unpacked weight and stride 2, as JAX's ``_run_fused``: the
    same calls and results as the plain-stem net's, and JAX's."""
    jm, params, stats, pm = _stem_pair(fuse_seq=True, time_window=0)
    plain = PNarrow(num_classes=2, in_hw=HW, device="cpu", fuse_seq=True,
                    time_window=0)
    plain.load_state_dict(pm.state_dict())
    calls = []
    kernel = PC.spiking_conv_seq

    def counted(x, w, a, b, v, i, cell, stride):
        calls.append((tuple(w.shape), stride))
        return kernel(x, w, a, b, v, i, cell, stride)

    monkeypatch.setattr(PC, "spiking_conv_seq", counted)
    X = torch.from_numpy(_frames(2))
    (c, b), state = pm.forward_seq(X)
    packed_calls, calls[:] = list(calls), []
    (pc, pb), p_state = plain.forward_seq(X)
    assert packed_calls == calls and len(calls) == 13
    assert packed_calls[0] == ((3, 3, 2, 8), 2)
    assert torch.equal(c, pc) and torch.equal(b, pb)
    (jc, _), _, _ = jax.jit(lambda x: jm.forward_seq(params, stats, x))(
        jnp.asarray(X.numpy()))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **PRED_TOL)
    assert cuda_kernels.spiking_conv_seq is not counted
