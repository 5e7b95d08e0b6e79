"""The port's reference-checkpoint importer
(``snn_for_object_detection_tpu_torch/import_torch_ckpt.py``), on the CPU.

The port's counterparts of ``tests/test_import_torch_ckpt.py``, on
synthesized state dicts with the reference's key names (the reference's
own weights are not in the repository):

- the reference key of every port tensor of full-width GEN1 TinyYolo,
  spot-pinned against hand-derived golden keys and equal, as a set, to
  the keys the JAX script derives from the JAX model;
- a strict, leaf-exact import (OIHW convs copied as they are);
- the conv orientation against ``torch.nn.functional.conv2d``;
- the anchor check, and the missing-key, unused-key and shape errors;
- ``main`` on a Lightning-format file, read back by the port's CLI;
- the same state dict through JAX's ``import_state_dict`` and the
  port's ``load_reference_state_dict``: bit-equal weights, bit-equal
  port predictions, and JAX's predictions within rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.import_torch_ckpt import import_state_dict, jax_to_torch_key
from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.models.detector import SODa as JSODa
from snn_for_object_detection_tpu.models.tiny_yolo import TinyYolo as JTiny
from snn_for_object_detection_tpu_torch import cli
from snn_for_object_detection_tpu_torch.import_torch_ckpt import (
    load_reference_state_dict,
    main,
    reference_key,
)
from snn_for_object_detection_tpu_torch.models import spec as PS
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.models.detector import SODa as PSODa
from snn_for_object_detection_tpu_torch.models.tiny_yolo import (
    TinyYolo as PTiny,
)

torch.set_num_threads(1)

HW = (32, 40)


def _micro(S, base):
    """The MicroSODa of tests/test_detector.py over either package's
    spec module: two scales, one LIF stage each."""

    class Micro(base):
        def backbone_cfgs(self):
            return [S.Conv(8, 3, 2), S.Norm(), S.LIF()]

        def neck_cfgs(self):
            return [
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
            ]

        def head_cfgs(self, box_out, cls_out):
            return [
                [S.Conv(kernel_size=1), S.Norm(), S.LI(), S.Tanh()],
                [S.Conv(box_out, 1)],
                [S.Conv(cls_out, 1)],
            ]

    return Micro


PMicro = _micro(PS, PSODa)
JMicro = _micro(JS, JSODa)


def _port_model():
    return PMicro(num_classes=2, in_hw=HW, time_window=1, device="cpu")


def _collection(name):
    return "stats" if name.endswith((".mean", ".var")) else "params"


def _port_names(model):
    names = [n for n, _ in model.named_parameters()]
    return names + [n for n, _ in model.named_buffers()
                    if n.endswith((".mean", ".var"))]


def _synth_state_dict(model, rng):
    """A reference-named state dict covering every port tensor (OIHW
    convs), with Lightning's bookkeeping entries and the anchors."""
    sd = {}
    for name in _port_names(model):
        shape = tuple(model.get_parameter(name).shape
                      if _collection(name) == "params"
                      else model.get_buffer(name).shape)
        arr = rng.standard_normal(shape).astype(np.float32)
        if name.endswith(".var"):
            arr = np.abs(arr) + 0.5
        key = reference_key(name.split("."), _collection(name))
        sd[key] = torch.from_numpy(arr)
        if _collection(name) == "stats":
            sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
                torch.tensor(100)
    for i in range(len(model.scale_sizes)):
        sd[f"head_net.anchor_gen_{i}.sizes"] = torch.from_numpy(
            np.asarray(model.scale_sizes[i], np.float32))
        sd[f"head_net.anchor_gen_{i}.ratios"] = torch.from_numpy(
            np.asarray(model.anchor_ratios, np.float32))
    return sd


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    else:
        yield list(path), tree


def test_tiny_yolo_key_names_match_reference_scheme():
    model = PTiny(num_classes=2, in_hw=(240, 304), device="cpu")
    keys = {reference_key(n.split("."), _collection(n))
            for n in _port_names(model)}
    golden = {
        "base_net.net.net.0.0.weight",
        "base_net.net.net.0.1.weight",
        "base_net.net.net.0.1.running_mean",
        "base_net.net.net.0.1.running_var",
        "base_net.net.net.0.10.net.0.0.weight",
        "base_net.net.net.0.10.net.1.0.weight",
        "neck_net.net.net.0.0.weight",
        "head_net.model_0.base_net.net.0.0.weight",
        "head_net.model_0.base_net.net.0.1.weight",
        "head_net.model_0.box_net.net.0.0.weight",
        "head_net.model_0.cls_net.net.0.0.weight",
        "head_net.model_2.cls_net.net.0.0.weight",
    }
    assert not golden - keys, sorted(golden - keys)
    for k in keys:
        assert k.split(".")[0] in {"base_net", "neck_net", "head_net"}, k
    # the same keys as the JAX script derives from the JAX model
    jm = JTiny(num_classes=2, in_hw=(240, 304))
    params, stats = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = {jax_to_torch_key(p, "params") for p, _ in _walk(params)}
    want |= {jax_to_torch_key(p, "stats") for p, _ in _walk(stats)}
    assert keys == want


def test_round_trip_leaf_exact():
    model = _port_model()
    sd = _synth_state_dict(model, np.random.default_rng(7))
    report = load_reference_state_dict(model, sd, strict=True)
    assert not report["missing"] and not report["unused"]
    assert len(report["anchors"]) == len(model.scale_sizes) == 2
    assert all(a["match"] for a in report["anchors"])
    for name in _port_names(model):
        got = (model.get_parameter(name) if _collection(name) == "params"
               else model.get_buffer(name))
        key = reference_key(name.split("."), _collection(name))
        assert torch.equal(got, sd[key]), name
    (cls, box), _ = model.forward(torch.ones(1, 1, *HW, 2))
    assert torch.isfinite(cls).all() and torch.isfinite(box).all()


def test_conv_orientation_pinned_against_torch():
    """A distinctive OIHW kernel imported through the whole path gives
    torch's conv (the port's Conv takes NHWC activations)."""
    model = _port_model()
    rng = np.random.default_rng(3)
    sd = _synth_state_dict(model, rng)
    load_reference_state_dict(model, sd, strict=True)
    w = sd["base_net.net.net.0.0.weight"]  # [8, 2, 3, 3]
    x = torch.from_numpy(rng.standard_normal((1, 2, 9, 9)).astype(np.float32))
    want = torch.nn.functional.conv2d(x, w, stride=2, padding=1)
    conv = model.backbone.b0.l0
    with torch.no_grad():
        got, _ = conv.step(x.permute(0, 2, 3, 1), (), None)
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_anchor_mismatch_is_reported():
    model = _port_model()
    sd = _synth_state_dict(model, np.random.default_rng(5))
    sd["head_net.anchor_gen_1.sizes"] = torch.zeros(3)
    del sd["head_net.anchor_gen_0.ratios"]
    report = load_reference_state_dict(model, sd, strict=True)
    by_scale = {a["scale"]: a for a in report["anchors"]}
    assert "no head_net.anchor_gen_0.ratios" in by_scale[0]["error"]
    assert not by_scale[0]["match"] and not by_scale[1]["match"]


def test_missing_unused_and_misshapen_keys_raise():
    model = _port_model()
    rng = np.random.default_rng(11)
    sd = _synth_state_dict(model, rng)
    sd.pop("base_net.net.net.0.0.weight")
    with pytest.raises(ValueError, match="without tensors"):
        load_reference_state_dict(model, sd, strict=True)
    report = load_reference_state_dict(model, sd, strict=False)
    assert report["missing"][0][0] == "backbone.b0.l0.w"

    sd = _synth_state_dict(model, rng)
    sd["base_net.net.net.0.99.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconsumed"):
        load_reference_state_dict(model, sd, strict=True)

    sd = _synth_state_dict(model, rng)
    sd["base_net.net.net.0.0.weight"] = torch.zeros(4, 2, 3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_reference_state_dict(model, sd, strict=True)


def test_main_writes_a_checkpoint_the_cli_reads(tmp_path):
    """``main`` on a Lightning-format file (a ``torch.save`` archive
    with Lightning's bookkeeping), read back by the CLI's
    ``load_model_state`` into a fresh model: every tensor equal."""
    model = _port_model()
    sd = _synth_state_dict(model, np.random.default_rng(21))
    src = tmp_path / "tiny_yolo_gen1_like.ckpt"
    torch.save({"epoch": 2499, "global_step": 250000, "state_dict": sd,
                "optimizer_states": [{"state": {}, "param_groups": []}],
                "hyper_parameters": {"num_classes": 2}}, str(src))
    cfg = tmp_path / "micro.yaml"
    cfg.write_text(
        "model:\n"
        "  class_path: test_torch_import_ckpt.PMicro\n"
        "  init_args:\n"
        "    num_classes: 2\n"
        "    in_hw: [32, 40]\n"
        "    time_window: 1\n"
    )
    dst = tmp_path / "imported"
    main([str(src), str(dst), "--config", str(cfg)])

    fresh = _port_model()
    cli.load_model_state(fresh, str(dst), str(tmp_path / "run"))
    for name in _port_names(fresh):
        got = (fresh.get_parameter(name) if _collection(name) == "params"
               else fresh.get_buffer(name))
        key = reference_key(name.split("."), _collection(name))
        assert torch.equal(got, sd[key]), name


def test_port_import_matches_jax_import():
    """One synthesized state dict through JAX's ``import_state_dict``
    (its weights carried into a port model by ``load_jax_params``) and
    through the port's ``load_reference_state_dict``: bit-equal tensors
    and bit-equal port predictions; JAX's own forward on its import
    within rtol 1e-5, atol 1e-6."""
    model = _port_model()
    sd = _synth_state_dict(model, np.random.default_rng(31))
    load_reference_state_dict(model, sd, strict=True)
    jm = JMicro(num_classes=2, in_hw=HW, time_window=1)
    params, stats, report = import_state_dict(jm, sd, strict=True)
    assert not report["missing"] and not report["unused"]
    via_jax = _port_model()
    load_jax_params(via_jax, params, stats)
    for (name, a), b in zip(model.state_dict().items(),
                            via_jax.state_dict().values()):
        assert torch.equal(a, b), name

    X = (np.random.default_rng(1).random((4, 1, *HW, 2)) < 0.4).astype(
        np.float32)
    preds, _ = model.forward(torch.from_numpy(X))
    preds_b, _ = via_jax.forward(torch.from_numpy(X))
    for a, b in zip(preds, preds_b):
        assert torch.equal(a, b)
    (j_cls, j_box), _, _ = jax.jit(
        lambda x: jm.forward(params, stats, x))(jnp.asarray(X))
    for got, want in zip(preds, (j_cls, j_box)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
