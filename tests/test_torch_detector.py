"""The port's detector and eval loop against the JAX package, on the CPU.

A narrow TinyYolo (the GEN1 stage plan shrunk to widths 8-16 on a
64x80 frame) and the ``SeqYolo`` shape of ``tests/test_forward_seq.py``
run in both packages on the same seeded event frames, with the same
weights: drawn with numpy in the JAX pytree layout, and carried into the
port by ``load_jax_params``. At fp32:

- every LIF spike train is identical to the JAX one, step by step;
- predictions, the loss and decoded detections agree within rtol 1e-4,
  atol 1e-5, and final neuron states within rtol 1e-4, atol 1e-4. The
  convolutions are the only inexact part: XLA and oneDNN sum a conv's
  products in different orders, so activations differ in the last bits
  (measured: ~1e-6 relative).
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.models.detector import SODa as JSODa
from snn_for_object_detection_tpu.models.tiny_yolo import TinyYolo as JTiny
from snn_for_object_detection_tpu.train import metrics as jmetrics
from snn_for_object_detection_tpu_torch.models import compile as PC
from snn_for_object_detection_tpu_torch.models import spec as PS
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.models.detector import SODa as PSODa
from snn_for_object_detection_tpu_torch.models.tiny_yolo import (
    TinyYolo as PTiny,
)
from snn_for_object_detection_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "snn_for_object_detection_tpu_torch")
HW, T, B = (64, 80), 8, 2
PRED_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)


class JNarrow(JTiny):
    backbone_plan = ((8, 1), (16, 1))
    neck_plan = ((16, 1), (16, 1), (16, 1))


class PNarrow(PTiny):
    backbone_plan = JNarrow.backbone_plan
    neck_plan = JNarrow.neck_plan


def _seq_yolo(S, base):
    """The SeqYolo of tests/test_forward_seq.py: Residual + Dense nesting
    and two scales, over either package's spec module."""

    class SeqYolo(base):
        def backbone_cfgs(self):
            return [
                S.Conv(8, 3, 2), S.Norm(), S.LIF(),
                S.Residual([[S.Conv(8, 3, 1), S.Norm(), S.LIF()],
                            [S.Pass()]]),
            ]

        def neck_cfgs(self):
            return [
                S.Conv(16, 3, 2), S.Norm(), S.LIF(),
                S.Dense([[S.Conv(8, 1)], [S.Conv(8, 1)]]),
                S.Return(),
                S.Conv(16, 3, 2), S.Norm(), S.LIF(),
                S.Return(),
            ]

        def head_cfgs(self, box_out, cls_out):
            return [
                [S.Conv(kernel_size=1), S.Norm(), S.LI(), S.Tanh()],
                [S.Conv(box_out, 1)],
                [S.Conv(cls_out, 1)],
            ]

    return SeqYolo


def _jax_weights(jm, seed, gain):
    """Weights in the JAX model's pytree layout, drawn with numpy: conv
    kernels as the Kaiming fan_out init draws them, BN gains raised so
    the narrow nets really spike, and non-trivial running stats so the
    folded affine is exercised. (The JAX init compiles one program per
    kernel shape, which costs seconds per model on the CPU.)"""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = getattr(path[-1], "key", None)
        if key == "w":  # HWIO
            kh, kw, _, out = leaf.shape
            std = (2.0 / (kh * kw * out)) ** 0.5
            value = rng.standard_normal(leaf.shape) * std
        elif key == "scale":
            value = np.full(leaf.shape, gain)
        elif key == "bias":
            value = rng.normal(0, 0.05, leaf.shape)
        elif key == "mean":
            value = rng.normal(0, 0.05, leaf.shape)
        elif key == "var":
            value = rng.uniform(0.8, 1.25, leaf.shape)
        else:
            raise KeyError(f"unexpected JAX leaf {jax.tree_util.keystr(path)}")
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(jcls, pcls, gain, **kw):
    jm = jcls(num_classes=2, in_hw=HW, **kw)
    params, stats = _jax_weights(jm, 0, gain)
    pm = pcls(num_classes=2, in_hw=HW, device="cpu")
    load_jax_params(pm, params, stats)
    return jm, params, stats, pm


def _frames(seed, t=T, b=B):
    rng = np.random.default_rng(seed)
    return (rng.random((t, b, *HW, 2)) < 0.4).astype(np.float32)


def _labels(seed, b=B, n=8):
    rng = np.random.default_rng(seed)
    lab = np.full((b, n, 5), -1.0, np.float32)
    for i in range(b):
        k = 3 + i
        xy = rng.random((k, 2)) * 0.6
        wh = rng.random((k, 2)) * 0.3 + 0.1
        lab[i, :k, 0] = rng.integers(0, 2, k)
        lab[i, :k, 1:] = np.concatenate([xy, xy + wh], 1)
    return lab


def _state_leaves(state):
    """Port state leaves in JAX's pytree order (sorted dict keys)."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _state_leaves(state[k])]
    return list(state)


def _assert_preds(got, want, tol=PRED_TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.fixture(scope="module")
def narrow():
    jm, params, stats, pm = _pair(JNarrow, PNarrow, 8.0,
                                  state_storage=True)
    return jm, params, stats, pm, _frames(1)


@pytest.fixture(scope="module")
def jax_seq(narrow):
    jm, params, stats, _, X = narrow
    fwd = jax.jit(lambda x, r: jm.forward_seq(params, stats, x,
                                              start_step=r))
    return {r: fwd(jnp.asarray(X), jnp.int32(r)) for r in (0, 3)}


@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("schedule", [False, True])
def test_narrow_tiny_yolo_matches_jax(narrow, jax_seq, schedule, start):
    _, _, _, pm, X = narrow
    (j_cls, j_box), _, j_state = jax_seq[start]
    preds, state = pm.forward_fn(schedule)(torch.from_numpy(X),
                                           start_step=start)
    assert preds[0].shape == (B, pm.num_anchors, 3)
    assert preds[1].shape == (B, pm.num_anchors, 4)
    assert float(preds[0].abs().max()) > 0.1  # the net is not silent
    _assert_preds(preds, (j_cls, j_box))
    jl, pl = jax.tree.leaves(j_state), _state_leaves(state)
    assert len(jl) == len(pl) == 2 * 13
    for j, p in zip(jl, pl):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **STATE_TOL)


def _record_cells(pm, mode):
    """Wrap every cell's ``step`` or ``seq`` to record its output."""
    records = {}
    for name, m in pm.named_modules():
        if isinstance(m, PC.Cell):
            inner = getattr(m, mode)

            def rec(x, state, ctx, inner=inner, name=name):
                z, st = inner(x, state, ctx)
                records.setdefault(name, []).append(z)
                return z, st

            setattr(m, mode, rec)
    return records


@pytest.mark.parametrize("mode", ["step", "seq"])
def test_spike_trains_identical_to_jax(narrow, mode):
    jm, params, stats, _, X = narrow
    _, _, _, j_rec = jax.jit(
        lambda x: jm.forward_with_records(params, stats, x)
    )(jnp.asarray(X))
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu")
    load_jax_params(pm, params, stats)
    records = _record_cells(pm, mode)
    fwd = pm.forward if mode == "step" else pm.forward_seq
    fwd(torch.from_numpy(X))
    assert len(records) == len(j_rec) == 13  # 10 LIF + 3 LI
    spikes = 0
    for name, zs in records.items():
        got = torch.stack(zs) if mode == "step" else zs[0]
        _, j_out = j_rec[name.replace(".", "/")]
        if name.startswith("head"):  # LI: the membrane voltage
            np.testing.assert_allclose(got.numpy(), np.asarray(j_out),
                                       **STATE_TOL)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(j_out))
            spikes += int(got.sum())
    assert spikes > 1000


def test_loss_detect_and_predict_match_jax(narrow, jax_seq):
    jm, params, stats, pm, X = narrow
    labels = _labels(2)
    (j_cls, j_box), _, _ = jax_seq[0]
    j_preds = (j_cls, j_box)
    preds, _ = pm.forward_seq(torch.from_numpy(X))
    np.testing.assert_allclose(
        float(pm.loss(preds, torch.from_numpy(labels))),
        float(jax.jit(jm.loss)(j_preds, jnp.asarray(labels))), rtol=1e-5,
    )
    got = pm.detect(preds).numpy()
    want = np.asarray(jax.jit(jm.detect)(j_preds))
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], **PRED_TOL)
    assert (got[..., 0] >= 0).sum() > 0

    # streaming predict, frame by frame from sample 0
    j_predict = jax.jit(lambda x, st: jm.predict(params, stats, x, st))
    j_state, p_state = None, None
    for t in range(3):
        j_dets, j_state = j_predict(jnp.asarray(X[t, 0]), j_state)
        p_dets, p_state = pm.predict(torch.from_numpy(X[t, 0]), p_state)
        assert p_dets.shape == (300, 6)
        np.testing.assert_array_equal(p_dets[:, 0].numpy(),
                                      np.asarray(j_dets)[:, 0])
        np.testing.assert_allclose(p_dets[:, 1:].numpy(),
                                   np.asarray(j_dets)[:, 1:], **PRED_TOL)


@pytest.fixture(scope="module")
def eval_run(narrow):
    """Two eval batches, a port model whose time window keeps r < T (as
    in every real run, T = 42 > time_window = 16: with r >= T the two
    schedules differ, in both packages), and the JAX package's metrics
    for the starts r that ``Trainer(seed=3)`` draws: the JAX model's
    forward_seq, loss and detect, and its mAP."""
    jm, params, stats, _, _ = narrow
    pm = PNarrow(num_classes=2, in_hw=HW, time_window=T - 1, device="cpu")
    load_jax_params(pm, params, stats)
    batches = [(_frames(10 + k), _labels(20 + k)) for k in range(2)]
    gen = torch.Generator().manual_seed(3)
    starts = [Trainer.draw_start(pm, gen) for _ in batches]
    assert starts != [0, 0]

    @jax.jit
    def eval_step(X, labels, r):
        preds, _, _ = jm.forward_seq(params, stats, X, start_step=r)
        return jm.loss(preds, labels), jm.detect(preds)

    m, losses = jmetrics.MeanAveragePrecision(), []
    for (X, lab), r in zip(batches, starts):
        loss, dets = eval_step(jnp.asarray(X), jnp.asarray(lab),
                               jnp.int32(r))
        losses.append(float(loss))
        m.update(*jmetrics.detections_to_map_inputs(np.asarray(dets), lab))
    return pm, batches, {"test_loss": float(np.mean(losses)), **m.compute()}


@pytest.mark.parametrize("time_batched", [True, False])
def test_trainer_test_matches_jax_eval_step(eval_run, time_batched):
    """``Trainer.test``: per batch a start r drawn from the seeded
    generator, forward, loss, detect, mAP, against the same steps in
    the JAX package."""
    pm, batches, want = eval_run
    trainer = Trainer(limit_test_batches=5, seed=3,
                      time_batched=time_batched)
    got = trainer.test(pm, iter(batches))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("start", [0, 2])
def test_seq_yolo_matches_jax(start):
    jm, params, stats, pm = _pair(_seq_yolo(JS, JSODa),
                                  _seq_yolo(PS, PSODa), 3.0)
    X = _frames(4, t=7)
    (j_cls, j_box), _, j_state = jax.jit(
        lambda x, r: jm.forward(params, stats, x, start_step=r)
    )(jnp.asarray(X), jnp.int32(start))
    for fwd in (pm.forward, pm.forward_seq):
        preds, state = fwd(torch.from_numpy(X), start_step=start)
        _assert_preds(preds, (j_cls, j_box))
        for j, p in zip(jax.tree.leaves(j_state), _state_leaves(state)):
            np.testing.assert_allclose(p.numpy(), np.asarray(j),
                                       **STATE_TOL)


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "float8_e5m2")])
def test_full_gen1_tiny_yolo_builds_on_cpu(dtypes):
    m = PTiny(num_classes=2, in_hw=(240, 304), compute_dtype=dtypes[0],
              state_dtype=dtypes[1], device="cpu")
    assert sum(p.numel() for p in m.parameters()) == 4_228_544
    assert [hw for _, hw in m.neck_out_shape] == [(30, 38), (15, 19), (8, 10)]
    assert m.num_anchors == 13545
    cells = [x for x in m.modules() if isinstance(x, PC.Cell)]
    assert len(cells) == 22 and sum(c.kind == "li" for c in cells) == 3
    state = m.init_state(1)
    leaves = _state_leaves(state)
    assert {x.dtype for x in leaves} == {getattr(torch, dtypes[1])}
    # (v, i) of the 22 cells per frame: the C2f bottleneck cells run at
    # half the stage width, e.g. stage 1 is 120*152*(64 + 2*32)
    assert sum(x.numel() for x in leaves) == 2 * 5_278_080


def test_cuda_model_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PNarrow(num_classes=2, in_hw=HW)


@pytest.mark.parametrize("leaf,flag", [
    (PS.Conv(8, 3, 2, s2d=True), "s2d"), (PS.LIF(state_storage=True),
                                          "record"),
])
def test_plan_and_recording_leaves_compile(leaf, flag):
    """``Conv(s2d=True)`` and ``state_storage=True`` cells compile with
    their option on and their JAX name (tests/test_torch_s2d.py and
    tests/test_torch_records.py hold their values against JAX's)."""
    block = PC.compile_block([PS.Conv(8, 1), leaf], 2, (8, 8), name="blk")
    layer = block.b0.l1
    assert getattr(layer, flag) is True
    assert getattr(layer, "name", "blk/b0/l1") == "blk/b0/l1"


@pytest.mark.parametrize("leaf,layer,out", [
    (PS.Pool(kernel_size=3, stride=2), "StridedPool", (8, (3, 3))),
    (PS.Up(mode="bilinear"), "Resize", (8, (16, 16))),
    (PS.PLIF(), "PLIF", (8, (8, 8))),
    (PS.ALIF(), "PlainCell", (8, (8, 8))),
    (PS.SLI(), "PlainCell", (8, (8, 8))),
    (PS.Synapse(), "PlainCell", (8, (8, 8))),
    (PS.LSTM(), "ConvLSTM", (8, (8, 8))),
    (PS.Up(mode="bicubic"), "Resize", (8, (16, 16))),
])
def test_zoo_leaves_compile(leaf, layer, out):
    """The leaves the model zoo needs compile, with JAX's shape
    inference (tests/test_torch_zoo.py holds their values against
    JAX's)."""
    block = PC.compile_block([PS.Conv(8, 1), leaf], 2, (8, 8))
    assert type(block.b0.l1).__name__ == layer
    assert (block.out_channels, block.out_hw) == out


def test_e4m3_states_are_taken():
    """e4m3 states, by name or dtype, stored as JAX stores them
    (tests/test_torch_e4m3.py)."""
    for dtype in ("float8_e4m3fn", torch.float8_e4m3fn):
        m = PNarrow(num_classes=2, in_hw=HW, device="cpu", state_dtype=dtype)
        assert m.state_dtype == torch.float8_e4m3fn
        assert {x.dtype for x in _state_leaves(m.init_state(1))} == {
            torch.float8_e4m3fn}


def test_hybrid_schedule_accepted():
    """The hybrid schedule is ported: ``forward_fn`` maps each trainer
    flag to its forward, and refuses an unknown one."""
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu")
    assert pm.forward_fn("hybrid") == pm.forward_hybrid
    assert pm.forward_fn(False) == pm.forward
    assert pm.forward_fn(True) == pm.forward_seq
    assert Trainer(time_batched="hybrid").time_batched == "hybrid"
    with pytest.raises(ValueError, match="unknown schedule"):
        pm.forward_fn("auto")


def test_load_jax_params_rejects_missing_and_unused_leaves(narrow):
    _, params, stats, _, _ = narrow
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu")
    extra = {**params, "extra": {"w": np.zeros((1, 1, 1, 1), np.float32)}}
    with pytest.raises(ValueError, match="unused leaves.*extra.w"):
        load_jax_params(pm, extra, stats)
    missing = {k: v for k, v in params.items() if k != "head2"}
    with pytest.raises(ValueError, match="missing leaves.*head2"):
        load_jax_params(pm, missing, stats)


def test_load_jax_params_takes_int8_weights(narrow):
    """The int8 PTQ leaves of ops/quantize.py make that conv int8, with
    JAX's values (tests/test_torch_quantize.py holds the int8 forward)."""
    _, params, stats, _, _ = narrow
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu")
    params = jax.tree.map(lambda a: a, params)  # a copy of the dicts
    w = params["head0"]["box"]["b0"]["l0"]["w"]
    leaf = {
        "w_q": np.round(w * 50).clip(-127, 127).astype(np.int8),
        "w_scale": np.full(w.shape[-1], 0.02, np.float32),
        "x_scale": np.float32(0.5),
    }
    params["head0"]["box"]["b0"]["l0"] = leaf
    load_jax_params(pm, params, stats)
    conv = pm.head0.box.b0.l0
    assert conv.quantized and conv.w_q.dtype == torch.int8
    np.testing.assert_array_equal(conv.w_q.numpy(),
                                  leaf["w_q"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(conv.w_scale.numpy(), leaf["w_scale"])
    assert float(conv.x_scale) == 0.5


# the one port script that reads JAX's checkpoint to write the port's
# (the place where the two packages meet)
_BRIDGE = "export_synth_net_torch.py"


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    for f in sorted(os.listdir(os.path.join(REPO, "scripts"))):
        if f.endswith("_torch.py") and f != _BRIDGE:
            yield os.path.join(REPO, "scripts", f)


def test_port_imports_no_jax(tmp_path):
    """No module of the port, not chip_smoke.py and no port script
    (``scripts/*_torch.py`` but the bridge that reads JAX's checkpoint)
    imports JAX, the JAX package, PyYAML or tensorboardX; importing the
    port leaves JAX out of sys.modules, and so do a CLI ``test`` run and
    a CLI ``fit`` with ``config/logger.yaml`` on the CPU, which leave
    PyYAML and tensorboard out too (the port reads the configs with its
    own reader and writes the event file itself), and so does serving a
    frame from an exported file, which leaves the port's models out too."""
    banned = ("jax", "jaxlib", "snn_for_object_detection_tpu", "yaml",
              "tensorboardX")
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{path}: {n}"
    code = (
        "import sys, snn_for_object_detection_tpu_torch.models, "
        "snn_for_object_detection_tpu_torch.train.loop; "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'snn_for_object_detection_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
    out = subprocess.run([sys.executable, "-c", CLI_RUN, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "test_loss=" in out.stdout, out.stdout
    assert "epoch_train_loss=" in out.stdout, out.stdout
    assert os.listdir(tmp_path / "fit" / "tb")
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout

    from snn_for_object_detection_tpu_torch import export
    from test_torch_megakernel import micro_soda

    path = str(tmp_path / "predict.pt2")
    export.export_predict(
        micro_soda(PS, PSODa)(num_classes=2, in_hw=(8, 8), device="cpu"),
        path, platforms=("cpu",))
    out = subprocess.run([sys.executable, "-c", SERVE_RUN, path], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


# one frame served from an exported file, then the banned modules and
# the port's models that were loaded
SERVE_RUN = """
import sys
import numpy as np
from snn_for_object_detection_tpu_torch.export import load_predict
dets = load_predict(sys.argv[1], device="cpu")(np.ones((1, 8, 8, 2), np.uint8))
assert dets.shape[-1] == 6
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "yaml", "snn_for_object_detection_tpu")
             or m.startswith("snn_for_object_detection_tpu_torch.models")))
"""


# a narrow TinyYolo tested from a weights-only checkpoint by the port's
# CLI on a synthetic test split and fitted with config/logger.yaml's
# back ends, then the banned modules that were loaded
CLI_RUN = """
import sys
from snn_for_object_detection_tpu_torch import cli, data, utils
from snn_for_object_detection_tpu_torch.data.synthetic import (
    make_synthetic_dataset)
from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo
from snn_for_object_detection_tpu_torch.train.checkpoint import save_single


class Narrow(TinyYolo):
    backbone_plan = ((8, 1), (16, 1))
    neck_plan = ((16, 1), (16, 1), (16, 1))


root = sys.argv[1]
make_synthetic_dataset(root, records_per_split=1, duration_ms=600)
m = Narrow(num_classes=2, device="cpu")
save_single(root + "/ckpt", {
    "params": dict(m.named_parameters()),
    "stats": {n: b for n, b in m.named_buffers()
              if n.endswith((".mean", ".var"))}})
cli.main(["test", "--config", "config/config.yaml", "--device", "cpu",
          "--model.class_path=__main__.Narrow",
          "--model.init_args.time_window=0",
          f"--data.init_args.data_dir={root}",
          "--data.init_args.batch_size=1", "--data.init_args.num_steps=3",
          "--data.init_args.num_workers=1",
          "--data.init_args.num_load_file=1",
          "--data.init_args.time_shift=2",
          "--trainer.limit_test_batches=1",
          f"--trainer.out_dir={root}/run", f"--ckpt_path={root}/ckpt"])
cli.main(["fit", "--config", "config/config.yaml", "--config",
          "config/logger.yaml", "--device", "cpu",
          "--model.class_path=__main__.Narrow",
          "--model.init_args.time_window=0",
          f"--data.init_args.data_dir={root}",
          "--data.init_args.batch_size=1", "--data.init_args.num_steps=3",
          "--data.init_args.num_workers=1",
          "--data.init_args.num_load_file=1",
          "--data.init_args.time_shift=2", "--trainer.max_epochs=1",
          "--trainer.limit_train_batches=1",
          "--trainer.limit_val_batches=1",
          "--trainer.check_val_every_n_epoch=1",
          f"--trainer.out_dir={root}/fit"])
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "yaml", "snn_for_object_detection_tpu",
              "tensorboardX", "tensorboard")))
"""
