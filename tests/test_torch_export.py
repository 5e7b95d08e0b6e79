"""The port's ``export.py`` (``torch.export`` of the streaming predict
step) against the JAX package's, on the CPU.

- the port's loaded CPU program against JAX's loaded blob of the same
  weights (``models/convert.py::load_jax_params``) over 5 frames at B=2:
  class ids equal, the other columns within rtol 1e-4, atol 1e-5 (the
  tolerance of ``test_loss_detect_and_predict_match_jax``);
- the loaded program bit-equal to the port's own ``predict``;
- the counterparts of tests/test_export.py: reset, an int8-PTQ model that
  exports and serves, loading in a process that imports no model code,
  and a symbolic batch that serves B=1 and B=3 and refuses a batch
  change mid-stream;
- without a card, asking for a CUDA program raises, to export or load;
- the registered cell operators' fake forms give the plain versions'
  shapes and dtypes for every state dtype, with a symbolic leading dim;
- ``scripts/export_predict_torch.py`` and ``scripts/export_model_torch.py``
  end to end (the counterparts of tests/test_scripts.py's).

Each file is exported once (module fixtures): a trace takes ~10 s and a
load ~4 s at 32x40 with a symbolic batch (the NMS loop traced as one
``scan``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from snn_for_object_detection_tpu import export as jexport
from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.models.detector import SODa as JSODa
from snn_for_object_detection_tpu_torch import export
from snn_for_object_detection_tpu_torch.models import spec as PS
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.models.detector import SODa as PSODa
from snn_for_object_detection_tpu_torch.ops import cuda_kernels as K
from snn_for_object_detection_tpu_torch.ops import quantize
from snn_for_object_detection_tpu_torch.train.checkpoint import (
    load_single,
    save_single,
)
from test_torch_detector import _jax_weights
from test_torch_megakernel import micro_soda

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 40)
SMALL_HW = (16, 20)  # the int8 and script cases: fewer anchors, faster
GAIN = 4.0
PRED_TOL = dict(rtol=1e-4, atol=1e-5)
JMicro, PMicro = micro_soda(JS, JSODa), micro_soda(PS, PSODa)


def frames(n, b=2, hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, b, *hw, 2)) < 0.25).astype(np.uint8)


@pytest.fixture(scope="module")
def pair():
    jm = JMicro(num_classes=2, in_hw=HW, time_window=0)
    params, stats = _jax_weights(jm, 0, GAIN)
    pm = PMicro(num_classes=2, in_hw=HW, time_window=0, device="cpu")
    load_jax_params(pm, params, stats)
    return jm, params, stats, pm


@pytest.fixture(scope="module")
def blob(pair, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "predict.pt2")
    export.export_predict(pair[3], path, platforms=("cpu",))
    return path


@pytest.fixture(scope="module")
def runner(blob):
    return export.load_predict(blob, device="cpu")


def test_loaded_program_matches_jax_s_blob(pair, runner, tmp_path):
    jm, params, stats, _ = pair
    path = str(tmp_path / "predict.stablehlo")
    jexport.export_predict(jm, params, stats, path, platforms=("cpu",))
    jrunner = jexport.load_predict(path)
    runner.reset()
    found = 0
    for x in frames(5):
        want = np.asarray(jrunner(x))
        got = runner(x).numpy()
        assert got.shape == want.shape == (2, 300, 6)
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_allclose(got[..., 1:], want[..., 1:], **PRED_TOL)
        found += int((got[..., 0] >= 0).sum())
    assert found > 0  # real detections, not background rows only


def test_loaded_program_is_predict_bit_for_bit(pair, runner):
    pm = pair[3]
    runner.reset()
    state = None
    for x in frames(5, seed=1):
        want, state = pm.predict(torch.from_numpy(x), state)
        assert torch.equal(runner(x), want)
    # the carried state too, leaf by leaf
    from torch.utils import _pytree

    for got, want in zip(runner.state, _pytree.tree_leaves(state)):
        assert torch.equal(got, want)


def test_nms_scan_form_is_the_loop():
    """The rolled ``scan`` form of the greedy NMS loop that a traced
    program holds keeps the same boxes as the eager loop, on random
    boxes, classes and thresholds, for K anchors around whole blocks of
    ``nms.SCAN_BLOCK`` (20) steps."""
    from snn_for_object_detection_tpu_torch.ops import boxes, nms

    rng = np.random.default_rng(0)
    for trial, k in enumerate((1, 2, 19, 20, 21, 39, 40, 41, 61, 97)):
        b = 3
        xy = rng.random((b, k, 2)) * 0.8
        bx = torch.from_numpy(np.concatenate(
            [xy, xy + rng.random((b, k, 2)) * 0.4], -1).astype(np.float32))
        cid = torch.from_numpy(rng.integers(-1, 3, (b, k)))
        thr = float(rng.random() * 0.6)
        iou = boxes.box_iou(bx, bx)
        valid = cid >= 0
        later = torch.ones(k, k, dtype=torch.bool).triu(1)
        suppress = later & (cid[:, :, None] == cid[:, None, :]) \
            & (iou > thr) & valid[:, :, None]
        want = nms._greedy_nms_keep(bx, cid, thr)
        got = nms._scan_keep(torch.ones_like(valid), suppress) & valid
        assert torch.equal(got, want), trial


def test_program_holds_the_nms_loop_rolled(runner):
    """The loaded program runs the NMS loop as one ``scan`` node, not 300
    unrolled steps."""
    graph = runner._program.graph
    scans = [n for n in graph.nodes if n.op == "call_function"
             and "scan" in str(n.target)]
    assert len(scans) == 1
    assert len(graph.nodes) < 1000


def test_reset_restarts_stream(runner):
    runner.reset()
    first = [runner(x) for x in frames(3, seed=2)]
    runner.reset()
    second = [runner(x) for x in frames(3, seed=2)]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_symbolic_batch_serves_any_camera_count(runner):
    """One file serves B=1 and B=3; the batched stream's row is the
    camera's own stream; a mid-stream batch change is refused."""
    runner.reset()
    seq = frames(4, b=3, seed=3)
    for x in seq:
        batched = runner(x)
    assert batched.shape == (3, 300, 6)
    with pytest.raises(ValueError, match="batch changed"):
        runner(seq[0][:1])
    runner.reset()
    for x in seq:
        single = runner(x[1:2])
    assert single.shape == (1, 300, 6)
    assert torch.equal(single[0], batched[1])


LOAD_ALONE = """
import sys
import numpy as np
from snn_for_object_detection_tpu_torch.export import load_predict
runner = load_predict(sys.argv[1], device="cpu")
x = (np.random.default_rng(0).random((2, {h}, {w}, 2)) < 0.25).astype(
    np.uint8)
dets = runner(x)
assert dets.shape[0] == 2 and bool(dets.isfinite().all())
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "yaml")
             or m.startswith(tuple("snn_for_object_detection_tpu_torch." + p
                                   for p in ("models", "train", "serve",
                                             "data", "cli")))))
"""


def test_loads_without_model_code(int8):
    """A fresh process loads a file (the int8 model's) and serves a frame
    importing only torch and the port's op library: nothing of models/,
    train/, serve, data/ or the CLI, and no JAX or PyYAML."""
    out = subprocess.run(
        [sys.executable, "-c", LOAD_ALONE.format(h=SMALL_HW[0],
                                                 w=SMALL_HW[1]), int8[1]],
        cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.fixture(scope="module")
def int8(tmp_path_factory):
    """An int8-PTQ ``MicroSODa`` at SMALL_HW (``ops/quantize.py``) and
    its file, a fixed batch of 2."""
    jm = JMicro(num_classes=2, in_hw=SMALL_HW, time_window=0)
    params, stats = _jax_weights(jm, 1, GAIN)
    pm = PMicro(num_classes=2, in_hw=SMALL_HW, time_window=0, device="cpu")
    load_jax_params(pm, params, stats)
    X = torch.from_numpy(frames(4, hw=SMALL_HW)).float()
    qm = quantize.quantize(pm, quantize.calibrate(pm, X))
    path = str(tmp_path_factory.mktemp("int8") / "q.pt2")
    export.export_predict(qm, path, batch_size=2, platforms=("cpu",))
    return qm, path


def test_int8_quantized_model_exports(int8):
    """An int8-PTQ model exports and serves through the same path,
    bit-equal to its own ``predict``."""
    qm, path = int8
    assert any(getattr(m, "w_q", None) is not None for m in qm.modules())
    runner = export.load_predict(path, device="cpu")
    state = None
    for x in frames(2, hw=SMALL_HW, seed=4):
        want, state = qm.predict(torch.from_numpy(x), state)
        got = runner(x)
        assert bool(got.isfinite().all())
        assert torch.equal(got, want)  # [2, 234, 6]: 234 anchors < 300


def test_cuda_program_without_a_card_raises(pair, blob):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.export_predict(pair[3], "unused.pt2", platforms=("cuda",))
    assert not os.path.exists("unused.pt2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_predict(blob)  # the default device is the card
    with pytest.raises(ValueError, match="holds programs for"):
        export.load_predict(blob, device="meta")
    with pytest.raises(ValueError, match="platforms"):
        export.export_predict(pair[3], "unused.pt2", platforms=("tpu",))


@pytest.mark.parametrize("state_dtype", K.STATE_DTYPES, ids=str)
@pytest.mark.parametrize("x_dtype", K.X_DTYPES, ids=str)
def test_cell_operators_fake_forms(x_dtype, state_dtype):
    """The fake forms of ``soda_torch::temporal_cell_seq`` and
    ``soda_torch::plif_cell_seq`` give the plain versions' shapes and
    dtypes, the leading (batch) dim of the state symbolic."""
    x = torch.randn(3, 2, 5, 4).to(x_dtype)
    v = torch.zeros(2, 5, 4, dtype=state_dtype)
    c = torch.full((4,), 0.5)
    ops = torch.ops.soda_torch
    cases = [
        (lambda x, v, i, c: ops.temporal_cell_seq(x, v, i, "lif", 1),
         lambda x, v, i, c: K.temporal_cell_seq_reference(x, v, i, "lif", 1)),
        (lambda x, v, i, c: ops.temporal_cell_seq(x, v, i, "li", 0),
         lambda x, v, i, c: K.temporal_cell_seq_reference(x, v, i, "li", 0)),
        (lambda x, v, i, c: ops.plif_cell_seq(x, v, i, c, c, 0),
         lambda x, v, i, c: K.plif_cell_seq_reference(x, v, i, c, c, 0)),
    ]
    for op, plain in cases:
        graph = make_fx(op, tracing_mode="symbolic")(x, v, v, c)
        places = [n.meta["val"] for n in graph.graph.nodes
                  if n.op == "placeholder"]
        assert not isinstance(places[1].shape[0], int)  # symbolic batch
        (out,) = [n for n in graph.graph.nodes if n.op == "output"]
        fakes = [a.meta["val"] for a in out.args[0]]
        wants = plain(x, v, v, c)
        # z has x's shape, (v_T, i_T) the state's: symbol for symbol, and
        # so do the plain version's outputs on the concrete inputs
        for fake, want, place, inp in zip(fakes, wants, places, (x, v, v)):
            assert fake.dtype == want.dtype
            assert str(fake.shape) == str(place.shape)
            assert want.shape == inp.shape


def test_export_scripts_end_to_end(tmp_path):
    """``export_model_torch.py`` strips a training checkpoint's optimizer
    state; ``export_predict_torch.py`` turns the artifact and a config
    into a file that ``load_predict`` serves, with the EMA weights."""
    model_cls = "torch_rank_worker.MicroSODa"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH", "")]))
    pm = PMicro(num_classes=2, in_hw=SMALL_HW, time_window=0, device="cpu")
    params = {n: p.detach().clone() for n, p in pm.named_parameters()}
    ema = {n: p * 0.5 for n, p in params.items()}
    stats = {n: b.clone() for n, b in pm.named_buffers()
             if n.endswith((".mean", ".var"))}
    src = str(tmp_path / "train")
    save_single(src, {"params": params, "stats": stats, "ema_params": ema,
                      "opt_state": {"mu": [torch.ones(3)]}, "step": 7,
                      "epoch": 2})
    dst = str(tmp_path / "model")
    out = subprocess.run(
        [sys.executable, "scripts/export_model_torch.py", src, dst],
        cwd=REPO, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    slim = load_single(dst)
    assert sorted(slim) == ["ema_params", "epoch", "params", "stats", "step"]
    assert slim["step"] == 7 and all(
        torch.equal(slim["params"][n], p) for n, p in params.items())

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"model:\n  class_path: {model_cls}\n  init_args:\n"
                   f"    num_classes: 2\n    in_hw: [32, 40]\n"
                   f"    time_window: 0\n")
    path = str(tmp_path / "predict.pt2")
    out = subprocess.run(
        [sys.executable, "scripts/export_predict_torch.py", dst, path,
         "--config", str(cfg), f"--model.init_args.in_hw=[{SMALL_HW[0]}, "
         f"{SMALL_HW[1]}]", "--platforms", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MB" in out.stdout
    runner = export.load_predict(path, device="cpu")
    with torch.no_grad():
        for n, p in pm.named_parameters():
            p.copy_(ema[n])
    state = None
    for x in frames(2, hw=SMALL_HW, seed=5):
        want, state = pm.predict(torch.from_numpy(x), state)
        assert torch.equal(runner(x), want)
