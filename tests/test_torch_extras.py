"""The port's training extras, plotter, model summary and anchor k-means
against the JAX package, on the CPU.

- ``CSVLogger`` on the same payloads (one adds columns, one has a
  boolean and a string): the two files byte-equal;
- ``TensorBoardLogger``: JAX's tensorboardX event file and the port's own,
  both read with tensorboard's event-file loader (in a subprocess, with
  tensorboard's stand-in for TensorFlow), give equal (tag, step, float32
  value) lists, and so does the port's ``read_scalars``;
- ``Trainer(logger=...)`` from ``config/logger.yaml``: every payload of
  ``fit`` in ``metrics.csv`` and the event file; on two gloo ranks
  (``tests/torch_rank_worker.py``) the files are written on rank 0 only;
- ``debug_nans`` on the ``MicroSODa`` of tests/test_detector.py: a NaN
  weight raises ``FloatingPointError`` in both packages' ``fit``, and so
  does an e4m3 overflow (head weights scaled so that the LI states pass
  464); a clean fit gives bit-equal weights with and without the check;
- ``profile_dir``: a Chrome trace is written and the weights are
  bit-equal without it; a fit that ends inside the window (steps 3-5)
  writes nothing and prints nothing, as JAX's (whose trace is left
  running, stopped here);
- each optax factory and option the port writes out: eight updates
  through the port's ``Optimizer`` and through optax (alone, and under
  ``MultiSteps(chain(clip, ...))``) within rtol 1e-3 (PR 8's gate);
- ``summarize`` on ``config.yaml``, ``1mpx.yaml`` and ``vgg.yaml``: the
  same dict as JAX's;
- ``kmeans_1d``, ``calc_anchor_params`` and ``scripts/calc_anchors_torch.py``
  against JAX's;
- ``Plotter``: frames byte-equal to JAX's with ``cv2`` and with
  ``_HAS_CV2`` patched off in both; the ``.avi`` is written (and not
  without ``cv2``).
"""

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.models.detector import SODa as JSODa
from snn_for_object_detection_tpu.train import Trainer as JTrainer
from snn_for_object_detection_tpu.train import loggers as jloggers
from snn_for_object_detection_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
)
from snn_for_object_detection_tpu_torch.models import spec as PS
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.models.detector import SODa as PSODa
from snn_for_object_detection_tpu_torch.train import (
    loggers,
    loop,
    optax_rules,
)
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from snn_for_object_detection_tpu_torch.utils.config import load_yaml
from test_torch_detector import _jax_weights
from test_torch_megakernel import micro_soda
from test_torch_train import _tree
from torch_rank_worker import start_ranks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, T, B, WINDOW = (32, 40), 4, 2, 2

# ---- loggers ----

PAYLOADS = [
    (1, {"train_loss": 0.5}),
    (2, {"train_loss": 0.125, "flag": True, "name": "x"}),
    (2, {"epoch": 1, "epoch_train_loss": 0.3125, "epoch_time_s": 1.75}),
    (2, {"val_loss": 1.0 / 3.0, "map": 0.0, "map_50": np.float64(0.25)}),
    (3, {}),
    (-1, {"train_loss": 1e-30, "epoch": 2}),
]


def _log_all(logger, out_dir):
    os.makedirs(out_dir)  # the trainer makes it
    logger.set_out_dir(out_dir)
    for step, payload in PAYLOADS:
        logger.log_metrics(step, payload)
    logger.close()


def test_csv_logger_file_is_jax_s(tmp_path):
    _log_all(jloggers.CSVLogger(), str(tmp_path / "jax"))
    _log_all(loggers.CSVLogger(), str(tmp_path / "port"))
    want = (tmp_path / "jax" / "metrics.csv").read_bytes()
    assert (tmp_path / "port" / "metrics.csv").read_bytes() == want
    assert want.count(b"\n") == len(PAYLOADS) + 1
    assert sorted(os.listdir(tmp_path / "port")) == ["metrics.csv"]


TB_READ = """
import json, sys, types
# tensorboard's stand-in for TensorFlow, as where TensorFlow is absent
sys.modules["tensorboard.compat.notf"] = types.ModuleType("notf")
from tensorboard.backend.event_processing.event_file_loader import (
    LegacyEventFileLoader)
print(json.dumps([[[v.tag, e.step, v.simple_value]
                   for e in LegacyEventFileLoader(path).Load()
                   for v in e.summary.value] for path in sys.argv[1:]]))
"""


def tensorboard_scalars(*paths):
    """(tag, step, value) lists of event files, read by tensorboard."""
    out = subprocess.run([sys.executable, "-c", TB_READ, *paths],
                         capture_output=True, text=True, check=True)
    return [[tuple(t) for t in rows] for rows in json.loads(out.stdout)]


def test_tensorboard_logger_matches_tensorboardx(tmp_path):
    _log_all(jloggers.TensorBoardLogger(), str(tmp_path / "jax"))
    port = loggers.TensorBoardLogger()
    _log_all(port, str(tmp_path / "port"))
    (jax_file,) = glob.glob(str(tmp_path / "jax" / "tb" / "events.*"))
    (port_file,) = glob.glob(str(tmp_path / "port" / "tb" / "events.*"))
    assert os.path.basename(port_file).startswith("events.out.tfevents.")
    want, got = tensorboard_scalars(jax_file, port_file)
    assert got == want
    assert len(got) == 10 and ("train_loss", -1, np.float32(1e-30)) in got
    assert loggers.read_scalars(port_file) == got
    events = loggers.read_events(port_file)
    assert events[0]["file_version"] == "brain.Event:2"


def test_event_reader_refuses_a_bad_record(tmp_path):
    path = tmp_path / "events"
    record = loggers.frame_record(loggers.encode_event(1.0, 3, scalars={
        "a": 0.5}))
    path.write_bytes(record)
    assert loggers.read_scalars(str(path)) == [("a", 3, 0.5)]
    path.write_bytes(record[:-1] + bytes([record[-1] ^ 1]))
    with pytest.raises(ValueError, match="bad record data"):
        loggers.read_scalars(str(path))


# ---- the trainer's extras on the MicroSODa ----

def _pair(state_dtype="float32", gain=4.0):
    jm = micro_soda(JS, JSODa)(num_classes=2, in_hw=HW, time_window=WINDOW,
                               state_dtype=state_dtype)
    params, stats = _jax_weights(jm, 0, gain)
    pm = micro_soda(PS, PSODa)(num_classes=2, in_hw=HW, time_window=WINDOW,
                               state_dtype=state_dtype, device="cpu")
    load_jax_params(pm, params, stats)
    return jm, params, stats, pm


def _batch(seed):
    rng = np.random.default_rng(seed)
    X = (rng.random((T, B, *HW, 2)) < 0.4).astype(np.float32)
    lab = np.full((B, 4, 5), -1.0, np.float32)
    lab[:, 0] = [1, 0.2, 0.2, 0.6, 0.7]
    return X, lab


class _Data:
    batch_size = B

    def train_loader(self):
        return (_batch(s) for s in range(1000))

    def val_loader(self):
        return (_batch(1000 + s) for s in range(1000))


KW = dict(max_epochs=1, limit_train_batches=2, limit_val_batches=1,
          check_val_every_n_epoch=1, log_every_n_steps=1, seed=0,
          prefetch_batches=0)


def _fit(tmp_path, tag, model=None, **kw):
    model = model or _pair()[3]
    Trainer(**{**KW, "out_dir": str(tmp_path / tag), **kw}).fit(
        model, _Data())
    return [p.detach().clone() for p in model.parameters()]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_fit_logs_to_the_back_ends_of_logger_yaml(tmp_path):
    """``config/logger.yaml``'s back ends (JAX's class paths) get every
    payload of ``fit``: metrics.csv's rows and the event file's scalars
    are metrics.jsonl's."""
    logger = load_yaml(os.path.join(REPO, "config", "logger.yaml"))[
        "trainer"]["logger"]
    out = tmp_path / "run"
    trainer = Trainer(**KW, out_dir=str(out), logger=logger)
    assert [type(b).__name__ for b in trainer.loggers] == [
        "TensorBoardLogger", "CSVLogger"]
    trainer.fit(_pair()[3], _Data())
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    scalars = [(k, r["step"], v) for r in records for k, v in r.items()
               if k not in ("step", "time")]
    (tb,) = glob.glob(str(out / "tb" / "events.*"))
    assert loggers.read_scalars(tb) == [
        (k, s, float(np.float32(v))) for k, s, v in scalars]
    with open(out / "metrics.csv") as f:
        header, *rows = [line.rstrip("\n").split(",") for line in f]
    assert len(rows) == len(records)
    for row, rec in zip(rows, records):
        got = {k: float(v) for k, v in zip(header, row) if v}
        assert got == {"step": rec["step"], **{
            k: float(v) for k, v in rec.items() if k not in ("step", "time")}}
    assert trainer.loggers[0]._file is None  # closed when fit ended


def test_back_ends_write_on_rank_0_only(tmp_path):
    data_dir = make_synthetic_dataset(str(tmp_path / "data"),
                                      records_per_split=1, duration_ms=600,
                                      splits=("train", "val"))
    logger = load_yaml(os.path.join(REPO, "config", "logger.yaml"))[
        "trainer"]["logger"]
    ranks = start_ranks([("fit_logged", {
        "data_dir": data_dir, "out_dir": str(tmp_path / "runs"),
        "logger": logger})], 2, tmp_path)
    (r0,), (r1,) = ranks.results()
    assert {"metrics.jsonl", "metrics.csv"} <= set(r0["files"])
    assert any(f.startswith("tb/events.out.tfevents.") for f in r0["files"])
    assert not any(f.startswith(("metrics", "tb")) for f in r1["files"])


@pytest.fixture
def jax_debug_nans():
    """JAX's trainer turns ``jax_debug_nans`` on for the process and
    never off: put it back for the other tests of this worker."""
    yield
    jax.config.update("jax_debug_nans", False)


def _jax_fit(tmp_path, jm, params, stats, **kw):
    jm.init = lambda key: (params, stats)
    return JTrainer(**{**KW, "out_dir": str(tmp_path / "jax"), **kw}).fit(
        jm, _Data())


def _nan_weight(params):
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [np.array(x) for x in leaves]
    leaves[0].reshape(-1)[0] = np.nan
    return jax.tree_util.tree_unflatten(tree, leaves)


def test_debug_nans_raises_on_a_nan_weight(tmp_path, jax_debug_nans):
    jm, params, stats, _ = _pair()
    params = _nan_weight(params)
    with pytest.raises(FloatingPointError):
        _jax_fit(tmp_path, jm, params, stats, debug_nans=True)
    pm = _pair()[3]
    load_jax_params(pm, params, stats)
    with pytest.raises(FloatingPointError, match="train step.*params"):
        _fit(tmp_path, "port", pm, debug_nans=True)


def test_debug_nans_raises_on_an_e4m3_overflow(tmp_path, jax_debug_nans):
    """e4m3 states store an overflow as NaN (JAX's ``astype``): head
    weights scaled by 1000 push the LI states past 464, the NaN reaches
    the loss, and both trainers raise; the port's check is what raises
    (without it the fit runs on, on NaN)."""
    jm, params, stats, _ = _pair("float8_e4m3fn")
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 1000 if "head" in jax.tree_util.keystr(path)
        else x, params)
    with pytest.raises(FloatingPointError):
        _jax_fit(tmp_path, jm, params, stats, debug_nans=True)
    pm = _pair("float8_e4m3fn")[3]
    load_jax_params(pm, params, stats)
    with pytest.raises(FloatingPointError, match="train step.*loss"):
        _fit(tmp_path, "port", pm, debug_nans=True)
    pm = _pair("float8_e4m3fn")[3]
    load_jax_params(pm, params, stats)
    assert any(torch.isnan(p).any() for p in _fit(tmp_path, "unchecked", pm))


def test_debug_nans_checks_eval_outputs():
    pm = _pair()[3]
    trainer = Trainer()
    trainer._check_nans = True
    X, lab = map(torch.from_numpy, _batch(0))
    trainer.eval_step(pm, X, lab, 0)  # clean
    with torch.no_grad():  # a head's weight: the NaN reaches the loss
        list(pm.parameters())[-1].view(-1)[0] = float("nan")
    with pytest.raises(FloatingPointError, match="eval step.*'loss'"):
        trainer.eval_step(pm, X, lab, 0)
    assert loop.nan_outputs({"a": [torch.tensor([1.0, float("inf")])],
                             "b": [torch.tensor([float("nan")])],
                             "c": [torch.arange(3)]}, "cpu") == ["b"]


@pytest.mark.parametrize("kw", [{"debug_nans": True},
                                {"profile_dir": "trace"}],
                         ids=["debug_nans", "profile_dir"])
def test_extras_leave_the_weights_bit_equal(tmp_path, kw, capsys):
    kw = {k: str(tmp_path / v) if k == "profile_dir" else v
          for k, v in kw.items()}
    plain = _fit(tmp_path, "plain", limit_train_batches=6)
    assert _equal(_fit(tmp_path, "extra", limit_train_batches=6, **kw), plain)
    if "profile_dir" in kw:
        (trace,) = glob.glob(os.path.join(kw["profile_dir"], "*.json"))
        with open(trace) as f:
            assert json.load(f)["traceEvents"]
        assert capsys.readouterr().out.count("profile written to") == 1


def test_fit_ending_inside_the_profile_window(tmp_path, capsys):
    """Four train steps: the trace starts at step 3 and would stop after
    step 5. JAX's fit leaves its trace running (stopped here, which
    would raise if none ran) and prints nothing; the port's stops its
    profiler, writes nothing and prints nothing."""
    jm, params, stats, _ = _pair()
    try:
        _jax_fit(tmp_path, jm, params, stats, limit_train_batches=4,
                 check_val_every_n_epoch=10,
                 profile_dir=str(tmp_path / "jax_trace"))
    finally:
        jax.profiler.stop_trace()
    _fit(tmp_path, "port", limit_train_batches=4, check_val_every_n_epoch=10,
         profile_dir=str(tmp_path / "trace"))
    assert "profile written" not in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "trace")
    assert not torch.autograd._profiler_enabled()


# ---- optax factories ----

FACTORIES = [
    ("lion", optax.lion(1e-2)),
    ({"name": "lion", "b1": 0.8, "b2": 0.95, "weight_decay": 0.0},
     optax.lion(1e-2, b1=0.8, b2=0.95, weight_decay=0.0)),
    ("nadam", optax.nadam(1e-2)),
    ("radam", optax.radam(1e-2)),
    ({"name": "radam", "threshold": 4.5, "nesterov": True,
      "eps_root": 1e-8}, optax.radam(1e-2, threshold=4.5, nesterov=True,
                                     eps_root=1e-8)),
    ("rmsprop", optax.rmsprop(1e-2)),
    ({"name": "rmsprop", "centered": True, "momentum": 0.9,
      "nesterov": True, "bias_correction": True, "initial_scale": 0.5},
     optax.rmsprop(1e-2, centered=True, momentum=0.9, nesterov=True,
                   bias_correction=True, initial_scale=0.5)),
    ({"name": "rmsprop", "eps_in_sqrt": False, "momentum": 0.5},
     optax.rmsprop(1e-2, eps_in_sqrt=False, momentum=0.5)),
    ("adagrad", optax.adagrad(1e-2)),
    ({"name": "adagrad", "initial_accumulator_value": 0.0, "eps": 1e-3},
     optax.adagrad(1e-2, initial_accumulator_value=0.0, eps=1e-3)),
    ("adabelief", optax.adabelief(1e-2)),
    ({"name": "adabelief", "nesterov": True}, optax.adabelief(
        1e-2, nesterov=True)),
    ({"name": "adam", "eps_root": 1e-6}, optax.adam(1e-2, eps_root=1e-6)),
    ({"name": "adam", "nesterov": True, "b1": 0.8},
     optax.adam(1e-2, b1=0.8, nesterov=True)),
    ({"name": "adamw", "nesterov": True, "eps_root": 1e-6,
      "weight_decay": 0.1},
     optax.adamw(1e-2, nesterov=True, eps_root=1e-6, weight_decay=0.1)),
    # the rest of optax 0.2.6's alias module, each written out
    ("adadelta", optax.adadelta(1e-2)),
    ({"name": "adadelta", "weight_decay": 0.1, "rho": 0.8},
     optax.adadelta(1e-2, weight_decay=0.1, rho=0.8)),
    ("adafactor", optax.adafactor(1e-2)),
    ({"name": "adafactor", "momentum": 0.9, "weight_decay_rate": 0.1,
      "clipping_threshold": None, "multiply_by_parameter_scale": False},
     optax.adafactor(1e-2, momentum=0.9, weight_decay_rate=0.1,
                     clipping_threshold=None,
                     multiply_by_parameter_scale=False)),
    ("adamaxw", optax.adamaxw(1e-2)),
    ("adan", optax.adan(1e-2)),
    ({"name": "adan", "weight_decay": 0.1, "b3": 0.9},
     optax.adan(1e-2, weight_decay=0.1, b3=0.9)),
    ("amsgrad", optax.amsgrad(1e-2)),
    ("fromage", optax.fromage(1e-2)),
    ("lamb", optax.lamb(1e-2)),
    ({"name": "lamb", "weight_decay": 0.1}, optax.lamb(1e-2,
                                                        weight_decay=0.1)),
    ("lars", optax.lars(1e-2)),
    ({"name": "lars", "weight_decay": 0.1, "nesterov": True,
      "trust_coefficient": 0.01},
     optax.lars(1e-2, weight_decay=0.1, nesterov=True,
                trust_coefficient=0.01)),
    ("nadamw", optax.nadamw(1e-2)),
    ({"name": "noisy_sgd", "eta": 0.0, "key": 0},
     optax.noisy_sgd(1e-2, eta=0.0, key=0)),
    ("novograd", optax.novograd(1e-2)),
    ({"name": "novograd", "weight_decay": 0.1},
     optax.novograd(1e-2, weight_decay=0.1)),
    ("optimistic_adam", optax.optimistic_adam(1e-2)),
    ({"name": "optimistic_adam", "optimism": 0.5},
     optax.optimistic_adam(1e-2, optimism=0.5)),
    ("optimistic_adam_v2", optax.optimistic_adam_v2(1e-2)),
    ({"name": "optimistic_adam_v2", "alpha": 0.5, "beta": 2.0},
     optax.optimistic_adam_v2(1e-2, alpha=0.5, beta=2.0)),
    ("optimistic_gradient_descent", optax.optimistic_gradient_descent(1e-2)),
    ("rprop", optax.rprop(1e-2)),
    ({"name": "rprop", "eta_minus": 0.4, "max_step_size": 0.02},
     optax.rprop(1e-2, eta_minus=0.4, max_step_size=0.02)),
    ("sign_sgd", optax.sign_sgd(1e-2)),
    ("sm3", optax.sm3(1e-2)),
    ({"name": "sm3", "momentum": 0.5}, optax.sm3(1e-2, momentum=0.5)),
    ("yogi", optax.yogi(1e-2)),
    ({"name": "yogi", "eps": 1e-4}, optax.yogi(1e-2, eps=1e-4)),
    ("sgd", optax.sgd(1e-2)),
    # the dtype options: the moment stored in bf16 between steps
    ({"name": "adam", "mu_dtype": "bfloat16"},
     optax.adam(1e-2, mu_dtype=jnp.bfloat16)),
    ({"name": "nadamw", "mu_dtype": torch.bfloat16},
     optax.nadamw(1e-2, mu_dtype=jnp.bfloat16)),
    ({"name": "amsgrad", "mu_dtype": "bfloat16"},
     optax.amsgrad(1e-2, mu_dtype=jnp.bfloat16)),
    ({"name": "lion", "mu_dtype": "bfloat16"},
     optax.lion(1e-2, mu_dtype=jnp.bfloat16)),
    ({"name": "sgd", "momentum": 0.9, "accumulator_dtype": "bfloat16"},
     optax.sgd(1e-2, momentum=0.9, accumulator_dtype=jnp.bfloat16)),
    ({"name": "adafactor", "momentum": 0.9, "dtype_momentum": "bfloat16"},
     optax.adafactor(1e-2, momentum=0.9, dtype_momentum=jnp.bfloat16)),
    # the masks: a dict of bools by name (the Optimizer's default names
    # are the positions), a callable over {name: tensor}, a bool
    ({"name": "adamw", "weight_decay": 0.1,
      "mask": {"0": True, "1": False, "2": True}},
     optax.adamw(1e-2, weight_decay=0.1, mask=[True, False, True])),
    ({"name": "lion", "mask": lambda ps: {n: p.dim() > 1
                                          for n, p in ps.items()}},
     optax.lion(1e-2, mask=lambda ps: [p.ndim > 1 for p in ps])),
    ({"name": "lars", "weight_decay": 0.1,
      "weight_decay_mask": {"0": False, "1": True, "2": True},
      "trust_ratio_mask": lambda ps: {n: p.dim() == 1
                                      for n, p in ps.items()}},
     optax.lars(1e-2, weight_decay=0.1,
                weight_decay_mask=[False, True, True],
                trust_ratio_mask=lambda ps: [p.ndim == 1 for p in ps])),
    ({"name": "adadelta", "weight_decay": 0.1, "weight_decay_mask": False},
     optax.adadelta(1e-2, weight_decay=0.1, weight_decay_mask=False)),
]
FACTORY_IDS = [f if isinstance(f, str) else "-".join(
    f"{k}={'fn' if callable(v) else v}" for k, v in f.items())
    for f, _ in FACTORIES]


def _trajectories(name_or_cfg, optax_opt, clip=None, every_k=1, steps=8):
    """tests/test_torch_train.py's ``_run_chain`` with optax's update
    jitted: the parameters after each of ``steps`` micro-batches."""
    params = _tree(10)
    tx = optax_opt
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    if every_k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=every_k)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = loop.Optimizer(tp, name_or_cfg, loop.make_schedule(1e-2, None),
                         clip, every_k)
    out = []
    for s in range(steps):
        grads = _tree(100 + s)
        upd, state = update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g) for g in grads])
        out.append(([np.asarray(p) for p in jp],
                    [p.detach().numpy().copy() for p in tp]))
    return out


@pytest.mark.parametrize("name,optax_opt", FACTORIES, ids=FACTORY_IDS)
def test_optax_factories_match_optax(name, optax_opt):
    """Eight updates within rtol 1e-3, atol 1e-5 (PR 8's gate on the
    trajectory), alone and under ``MultiSteps(chain(clip, ...), 2)``."""
    for kw in ({}, {"clip": 0.5, "every_k": 2}):
        for jp, tp in _trajectories(name, optax_opt, **kw):
            for a, b in zip(tp, jp):
                assert np.isfinite(a).all()
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


def test_radam_scalars_round_as_optax():
    """RAdam's ``ro`` is a difference of two numbers near 2 / (1 - b2):
    the port's float32 scalars are optax's bit for bit."""
    from snn_for_object_detection_tpu_torch.train import optax_rules

    for b2 in (0.999, 0.99):
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        for count in range(1, 40):
            c = jnp.int32(count)
            b2t = b2 ** c
            want = ro_inf - 2 * c * b2t / (1 - b2t)
            assert optax_rules.radam_ro(b2, count) == np.float32(want)
            assert optax_rules.f32_pow(b2, count) == np.float32(b2t)


def test_optimizer_options_left_out_or_unknown():
    """Every optax 0.2.6 factory and option is taken now: the dtype and
    mask options and every other factory build and step. An
    unknown keyword raises ``TypeError`` and an unknown factory
    ``ValueError``, as optax and JAX's trainer do."""
    params = [torch.nn.Parameter(torch.zeros(2))]
    for opt in ("fromage", {"name": "lion", "mu_dtype": "bfloat16"},
                {"name": "adamw", "mask": None},
                {"name": "sgd", "accumulator_dtype": "float32"}):
        loop.Optimizer(params, opt, lambda c: 1e-3).step([torch.ones(2)])
    for opt in ({"name": "adamax", "momentum": 0.9},
                {"name": "rmsprop", "b1": 0.9}):
        with pytest.raises(TypeError, match="unexpected keyword"):
            loop.Optimizer(params, opt, lambda c: 1e-3)
    with pytest.raises(ValueError, match="unknown optimizer"):
        loop.Optimizer(params, "adamz", lambda c: 1e-3)
    with pytest.raises(TypeError):
        optax.rmsprop(1e-3, b1=0.9)
    cfg = {"name": "cosine", "decay_steps": 4, "warmup_steps": 2}
    with pytest.raises(TypeError):
        optax.cosine_decay_schedule(1e-3, 4, warmup_steps=2)
    with pytest.raises(TypeError, match="cosine schedule"):
        loop.make_schedule(1e-3, cfg)


def test_optimizer_state_round_trips():
    """A written-out factory's state (a checkpoint's ``opt_state``) gives
    a fresh optimizer the same next update."""
    p0 = [torch.randn(3, generator=torch.Generator().manual_seed(0))]
    runs = []
    for restore in (False, True):
        params = [torch.nn.Parameter(p.clone()) for p in p0]
        opt = loop.Optimizer(params, "radam", lambda c: 1e-2)
        for s in range(7):
            if restore and s == 4:
                state = opt.state_dict()
                opt = loop.Optimizer(params, "radam", lambda c: 1e-2)
                opt.load_state_dict(state)
            opt.step([torch.full((3,), 0.1 * (s + 1))])
        runs.append(params[0].detach().clone())
    assert torch.equal(*runs)


NEW_FACTORIES = sorted(
    set(optax_rules.FACTORIES) - {"adam", "adamw", "nadam", "radam",
                                  "adabelief", "lion", "rmsprop", "adagrad"}
    - set(optax_rules.NEEDS_VALUE))


@pytest.mark.parametrize("name", NEW_FACTORIES)
def test_new_factories_state_round_trips(tmp_path, name):
    """A factory's state saved in a checkpoint (``save_single``, read back
    with ``weights_only``) gives a fresh optimizer the same next updates
    as the one that kept going; noisy_sgd's generator state included."""
    from snn_for_object_detection_tpu_torch.train.checkpoint import (
        load_single,
        save_single,
    )

    p0 = [torch.randn(3, 4, generator=torch.Generator().manual_seed(0)),
          torch.randn(5, generator=torch.Generator().manual_seed(1))]
    runs = []
    for restore in (False, True):
        params = [torch.nn.Parameter(p.clone()) for p in p0]

        def make():
            return loop.Optimizer(params, name, loop.make_schedule(1e-2, None))

        opt = make()
        for s in range(6):
            if restore and s == 3:
                save_single(str(tmp_path / name), {"opt": opt.state_dict()})
                opt = make()
                opt.load_state_dict(load_single(str(tmp_path / name))["opt"])
            opt.step([torch.full(p.shape, 0.1 * (s + 1) * (-1) ** s)
                      for p in params])
        runs.append([p.detach().clone() for p in params])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["lbfgs", "polyak_sgd"])
def test_factories_that_need_the_loss_value_fail_in_both(name):
    """``lbfgs`` and ``polyak_sgd`` need the loss value in their update,
    which JAX's trainer does not pass (``optimizer.update(grads,
    opt_state, params)`` under ``MultiSteps(chain(clip, ...))``): both
    packages raise ``TypeError`` at the first step."""
    jm = type("M", (), {"learning_rate": 1e-3})()
    tx = JTrainer(optimizer=name, gradient_clip_norm=1.0)._make_optimizer(jm)
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0), tx), 1)
    jp = [jnp.ones(3)]
    with pytest.raises(TypeError, match="value"):
        tx.update(jp, tx.init(jp), jp)
    params = [torch.nn.Parameter(torch.ones(3))]
    opt = loop.Optimizer(params, name, loop.make_schedule(1e-3, None), 1.0)
    with pytest.raises(TypeError, match="value"):
        opt.step([torch.ones(3)])
    assert torch.equal(params[0], torch.ones(3))


# a conv kernel wide enough to be factored (3x3x128x256 HWIO: both of its
# two largest dims reach min_dim_size_to_factor), one whose two largest
# dims tie, and a bias
CONV_SHAPES = ((3, 3, 128, 256), (3, 3, 128, 128), (256,))


@pytest.mark.parametrize("name,optax_opt", [
    ("adafactor", optax.adafactor(1e-2)),
    ({"name": "adafactor", "momentum": 0.9},
     optax.adafactor(1e-2, momentum=0.9)),
    ("sm3", optax.sm3(1e-2)),
], ids=["adafactor", "adafactor-momentum", "sm3"])
def test_factored_factories_on_conv_kernels(name, optax_opt):
    """adafactor and sm3 on conv kernels: JAX's HWIO leaves and the
    port's OIHW parameters (``models/convert.py``'s transpose), 8 steps
    within rtol 1e-3, alone and under ``MultiSteps(chain(clip, ...),
    2)``; adafactor factors over the dims JAX picks (O and I, also when
    they tie)."""
    assert optax_rules.factored_dims((256, 128, 3, 3), True, 128) == (1, 0)
    assert optax_rules.factored_dims((128, 128, 3, 3), True, 128) == (1, 0)
    assert optax_rules.factored_dims((64, 128, 3, 3), True, 128) is None

    def oihw(a):
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a

    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) * 0.1
          for s in CONV_SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in CONV_SHAPES]
             for _ in range(8)]
    for clip, every_k in ((None, 1), (0.5, 2)):
        tx = optax_opt
        if clip:
            tx = optax.chain(optax.clip_by_global_norm(clip), tx)
        if every_k > 1:
            tx = optax.MultiSteps(tx, every_k_schedule=every_k)
        jp = [jnp.asarray(p) for p in p0]
        state = tx.init(jp)
        update = jax.jit(tx.update)
        tp = [torch.nn.Parameter(torch.from_numpy(oihw(p).copy()))
              for p in p0]
        opt = loop.Optimizer(tp, name, loop.make_schedule(1e-2, None), clip,
                             every_k)
        for g in grads:
            upd, state = update([jnp.asarray(x) for x in g], state, jp)
            jp = optax.apply_updates(jp, upd)
            opt.step([torch.from_numpy(oihw(x).copy()) for x in g])
            for a, b in zip(tp, jp):
                np.testing.assert_allclose(a.detach().numpy(),
                                           oihw(np.asarray(b)), rtol=1e-3,
                                           atol=1e-5)


def test_noisy_sgd_noise_law():
    """``noisy_sgd`` with ``eta > 0``: its noise comes from a
    ``torch.Generator`` seeded by ``seed`` (JAX's from a JAX key: the same
    law, not the same draws). On zero gradients at lr 1 each step adds
    noise of variance ``eta / (1 + t) ** gamma`` (t from 0), mean 0; the
    same seed draws the same noise."""
    eta, gamma, n = 0.3, 0.55, 200_000
    runs = []
    for _ in range(2):
        p = torch.nn.Parameter(torch.zeros(n))
        opt = loop.Optimizer([p], {"name": "noisy_sgd", "eta": eta,
                                   "gamma": gamma, "seed": 7},
                             loop.make_schedule(1.0, None))
        steps = []
        for t in range(5):
            before = p.detach().clone()
            opt.step([torch.zeros(n)])
            steps.append((p.detach() - before).double())
        runs.append(steps)
    for t, d in enumerate(runs[0]):
        want = eta / (1 + t) ** gamma
        # the sample variance of n normals: relative sd sqrt(2 / n) = 0.3%
        assert abs(float(d.var()) / want - 1) < 0.015, (t, float(d.var()))
        assert abs(float(d.mean())) < 5 * (want / n) ** 0.5
        assert torch.equal(d, runs[1][t])


# ---- summary, anchors ----

@pytest.mark.parametrize("overlay", [None, "1mpx.yaml", "vgg.yaml"])
def test_summary_matches_jax(monkeypatch, overlay):
    from snn_for_object_detection_tpu.utils.config import (
        instantiate as jinstantiate,
    )
    from snn_for_object_detection_tpu.utils.config import (
        load_config as jload_config,
    )
    from snn_for_object_detection_tpu.utils.summary import (
        summarize as jsummarize,
    )
    from snn_for_object_detection_tpu_torch.utils.config import (
        instantiate,
        load_config,
    )
    from snn_for_object_detection_tpu_torch.utils.summary import (
        print_summary,
        summarize,
    )

    monkeypatch.chdir(REPO)
    paths = ["config/config.yaml"] + ([f"config/{overlay}"] if overlay
                                      else [])
    jm = jinstantiate(jload_config(paths)["model"])
    # the parameters' shapes alone: summarize counts their sizes
    jm.init = lambda key, init=jm.init: jax.eval_shape(init, key)
    want = jsummarize(jm)
    model = instantiate(load_config(paths)["model"], device="cpu")
    assert summarize(model) == want
    if overlay is None:
        assert want["params"] == 4_228_544
        print_summary(model)


def test_kmeans_and_anchor_params_match_jax():
    from snn_for_object_detection_tpu.ops import anchors as janchors
    from snn_for_object_detection_tpu_torch.ops import anchors

    rng = np.random.default_rng(0)
    values = rng.lognormal(-2.0, 0.6, 500)
    for k in (1, 3, 9):
        np.testing.assert_array_equal(anchors.kmeans_1d(values, k),
                                      janchors.kmeans_1d(values, k))
    wh = rng.uniform(0.02, 0.5, (400, 2))
    wh[:7] = 0.0  # empty boxes are left out
    for args in ((3, 3, 3, 304 / 240), (2, 2, 4, 1.0)):
        got = anchors.calc_anchor_params(wh, *args)
        want = janchors.calc_anchor_params(wh, *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="no values"):
        anchors.kmeans_1d([], 3)


def test_calc_anchors_script_matches_jax_s(tmp_path):
    data_dir = make_synthetic_dataset(str(tmp_path), records_per_split=2,
                                      duration_ms=600, splits=("train",))
    outs = []
    for script in ("calc_anchors.py", "calc_anchors_torch.py"):
        outs.append(subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", script),
             "--data_dir", data_dir, "--box_size_threshold", "0"],
            capture_output=True, text=True, check=True).stdout)
    assert outs[0] == outs[1] and "anchor_ratios" in outs[1]


# ---- Plotter ----

def test_plotter_frames_match_jax(tmp_path, monkeypatch):
    from snn_for_object_detection_tpu.utils import plotter as jplotter
    from snn_for_object_detection_tpu_torch.utils import plotter

    assert plotter._HAS_CV2 and jplotter._HAS_CV2
    rng = np.random.default_rng(0)
    frames = (rng.random((3, 60, 76, 2)) < 0.1).astype(np.float32)
    preds = np.array([[0, 0.9, 0.1, 0.1, 0.5, 0.6],
                      [1, 0.95, 0.4, 0.3, 0.9, 0.8],
                      [1, 0.5, 0.2, 0.2, 0.3, 0.3],  # under the threshold
                      [-1, 0.99, 0.0, 0.0, 1.0, 1.0]], np.float32)
    gt = np.array([[1, 0.2, 0.2, 0.6, 0.7], [-1, -1, -1, -1, -1]],
                  np.float32)

    def draw(module, path):
        p = module.Plotter(file_path=str(path), file_name="v")
        p.labels = ["car", "person"]
        video = [p.apply(frames[0]), p.apply(frames[1], preds),
                 p.apply(frames[2], preds, gt)]
        p(video, 16, "0")
        return video

    for cv2_on in (True, False):
        monkeypatch.setattr(plotter, "_HAS_CV2", cv2_on)
        monkeypatch.setattr(jplotter, "_HAS_CV2", cv2_on)
        tag = "cv2" if cv2_on else "plain"
        got = draw(plotter, tmp_path / tag / "port")
        want = draw(jplotter, tmp_path / tag / "jax")
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and np.array_equal(g, w)
        boxes = (got[2] != plotter.Plotter().apply(frames[2])).any()
        assert boxes == cv2_on
        avi = tmp_path / tag / "port" / "v0.avi"
        assert avi.exists() == cv2_on
        if cv2_on:
            assert avi.stat().st_size > 0
