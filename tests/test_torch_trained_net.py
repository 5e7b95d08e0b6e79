"""The JAX-trained synthetic net, carried into the port, on the CPU.

``nets/tiny_yolo_synth_torch/model/state.pt`` is full-width GEN1 TinyYolo
(4,228,544 params) trained by the JAX package on synthetic recordings
(``nets/tiny_yolo_synth``) and written by
``scripts/export_synth_net_torch.py``:

- the committed file is pinned by its sha256, and every tensor in it is
  bit-equal to the Orbax checkpoint restored by JAX and carried by
  ``load_jax_params``;
- the port's per-step and time-batched eval on those weights at GEN1
  full width (T=12, B=1) against JAX's ``forward``. At fp32 states the
  predictions are within rtol 1e-5 and an atol of 1e-6 times the
  tensor's largest magnitude; at the checkpoint's bf16 states within
  rtol 2e-2, atol 1e-3 (the bf16 bars of
  ``tests/test_torch_megakernel.py``). The trained net sits near its
  thresholds, so the convs' summation order (XLA's against oneDNN's)
  flips a few spikes: at most 1% of any final state tensor's elements
  may lie outside rtol 1e-5, atol 1e-6 of its scale (measured: 0.50%
  at fp32, 0.45% at bf16 states);
- ``python -m snn_for_object_detection_tpu_torch test`` from the
  committed checkpoint and config against JAX's ``Trainer.test`` from
  the Orbax one, on a synthetic GEN1 recording at time window 0: every
  metric within rtol 1e-5, atol 1e-6 at fp32 states, and within the
  bf16 bars above at the checkpoint's own bf16 states (where the flipped
  spikes move the loss by ~5e-4 relative).
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.data import (
    PropheseeDataModule as JDataModule,
)
from snn_for_object_detection_tpu.models.tiny_yolo import TinyYolo as JTiny
from snn_for_object_detection_tpu.train import Trainer as JTrainer
from snn_for_object_detection_tpu.train.checkpoint import (
    load_single as jax_load_single,
)
from snn_for_object_detection_tpu_torch import cli
from snn_for_object_detection_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
)
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.models.tiny_yolo import (
    TinyYolo as PTiny,
)
from snn_for_object_detection_tpu_torch.train.checkpoint import load_single
from test_torch_detector import _state_leaves

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = os.path.join(REPO, "nets", "tiny_yolo_synth_torch")
JAX_NET = os.path.join(REPO, "nets", "tiny_yolo_synth", "model")
SHA256 = "65264659a56542ba692d4ae81b450e21ddbe9d8f11167cfda138ac99fc736c6c"
GEN1_HW, T = (240, 304), 12
PRED_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
            "bfloat16": dict(rtol=2e-2, atol=1e-3)}
STATE_OUTSIDE = 0.01


@pytest.fixture(scope="module")
def restored():
    return jax_load_single(JAX_NET)


@pytest.fixture(scope="module")
def payload():
    return load_single(os.path.join(NET, "model"))


def test_committed_state_is_the_jax_checkpoint(restored, payload):
    with open(os.path.join(NET, "model", "state.pt"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == SHA256
    pm = PTiny(num_classes=2, in_hw=GEN1_HW, device="cpu")
    load_jax_params(pm, restored["params"], restored["stats"])
    state = pm.state_dict()
    names = [n for n, _ in pm.named_parameters()]
    assert list(payload["params"]) == names
    assert sum(v.numel() for v in payload["params"].values()) == 4_228_544
    stats = {n for n in state if n.endswith((".mean", ".var"))}
    assert set(payload["stats"]) == stats
    for name, value in {**payload["params"], **payload["stats"]}.items():
        assert value.dtype == torch.float32
        assert torch.equal(value, state[name]), name
    assert (payload["step"], payload["epoch"]) == (restored["step"],
                                                   restored["epoch"])
    assert "opt_state" not in payload


def _port_model(payload, state_dtype):
    pm = PTiny(num_classes=2, in_hw=GEN1_HW, time_window=4,
               state_dtype=state_dtype, device="cpu")
    with torch.no_grad():
        for name, value in payload["params"].items():
            pm.get_parameter(name).copy_(value)
        for name, value in payload["stats"].items():
            pm.get_buffer(name).copy_(value)
    return pm


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return (rng.random((T, 1, *GEN1_HW, 2)) < 0.05).astype(np.float32)


@pytest.fixture(scope="module")
def jax_forward(restored, frames):
    out = {}
    for sd in ("float32", "bfloat16"):
        jm = JTiny(num_classes=2, in_hw=GEN1_HW, time_window=4,
                   state_dtype=sd)
        out[sd] = jax.jit(lambda x, jm=jm: jm.forward(
            restored["params"], restored["stats"], x))(jnp.asarray(frames))
    return out


def _outside_share(got, want):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    return float((np.abs(got - want) > 1e-6 * scale + 1e-5 * np.abs(want))
                 .mean())


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_trained_net_eval_matches_jax(payload, frames, jax_forward,
                                      state_dtype, schedule):
    pm = _port_model(payload, state_dtype)
    (cls, box), state = pm.forward_fn(schedule)(torch.from_numpy(frames))
    (j_cls, j_box), _, j_state = jax_forward[state_dtype]
    tol = dict(PRED_TOL[state_dtype])
    for got, want in ((cls, j_cls), (box, j_box)):
        want = np.asarray(want)
        if state_dtype == "float32":
            tol["atol"] = 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, **tol)
    assert float(cls.abs().max()) > 1.0  # a trained net's confident logits
    jl, pl = jax.tree.leaves(j_state), _state_leaves(state)
    assert len(jl) == len(pl) == 44
    for j, p in zip(jl, pl):
        assert p.dtype == getattr(torch, state_dtype)
        assert _outside_share(p.float().numpy(), j) <= STATE_OUTSIDE


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("synth")),
                                  records_per_split=1, duration_ms=1200)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_cli_test_from_the_committed_checkpoint_matches_jax(
        restored, synth_root, tmp_path, state_dtype):
    """``test`` with ``--config nets/tiny_yolo_synth_torch/config.yaml
    --ckpt_path nets/tiny_yolo_synth_torch/model`` against JAX's
    ``Trainer.test`` with the Orbax checkpoint, on the same loader
    settings: one recording a split, B=1, one batch, time window 0 (so
    both packages start every batch at r = 0)."""
    run = cli.main([
        "test", "--config", os.path.join(NET, "config.yaml"),
        f"--ckpt_path={os.path.join(NET, 'model')}",
        f"--data.init_args.data_dir={synth_root}",
        "--data.init_args.batch_size=1",
        "--data.init_args.num_workers=1",
        "--data.init_args.num_load_file=1",
        "--model.init_args.time_window=0",
        f"--model.init_args.state_dtype={state_dtype}",
        "--trainer.limit_test_batches=1",
        f"--trainer.out_dir={tmp_path}",
        "--device", "cpu",
    ])
    assert type(run.model) is PTiny
    assert run.model.state_dtype == getattr(torch, state_dtype)
    jm = JTiny(**{**run.cfg["model"]["init_args"], "in_hw": GEN1_HW})
    data = JDataModule(**run.cfg["data"]["init_args"])
    jt = JTrainer(out_dir=str(tmp_path / "jax"), seed=0, limit_test_batches=1)
    want = jt.test(jm, data, restored["params"], restored["stats"])
    got = run.result
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **PRED_TOL[state_dtype])
    assert got["map_50"] > 0  # the weights crossed: the net detects
