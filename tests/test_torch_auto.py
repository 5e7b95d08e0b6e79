"""``Trainer(time_batched="auto")``: the schedule picked by measurement.

On the CPU, with a narrow TinyYolo (the GEN1 stage plan at widths 8-16,
32x40 frames) and ``loop.time_call`` stubbed where a test needs a clock
it controls:

- the fastest schedule wins, for the train and the eval step apart, and
  each is measured once for the life of the trainer;
- a schedule that raises ``torch.OutOfMemoryError`` is disqualified and
  the next one still runs; any other error propagates; when every
  schedule fails, JAX's ``RuntimeError`` is raised;
- the measurement moves neither the weights nor the BatchNorm running
  statistics of the real model (bit-equal after it);
- ``Trainer.test`` and ``train_step`` with "auto" give what the schedule
  it picked gives.
"""

import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu_torch.train import loop
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from test_torch_train import _batch, _tiny_model

torch.set_num_threads(1)


def _inputs(seed=0):
    X, lab = _batch(seed)
    return torch.from_numpy(X), torch.from_numpy(lab)


def _stub_clock(monkeypatch, seconds):
    """``time_call`` that runs the step once and reports the next of
    ``seconds`` (one a schedule, in the order "auto" measures them)."""
    it = iter(seconds)
    measured = []

    def fake(fn, device, reps=2):
        fn()
        measured.append(device)
        return next(it)

    monkeypatch.setattr(loop, "time_call", fake)
    return measured


@pytest.mark.parametrize("seconds, winner", [
    ((3.0, 1.0, 2.0), "hybrid"),
    ((1.0, 3.0, 2.0), False),
    ((3.0, 2.0, 1.0), True),
])
def test_auto_picks_the_fastest_schedule(monkeypatch, seconds, winner):
    _stub_clock(monkeypatch, seconds)
    trainer = Trainer(time_batched="auto")
    X, lab = _inputs()
    assert trainer._schedule_for(_tiny_model(), X, lab, train=True) == winner
    timings = trainer.schedule_timings["train"]
    assert list(timings) == list(loop.SCHEDULES)
    assert [timings[s]["ms"] for s in loop.SCHEDULES] == [
        t * 1e3 for t in seconds]
    assert all(r["oom"] is None and r["peak_gb"] is None
               for r in timings.values())


def test_train_and_eval_are_measured_apart_and_once(monkeypatch):
    measured = _stub_clock(monkeypatch, (3.0, 1.0, 2.0, 1.0, 2.0, 3.0))
    trainer = Trainer(time_batched="auto")
    model = _tiny_model()
    X, lab = _inputs()
    for _ in range(2):
        assert trainer._schedule_for(model, X, lab, train=True) == "hybrid"
        assert trainer._schedule_for(model, X, lab, train=False) is False
    assert len(measured) == 6
    assert trainer._auto_schedule == {"train": "hybrid", "eval": False}
    assert set(trainer.schedule_timings) == {"train", "eval"}


@pytest.mark.parametrize("train", [True, False])
def test_out_of_memory_disqualifies_a_schedule(monkeypatch, train):
    def oom(self, *args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(type(_tiny_model()), "forward_hybrid", oom)
    trainer = Trainer(time_batched="auto")
    X, lab = _inputs()
    picked = trainer._schedule_for(_tiny_model(), X, lab, train=train)
    assert picked in (False, True)
    timings = trainer.schedule_timings["train" if train else "eval"]
    assert "OutOfMemoryError" in timings["hybrid"]["oom"]
    assert timings["hybrid"]["ms"] is None
    # the schedule after the failed one still ran
    assert timings[True]["ms"] > 0 and timings[False]["ms"] > 0


@pytest.mark.parametrize("error", [RuntimeError("kernel build failed"),
                                   ValueError("bad shape")])
def test_other_errors_propagate(monkeypatch, error):
    def fail(self, *args, **kwargs):
        raise error

    monkeypatch.setattr(type(_tiny_model()), "forward_hybrid", fail)
    trainer = Trainer(time_batched="auto")
    X, lab = _inputs()
    with pytest.raises(type(error), match=str(error)):
        trainer._schedule_for(_tiny_model(), X, lab, train=True)
    assert "train" not in trainer._auto_schedule


def test_no_schedule_left_raises(monkeypatch):
    def oom(self, *args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory (test)")

    cls = type(_tiny_model())
    for name in ("forward", "forward_seq", "forward_hybrid"):
        monkeypatch.setattr(cls, name, oom)
    trainer = Trainer(time_batched="auto")
    X, lab = _inputs()
    with pytest.raises(RuntimeError, match="time_batched='auto': no "
                       "schedule compiled at T=6 B=1 32x40"):
        trainer._schedule_for(_tiny_model(), X, lab, train=False)


def test_measurement_leaves_the_model_as_it_was():
    model = _tiny_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(time_batched="auto")
    X, lab = _inputs()
    for train in (True, False):
        trainer._schedule_for(model, X, lab, train=train)
    after = model.state_dict()
    assert before.keys() == after.keys()
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    assert all(p.grad is None for p in model.parameters())
    assert all(r["ms"] for r in trainer.schedule_timings["train"].values())


def test_auto_runs_the_schedule_it_picked(monkeypatch):
    """``test`` and ``train_step`` on "auto" give what ``Trainer`` on the
    schedule it picked gives, on the same batches and weights."""
    _stub_clock(monkeypatch, (3.0, 1.0, 2.0, 3.0, 2.0, 1.0))
    auto = Trainer(time_batched="auto", limit_test_batches=2, seed=1)
    batches = [_batch(10), _batch(11)]
    model = _tiny_model()
    got = auto.test(model, iter(batches))
    assert auto._auto_schedule == {"eval": "hybrid"}
    want = Trainer(time_batched="hybrid", limit_test_batches=2,
                   seed=1).test(_tiny_model(), iter(batches))
    assert got == want

    models = [_tiny_model(), _tiny_model()]
    trainers = [auto, Trainer(time_batched=True)]
    X, lab = _inputs(3)
    losses = []
    for trainer, m in zip(trainers, models):
        trainer.configure(m)
        losses.append(trainer.train_step(m, X, lab, 1))
    assert auto._auto_schedule["train"] is True
    assert torch.equal(losses[0], losses[1])
    for a, b in zip(*(m.parameters() for m in models)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        [float(b.sum()) for b in models[0].buffers()],
        [float(b.sum()) for b in models[1].buffers()])
