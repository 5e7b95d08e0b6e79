"""``correct`` comes out false where it should: for the control (the
reference in TF32 put in the program's place) and for a run whose timed
path is broken underneath, each fault a cell can have. At the CPU's
size, with the cells' own limits."""

from __future__ import annotations

import pytest

from portbench import run
from portbench.lib.harness import gate
from portbench.lib.session import Run
from portbench.tests import tiny


@pytest.fixture
def catalog(tmp_path):
    return tiny.catalog(str(tmp_path))


@pytest.mark.parametrize("name", ["gen1_train", "gen1_serve_c64",
                                  "mpx_train", "mpx_eval"])
def test_control_is_not_correct(catalog, name):
    cell = catalog.cell(name)
    for seed in (1, 2 ** 33 + 3):
        ctx = Run(cell=cell, config=catalog.config(cell["config"]),
                  seed=seed, seconds=0, trace=False, device=tiny.DEVICE,
                  started=0.0)
        values = catalog.driver(cell["driver"]).control(ctx, 40)
        checks = gate(values, cell["limits"])
        assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("name", ["gen1_train", "gen1_serve_c64",
                                  "mpx_train", "mpx_eval"])
def test_a_sound_run_is_correct(catalog, name):
    _, outcome = run.run_cell(catalog, name, 2 ** 33 + 11, 0.5, False,
                              tiny.DEVICE)
    assert all(c.ok for c in outcome.checks), outcome.checks


def _loss_on_half(orig):
    def loss(self, preds, labels, group=None):
        h = labels.shape[0] // 2
        return orig(self, (preds[0][:h], preds[1][:h]), labels[:h], group)
    return loss


def _scaled_loss(orig):
    def loss(self, preds, labels, group=None):
        return orig(self, preds, labels, group) * 1.01
    return loss


def _keep_state(orig):
    def predict(self, x, state=None, max_out=300):
        dets, _ = orig(self, x, state, max_out)
        return dets, state
    return predict


def _half_frames(orig):
    def predict(self, x, state=None, max_out=300):
        x = x.clone()
        x[x.shape[0] // 2:] = 0
        return orig(self, x, state, max_out)
    return predict


def _shifted_conf(orig):
    def detect(self, preds, max_out=300):
        dets = orig(self, preds, max_out).clone()
        dets[..., 1] += 0.01
        return dets
    return detect


def _no_update(self, grads):
    return True


FAULTS = {
    # a step that returns its state unchanged: no update
    ("gen1_train", "state_unchanged"): ("train.loop.Optimizer", "step",
                                        lambda orig: _no_update),
    # half of the batch left out, the mean over the rest
    ("gen1_train", "half_batch"): ("models.detector.SODa", "loss",
                                   _loss_on_half),
    # the answer altered where it is produced
    ("gen1_train", "answer_altered"): ("models.detector.SODa", "loss",
                                       _scaled_loss),
    ("gen1_serve_c64", "state_unchanged"): ("models.detector.SODa",
                                            "predict", _keep_state),
    ("gen1_serve_c64", "half_batch"): ("models.detector.SODa", "predict",
                                       _half_frames),
    ("gen1_serve_c64", "answer_altered"): ("models.detector.SODa", "detect",
                                           _shifted_conf),
    # an eval step carries no state from step to step
    ("mpx_eval", "half_batch"): ("models.detector.SODa", "loss",
                                 _loss_on_half),
    ("mpx_eval", "answer_altered"): ("models.detector.SODa", "detect",
                                     _shifted_conf),
}


def _altered_after(n):
    """A loss scaled by 1.01 from its ``n``-th call on: a path that
    changes once the checked steps of the set-up have run."""
    def make(orig):
        calls = [0]

        def loss(self, preds, labels, group=None):
            calls[0] += 1
            out = orig(self, preds, labels, group)
            return out * 1.01 if calls[0] > n else out
        return loss
    return make


@pytest.mark.parametrize("name", ["gen1_train", "mpx_train"])
def test_a_path_that_changes_after_the_setup_is_not_correct(
        catalog, monkeypatch, name):
    """The checked steps of the set-up pass; the step after the window,
    from the program's own state, does not."""
    from snn_for_object_detection_tpu_torch.models.detector import SODa

    cell = catalog.cell(name)
    monkeypatch.setattr(SODa, "loss", _altered_after(cell["checked_steps"])(
        SODa.loss))
    _, outcome = run.run_cell(catalog, name, 2 ** 33 + 11, 0.5, False,
                              tiny.DEVICE)
    failed = {c.name for c in outcome.checks if not c.ok}
    assert failed and failed <= {"loss_post", "grad_post"}, outcome.checks


@pytest.mark.parametrize("name,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(catalog, monkeypatch, name,
                                            fault):
    import importlib

    where, attr, make = FAULTS[(name, fault)]
    module, cls = where.rsplit(".", 1)
    owner = getattr(importlib.import_module(
        "snn_for_object_detection_tpu_torch." + module), cls)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    _, outcome = run.run_cell(catalog, name, 2 ** 33 + 11, 0.5, False,
                              tiny.DEVICE)
    assert not all(c.ok for c in outcome.checks), outcome.checks
