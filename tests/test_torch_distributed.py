"""The port's data parallel over four ranks, and its multi-rank ``fit``.

Gloo ranks on the CPU (``tests/torch_rank_worker.py``), started before
JAX's references are computed, so the two run side by side:

- four ranks against JAX's train step on a four-device mesh of
  conftest's virtual CPU devices, with the bars and cases of
  tests/test_torch_parallel.py (every schedule, fp32 and bf16 states;
  one row a rank), and ``Trainer.test`` on four ranks against one;
- the counterpart of tests/test_distributed.py: ``fit`` on two ranks of
  a synthetic GEN1 set, each rank on its own file shard (``host_id`` and
  ``num_hosts`` derived from the rank), folding the mAP accumulators:
  both ranks end with the same best metric and weights, every step is
  logged once, and only rank 0 writes checkpoints;
- ``time_batched="auto"`` with a schedule that runs out of memory on one
  rank only: both ranks disqualify it and pin the same schedule from the
  summed timings.
"""

import json
import os

import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
)
from test_torch_parallel import (
    CONFIGS,
    against_jax,
    check_eval,
    check_ranks_agree,
    check_step,
    check_trajectory,
    config_id,
    eval_job,
    jax_train,
    one_rank_eval,  # noqa: F401 (a fixture)
    train_job,
    weights,
)
from torch_rank_worker import start_ranks

torch.set_num_threads(1)

# (False, True, "hybrid") seconds a schedule takes on ranks 0 and 1; rank
# 1 runs out of memory on "hybrid" (fastest on rank 0): alone, rank 0
# would pick "hybrid" and rank 1 the per-step schedule
AUTO_TIMES = [{False: 3.0, True: 2.0, "hybrid": 1.0},
              {False: 1.0, True: 1.5, "hybrid": 1.0}]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    params, stats = weights()
    data = make_synthetic_dataset(str(tmp / "data"), records_per_split=2,
                                  duration_ms=1200)
    out_dir = str(tmp / "run")
    four = start_ranks([train_job(params, stats), eval_job(params, stats)],
                       4, tmp)
    two = start_ranks([("fit", dict(data_dir=data, out_dir=out_dir,
                                    time_window=2)),
                       ("auto", dict(in_hw=(32, 40), failing_rank=1,
                                     times=AUTO_TIMES))], 2, tmp)
    jax_out = {cfg: jax_train(4, *cfg, params, stats) for cfg in CONFIGS}
    got4, got2 = four.results(), two.results()
    return {"train": [r[0] for r in got4], "jax": jax_out,
            "eval": [r[1] for r in got4], "fit": [r[0] for r in got2],
            "auto": [r[1] for r in got2], "out_dir": out_dir}


@pytest.mark.parametrize("config", CONFIGS, ids=config_id)
def test_train_step_matches_jax(ranks, config):
    against_jax(check_step, ranks["train"][0][config], ranks["jax"], config)


@pytest.mark.parametrize("config", CONFIGS, ids=config_id)
def test_adamax_trajectory_matches_jax(ranks, config):
    against_jax(check_trajectory, ranks["train"][0][config], ranks["jax"],
                config)


@pytest.mark.parametrize("config", CONFIGS, ids=config_id)
def test_ranks_hold_the_same_weights(ranks, config):
    check_ranks_agree([r[config] for r in ranks["train"]])


def test_eval_matches_one_rank(ranks, one_rank_eval):  # noqa: F811
    check_eval(ranks["eval"], one_rank_eval)


def test_two_rank_fit_merges_metrics(ranks):
    fit = ranks["fit"]
    # each rank's data shard was derived from its rank
    for rank, rec in enumerate(fit):
        assert (rec["host_id"], rec["num_hosts"]) == (rank, 2)
        assert rec["step"] == 2
    # the folded evaluation: the same metric, and the same weights
    assert fit[0]["best_metric"] == fit[1]["best_metric"]
    for name, w in fit[0]["weights"].items():
        np.testing.assert_array_equal(fit[1]["weights"][name], w)
    # one writer: each record once, and only rank 0 saved checkpoints
    with open(os.path.join(ranks["out_dir"], "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    seen = [(r["step"], tuple(sorted(r))) for r in lines]
    assert len(seen) == len(set(seen))
    assert [r["step"] for r in lines if "train_loss" in r] == [1, 2]
    assert any("map" in r for r in lines)
    assert [rec["saves"] for rec in fit] == [1, 0]
    last = os.path.join(ranks["out_dir"], "checkpoints", "last")
    saved = torch.load(os.path.join(last, "state.pt"), weights_only=True)
    for name, w in fit[0]["weights"].items():
        np.testing.assert_array_equal(saved["params"][name].numpy(), w)


def test_auto_disqualifies_a_schedule_that_fails_on_one_rank(ranks):
    auto = ranks["auto"]
    assert auto[0]["schedule"] == auto[1]["schedule"] is True
    for rec in auto:
        timings = rec["timings"]
        assert "OutOfMemoryError" in timings["hybrid"]["oom"]
        assert timings[False]["ms"] == pytest.approx(4000.0)
        assert timings[True]["ms"] == pytest.approx(3500.0)
