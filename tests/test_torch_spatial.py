"""The port's spatial sharding against the JAX package's, on the CPU.

Eight gloo ranks (``tests/torch_rank_worker.py``) form the port's
``make_mesh(spatial=4)`` grid, two data blocks of four space ranks
(``dp2_sp4``); each holds its data block's rows of B and its space
block's rows of H (``parallel.halo.row_blocks``: balanced, uneven where
H does not divide). The JAX references are the same steps jitted on
conftest's 8 virtual CPU devices as a ``(data=2, space=4)`` mesh, where
GSPMD adds the halos, and on one device (tests/test_parallel.py,
tests/test_s2d.py), from the same weights (numpy, in JAX's layout), on
the ``MicroSODa`` of tests/test_detector.py:

- one train step a schedule (per-step, time-batched, hybrid), fp32, at
  ``in_hw`` (32, 40) and (60, 40) (maps of 30 and 15 rows, which do not
  divide over four ranks): the loss within rtol 1e-5, the gradients
  within rtol 2e-3, atol 1e-6 and the running statistics within rtol
  1e-5, atol 1e-6 of both JAX runs; after the per-step step's Adamax
  update the weights within rtol 1e-4, atol 1e-6, as JAX's own test;
  every rank's loss and weights bit-equal. JAX's grid gives twice its
  own one-device gradient for some layers (the stem conv on the
  time-batched and hybrid schedules at (32, 40), the neck's first conv
  on the per-step one at (60, 40); hidden in tests/test_parallel.py by
  its atol at the smaller gradients of its init): there the port is held
  to JAX's one-device gradient and JAX's grid to twice it. At (60, 40) JAX's grid
  compiles the per-step schedule only: its partitioned cell kernel
  (``custom_partitioning`` over H) fails to compile where a map's rows do
  not divide over the space axis, so the time-batched and hybrid steps
  there are held against JAX's one-device step alone;
- the s2d stem on ``dp2_sp4``: loss and gradients;
- the split rule on GEN1's and 1Mpx's maps, and its ``ValueError``;
- ``halo.fetch_rows`` on four ranks against slicing one padded tensor,
  forward and backward (autograd: a fetched row's gradient adds on its
  owner);
- ``global_moments`` on eight ranks with crafted sums whose fp64 total
  depends on the order of the additions: every rank gets the rank-order
  sum, bit for bit; a train Norm over uneven blocks of H against one
  process;
- Conv, Pool and Up over uneven blocks against one process (float64);
- ``Trainer.test`` on a ``dp1_sp2`` grid: the one-rank detections, mAP
  and loss; ``prefetch_to_device`` on the grid;
- ``StridedPool``, ``Resize``, ``ConvLSTM`` and the fused schedule, which
  raised under a space axis before they split, under a space axis of one
  rank against the one-process forms (tests/test_torch_spatial_layers.py
  splits them over gloo ranks against JAX).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.models.detector import SODa as JSODa
from snn_for_object_detection_tpu.parallel import (
    batch_sharding,
    feature_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from snn_for_object_detection_tpu_torch.models import compile as C
from snn_for_object_detection_tpu_torch.models import spec as S
from snn_for_object_detection_tpu_torch.models.convert import _flatten
from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo
from snn_for_object_detection_tpu_torch.parallel import Space, row_blocks
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from test_torch_detector import _jax_weights
from test_torch_megakernel import micro_soda
from torch_rank_worker import port_model, start_ranks

torch.set_num_threads(1)

T, B, SPATIAL, WORLD = 4, 2, 4, 8
HWS = [(32, 40), (60, 40)]
SCHEDULES = [False, True, "hybrid"]
CONFIGS = [(hw, s) for hw in HWS for s in SCHEDULES]
# the configurations JAX's (2 x 4) mesh compiles (see the docstring)
JAX_GRID_CONFIGS = [c for c in CONFIGS if c[0] == HWS[0] or c[1] is False]
JAX_RUNS = [(c, n) for c in CONFIGS for n in (WORLD, 1)
            if n == 1 or c in JAX_GRID_CONFIGS]
GRAD_TOL = dict(rtol=2e-3, atol=1e-6)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
S2D_HW, S2D_T = (32, 40), 3
EVAL_HW, EVAL_WINDOW, EVAL_BATCHES = (32, 40), 3, 2
SCHEDULE_NAMES = {False: "step", True: "seq", "hybrid": "hybrid"}


def config_id(config):
    hw, schedule = config
    return f"{SCHEDULE_NAMES[schedule]}-{hw[0]}x{hw[1]}"


def weights(hw, s2d_stem=False):
    jm = micro_soda(JS, JSODa)(num_classes=2, in_hw=hw, time_window=0,
                               s2d_stem=s2d_stem)
    return _jax_weights(jm, 0, 4.0)


def batch(seed, hw, t=T, b=B):
    """Bernoulli(0.4) frames [t, b, H, W, 2] and 3-5 boxes a row."""
    rng = np.random.default_rng(seed)
    X = (rng.random((t, b, *hw, 2)) < 0.4).astype(np.float32)
    lab = np.full((b, 8, 5), -1.0, np.float32)
    for i in range(b):
        k = 3 + i % 3
        xy = rng.random((k, 2)) * 0.6
        wh = rng.random((k, 2)) * 0.3 + 0.1
        lab[i, :k, 0] = rng.integers(0, 2, k)
        lab[i, :k, 1:] = np.concatenate([xy, xy + wh], 1)
    return X, lab


def jax_step(hw, schedule, n_dev, params, stats, X, lab, s2d_stem=False):
    """JAX's train step jitted on one device or the (2 x 4) mesh: the
    loss, gradients, new statistics and the weights after one Adamax
    step, flattened to the port's names."""
    jm = micro_soda(JS, JSODa)(num_classes=2, in_hw=hw, time_window=0,
                               s2d_stem=s2d_stem)
    devices = jax.devices()[:n_dev]
    mesh = make_mesh(devices, spatial=SPATIAL) if n_dev > 1 \
        else make_mesh(devices)
    opt = optax.adamax(jm.learning_rate)
    fwd = jm.forward_fn(schedule)

    def step(p, s, X, lab):
        def loss_fn(p, s):
            preds, new, _ = fwd(p, s, X, train=True)
            return jm.loss(preds, lab), new

        (loss, new), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, s)
        updates, _ = opt.update(grads, opt.init(p), p)
        return loss, grads, new, optax.apply_updates(p, updates)

    rep = replicated(mesh)
    step = jax.jit(step, in_shardings=(rep, rep, feature_sharding(mesh),
                                       batch_sharding(mesh, 0)),
                   out_shardings=rep)
    loss, grads, new, p = step(params, stats, *shard_batch(mesh, X, lab))
    return {"losses": np.asarray([float(loss)]),
            "grads": _flatten(jax.device_get(grads)),
            "stats": _flatten(jax.device_get(new)),
            "weights": _flatten(jax.device_get(p))}


def oihw(a):
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def check_step(got, want, weights_too=False, one=None):
    """``got`` (the port) against ``want`` (a JAX run). ``one``: JAX's
    one-device run where ``want`` is its grid's: a gradient the grid
    gives twice of (see the docstring) must be JAX's grid missing its
    own one-device function by that factor, and the port must meet the
    one-device gradient, and the one-device weights after the Adamax
    step (where the gradient nears Adamax's eps, doubling it moves the
    update)."""
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-5)
    assert got["grads"].keys() == want["grads"].keys()
    moved, doubled = 0, set()
    for name, g in got["grads"].items():
        w = oihw(want["grads"][name])
        if one is not None and not np.allclose(g, w, **GRAD_TOL):
            w1 = oihw(one["grads"][name])
            np.testing.assert_allclose(w, 2 * w1, err_msg=name, **GRAD_TOL)
            w = w1
            doubled.add(name)
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)
        moved += bool(np.abs(w).max() > 0)
    assert moved > len(got["grads"]) // 2
    for name, s in got["stats"].items():
        np.testing.assert_allclose(s, want["stats"][name], err_msg=name,
                                   **STATS_TOL)
    if weights_too:
        for name, w in got["weights"][-1].items():
            ref = one if name in doubled else want
            np.testing.assert_allclose(w, oihw(ref["weights"][name]),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


# ---- the halo exchange ----

HALO_H = 15
HALO_CASES = [("conv", 3, 1), ("conv", 3, 2), ("conv", 1, 2), ("up", 0, 2),
              ("pool", 3, 3)]


def halo_reference(seed, pad=4):
    """The worker's seeded global map, zero-padded by ``pad`` rows above
    and below: what each rank must fetch is a slice of it, and the
    gradient each block must get is autograd's for those slices."""
    full = torch.randn((2, HALO_H, 3, 2), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(seed))
    padded = torch.nn.functional.pad(full, (0, 0, 0, 0, pad, pad))
    return padded.requires_grad_(True), pad


# ---- the crafted moments ----

# fp32 values whose fp64 total depends on the order of the additions
# (2^60 + 1 rounds to 2^60 in fp64, 2^55 + 4 to 2^55)
CRAFTED = [2.0 ** 60, 1.0, -2.0 ** 60, 1.0, 3.0, 2.0 ** 55, -2.0 ** 55, 1.0]
PERMS = [list(range(WORLD)), [0, 2, 1, 3, 4, 5, 6, 7],
         [1, 3, 5, 7, 0, 2, 4, 6], [5, 1, 6, 0, 7, 2, 3, 4]]


# ---- Conv, Pool and Up over uneven blocks ----

_layers_rng = np.random.default_rng(21)
LAYERS_X = _layers_rng.normal(size=(2, 30, 8, 3))
LAYERS_W = _layers_rng.normal(size=(2, 8, 2, 5))


def rank_order_sum(values):
    total = np.float64(values[0])
    for v in values[1:]:
        total = total + np.float64(v)
    return total


def norm_input(form):
    """B=2, H=15 (blocks of 4, 4, 4, 3 rows), means that differ by row."""
    rng = np.random.default_rng(11)
    shape = (2, HALO_H, 6, 3) if form == "step" else (3, 2, HALO_H, 6, 3)
    x = rng.normal(size=shape).astype(np.float32)
    x += np.arange(HALO_H, dtype=np.float32)[:, None, None] * 2.0
    return x


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The eight- and two-rank sets start first; JAX's references are
    computed while they run."""
    tmp = tmp_path_factory.mktemp("spatial")
    train_jobs = []
    for hw in HWS:
        X, lab = batch(100 + hw[0], hw)
        params, stats = weights(hw)
        train_jobs.append(("spatial_train", dict(
            params=params, stats=stats, in_hw=hw,
            spatial=SPATIAL, schedules=SCHEDULES, X=X, labels=lab)))
    X, lab = batch(300, S2D_HW, t=S2D_T)
    sp, ss = weights(S2D_HW, s2d_stem=True)
    train_jobs.append(("spatial_train", dict(
        params=sp, stats=ss, in_hw=S2D_HW, spatial=SPATIAL,
        schedules=[False], X=X, labels=lab, s2d_stem=True)))
    eight = start_ranks(
        train_jobs + [
            ("halo", dict(H=HALO_H, cases=HALO_CASES, seed=5)),
            ("moments", dict(sums=CRAFTED, perms=PERMS)),
            ("space_norm", dict(x=norm_input("step"), form="step")),
            ("space_norm", dict(x=norm_input("seq"), form="seq")),
            ("space_layers", dict(x=LAYERS_X, w=LAYERS_W)),
        ], WORLD, tmp)
    jm = micro_soda(JS, JSODa)(num_classes=2, in_hw=EVAL_HW,
                               time_window=EVAL_WINDOW)
    ep, es = _jax_weights(jm, 0, 4.0)
    eval_batches = [batch(200 + i, EVAL_HW) for i in range(EVAL_BATCHES)]
    two = start_ranks(
        [("spatial_eval", dict(params=ep, stats=es, in_hw=EVAL_HW,
                               time_window=EVAL_WINDOW,
                               batches=eval_batches, schedule=schedule))
         for schedule in SCHEDULES], 2, tmp)

    jax_out = {}
    for hw in HWS:
        params, stats = weights(hw)
        X, lab = batch(100 + hw[0], hw)
        for schedule in SCHEDULES:
            for n in (1, WORLD):
                if ((hw, schedule), n) in JAX_RUNS:
                    jax_out[(hw, schedule), n] = jax_step(
                        hw, schedule, n, params, stats, X, lab)
    X, lab = batch(300, S2D_HW, t=S2D_T)
    for n in (1, WORLD):
        jax_out["s2d", n] = jax_step(S2D_HW, False, n, sp, ss, X, lab,
                                     s2d_stem=True)
    one_eval = {}
    for schedule in SCHEDULES:
        model = port_model(ep, es, EVAL_HW, EVAL_WINDOW)
        trainer = Trainer(seed=0, time_batched=schedule,
                          limit_test_batches=EVAL_BATCHES)
        dets = []
        step = trainer.eval_step

        def record(*args, step=step, dets=dets):
            loss, d = step(*args)
            dets.append(d.numpy().copy())
            return loss, d

        trainer.eval_step = record
        one_eval[schedule] = {"metrics": trainer.test(model,
                                                      iter(eval_batches)),
                              "dets": dets}
    got = eight.results()
    two_got = two.results()
    n_train = len(HWS)
    return {
        "train": {hw: [r[i] for r in got] for i, hw in enumerate(HWS)},
        "s2d": [r[n_train] for r in got],
        "halo": [r[n_train + 1] for r in got],
        "moments": [r[n_train + 2] for r in got],
        "norm": {"step": [r[n_train + 3] for r in got],
                 "seq": [r[n_train + 4] for r in got]},
        "layers": [r[n_train + 5] for r in got],
        "jax": jax_out,
        "eval": {s: [r[i] for r in two_got]
                 for i, s in enumerate(SCHEDULES)},
        "one_eval": one_eval,
    }


@pytest.mark.parametrize(
    "config,n_dev", JAX_RUNS,
    ids=[f"{config_id(c)}-{'jax_dp2_sp4' if n > 1 else 'jax_one_device'}"
         for c, n in JAX_RUNS])
def test_train_step_matches_jax(grid, config, n_dev):
    hw, schedule = config
    check_step(grid["train"][hw][0][schedule], grid["jax"][config, n_dev],
               weights_too=schedule is False,
               one=grid["jax"][config, 1] if n_dev > 1 else None)


@pytest.mark.parametrize("config", CONFIGS, ids=config_id)
def test_ranks_hold_the_same_weights(grid, config):
    hw, schedule = config
    runs = [r[schedule] for r in grid["train"][hw]]
    for other in runs[1:]:
        np.testing.assert_array_equal(other["losses"], runs[0]["losses"])
        for name, w in runs[0]["weights"][-1].items():
            np.testing.assert_array_equal(other["weights"][-1][name], w,
                                          err_msg=name)


@pytest.mark.parametrize("n_dev", [WORLD, 1], ids=["jax_dp2_sp4",
                                                   "jax_one_device"])
def test_s2d_stem_matches_jax(grid, n_dev):
    for r in grid["s2d"]:
        check_step(r[False], grid["jax"]["s2d", n_dev],
                   one=grid["jax"]["s2d", 1] if n_dev > 1 else None)


def test_make_mesh_spatial_grid(grid):
    """Rank r at data index r // 4 and space index r % 4, a
    ``{"data": 2, "space": 4}`` grid; the Trainer points the data module
    at the data block's shard, the same for the block's space ranks."""
    for r, run in enumerate(grid["train"][HWS[0]]):
        assert run["shape"] == {"data": 2, "space": 4}
        assert run["data_extent"] == 2
        assert (run["data_index"], run["space_rank"]) == divmod(r, SPATIAL)
        assert run["shard"] == (r // SPATIAL, 2)


def test_conv_pool_up_over_uneven_blocks(grid):
    """Conv (3x3 at stride 1 and 2, 1x1), Pool (mean, max) and Up on
    blocks of 8/8/7/7, 4/4/4/3 and 2-row maps, float64: each rank's
    output rows and input gradient are the one-process run's, and the
    ranks' weight gradients sum to its."""
    from torch_rank_worker import space_layers_block

    block = space_layers_block()
    x = torch.from_numpy(LAYERS_X).requires_grad_(True)
    y, _ = block.step(x, block.init_state(2, "cpu"), C.Ctx())
    (y * torch.from_numpy(LAYERS_W)).sum().backward()
    total = {n: np.zeros(p.shape) for n, p in block.named_parameters()}
    for r in grid["layers"]:
        d, (a, b), (lo, hi) = r["data"], r["rows"], r["in_rows"]
        np.testing.assert_allclose(r["y"], y.detach()[d:d + 1, a:b].numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r["grad"], x.grad[d:d + 1, lo:hi].numpy(),
                                   rtol=1e-12, atol=1e-12)
        for n, g in r["w_grads"].items():
            total[n] += g
    for n, p in block.named_parameters():
        np.testing.assert_allclose(total[n], p.grad.numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=n)


# ---- the split rule ----

GEN1_MAPS = [240, 120, 60, 30, 15, 8]
MPX_MAPS = [720, 360, 180, 90, 45, 23]


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("maps", [GEN1_MAPS, MPX_MAPS],
                         ids=["gen1", "1mpx"])
def test_row_blocks_balanced(maps, k):
    for rows in maps:
        blocks = row_blocks(rows, k)
        assert len(blocks) == k
        assert blocks[0][0] == 0 and blocks[-1][1] == rows
        for (_, hi), (lo, _) in zip(blocks, blocks[1:]):
            assert hi == lo
        sizes = [hi - lo for lo, hi in blocks]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)


def test_row_blocks_uneven_examples():
    assert row_blocks(15, 4) == ((0, 4), (4, 8), (8, 12), (12, 15))
    assert row_blocks(30, 4) == ((0, 8), (8, 16), (16, 23), (23, 30))
    assert row_blocks(15, 2) == ((0, 8), (8, 15))
    with pytest.raises(ValueError, match="3 rows do not split over 4"):
        row_blocks(3, 4)


def test_map_shorter_than_the_space_axis_names_the_layer():
    """GEN1 TinyYolo's maps have 8 rows at the least: 8 space ranks
    split them, 16 raise, naming the first layer whose map (15 rows) is
    too short."""
    model = TinyYolo(num_classes=2, in_hw=(240, 304), device="cpu")
    model.init_state(1, Space(None, 8, 0))
    with pytest.raises(ValueError, match=r"neck/b0/l[0-9]+.*15 rows do not "
                                         r"split over 16 space ranks"):
        model.init_state(1, Space(None, 16, 0))


# ---- the halo exchange ----


@pytest.mark.parametrize("case", HALO_CASES,
                         ids=lambda c: f"{c[0]}{c[1] or ''}s{c[2]}")
def test_fetch_rows_forward_and_backward(grid, case):
    """Four ranks (each data block's space group) fetch the rows their
    output blocks read; the rows are slices of one zero-padded tensor
    and each block's gradient is what autograd gives that tensor's rows
    for every rank's ``(rows * w).sum()``: a fetched row's gradient is
    added on its owner."""
    padded, pad = halo_reference(5)
    total = 0
    for r in range(SPATIAL):
        got = grid["halo"][r][case]
        lo, hi = got["want"]
        piece = padded[:, lo + pad:hi + pad]
        np.testing.assert_array_equal(got["rows"], piece.detach().numpy())
        w = torch.randn(piece.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(5 + 1 + r))
        total = total + (piece * w).sum()
    total.backward()
    grad = padded.grad[:, pad:pad + HALO_H]
    for r in range(WORLD):  # the second data block's group alike
        got = grid["halo"][r][case]
        lo, hi = got["block"]
        np.testing.assert_allclose(got["grad"], grad[:, lo:hi].numpy(),
                                   rtol=1e-12, atol=1e-12)
    crossing = any(
        grid["halo"][r][case]["want"][0] < grid["halo"][r][case]["block"][0]
        or grid["halo"][r][case]["want"][1] > grid["halo"][r][case]["block"][1]
        for r in range(SPATIAL))
    # a 1x1 conv at stride 2 reads rows of its own block only, here
    assert crossing == (case != ("conv", 1, 2))


# ---- moments ----


def test_global_moments_sum_in_rank_order(grid):
    """Each channel adds the crafted sums in another order across the
    ranks; the orders give different fp64 totals, and every rank gets
    the rank-order total of its channel, bit for bit."""
    totals = [rank_order_sum([CRAFTED[i] for i in perm]) for perm in PERMS]
    assert len(set(totals)) > 1  # the order moves the total
    mean = np.array([np.float32(t) / np.float32(2 * WORLD) for t in totals],
                    np.float32)
    for r in grid["moments"]:
        np.testing.assert_array_equal(r["mean"], mean)
        np.testing.assert_array_equal(r["var"], grid["moments"][0]["var"])
    # the variance pass: each rank's fp32 sum of squared deviations
    sq = []
    for c, perm in enumerate(PERMS):
        parts = []
        for r in range(WORLD):
            v = np.float32(CRAFTED[perm[r]])
            parts.append(np.float32((v - mean[c]) ** 2)
                         + np.float32((np.float32(0) - mean[c]) ** 2))
        sq.append(np.float32(rank_order_sum(parts)) / np.float32(2 * WORLD))
    np.testing.assert_array_equal(grid["moments"][0]["var"],
                                  np.asarray(sq, np.float32))


@pytest.mark.parametrize("form", ["step", "seq"])
def test_space_norm_matches_one_process(grid, form):
    """A train Norm over blocks of 4, 4, 4 and 3 rows takes the whole
    grid's moments with the global count: the one-process Norm's output
    and running statistics."""
    x = norm_input(form)
    block = C.compile_block([S.Norm()], x.shape[-1], x.shape[-3:-1])
    fn = block.step if form == "step" else block.seq
    bdim = 0 if form == "step" else 1
    y, new = fn(torch.from_numpy(x), block.init_state(x.shape[bdim], "cpu"),
                C.Ctx(train=True))
    mean, var = new["b0"]["l0"]
    for r in grid["norm"][form]:
        lo, hi = r["rows"]
        want = y.detach().narrow(bdim, r["data"], 1).narrow(
            bdim + 1, lo, hi - lo).numpy()
        np.testing.assert_allclose(r["y"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["mean"], mean.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["var"], var.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(r["mean"], grid["norm"][form][0]["mean"])


# ---- eval ----


@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=lambda s: SCHEDULE_NAMES[s])
def test_eval_on_dp1_sp2_matches_one_rank(grid, schedule):
    want = grid["one_eval"][schedule]
    for r in grid["eval"][schedule]:
        assert r["prefetch_same"] and r["rows"] == EVAL_HW[0] // 2
        for got, d in zip(r["dets"], want["dets"]):
            np.testing.assert_allclose(got, d, rtol=1e-4, atol=1e-5)
        assert r["metrics"].keys() == want["metrics"].keys()
        for key, value in want["metrics"].items():
            np.testing.assert_allclose(r["metrics"][key], value, rtol=1e-6,
                                       atol=1e-7, err_msg=key)
    assert want["metrics"]["test_loss"] > 0


# ---- the layers that split since they were ported ----


def _space_ctx():
    return C.Ctx(space=Space(None, 1, 0))


@pytest.mark.parametrize("spec", [S.Pool("M", 3, 2), S.Up(2, "bilinear"),
                                  S.LSTM()],
                         ids=["strided_pool", "resize", "lstm"])
def test_layers_that_do_not_split_raise(spec):
    """These layers raised under a space axis until they split (the
    test keeps its name). Under a space axis of one rank each runs its
    rows form (the rows it reads fetched, in one process with no
    collective: the uncropped tail of the strided Pool's map, the rows
    of the resize weights' support, the LSTM's halo of ``[x, h]``), and
    gives the one-process form's output and state, float64 within 1e-12
    (tests/test_torch_spatial_layers.py splits them over gloo ranks)."""
    block = C.compile_block([spec], 4, (9, 8)).double()
    for m in block.modules():
        if isinstance(m, C.ConvLSTM):
            m.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn((2, 3, 9, 8, 4), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    state = block.init_state(3, "cpu")
    (y, new), (y1, new1) = [block.seq(x, state, C.Ctx(space=space))
                            for space in (None, Space(None, 1, 0))]
    torch.testing.assert_close(y1, y, rtol=1e-12, atol=1e-12)
    for a, b in zip(jax.tree.leaves(new1), jax.tree.leaves(new)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert float(y.detach().abs().max()) > 0


def test_fused_eval_under_a_space_axis_raises():
    """The fused schedule raised under a space axis until the kernel
    took fetched rows (the test keeps its name). Under a space axis of
    one rank every triple runs ``spiking_conv_seq(pad_h=0)`` on rows
    fetched with their zero rows, and the predictions and states are
    the whole map's fused run's bit for bit."""
    from snn_for_object_detection_tpu_torch.models.convert import (
        load_jax_params,
    )
    from snn_for_object_detection_tpu_torch.models.detector import SODa
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels

    model = micro_soda(S, SODa)(num_classes=2, in_hw=(32, 40),
                                time_window=0, fuse_seq=True, device="cpu")
    load_jax_params(model, *weights((32, 40)))
    X = (torch.rand((3, 2, 32, 40, 2),
                    generator=torch.Generator().manual_seed(4)) < 0.4).float()
    pads = []
    plain = cuda_kernels.spiking_conv_seq_reference

    def spy(*args, pad_h=None, **kwargs):
        pads.append(pad_h)
        return plain(*args, pad_h=pad_h, **kwargs)

    C_ref = C.spiking_conv_seq
    (cls, box), state = model.forward_seq(X)
    cuda_kernels.spiking_conv_seq_reference = spy
    try:
        (cls1, box1), state1 = model.forward_seq(X, space=Space(None, 1, 0))
    finally:
        cuda_kernels.spiking_conv_seq_reference = plain
    assert C.spiking_conv_seq is C_ref
    assert pads == [0] * 5  # the micro net's 5 triples
    assert float(cls.abs().max()) > 0.05
    torch.testing.assert_close(cls1, cls, rtol=0, atol=0)
    torch.testing.assert_close(box1, box, rtol=0, atol=0)
    for a, b in zip(jax.tree.leaves(state1), jax.tree.leaves(state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
