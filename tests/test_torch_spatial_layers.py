"""Spatial sharding's last parts in the port against the JAX package, on
the CPU: the layers that split since they stopped raising under a space
axis, fused eval on row blocks, ``Trainer(spatial_devices=k)``, the live
reshape, ``time_batched="auto"`` on a grid and the serving engine on a
``(data, space)`` mesh.

Gloo ranks (``tests/torch_rank_worker.py``) form ``make_mesh(spatial=
world)`` grids of 2 and 4 ranks (one data block), each holding its rows
of H (``halo.row_blocks``: 30 rows split 15/15 and 8/8/7/7, the deeper
maps unevenly). The JAX references run on one device (PR 17 found that
JAX's own ``(data, space)`` step doubles some gradients, so its grid is
no reference), from the same numpy-drawn weights in JAX's layout:

- each layer that used to raise (``StridedPool`` max / mean / sum,
  ``Resize`` bilinear and bicubic, the k=3 ``ConvLSTM``) after the
  spiking stem of tests/test_torch_zoo.py's narrow net at 60x40: one
  time-batched train step on the grid (the loss within rtol 1e-5, the
  gradients the optimizer sees within rtol 2e-3, atol 1e-6, the running
  statistics within rtol 1e-5, atol 1e-6: tests/test_torch_spatial.py's
  tolerances) and the eval forward (the predictions within rtol 1e-4,
  atol 1e-5, each rank's rows of every final state within rtol 1e-4,
  atol 1e-4: the detector tests' tolerances);
- the int8 conv, plain and on the s2d stem, in a ``MicroSODa`` loaded
  with JAX's quantized weights: the eval forward as above;
- fused eval (``fuse_seq=True``, window 0) on the grid: every triple's
  ``spiking_conv_seq`` takes fetched rows (``pad_h=0``); the predictions
  and states against JAX's fused ``forward_seq`` (its Pallas kernel in
  interpret mode, as tests/test_pallas.py runs it) and against the
  port's unfused schedule on the same grid at fp32, as above;
- the plain ``pad_h=0`` form on every row block of 2, 3 and 4 against
  the whole map's ``pad_h=k//2`` form: bit for bit;
- ``Trainer(spatial_devices=k)`` on 4 ranks: the grid of JAX's
  tests/test_parallel.py::test_trainer_spatial_mesh_geometry as the
  port's semantics allow (a rank's batch is its data block's, so there
  is no batch to size the grid from), JAX's ``ValueError``s, the queued
  reshape's shape; ``fit`` on the grid with a reshape queued and a
  ``reshape_request`` file written: rank 0 prints JAX's multi-host
  message and the file stays, for the supervisor that relaunches. In
  one process (JAX's tests/test_train.py::
  test_live_mesh_reshape_file_trigger as one rank of one device allows):
  the file claimed, read and removed, a bad count ignored with JAX's
  message;
- ``time_batched="auto"`` on a 2-rank grid pins one schedule a mode on
  every rank, and a schedule out of memory on one rank (placing its
  copy of the model, or after the timed step) is disqualified on both;
- ``StreamingEngine`` on a one-process ``(data 2, space 2)`` mesh of
  CPU devices against the engine on the two data devices alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.models.detector import SODa as JSODa
from snn_for_object_detection_tpu.ops import quantize as JQ
from snn_for_object_detection_tpu_torch.models.convert import _flatten
from snn_for_object_detection_tpu_torch.ops import cuda_kernels
from snn_for_object_detection_tpu_torch.parallel import make_mesh, row_blocks
from snn_for_object_detection_tpu_torch.serve import StreamingEngine
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from test_torch_detector import _jax_weights
from test_torch_megakernel import micro_soda
from test_torch_spatial import batch, oihw
from test_torch_zoo import zoo_weights
from torch_rank_worker import (
    GridData,
    grid_leaves,
    leaf_net,
    port_model,
    start_ranks,
    state_leaves,
)

torch.set_num_threads(1)

RANKS = (2, 4)
HW, GAIN = (60, 40), 4.0
LEAVES = sorted(grid_leaves(JS))
INT8 = ("plain", "s2d")
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-3, atol=1e-6)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
PRED_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
FUSED_TRIPLES = 5  # MicroSODa: the stem, two neck convs, two head stems
SMALL_HW = (32, 40)  # the Trainer's grids: maps of 16, 8 and 4 rows
AUTO_FAILS = (None, "placing", "timing")  # "auto": where rank 1 runs out


def leaf_weights(leaf):
    jm = leaf_net(JS, JSODa, grid_leaves(JS)[leaf])(
        num_classes=2, in_hw=HW, time_window=0)
    return jm, zoo_weights(jm, 0, GAIN)


def micro_weights(hw, **kw):
    jm = micro_soda(JS, JSODa)(num_classes=2, in_hw=hw, time_window=0, **kw)
    return jm, _jax_weights(jm, 0, GAIN)


def jax_train(jm, params, stats, X, lab):
    """JAX's time-batched train step on one device: the loss, the
    gradients and the new statistics, flattened to the port's names."""
    def loss_fn(p, s):
        preds, new, _ = jm.forward_fn(True)(p, s, X, train=True)
        return jm.loss(preds, lab), new

    (loss, new), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, stats)
    return {"loss": float(loss), "grads": _flatten(jax.device_get(grads)),
            "stats": _flatten(jax.device_get(new))}


def jax_eval(jm, params, stats, X):
    """JAX's ``forward_seq`` on one device from start 0: the predictions
    and the final state's leaves."""
    preds, _, state = jax.jit(lambda x: jm.forward_seq(params, stats, x))(
        jnp.asarray(X))
    return {"preds": [np.asarray(p) for p in preds],
            "state": [np.asarray(s, np.float32)
                      for s in jax.tree.leaves(state)]}


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """The 4- and 2-rank sets start first; JAX's references are computed
    while they run."""
    tmp = tmp_path_factory.mktemp("spatial_layers")
    X, lab = batch(400, HW)
    Xs, labs = batch(401, SMALL_HW)
    leaf_jobs = []
    for leaf in LEAVES:
        _, (params, stats) = leaf_weights(leaf)
        leaf_jobs.append(("grid_leaf", dict(leaf=leaf, params=params,
                                            stats=stats, in_hw=HW, X=X,
                                            labels=lab)))
    int8_refs, eval_jobs = {}, []
    for form in INT8:
        jm, (params, stats) = micro_weights(HW, s2d_stem=form == "s2d")
        absmax = JQ.calibrate(jm, params, stats, jnp.asarray(X))
        qparams = jax.device_get(JQ.quantize(params, absmax))
        eval_jobs.append(("grid_eval", dict(params=qparams, stats=stats,
                                            in_hw=HW, X=X,
                                            s2d_stem=form == "s2d")))
        int8_refs[form] = (jm, qparams, stats)
    jf, (fparams, fstats) = micro_weights(HW, fuse_seq=True)
    eval_jobs.append(("grid_eval", dict(params=fparams, stats=fstats,
                                        in_hw=HW, X=X, fuse=True)))
    _, (sparams, sstats) = micro_weights(SMALL_HW)
    ranks = {
        4: start_ranks(leaf_jobs + eval_jobs + [
            ("trainer_grid", dict(params=sparams, stats=sstats,
                                  in_hw=SMALL_HW, X=Xs, labels=labs,
                                  out_dir=str(tmp / "fit")))], 4, tmp),
        2: start_ranks(leaf_jobs + eval_jobs + [
            *[("grid_auto", dict(params=sparams, stats=sstats,
                                 in_hw=SMALL_HW, X=Xs, labels=labs,
                                 fail=fail)) for fail in AUTO_FAILS]],
            2, tmp),
    }
    ref = {}
    for leaf in LEAVES:
        jm, (params, stats) = leaf_weights(leaf)
        ref[leaf] = {**jax_train(jm, params, stats, X, lab),
                     **jax_eval(jm, params, stats, X)}
    for form in INT8:
        ref["int8", form] = jax_eval(*int8_refs[form], X)
    ref["fused"] = jax_eval(jf, fparams, fstats, X)
    got = {n: r.results() for n, r in ranks.items()}
    out = {"ref": ref}
    for n, runs in got.items():
        for i, leaf in enumerate(LEAVES):
            out[leaf, n] = [r[i] for r in runs]
        k = len(LEAVES)
        for i, form in enumerate(INT8):
            out["int8", form, n] = [r[k + i] for r in runs]
        out["fused", n] = [r[k + len(INT8)] for r in runs]
    base = len(LEAVES) + len(INT8) + 1
    out["trainer"] = [r[base] for r in got[4]]
    for i, fail in enumerate(AUTO_FAILS):
        out["auto", fail] = [r[base + i] for r in got[2]]
    return out


def check_eval(runs, want, ranks):
    """Every rank's predictions against ``want``'s, and its rows of each
    final state leaf against the matching rows of ``want``'s."""
    for r, got in enumerate(runs):
        for g, w in zip(got["preds"], want["preds"]):
            np.testing.assert_allclose(g, w, **PRED_TOL)
        assert len(got["state"]) == len(want["state"])
        for g, w in zip(got["state"], want["state"]):
            lo, hi = row_blocks(w.shape[1], ranks)[r]
            np.testing.assert_allclose(g, w[:, lo:hi], **STATE_TOL)
    assert float(np.abs(want["preds"][0]).max()) > 0.05  # not silent


# ---- the layers that split ----


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("leaf", LEAVES)
def test_leaf_train_step_on_grid_matches_jax(grids, leaf, ranks):
    """One time-batched train step on the grid: the loss, the gradients
    summed over the grid and the running statistics against JAX's one
    device; the ranks' losses bit-equal."""
    want = grids["ref"][leaf]
    runs = grids[leaf, ranks]
    for got in runs:
        assert got["loss"] == runs[0]["loss"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        assert got["grads"].keys() == want["grads"].keys()
        moved = 0
        for name, g in got["grads"].items():
            w = oihw(want["grads"][name])
            np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)
            moved += bool(np.abs(w).max() > 0)
        assert moved > len(got["grads"]) // 2
        for name, s in got["stats"].items():
            np.testing.assert_allclose(s, want["stats"][name], err_msg=name,
                                       **STATS_TOL)
    assert [r["rows"] for r in runs] == list(row_blocks(HW[0], ranks))


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("leaf", LEAVES)
def test_leaf_eval_on_grid_matches_jax(grids, leaf, ranks):
    check_eval(grids[leaf, ranks], grids["ref"][leaf], ranks)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("form", INT8)
def test_int8_conv_on_grid_matches_jax(grids, form, ranks):
    """JAX's int8 forward (its quantized weights; the input scales fixed
    at quantization) against the port's int8 convs on their rows."""
    runs = grids["int8", form, ranks]
    check_eval(runs, grids["ref"]["int8", form], ranks)
    for got in runs:
        assert got["int8_calls"]["plain"] > 0 and got["pads"] == []


# ---- fused eval ----


@pytest.mark.parametrize("ranks", RANKS)
def test_fused_eval_on_grid_matches_jax(grids, ranks):
    runs = grids["fused", ranks]
    check_eval(runs, grids["ref"]["fused"], ranks)
    for got in runs:
        assert got["pads"] == [0] * FUSED_TRIPLES


@pytest.mark.parametrize("ranks", RANKS)
def test_fused_eval_on_grid_matches_the_unfused_grid(grids, ranks):
    for got in grids["fused", ranks]:
        check_eval([got], got["unfused"], 1)


CONV_CASES = [(3, 1, "lif"), (3, 2, "lif"), (1, 1, "li"), (1, 2, "lif"),
              (3, 2, "li"), (1, 1, "lif")]
DTYPE_PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
               ("bfloat16", "float8_e5m2")]


@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS,
                         ids=["-".join(p) for p in DTYPE_PAIRS])
@pytest.mark.parametrize("k,stride,cell", CONV_CASES,
                         ids=[f"k{k}s{s}{c}" for k, s, c in CONV_CASES])
def test_fetched_rows_form_is_the_whole_maps_rows(k, stride, cell, x_dtype,
                                                 state_dtype):
    """``spiking_conv_seq_reference(pad_h=0)`` on the rows a block of 2, 3
    or 4 reads, sliced from the zero-padded map, gives the whole map's
    rows of z, v and i bit for bit, on maps of 15 and 16 rows."""
    gen = torch.Generator().manual_seed(k * 10 + stride)
    xd, sd = getattr(torch, x_dtype), getattr(torch, state_dtype)
    T, N, W, cin, cout = 5, 2, 11, 6, 8
    p = k // 2
    for H in (15, 16):
        x = (torch.rand((T, N, H, W, cin), generator=gen) < 0.3).to(xd)
        w = torch.randn((k, k, cin, cout), generator=gen)
        a = torch.rand(cout, generator=gen) + 0.5
        b = 0.1 * torch.randn(cout, generator=gen)
        ho, wo = (H + 2 * p - k) // stride + 1, (W + 2 * p - k) // stride + 1
        v0 = (0.3 * torch.randn((N, ho, wo, cout), generator=gen)).to(sd)
        i0 = (0.3 * torch.randn((N, ho, wo, cout), generator=gen)).to(sd)
        whole = cuda_kernels.spiking_conv_seq(x, w, a, b, v0, i0, cell,
                                              stride)
        padded = F.pad(x.float(), (0, 0, 0, 0, p, p + stride)).to(xd)
        for blocks in (2, 3, 4):
            for o0, o1 in row_blocks(ho, blocks):
                rows = padded[:, :, o0 * stride:(o1 - 1) * stride + k]
                got = cuda_kernels.spiking_conv_seq(
                    rows.contiguous(), w, a, b, v0[:, o0:o1].contiguous(),
                    i0[:, o0:o1].contiguous(), cell, stride, pad_h=0)
                for g, full in zip(got, (whole[0][:, :, o0:o1],
                                         whole[1][:, o0:o1],
                                         whole[2][:, o0:o1])):
                    assert torch.equal(g.float(), full.float())
        assert 0 < float(whole[0].float().abs().mean())


def test_fetched_rows_form_refuses_rows_that_do_not_fit():
    x = torch.zeros((2, 1, 6, 5, 4))
    w = torch.zeros((3, 3, 4, 8))
    a = b = torch.zeros(8)
    v = torch.zeros((1, 4, 5, 8))
    # 6 rows fetched for a 3x3 stride-1 conv give 4 rows, not 6
    cuda_kernels.spiking_conv_seq(x, w, a, b, v, v, "lif", 1, pad_h=0)
    with pytest.raises(ValueError, match="want state"):
        cuda_kernels.spiking_conv_seq(x, w, a, b, v, v, "lif", 1)
    with pytest.raises(ValueError, match="pad_h 2"):
        cuda_kernels.spiking_conv_seq(x, w, a, b, v, v, "lif", 1, pad_h=2)
    with pytest.raises(ValueError, match="pad_h 0 with k=3 and 2 rows"):
        cuda_kernels.spiking_conv_seq(x[:, :, :2], w, a, b, v, v, "lif", 1,
                                      pad_h=0)


# ---- the Trainer ----


def test_spatial_devices_grid(grids):
    """``Trainer(spatial_devices=k).mesh_for`` over 4 ranks: ``{"data":
    2, "space": 2}`` for k=2 (rank r at data index r // 2, space index r
    % 2), ``{"data": 1, "space": 4}`` for k=4, the data axis alone for
    k=1; JAX's grid for 8 devices and k=4, ``{"data": 2, "space": 4}``,
    has the same layout."""
    for r, got in enumerate(grids["trainer"]):
        assert got["shapes"][1] == ({"data": 4}, r, 0)
        assert got["shapes"][2] == ({"data": 2, "space": 2}, r // 2, r % 2)
        assert got["shapes"][4] == ({"data": 1, "space": 4}, 0, r)
        assert got["one_host_data_parallel"] == {"data": 4}


def test_spatial_devices_refused_as_jax(grids):
    """JAX's ``ValueError``s: a world ``k`` does not divide, and a space
    axis across hosts (``LOCAL_WORLD_SIZE`` 2 of 4 ranks)."""
    for got in grids["trainer"]:
        assert got["errors"][3] == ("4 devices not divisible by "
                                    "spatial_devices=3")
        assert "single-host only" in got["errors"]["hosts"]
        assert sorted(k for k in got["errors"] if k != "hosts") == [3]


def test_reshape_request_keeps_the_space_extent(grids):
    """JAX's test: a reshape to 2 devices at ``spatial_devices=2`` queues
    ``{"data": 1, "space": 2}``, to every device ``{"data": 2, "space":
    2}``; 3 is not divisible, 5 more than the ranks."""
    for got in grids["trainer"]:
        assert got["reshape"][2] == {"data": 1, "space": 2}
        assert got["reshape"][4] == {"data": 2, "space": 2}
        assert got["reshape"][3] == ("3 devices not divisible by "
                                     "spatial_devices=2")
        assert got["reshape"][5] == "num_devices must be in [1, 4], got 5"


def test_reshape_under_several_ranks_is_ignored(grids):
    """``fit`` on the grid with a reshape queued and a ``reshape_request``
    written: rank 0 prints JAX's multi-host message, every rank drops
    the queue, the file stays unread, the epoch runs on the
    ``spatial_devices=2`` grid and the ranks hold the same weights."""
    runs = grids["trainer"]
    message = ("live reshape ignored under multi-host; use checkpoint + "
               "relaunch")
    for r, got in enumerate(runs):
        assert (message in got["printed"]) == (r == 0)
        assert got["left"] and got["pending"] is None and got["step"] == 1
        assert got["fit_shape"] == {"data": 2, "space": 2}
        for name, w in got["weights"].items():
            np.testing.assert_array_equal(w, runs[0]["weights"][name],
                                          err_msg=name)


def _one_rank_fit(tmp_path, request):
    (params, stats) = micro_weights(SMALL_HW)[1]
    model = port_model(params, stats, SMALL_HW, 0)
    path = tmp_path / "reshape_request"
    path.write_text(request)
    trainer = Trainer(max_epochs=2, limit_train_batches=1,
                      check_val_every_n_epoch=5, out_dir=str(tmp_path),
                      seed=0, prefetch_batches=0)
    result = trainer.fit(model, GridData(*batch(402, SMALL_HW), batches=2))
    assert result["step"] == 2 and trainer._pending_mesh is None
    assert not path.exists() and not (tmp_path / "reshape_request.claimed"
                                      ).exists()
    return trainer


def test_one_rank_claims_and_removes_the_reshape_file(tmp_path, capsys):
    """One rank of one device: a request for 1 device is claimed, read
    and removed and changes nothing (JAX's single-process path; 1 is the
    only count one device allows)."""
    _one_rank_fit(tmp_path, "1")
    assert "reshape" not in capsys.readouterr().out
    trainer = Trainer(spatial_devices=4)
    with pytest.raises(ValueError, match="1 devices not divisible by "
                                         "spatial_devices=4"):
        trainer.request_mesh_reshape(num_devices=1)
    Trainer().request_mesh_reshape(devices=["cpu"])


@pytest.mark.parametrize("request_text,why", [
    ("3", "num_devices must be in [1, 1], got 3"),
    ("two", "invalid literal for int()"),
], ids=["count", "text"])
def test_one_rank_ignores_a_bad_reshape_request(tmp_path, capsys,
                                                request_text, why):
    _one_rank_fit(tmp_path, request_text)
    out = capsys.readouterr().out
    assert "[trainer] bad reshape_request ignored: " in out and why in out


# ---- "auto" ----


def test_auto_on_grid_pins_one_schedule(grids):
    """Each rank measured every schedule on the grid (its collectives
    included); the merged timings, and so the schedules pinned for the
    train and the eval step, are the same on both ranks."""
    runs = grids["auto", None]
    for got in runs:
        assert got["schedules"] == runs[0]["schedules"]
        assert set(got["schedules"]) == {"train", "eval"}
        assert got["timings"] == runs[0]["timings"]
        for mode in ("train", "eval"):
            assert all(t["ms"] > 0 and t["oom"] is None
                       for t in got["timings"][mode].values())


@pytest.mark.parametrize("fail", AUTO_FAILS[1:])
def test_auto_on_grid_disqualifies_a_schedule_out_of_memory_on_one_rank(
        grids, fail):
    """Rank 1 runs out of memory on the hybrid schedule, placing its copy
    (the ranks agree before the step, so neither runs it) or after the
    timed step (the ranks' notes): both disqualify it and pin the same
    schedules."""
    runs = grids["auto", fail]
    for got in runs:
        assert got["timings"] == runs[0]["timings"]
        for mode in ("train", "eval"):
            hybrid = got["timings"][mode]["hybrid"]
            # the first rank's note: rank 0 could not run it either way
            why = "could not place" if fail == "placing" else "forced"
            assert hybrid["ms"] is None and why in hybrid["oom"]
            assert got["schedules"][mode] in (False, True)


# ---- the engine ----


def test_engine_on_a_data_space_mesh_is_the_data_engine():
    """JAX's engine shards its slots over ``data`` and replicates them
    over ``space``: on ``make_mesh(4 CPU devices, spatial=2)`` the port's
    engine runs a replica a data row and gives the detections of the
    engine on the two data devices alone, bit for bit; a capacity that
    does not divide by the mesh's 4 devices raises JAX's message."""
    (params, stats) = micro_weights(SMALL_HW)[1]
    model = port_model(params, stats, SMALL_HW, 0)
    grid = StreamingEngine(model, capacity=4,
                           mesh=make_mesh(["cpu"] * 4, spatial=2))
    data = StreamingEngine(model, capacity=4, mesh=make_mesh(["cpu"] * 2))
    assert len(grid._replicas) == len(data._replicas) == 2
    streams = ["cam0", "cam1", "cam2"]
    for engine in (grid, data):
        for s in streams:
            engine.add_stream(s)
    rng = np.random.default_rng(9)
    seen = 0
    for _ in range(3):
        frames = {s: (rng.random((*SMALL_HW, 2)) < 0.4).astype(np.uint8)
                  for s in streams}
        a, b = grid.step(frames), data.step(frames)
        assert a.keys() == b.keys() == set(streams)
        for s in streams:
            np.testing.assert_array_equal(a[s], b[s])
            seen += len(a[s])
    assert seen > 0
    with pytest.raises(ValueError, match="capacity 6 must divide by the "
                                         "mesh size 4"):
        StreamingEngine(model, capacity=6,
                        mesh=make_mesh(["cpu"] * 4, spatial=2))
