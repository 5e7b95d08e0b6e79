"""Ranks of the port on the CPU: gloo processes for the data-parallel tests.

Not a pytest module. ``start_ranks(jobs, world, tmp)`` starts ``world``
processes of this script and returns at once, so that a test computes
its JAX reference while the ranks run; each rank joins a gloo group
through a ``file://`` store in ``tmp`` (no port to clash on between
xdist workers), runs ``torch.set_num_threads(1)``, imports only torch,
numpy and the port, runs every job of ``jobs`` in order and saves its
results, which ``Ranks.results`` returns rank by rank once they end.

A job is ``(case, kwargs)``; the cases are the ``case_*`` functions
below.
"""

import os
import pickle
import subprocess
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600


class Ranks:
    """``world`` rank processes running ``jobs``."""

    def __init__(self, jobs, world, tmp, timeout_s=None):
        self.dir = os.path.join(str(tmp), f"ranks_{world}_{os.getpid()}_"
                                f"{id(self)}")
        os.makedirs(self.dir)
        with open(os.path.join(self.dir, "jobs.pkl"), "wb") as f:
            pickle.dump(jobs, f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [REPO, os.environ.get("PYTHONPATH", "")]))
        self.world = world
        self.procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), self.dir,
                 str(r), str(world)]
                + ([] if timeout_s is None else [str(timeout_s)]),
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            for r in range(world)]

    def results(self, ended_ok=True):
        """Every rank's results (a list a rank, one entry a job).
        ``ended_ok=False``: for jobs that leave the group broken, so that
        the ranks' closing barrier fails: every rank must have saved its
        results, whatever its exit code."""
        outs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=TIMEOUT_S)
                outs.append(out)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0 or not ended_ok, \
                f"rank {r} failed:\n{out[-6000:]}"
        got = []
        for r, out in enumerate(outs):
            path = os.path.join(self.dir, f"rank{r}.pkl")
            assert os.path.exists(path), f"rank {r} saved nothing:\n" \
                f"{out[-6000:]}"
            with open(path, "rb") as f:
                got.append(pickle.load(f))
        return got


def start_ranks(jobs, world, tmp, timeout_s=None) -> Ranks:
    """``timeout_s``: the process group's timeout (``distributed.
    initialize``'s default when ``None``)."""
    return Ranks(jobs, world, tmp, timeout_s)


# ---- what a rank runs ----


def micro_soda():
    """The ``MicroSODa`` of tests/test_detector.py over the port's spec
    (tests/test_torch_megakernel.py::micro_soda, without JAX)."""
    from snn_for_object_detection_tpu_torch.models import spec as S
    from snn_for_object_detection_tpu_torch.models.detector import SODa

    class MicroSODa(SODa):
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

    return MicroSODa


def port_model(params, stats, in_hw, time_window, state_dtype="float32",
               s2d_stem=False):
    import torch

    from snn_for_object_detection_tpu_torch.models.convert import (
        load_jax_params,
    )

    model = micro_soda()(num_classes=2, in_hw=in_hw, time_window=time_window,
                         state_dtype=getattr(torch, state_dtype),
                         s2d_stem=s2d_stem, device="cpu")
    load_jax_params(model, params, stats)
    return model


def _numpy(named):
    return {n: t.detach().numpy().copy() for n, t in named}


def case_train(params, stats, in_hw, time_window, configs, batches, starts):
    """For each (schedule, state dtype) of ``configs``: ``Trainer(mesh=
    make_mesh())`` from the given weights through every global batch of
    ``batches`` (this rank's rows), with the given starts. Returns per
    config the losses, the first step's gradients as the optimizer saw
    them, the running statistics after it, and the weights after every
    step."""
    import numpy as np
    import torch

    from snn_for_object_detection_tpu_torch.parallel import distributed
    from snn_for_object_detection_tpu_torch.parallel import make_mesh
    from snn_for_object_detection_tpu_torch.train.loop import Trainer, _stats

    out = {}
    for schedule, state_dtype in configs:
        model = port_model(params, stats, in_hw, time_window, state_dtype)
        trainer = Trainer(mesh=make_mesh(), seed=0, time_batched=schedule,
                          prefetch_batches=0)
        trainer.configure(model)
        seen = []
        step = trainer.opt.step

        def record(grads, step=step):
            if not seen:
                seen.append([g.clone() for g in grads])
            return step(grads)

        trainer.opt.step = record
        losses, weights, stats0 = [], [], None
        for (X, lab), r in zip(batches, starts):
            x = distributed.local_rows(torch.from_numpy(X), 1)
            y = distributed.local_rows(torch.from_numpy(lab), 0)
            losses.append(float(trainer.train_step(model, x, y, r)))
            if stats0 is None:
                stats0 = _numpy(_stats(model).items())
            weights.append(_numpy(model.named_parameters()))
        names = [n for n, _ in model.named_parameters()]
        out[schedule, state_dtype] = {
            "losses": np.asarray(losses),
            "grads": {n: g.numpy() for n, g in zip(names, seen[0])},
            "stats": stats0,
            "weights": weights,
        }
    return out


def case_norm(x, form, start):
    """A train-mode Norm (no bias, identity affine, zero / unit running
    stats) on this rank's rows of ``x`` inside the global batch: its
    output rows and new running statistics."""
    import torch

    from snn_for_object_detection_tpu_torch.models import compile as C
    from snn_for_object_detection_tpu_torch.models import spec as S
    from snn_for_object_detection_tpu_torch.parallel import distributed

    axis = 0 if form == "step" else 1
    ch, hw = x.shape[-1], x.shape[-3:-1]
    block = C.compile_block([S.Norm()], ch, hw)
    local = distributed.local_rows(torch.from_numpy(x), axis)
    ctx = C.Ctx(train=True, start_step=start,
                batch_group=torch.distributed.group.WORLD)
    state = block.init_state(local.shape[axis], "cpu")
    fn = block.step if form == "step" else block.seq
    y, new = fn(local, state, ctx)
    mean, var = new["b0"]["l0"]
    return {"y": y.detach().numpy(), "mean": mean.numpy(),
            "var": var.numpy()}


def case_eval(params, stats, in_hw, time_window, batches, schedule):
    """``Trainer(mesh=make_mesh()).test`` on this rank's rows of each
    global batch, and the detections of each of its eval steps."""
    import torch

    from snn_for_object_detection_tpu_torch.parallel import distributed
    from snn_for_object_detection_tpu_torch.parallel import make_mesh
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    model = port_model(params, stats, in_hw, time_window)
    local = [(distributed.local_rows(X, 1), distributed.local_rows(lab, 0))
             for X, lab in batches]
    trainer = Trainer(mesh=make_mesh(), seed=0, time_batched=schedule,
                      limit_test_batches=len(batches))
    dets = []
    step = trainer.eval_step

    def record(*args):
        loss, d = step(*args)
        dets.append(d.numpy().copy())
        return loss, d

    trainer.eval_step = record
    metrics = trainer.test(model, iter(local))
    return {"metrics": metrics, "dets": dets}


def _grid_rows(mesh, X, labels):
    """This rank's block of a global batch on a ``(data, space)`` grid:
    its data block's rows of B (frames and labels) and its space
    block's rows of H (frames)."""
    import torch

    from snn_for_object_detection_tpu_torch.parallel import data_extent

    n, d = data_extent(mesh), mesh.data_index
    per = X.shape[1] // n
    X = torch.from_numpy(X[:, d * per:(d + 1) * per])
    lo, hi = mesh.space_ctx.block(X.shape[2])
    return (X[:, :, lo:hi].contiguous(),
            torch.from_numpy(labels[d * per:(d + 1) * per]))


def case_spatial_train(params, stats, in_hw, spatial, schedules, X, labels,
                       s2d_stem=False):
    """One train step of ``Trainer(mesh=make_mesh(spatial=spatial))`` a
    schedule, from start 0 on this rank's block of the global batch:
    the loss, the gradients as the optimizer saw them, the running
    statistics and the weights after the Adamax step; and the grid's
    shape."""
    import numpy as np

    from snn_for_object_detection_tpu_torch.parallel import (
        data_extent,
        make_mesh,
    )
    from snn_for_object_detection_tpu_torch.train.loop import Trainer, _stats

    mesh = make_mesh(spatial=spatial)
    data = types.SimpleNamespace(host_id=0, num_hosts=1)
    Trainer(mesh=mesh)._sync_data_sharding(data)
    out = {"shape": mesh.shape, "data_extent": data_extent(mesh),
           "data_index": mesh.data_index, "space_rank": mesh.space_rank,
           "shard": (data.host_id, data.num_hosts)}
    x, y = _grid_rows(mesh, X, labels)
    for schedule in schedules:
        model = port_model(params, stats, in_hw, 0, s2d_stem=s2d_stem)
        trainer = Trainer(mesh=mesh, seed=0, time_batched=schedule,
                          prefetch_batches=0)
        trainer.configure(model)
        seen = []
        step = trainer.opt.step

        def record(grads, step=step):
            seen.append([g.clone() for g in grads])
            return step(grads)

        trainer.opt.step = record
        loss = float(trainer.train_step(model, x, y, 0))
        names = [n for n, _ in model.named_parameters()]
        out[schedule] = {
            "losses": np.asarray([loss]),
            "grads": {n: g.numpy() for n, g in zip(names, seen[0])},
            "stats": _numpy(_stats(model).items()),
            "weights": [_numpy(model.named_parameters())],
        }
    return out


def case_halo(H, cases, seed):
    """``halo.fetch_rows`` on this rank's block of a seeded global map
    ``[2, H, 3, 2]`` (float64) over the space group of a ``make_mesh(
    spatial=4)`` grid, for each ``(kind, k, s)`` of ``cases``: the rows
    of a k x k conv at stride s (``"conv"``), of a 2x Up (``"up"``) or a
    2x2 Pool (``"pool"``) over the balanced output blocks; then the
    backward of ``(out * w).sum()`` with a seeded ``w`` a rank. Returns
    per case the rows fetched, their range and the input's gradient."""
    import torch

    from snn_for_object_detection_tpu_torch.parallel import (
        fetch_rows,
        make_mesh,
        row_blocks,
    )

    mesh = make_mesh(spatial=4)
    space = mesh.space_ctx
    full = torch.randn((2, H, 3, 2), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(seed))
    lo, hi = space.block(H)
    out = {}
    for kind, k, s in cases:
        if kind == "conv":
            rows_out = (H + 2 * (k // 2) - k) // s + 1
            blocks = row_blocks(rows_out, 4)

            def want(j, blocks=blocks, k=k, s=s):
                return (blocks[j][0] * s - k // 2,
                        (blocks[j][1] - 1) * s - k // 2 + k)
        elif kind == "up":
            blocks = row_blocks(H * 2, 4)

            def want(j, blocks=blocks):
                return (blocks[j][0] // 2, (blocks[j][1] - 1) // 2 + 1)
        else:
            blocks = row_blocks(H // s, 4)

            def want(j, blocks=blocks, s=s):
                return (blocks[j][0] * s, blocks[j][1] * s)
        x = full[:, lo:hi].clone().requires_grad_(True)
        y = fetch_rows(x, H, want, space)
        w = torch.randn(y.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(
                            seed + 1 + space.index))
        (y * w).sum().backward()
        out[kind, k, s] = {"rows": y.detach().numpy(),
                           "want": want(space.index), "block": (lo, hi),
                           "grad": x.grad.numpy()}
    return out


def space_layers_block():
    """Conv 3x3 s1, average Pool 2, Conv 3x3 s2, nearest Up 2, Conv 1x1,
    max Pool 2 over a [*, 30, 8, 3] map (30, 15, 8, 16, 16, 8 rows),
    float64, weights from a seeded generator."""
    import torch

    from snn_for_object_detection_tpu_torch.models import compile as C
    from snn_for_object_detection_tpu_torch.models import spec as S

    block = C.compile_block(
        [S.Conv(6, 3, 1), S.Pool("A", 2), S.Conv(6, 3, 2), S.Up(2),
         S.Conv(5, 1, 1), S.Pool("M", 2)], 3, (30, 8)).double()
    generator = torch.Generator().manual_seed(3)
    for m in block.modules():
        if isinstance(m, C.Conv):
            m.reset_parameters(generator)
    return block


def case_space_layers(x, w):
    """``space_layers_block`` on this rank's block of ``x [2, 30, 8, 3]``
    (B along ``data``, H along ``space`` of a ``make_mesh(spatial=4)``
    grid): its output rows, and after the backward of ``(out * w).sum()``
    (this rank's rows of ``w``) the input's gradient and the convs'
    weight gradients (this rank's share)."""
    import torch

    from snn_for_object_detection_tpu_torch.models import compile as C
    from snn_for_object_detection_tpu_torch.parallel import make_mesh

    mesh = make_mesh(spatial=4)
    space = mesh.space_ctx
    d = mesh.data_index
    lo, hi = space.block(x.shape[1])
    local = torch.from_numpy(x[d:d + 1, lo:hi].copy()).requires_grad_(True)
    block = space_layers_block()
    y, _ = block.step(local, block.init_state(1, "cpu", space),
                      C.Ctx(space=space))
    a, b = space.block(w.shape[1])
    (y * torch.from_numpy(w[d:d + 1, a:b].copy())).sum().backward()
    return {"y": y.detach().numpy(), "rows": (a, b), "data": d,
            "grad": local.grad.numpy(), "in_rows": (lo, hi),
            "w_grads": {n: p.grad.numpy()
                        for n, p in block.named_parameters()}}


def case_moments(sums, perms):
    """``compile.global_moments`` over every rank of ``x [1, 1, 2, C]``:
    channel c of rank r holds ``sums[perms[c][r]]`` and a zero, so the
    ranks' fp32 sums are those values in the order ``perms[c]``. Returns
    the mean and the variance."""
    import numpy as np
    import torch

    from snn_for_object_detection_tpu_torch.models import compile as C
    from snn_for_object_detection_tpu_torch.parallel import distributed

    r, world = distributed.rank(), distributed.world_size()
    x = torch.zeros((1, 1, 2, len(perms)), dtype=torch.float32)
    for c, perm in enumerate(perms):
        x[0, 0, 0, c] = float(np.float32(sums[perm[r]]))
    mean, var = C.global_moments(x, (0, 1, 2), torch.distributed.group.WORLD,
                                 2 * world)
    return {"mean": mean.flatten().numpy(), "var": var.flatten().numpy()}


def case_space_norm(x, form):
    """A train-mode Norm on this rank's block of ``x`` (B along
    ``data``, H along ``space`` in uneven blocks) of a ``make_mesh(
    spatial=4)`` grid, with the grid as its group: the output block and
    the new running statistics."""
    import torch

    from snn_for_object_detection_tpu_torch.models import compile as C
    from snn_for_object_detection_tpu_torch.models import spec as S
    from snn_for_object_detection_tpu_torch.parallel import (
        data_extent,
        make_mesh,
    )

    mesh = make_mesh(spatial=4)
    space = mesh.space_ctx
    bdim = 0 if form == "step" else 1
    per = x.shape[bdim] // data_extent(mesh)
    d = mesh.data_index
    lo, hi = space.block(x.shape[bdim + 1])
    local = torch.from_numpy(x).narrow(bdim, d * per, per).narrow(
        bdim + 1, lo, hi - lo).contiguous()
    block = C.compile_block([S.Norm()], x.shape[-1], x.shape[-3:-1])
    ctx = C.Ctx(train=True, batch_group=mesh.group, space=space)
    fn = block.step if form == "step" else block.seq
    y, new = fn(local, block.init_state(per, "cpu", space), ctx)
    mean, var = new["b0"]["l0"]
    return {"y": y.detach().numpy(), "mean": mean.numpy(),
            "var": var.numpy(), "data": d, "rows": (lo, hi)}


def case_spatial_eval(params, stats, in_hw, time_window, batches, schedule):
    """``Trainer(mesh=make_mesh(spatial=world)).test`` with the whole
    batch on every rank (one data block) and each rank's rows of H:
    the metrics and the detections of each eval step."""
    from snn_for_object_detection_tpu_torch.parallel import (
        distributed,
        make_mesh,
    )
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    import numpy as np

    from snn_for_object_detection_tpu_torch.parallel import (
        prefetch_to_device,
        shard_batch,
    )

    model = port_model(params, stats, in_hw, time_window)
    mesh = make_mesh(spatial=distributed.world_size())
    prefetched = list(prefetch_to_device(iter(batches), mesh, size=2))
    placed = [shard_batch(mesh, X, lab) for X, lab in batches]
    same = all(np.array_equal(a.numpy(), b.numpy())
               for p, q in zip(prefetched, placed) for a, b in zip(p, q))
    trainer = Trainer(mesh=mesh, seed=0, time_batched=schedule,
                      limit_test_batches=len(batches))
    dets = []
    step = trainer.eval_step

    def record(*args):
        loss, d = step(*args)
        dets.append(d.numpy().copy())
        return loss, d

    trainer.eval_step = record
    metrics = trainer.test(model, iter(batches))
    return {"metrics": metrics, "dets": dets, "prefetch_same": same,
            "rows": int(prefetched[0][0].shape[2])}


def case_fit(data_dir, out_dir, time_window):
    """The two-host ``fit`` of tests/distributed_worker.py on the port: a
    GEN1 synthetic set, B=2 a rank, T=4, one epoch of 2 batches and one
    validation."""
    import torch

    from snn_for_object_detection_tpu_torch.data import PropheseeDataModule
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    saves = []
    save = torch.save

    def counted(*args, **kwargs):  # the checkpoints this rank writes
        saves.append(args[1])
        return save(*args, **kwargs)

    torch.save = counted
    data = PropheseeDataModule(
        dataset="gen1", data_dir=data_dir, batch_size=2, num_steps=4,
        time_shift=2, num_workers=1, num_load_file=1)
    model = micro_soda()(num_classes=2, in_hw=(data.height, data.width),
                         time_window=time_window, device="cpu")
    trainer = Trainer(max_epochs=1, min_epochs=0, limit_train_batches=2,
                      limit_val_batches=1, check_val_every_n_epoch=1,
                      out_dir=out_dir, log_every_n_steps=1)
    result = trainer.fit(model, data)
    return {"host_id": data.host_id, "num_hosts": data.num_hosts,
            "best_metric": float(result["best_metric"]),
            "step": int(result["step"]), "saves": len(saves),
            "weights": _numpy(model.named_parameters())}


def case_fit_logged(data_dir, out_dir, logger):
    """A one-batch ``fit`` with tracker back ends (``logger``), each rank
    in its own ``out_dir/rank<r>``; returns the files under it."""
    from snn_for_object_detection_tpu_torch.data import PropheseeDataModule
    from snn_for_object_detection_tpu_torch.parallel import distributed
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    out_dir = os.path.join(out_dir, f"rank{distributed.rank()}")
    data = PropheseeDataModule(
        dataset="gen1", data_dir=data_dir, batch_size=1, num_steps=3,
        time_shift=2, num_workers=1, num_load_file=1)
    model = micro_soda()(num_classes=2, in_hw=(data.height, data.width),
                         time_window=0, device="cpu")
    Trainer(max_epochs=1, min_epochs=0, limit_train_batches=1,
            limit_val_batches=1, check_val_every_n_epoch=1,
            out_dir=out_dir, log_every_n_steps=1, logger=logger,
            prefetch_batches=0).fit(model, data)
    return {"files": sorted(
        os.path.relpath(os.path.join(root, f), out_dir)
        for root, _, files in os.walk(out_dir) for f in files)}


def case_auto(in_hw, failing_rank, times):
    """``time_batched="auto"`` with ``loop.time_call`` stubbed: rank
    ``failing_rank`` runs out of memory on the hybrid schedule, and the
    other schedules take ``times[rank][schedule]`` seconds. Returns the
    schedule the train step pinned and the merged timings."""
    import numpy as np
    import torch

    from snn_for_object_detection_tpu_torch.parallel import distributed
    from snn_for_object_detection_tpu_torch.parallel import make_mesh
    from snn_for_object_detection_tpu_torch.train import loop

    rank = distributed.rank()
    order = iter(loop.SCHEDULES)  # the order the trainer times them

    def time_call(fn, device, reps=2):
        schedule = next(order)
        if rank == failing_rank and schedule == "hybrid":
            raise torch.OutOfMemoryError("forced on this rank")
        return times[rank][schedule]

    loop.time_call = time_call
    model = micro_soda()(num_classes=2, in_hw=in_hw, time_window=0,
                         device="cpu")
    trainer = loop.Trainer(mesh=make_mesh(), time_batched="auto",
                           prefetch_batches=0)
    trainer.configure(model)
    rng = np.random.default_rng(rank)
    X = torch.from_numpy(
        (rng.random((2, 1, *in_hw, 2)) < 0.3).astype(np.float32))
    trainer.train_step(model, X, torch.full((1, 2, 5), -1.0), 0)
    return {"schedule": trainer._auto_schedule["train"],
            "timings": trainer.schedule_timings["train"]}


# ---- the layers that split, fused eval, the Trainer's grid ----


def grid_leaves(S):
    """The leaves of tests/test_torch_spatial_layers.py, each put after
    the stride-2 spiking stem of :func:`leaf_net`: the layers that raised
    under a space axis before they split."""
    return {
        "pool_max_k3s2": [S.Pool("M", 3, 2)],
        "pool_avg_k3s2": [S.Pool("A", 3, 2)],
        "pool_sum_k3s2": [S.Pool("S", 3, 2)],
        "up_bilinear": [S.Up(2, "bilinear"), S.Pool("A")],
        "up_bicubic": [S.Up(2, "bicubic"), S.Pool("A")],
        "lstm_k3": [S.LSTM(hidden_size=6, kernel_size=3)],
    }


def leaf_net(S, base, leaf):
    """tests/test_torch_zoo.py's two-scale net with ``leaf`` (a list of
    specs) after the stride-2 spiking stem."""

    class LeafNet(base):
        def backbone_cfgs(self):
            return [S.Conv(8, 3, 2), S.Norm(), S.LIF(), *leaf]

        def neck_cfgs(self):
            return [S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
                    S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return()]

        def head_cfgs(self, box_out, cls_out):
            return [[S.Conv(kernel_size=1), S.Norm(), S.LI(), S.Tanh()],
                    [S.Conv(box_out, 1)], [S.Conv(cls_out, 1)]]

    return LeafNet


def state_leaves(state):
    """State leaves in JAX's pytree order (sorted dict keys)."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in state_leaves(state[k])]
    return list(state)


def _eval_on_grid(model, x, space, **kw):
    """``forward_seq`` in eval from start 0 on this rank's rows: the
    predictions and this rank's rows of each final state leaf."""
    import torch

    with torch.no_grad():
        (cls, box), state = model.forward_seq(x, space=space, **kw)
    return {"preds": (cls.numpy(), box.numpy()),
            "state": [t.float().numpy() for t in state_leaves(state)]}


def case_grid_leaf(leaf, params, stats, in_hw, X, labels):
    """The net of ``leaf`` (:func:`leaf_net`, :func:`grid_leaves`) with
    the given weights on a ``make_mesh(spatial=world)`` grid, on this
    rank's rows of H of the batch: one time-batched train step from
    start 0 (the loss, the gradients as the optimizer saw them, the
    running statistics), then the eval forward (:func:`_eval_on_grid`)
    on the weights as given."""
    import torch

    from snn_for_object_detection_tpu_torch.models import spec as S
    from snn_for_object_detection_tpu_torch.models.convert import (
        load_jax_params,
    )
    from snn_for_object_detection_tpu_torch.models.detector import SODa
    from snn_for_object_detection_tpu_torch.parallel import (
        distributed,
        make_mesh,
    )
    from snn_for_object_detection_tpu_torch.train.loop import Trainer, _stats

    mesh = make_mesh(spatial=distributed.world_size())
    x, y = _grid_rows(mesh, X, labels)

    def build():
        model = leaf_net(S, SODa, grid_leaves(S)[leaf])(
            num_classes=2, in_hw=in_hw, time_window=0, device="cpu")
        load_jax_params(model, params, stats)
        return model

    out = _eval_on_grid(build(), x, mesh.space_ctx)
    model = build()
    trainer = Trainer(mesh=mesh, seed=0, time_batched=True,
                      prefetch_batches=0)
    trainer.configure(model)
    seen = []
    step = trainer.opt.step

    def record(grads):
        seen.append([g.clone() for g in grads])
        return step(grads)

    trainer.opt.step = record
    out["loss"] = float(trainer.train_step(model, x, y, 0))
    out["grads"] = {n: g.numpy() for (n, _), g in
                    zip(model.named_parameters(), seen[0])}
    out["stats"] = _numpy(_stats(model).items())
    out["rows"] = mesh.space_ctx.block(X.shape[2])
    return out


def case_grid_eval(params, stats, in_hw, X, s2d_stem=False, fuse=False):
    """``MicroSODa`` (``fuse_seq=fuse``, window 0) with the given weights
    (int8 leaves make its int8 convs) on a ``make_mesh(spatial=world)``
    grid: :func:`_eval_on_grid` on this rank's rows of ``X``; with
    ``fuse`` also the unfused schedule on the grid, and the ``pad_h`` of
    every ``spiking_conv_seq`` call of the fused one."""
    import torch

    from snn_for_object_detection_tpu_torch.models.convert import (
        load_jax_params,
    )
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels
    from snn_for_object_detection_tpu_torch.ops import quantize
    from snn_for_object_detection_tpu_torch.parallel import (
        distributed,
        make_mesh,
    )

    mesh = make_mesh(spatial=distributed.world_size())
    lo, hi = mesh.space_ctx.block(X.shape[2])
    x = torch.from_numpy(X[:, :, lo:hi].copy())
    model = micro_soda()(num_classes=2, in_hw=in_hw, time_window=0,
                         s2d_stem=s2d_stem, fuse_seq=fuse, device="cpu")
    load_jax_params(model, params, stats)
    plain = cuda_kernels.spiking_conv_seq_reference
    pads = []

    def spy(*args, pad_h=None, **kwargs):
        pads.append(pad_h)
        return plain(*args, pad_h=pad_h, **kwargs)

    cuda_kernels.spiking_conv_seq_reference = spy
    quantize.CALLS.update(int_mm=0, plain=0)
    try:
        out = _eval_on_grid(model, x, mesh.space_ctx)
    finally:
        cuda_kernels.spiking_conv_seq_reference = plain
    out.update(pads=pads, int8_calls=dict(quantize.CALLS), rows=(lo, hi))
    if fuse:
        out["unfused"] = _eval_on_grid(model, x, mesh.space_ctx, fuse=False)
    return out


class GridData:
    """A data module of one global batch ``(X, labels)``: a rank's train
    loader yields its data block's rows of B (whole H: the trainer's
    placement keeps the rank's rows) ``batches`` times."""

    def __init__(self, X, labels, batches=1):
        self.X, self.labels, self.batches = X, labels, batches
        self.host_id, self.num_hosts = 0, 1
        self.batch_size = X.shape[1]

    def train_loader(self):
        per = self.X.shape[1] // self.num_hosts
        rows = slice(self.host_id * per, (self.host_id + 1) * per)
        return iter([(self.X[:, rows], self.labels[rows])] * self.batches)

    def val_loader(self):
        return iter([])


def case_trainer_grid(params, stats, in_hw, X, labels, out_dir):
    """``Trainer(spatial_devices=k)`` over the world's ranks: the grid
    ``mesh_for`` builds for each ``k`` (or its ``ValueError``), with
    ``LOCAL_WORLD_SIZE`` saying the ranks span two hosts, and what
    ``request_mesh_reshape`` queues; then one epoch of ``fit`` with
    ``spatial_devices=2`` from the given weights, a reshape queued and a
    ``reshape_request`` file written (by rank 0) first: what this rank
    printed, whether the file is left and the weights after the step."""
    import contextlib
    import io

    import torch

    from snn_for_object_detection_tpu_torch.parallel import distributed
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    world = distributed.world_size()
    out = {"shapes": {}, "errors": {}, "reshape": {}}
    for k in range(1, world + 1):
        try:
            mesh = Trainer(spatial_devices=k).mesh_for(torch.device("cpu"))
            out["shapes"][k] = (mesh.shape, mesh.data_index,
                                mesh.space_rank)
        except ValueError as e:
            out["errors"][k] = str(e)
    os.environ["LOCAL_WORLD_SIZE"] = str(world // 2)
    try:
        Trainer(spatial_devices=2).mesh_for(torch.device("cpu"))
    except ValueError as e:
        out["errors"]["hosts"] = str(e)
    out["one_host_data_parallel"] = Trainer().mesh_for(
        torch.device("cpu")).shape
    del os.environ["LOCAL_WORLD_SIZE"]
    trainer = Trainer(spatial_devices=2)
    for n in (2, world, 3, world + 1):
        try:
            trainer.request_mesh_reshape(num_devices=n)
            out["reshape"][n] = trainer._pending_mesh.shape
        except ValueError as e:
            out["reshape"][n] = str(e)

    model = port_model(params, stats, in_hw, 0)
    trainer = Trainer(spatial_devices=2, max_epochs=1,
                      limit_train_batches=1, check_val_every_n_epoch=5,
                      out_dir=out_dir, seed=0, time_batched=True)
    request = os.path.join(out_dir, "reshape_request")
    if distributed.is_primary():
        os.makedirs(out_dir, exist_ok=True)
        with open(request, "w") as f:
            f.write("2")
    distributed.barrier("request written")
    trainer.request_mesh_reshape(num_devices=2)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = trainer.fit(model, GridData(X, labels))
    out.update(printed=printed.getvalue(), left=os.path.exists(request),
               pending=trainer._pending_mesh, step=result["step"],
               fit_shape=trainer._mesh.shape,
               weights=_numpy(model.named_parameters()))
    return out


def case_grid_auto(params, stats, in_hw, X, labels, fail=None):
    """``time_batched="auto"`` on a ``make_mesh(spatial=world)`` grid: the
    schedule each mode pins and the merged timings, from one train and
    one eval step on this rank's rows. ``fail``: rank 1 runs out of
    memory on the hybrid schedule of both modes, placing its copy of the
    model (``"placing"``: the ranks agree before the step that no rank
    runs it) or once the timed step, collectives and all, is done
    (``"timing"``: the ranks' notes disqualify it after)."""
    import copy

    import torch

    from snn_for_object_detection_tpu_torch.parallel import (
        distributed,
        make_mesh,
    )
    from snn_for_object_detection_tpu_torch.train import loop

    mesh = make_mesh(spatial=distributed.world_size())
    x, y = _grid_rows(mesh, X, labels)
    order = iter(loop.SCHEDULES * 2)  # the train step's, then the eval's
    saved = loop.copy, loop.time_call
    failing = fail is not None and distributed.rank() == 1

    def placing(obj):  # the trainer's copy.deepcopy
        if next(order) == "hybrid":
            raise torch.OutOfMemoryError("forced on this rank")
        return copy.deepcopy(obj)

    def timing(fn, device, reps=2):
        seconds = saved[1](fn, device, reps)
        if next(order) == "hybrid":
            raise torch.OutOfMemoryError("forced on this rank")
        return seconds

    model = port_model(params, stats, in_hw, 0)
    trainer = loop.Trainer(mesh=mesh, time_batched="auto",
                           prefetch_batches=0)
    trainer.configure(model)
    if failing and fail == "placing":
        loop.copy = types.SimpleNamespace(deepcopy=placing)
    if failing and fail == "timing":
        loop.time_call = timing
    try:
        trainer.train_step(model, x, y, 0)
        trainer.eval_step(model, x, y, 0)
    finally:
        loop.copy, loop.time_call = saved
    return {"schedules": dict(trainer._auto_schedule),
            "timings": trainer.schedule_timings}


def case_grid_auto_rank_fails(params, stats, in_hw, X, labels, error):
    """``time_batched="auto"`` on a ``make_mesh(spatial=world)`` grid
    where rank 1 raises ``error`` (a class) inside the first schedule's
    measured train step, between two collectives: at its second halo
    fetch, after the first exchanged its rows. Returns this rank's error
    (``"<type>: <message>"``, or ``None``), the seconds from the start of
    the train step to it, and the schedules pinned."""
    import time

    from snn_for_object_detection_tpu_torch.models import compile as C
    from snn_for_object_detection_tpu_torch.parallel import (
        distributed,
        make_mesh,
    )
    from snn_for_object_detection_tpu_torch.train import loop

    mesh = make_mesh(spatial=distributed.world_size())
    x, y = _grid_rows(mesh, X, labels)
    model = port_model(params, stats, in_hw, 0)
    trainer = loop.Trainer(mesh=mesh, time_batched="auto",
                           prefetch_batches=0)
    trainer.configure(model)
    fetch, calls = C.fetch_rows, []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise error("forced on this rank between two exchanges")
        return fetch(*args, **kwargs)

    if distributed.rank() == 1:
        C.fetch_rows = failing
    t0 = time.perf_counter()
    try:
        trainer.train_step(model, x, y, 0)
        err = None
    except Exception as e:  # the outcome under test, whatever it is
        err = f"{type(e).__name__}: {e}"
    finally:
        C.fetch_rows = fetch
    return {"error": err, "seconds": time.perf_counter() - t0,
            "schedules": dict(trainer._auto_schedule)}


def main(job_dir, rank, world, timeout_s=None):
    import torch

    torch.set_num_threads(1)
    from snn_for_object_detection_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{os.path.join(job_dir, 'store')}",
                           num_processes=world, process_id=rank,
                           device="cpu",
                           **({} if timeout_s is None
                              else {"timeout_s": timeout_s}))
    with open(os.path.join(job_dir, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    results = [globals()[f"case_{case}"](**kwargs) for case, kwargs in jobs]
    with open(os.path.join(job_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    distributed.barrier("done")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
         *map(float, sys.argv[4:5]))


def __getattr__(name):
    """``torch_rank_worker.MicroSODa``, a ``class_path`` for the CLI."""
    if name == "MicroSODa":
        return micro_soda()
    raise AttributeError(name)
