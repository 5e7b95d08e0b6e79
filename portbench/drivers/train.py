"""Training throughput: ``Trainer.train_step`` back to back, closed loop.

Set-up builds one model and one trainer from the seed and drives them
through the cell's first ``checked_steps`` steps, through the same call
and on the same pool as the window; those steps' losses, the first
gradient (from Adamax's first moment after one step) and each leaf's
change after them are kept. The window then goes on with the same
objects. After the window (and, traced, a profiled sub-window of
``profile_steps`` steps), the same objects take one more step, the next
of the loop, whose loss and gradient (from the change of Adamax's first
moment) are kept with the weights it started from. Then the reference
repeats the checked steps from the weights and inputs made from the
seed, and that last step from the program's weights after the window:
the one reading that follows the program's own state, so that a path
that changes once the set-up has ended is held too.

Cell keys: ``pool`` (batches cycled), ``checked_steps``,
``profile_steps``, ``schedule`` (``Trainer(time_batched=...)``),
``limits`` (``loss``, ``grad``, ``change``, ``loss_post``,
``grad_post``).
"""

from __future__ import annotations

import time

from portbench.lib import compare, inputs, port, roofline, session
from portbench.lib.harness import Outcome, gate
from portbench.lib.spans import span, wrap
from portbench.reference import detection as D
from portbench.reference import tiny_yolo as R
from portbench.reference import train as RT


def run(ctx: session.Run) -> Outcome:
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    cfg, cell, dev, seed = ctx.config, ctx.cell, ctx.device, ctx.seed
    net = R.Net(cfg["num_classes"], cfg["in_hw"])
    weights = inputs.weights(net.weight_shapes(), seed, dev)
    scales = inputs.scales(net.norms, dev)
    model, leaf_map = port.build_model(cfg, weights, scales, dev)
    trainer = Trainer(time_batched=cell["schedule"], seed=seed,
                      optimizer=cfg["optimizer"])
    trainer.configure(model)
    B, T = cfg["batch_size"], cfg["num_steps"]
    pool = cell["pool"]
    X = inputs.frames(pool, (T, B, *cfg["in_hw"], 2), seed, dev)
    L = inputs.labels(pool, B, cfg["max_labels"], cfg["num_classes"], seed,
                      dev)
    starts = inputs.starts(100_000, cfg["time_window"], seed)
    count = [0]

    def step():
        k = count[0]
        count[0] += 1
        return trainer.train_step(model, X[k % pool], L[k % pool], starts[k])

    params = trainer.opt.params
    p0 = [p.detach().clone() for p in params]
    losses, grad_norms = [], None
    for k in range(cell["checked_steps"]):
        losses.append(float(step()))
        if k == 0:
            grad_norms = step_grad_norms(trainer.opt, params)
    change_norms = [float((p.detach() - q).norm()) for p, q in zip(params, p0)]
    del p0
    session.synchronize(dev)
    ctx.setup_done()

    if ctx.trace:
        wrap(model, "loss", "loss", ctx.spans)
        wrap(model, "forward_seq", "forward", ctx.spans)
        wrap(trainer.opt, "step", "optimizer", ctx.spans)

        def timed_step():
            with span("train_step", ctx.spans):
                step()
    else:
        timed_step = step
    first = count[0]
    t0 = time.perf_counter()
    ticks = [t0]
    while ticks[-1] - t0 < ctx.seconds:
        timed_step()
        ticks.append(time.perf_counter())
    session.synchronize(dev)
    elapsed = time.perf_counter() - t0
    steps = count[0] - first
    e2e = {"train_frames_per_s": steps * B * T / elapsed,
           "setup_s": ctx.setup_s}

    record = busy = window = breakdown = None
    if ctx.trace:
        n = cell["profile_steps"]
        prof_starts = starts[count[0]:count[0] + n]
        trace, win = session.profiled(timed_step, n, dev)
        busy, window, breakdown = session.device_summary(trace, win)
        per_frame = net.conv_flops_per_frame()
        record = {
            "path": "train", "trace": trace, "window": win,
            "spans": ctx.spans, "steps": steps,
            "conv_flops_fwd": n * B * T * per_frame,
            "conv_flops_bwd": sum(2 * B * (T - r) * per_frame
                                  for r in prof_starts),
            "cell_bound_s": sum(roofline.cells_bound_s(
                net.cells, B, T, r, 2, True) for r in prof_starts),
        }
    k = count[0]
    post_batch = (X[k % pool].clone(), L[k % pool].clone())
    post_start = [p.detach().clone() for p in params]
    moments = [trainer.opt.torch.state.get(p, {}).get("exp_avg")
               for p in params]
    moments = [None if m is None else m.clone() for m in moments]
    post_loss = float(step())
    post_grad_norms = step_grad_norms(trainer.opt, params, moments)
    peak = session.memory_peak(dev)
    batches = [(X[k].clone(), L[k].clone())
               for k in range(cell["checked_steps"])]
    del model, trainer, params, step, timed_step, X, L, moments
    session.free(dev)

    t_ref = time.perf_counter()
    anc = D.anchors(net.taps).to(dev)
    ref = RT.train_steps(net, weights, scales, batches,
                         starts[:cell["checked_steps"]], anc,
                         cfg["learning_rate"], cfg["iou_threshold"],
                         cfg["loss_ratio"])
    values = train_values(ref, losses, grad_norms, change_norms, leaf_map,
                          weights, scales)
    w_post, s_post = by_spec(post_start, leaf_map, len(weights))
    del post_start
    ref_post = RT.train_steps(net, w_post, s_post, [post_batch],
                              [starts[k]], anc, cfg["learning_rate"],
                              cfg["iou_threshold"], cfg["loss_ratio"])
    values.update(post_values(ref_post, post_loss, post_grad_norms,
                              leaf_map, len(weights)))
    return Outcome(e2e, steps, 0, gate(values, cell["limits"]), peak, record,
                   busy, window, breakdown, values,
                   time.perf_counter() - t_ref,
                   [b - a for a, b in zip(ticks, ticks[1:])])


def step_grad_norms(opt, params, before=None):
    """Each leaf's gradient as Adamax got it in its last step, from its
    first moment: ``m = b1 m_before + (1 - b1) g``, ``m_before`` 0 for
    the first step or where none was kept (a norm of 0 where the
    optimizer keeps none)."""
    out = []
    for k, p in enumerate(params):
        m = opt.torch.state.get(p, {}).get("exp_avg")
        if m is None:
            out.append(0.0)
            continue
        m = m.double()
        if before is not None and before[k] is not None:
            m = m - RT.B1 * before[k].double()
        out.append(float(m.norm()) / (1 - RT.B1))
    return out


def by_spec(leaves, leaf_map, nw):
    """The program's leaves, in its parameter order, as the reference's
    ``(weights, scales)``."""
    w, s = [None] * nw, [None] * (len(leaves) - nw)
    for (kind, i), x in zip(leaf_map, leaves):
        (w if kind == "w" else s)[i] = x
    return w, s


def post_values(ref, loss, grad_norms, leaf_map, nw):
    """The step after the window against the reference's step from the
    same weights: the loss's relative gap, the worst leaf's gap of
    gradient norms (leaves in the program's parameter order)."""
    index = [i if kind == "w" else nw + i for kind, i in leaf_map]
    ref_grad = [float(ref["first_grads"][i].norm()) for i in index]
    return {"loss_post": compare.rel_gap(loss, ref["losses"][0]),
            "grad_post": compare.leaf_gap(grad_norms, ref_grad)}


def train_values(ref, losses, grad_norms, change_norms, leaf_map, weights,
                 scales):
    """The program's readings against the reference's: the first step's
    loss and the later steps', the first gradient's norm a leaf, each
    leaf's change; the leaves in the program's parameter order."""
    nw = len(weights)
    index = [i if kind == "w" else nw + i for kind, i in leaf_map]
    start = weights + scales
    ref_grad = [float(ref["first_grads"][i].norm()) for i in index]
    ref_change = [float((ref["leaves"][i] - start[i]).norm()) for i in index]
    moved = compare.moved_leaves(ref_grad)
    gaps = [compare.rel_gap(a, b) for a, b in zip(losses, ref["losses"])]
    return {"loss": gaps[0], "loss_later": max(gaps[1:], default=0.0),
            "grad": compare.leaf_gap(grad_norms, ref_grad),
            "change": compare.leaf_gap(change_norms, ref_change, moved)}


def control(ctx: session.Run, steps: int = 0):
    """The control: the reference in TF32 put in the program's place, on
    the cell's checked steps, against the reference."""
    cfg, cell, dev, seed = ctx.config, ctx.cell, ctx.device, ctx.seed
    net = R.Net(cfg["num_classes"], cfg["in_hw"])
    weights = inputs.weights(net.weight_shapes(), seed, dev)
    scales = inputs.scales(net.norms, dev)
    B, T = cfg["batch_size"], cfg["num_steps"]
    n, pool = cell["checked_steps"], cell["pool"]
    X = inputs.frames(pool, (T, B, *cfg["in_hw"], 2), seed, dev)
    L = inputs.labels(pool, B, cfg["max_labels"], cfg["num_classes"], seed,
                      dev)
    starts = inputs.starts(n + 1, cfg["time_window"], seed)
    anc = D.anchors(net.taps).to(dev)
    runs = [RT.train_steps(net, weights, scales, list(zip(X[:n], L[:n])),
                           starts[:n], anc, cfg["learning_rate"], cfg["iou_threshold"],
                           cfg["loss_ratio"], tf32=tf32)
            for tf32 in (True, False)]
    got, ref = runs
    start = weights + scales
    grad = [float(g.norm()) for g in got["first_grads"]]
    change = [float((x - s).norm()) for x, s in zip(got["leaves"], start)]
    leaf_map = [("w", i) for i in range(len(weights))] + \
        [("s", i) for i in range(len(scales))]
    values = train_values(ref, got["losses"], grad, change, leaf_map,
                          weights, scales)
    # the step after the window: one more step from the reference's own
    # state after the checked steps, in TF32 against fp32
    nw = len(weights)
    state = ref["leaves"]
    post = [(X[n % pool], L[n % pool])]
    got, ref = [RT.train_steps(net, state[:nw], state[nw:], post,
                               [starts[n]], anc, cfg["learning_rate"],
                               cfg["iou_threshold"], cfg["loss_ratio"],
                               tf32=tf32)
                for tf32 in (True, False)]
    values.update(post_values(ref, got["losses"][0],
                              [float(g.norm()) for g in got["first_grads"]],
                              leaf_map, nw))
    return values
