"""Checkpoint evaluation: ``Trainer.eval_step`` back to back, closed loop.

Set-up builds the model from the seed, a pool of ``pool`` batches on the
device and the trainer, and runs ``warmup_steps`` eval steps. Each
step's truncation start comes from the seed, every value of the
window once in each block of steps. Every step's loss and detections
are kept on the device. After the window (and, traced, a profiled
sub-window of ``profile_steps`` steps), ``checked_steps`` steps of the
window drawn from the seed are repeated by the reference and compared.

Cell keys: ``pool``, ``schedule``, ``warmup_steps``, ``profile_steps``,
``checked_steps``, ``limits`` (``loss``, ``detections``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib import compare, inputs, port, session
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
    model, _ = port.build_model(cfg, weights, scales, dev)
    trainer = Trainer(time_batched=cell["schedule"], seed=seed)
    B, T = cfg["batch_size"], cfg["num_steps"]
    pool = cell["pool"]
    X = inputs.frames(pool, (T, B, *cfg["in_hw"], 2), seed, dev)
    L = inputs.labels(pool, B, cfg["max_labels"], cfg["num_classes"], seed,
                      dev)
    starts = inputs.starts(100_000, cfg["time_window"], seed)
    outputs = []

    def step():
        k = len(outputs)
        loss, dets = trainer.eval_step(model, X[k % pool], L[k % pool],
                                       starts[k])
        outputs.append((loss, dets))

    for _ in range(cell["warmup_steps"]):
        step()
    session.synchronize(dev)
    ctx.setup_done()

    if ctx.trace:
        wrap(model, "loss", "loss", ctx.spans)
        wrap(model, "detect", "detect", ctx.spans)
        wrap(model, "forward_seq", "forward", ctx.spans)

        def timed_step():
            with span("eval_step", ctx.spans):
                step()
    else:
        timed_step = step
    first = len(outputs)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        timed_step()
    session.synchronize(dev)
    elapsed = time.perf_counter() - t0
    steps = len(outputs) - first
    e2e = {"eval_frames_per_s": steps * B * T / elapsed,
           "setup_s": ctx.setup_s}

    record = busy = window = breakdown = None
    if ctx.trace:
        n = cell["profile_steps"]
        trace, win = session.profiled(timed_step, n, dev)
        busy, window, breakdown = session.device_summary(trace, win)
        record = {
            "path": "eval", "trace": trace, "window": win,
            "spans": ctx.spans, "steps": steps,
            "conv_flops_fwd": n * B * T * net.conv_flops_per_frame(),
        }
    peak = session.memory_peak(dev)
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    due = sorted(int(k) + first for k in rng.choice(
        steps, min(cell["checked_steps"], steps), replace=False))
    got = [(float(outputs[k][0]), outputs[k][1].cpu().numpy()) for k in due]
    batches = [(X[k % pool].clone(), L[k % pool].clone(), starts[k])
               for k in due]
    del model, trainer, step, timed_step, outputs, X, L
    session.free(dev)
    t_ref = time.perf_counter()
    values = eval_values(net, weights, scales, cfg, batches, got, dev)
    return Outcome(e2e, steps, 0, gate(values, cell["limits"]), peak, record,
                   busy, window, breakdown, values,
                   time.perf_counter() - t_ref)


def eval_values(net, weights, scales, cfg, batches, got, dev):
    """The reference's eval steps on the drawn batches against the
    program's loss and detections (foreground rows)."""
    p = R.Params(weights, scales,
                 [torch.zeros(c, device=dev) for c in net.norms],
                 [torch.ones(c, device=dev) for c in net.norms])
    anc = D.anchors(net.taps).to(dev)
    loss_gap = det_gap = 0.0
    for (X, L, r), (loss, dets) in zip(batches, got):
        ref_loss, ref_dets = RT.eval_step(net, p, X, L, r, anc,
                                          cfg["iou_threshold"],
                                          cfg["loss_ratio"])
        loss_gap = max(loss_gap, compare.rel_gap(loss, ref_loss))
        ref_dets = ref_dets.cpu().numpy()
        for a, b in zip(dets, ref_dets):
            det_gap = max(det_gap, compare.detection_gap(
                a[a[:, 0] >= 0], b[b[:, 0] >= 0]))
    return {"loss": loss_gap, "detections": det_gap}


def control(ctx: session.Run, steps: int = 0):
    """The control: the reference in TF32 put in the program's place, on
    the cell's checked steps, against the reference."""
    cfg, cell, dev, seed = ctx.config, ctx.cell, ctx.device, ctx.seed
    net = R.Net(cfg["num_classes"], cfg["in_hw"])
    weights = inputs.weights(net.weight_shapes(), seed, dev)
    scales = inputs.scales(net.norms, dev)
    B, T = cfg["batch_size"], cfg["num_steps"]
    pool = cell["pool"]
    X = inputs.frames(pool, (T, B, *cfg["in_hw"], 2), seed, dev)
    L = inputs.labels(pool, B, cfg["max_labels"], cfg["num_classes"], seed,
                      dev)
    n = cell["checked_steps"]
    starts = inputs.starts(n, cfg["time_window"], seed)
    batches = [(X[k % pool], L[k % pool], starts[k]) for k in range(n)]
    p = R.Params(weights, scales,
                 [torch.zeros(c, device=dev) for c in net.norms],
                 [torch.ones(c, device=dev) for c in net.norms])
    anc = D.anchors(net.taps).to(dev)
    got = []
    for X_, L_, r in batches:
        loss, dets = RT.eval_step(net, p, X_, L_, r, anc,
                                  cfg["iou_threshold"], cfg["loss_ratio"],
                                  tf32=True)
        got.append((loss, dets.cpu().numpy()))
    return eval_values(net, weights, scales, cfg, batches, got, dev)
