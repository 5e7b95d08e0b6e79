"""Multi-camera serving: ``StreamingEngine.step`` back to back, closed loop.

Set-up builds the model from the seed, the engine (pipelined, uint8
frames) at the cell's ``capacity`` with every slot's stream attached, and a pool of ``pool``
event frames made on the device and kept on the host (making frames on
the host inside the window would pace it); then ``warmup_steps`` engine
steps. Stream ``k`` sends frame ``(stride * k + t) % pool`` at step
``t``. Every ``churn_every`` steps the oldest stream leaves and a new
one joins, so a stream's warm-up frames recur.

A camera-frame's latency runs from the ``step()`` call that handed it in
to the return of the call that gave back its detections: the next call.
The window ends with the engine flushed.

After the window (and, traced, a profiled sub-window of
``profile_steps`` steps), the reference replays every stream attached at
the end, each in its slot's batch row, from the step it joined: the
replay runs the engine's batch of ``capacity`` rows, so that each conv
sums in the order the engine's does. Their detections at
``checked_frames`` frames drawn from the seed are compared with the
engine's, and their carried state after the last step with the
engine's.

Cell keys: ``capacity``, ``pool``, ``stride``,
``churn_every``, ``warmup_steps``, ``profile_steps``,
``checked_frames``, ``limits`` (``detections``, ``state``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib import compare, inputs, port, roofline, session
from portbench.lib.harness import Outcome, gate
from portbench.lib.spans import wrap
from portbench.reference import detection as D
from portbench.reference import tiny_yolo as R


class Traffic:
    """The streams: which are attached, what each sends, and what came
    back for it."""

    def __init__(self, cell, pool):
        self.cell, self.pool = cell, pool
        self.joined = {}        # stream id -> (index k, first step)
        self.next_k = 0
        self.t = 0              # the step being taken
        self.outputs = {}       # step -> {stream id: detections}

    def frames(self):
        n, stride = len(self.pool), self.cell["stride"]
        return {sid: self.pool[(stride * k + self.t) % n]
                for sid, (k, _) in self.joined.items()}

    def join(self, engine, at: int):
        sid = f"cam{self.next_k}"
        engine.add_stream(sid)
        self.joined[sid] = (self.next_k, at)
        self.next_k += 1

    def churn(self, engine):
        """After step ``t``: every ``churn_every`` steps the oldest
        stream leaves and a new one joins from step ``t + 1``."""
        if (self.t + 1) % self.cell["churn_every"] == 0:
            oldest = min(self.joined, key=lambda s: self.joined[s])
            engine.remove_stream(oldest)
            del self.joined[oldest]
            self.join(engine, self.t + 1)


def run(ctx: session.Run) -> Outcome:
    from snn_for_object_detection_tpu_torch.serve import StreamingEngine

    cfg, cell, dev, seed = ctx.config, ctx.cell, ctx.device, ctx.seed
    net = R.Net(cfg["num_classes"], cfg["in_hw"])
    weights = inputs.weights(net.weight_shapes(), seed, dev)
    scales = inputs.scales(net.norms, dev)
    model, _ = port.build_model(cfg, weights, scales, dev)
    engine = StreamingEngine(model, capacity=cell["capacity"],
                             pipelined=True, frame_dtype="uint8")
    pool = inputs.frames(cell["pool"], (*cfg["in_hw"], 2), seed,
                         dev).cpu().numpy()
    traffic = Traffic(cell, pool)
    for _ in range(cell["capacity"]):
        traffic.join(engine, 0)
    calls, returns, sizes = [], [], []

    def step():
        sizes.append(len(traffic.joined))
        frames = traffic.frames()
        calls.append(time.perf_counter())
        out = engine.step(frames)
        returns.append(time.perf_counter())
        if out:  # the previous step's frames
            traffic.outputs[traffic.t - 1] = out
        traffic.churn(engine)
        traffic.t += 1

    for _ in range(cell["warmup_steps"]):
        step()
    session.synchronize(dev)
    ctx.setup_done()

    if ctx.trace:
        wrap(model, "predict", "predict", ctx.spans)
        wrap(model, "detect", "detect", ctx.spans)
        wrap(engine, "step", "engine_step", ctx.spans)
    first = len(calls)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        step()
    traffic.outputs[traffic.t - 1] = engine.flush()
    t_end = time.perf_counter()
    step_s = [b - a for a, b in zip(calls[first:], returns[first:])]
    # the frames whose detections came back inside the window: a step's
    # come back from the next call (the last step's from the flush), so
    # the step before the window counts too
    latencies, frames_back, failed = [], 0, 0
    for j, t_back in zip(range(first - 1, len(calls)),
                         returns[first:] + [t_end]):
        latencies.extend([t_back - calls[j]] * sizes[j])
        frames_back += sizes[j]
        failed += sizes[j] - len(traffic.outputs.get(j, {}))
    elapsed = t_end - t0
    e2e = {"serve_frames_per_s": frames_back / elapsed,
           "serve_frame_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
           "setup_s": ctx.setup_s}

    record = busy = window = breakdown = None
    if ctx.trace:
        n = cell["profile_steps"]
        trace, win = session.profiled(step, n, dev)
        traffic.outputs[traffic.t - 1] = engine.flush()
        busy, window, breakdown = session.device_summary(trace, win)
        record = {
            "path": "serve", "trace": trace, "window": win,
            "spans": ctx.spans, "steps": len(calls) - first,
            "frame_p95_ms": e2e["serve_frame_p95_ms"],
            "conv_flops_fwd": n * cell["capacity"]
            * net.conv_flops_per_frame(),
            "cell_bound_s": n * roofline.cells_bound_s(
                net.cells, cell["capacity"], 1, 0, 1, False),
        }
    peak = session.memory_peak(dev)
    rows = checked_rows(traffic, engine._slots)
    program_state = [tuple(x[list(rows.values())].clone() for x in vi)
                     for vi in port.cell_states(engine._states[0])]
    del engine, model, step
    session.free(dev)
    t_ref = time.perf_counter()
    due = due_frames(traffic, rows, seed, cfg["time_window"])
    got = {(t, sid): traffic.outputs[t][sid]
           for t, sids in due.items() for sid in sids}
    values = serve_values(got, program_state,
                          *replay(net, weights, scales, traffic, rows, due,
                                  dev))
    return Outcome(e2e, frames_back, failed, gate(values, cell["limits"]),
                   peak, record, busy, window, breakdown, values,
                   time.perf_counter() - t_ref, step_s)


def checked_rows(traffic, slots):
    """Every stream attached at the end that has sent a frame, with its
    slot: ``{stream: row}`` in row order."""
    return {sid: slots[sid] for sid in sorted(
        (s for s in traffic.joined if traffic.joined[s][1] < traffic.t),
        key=lambda s: slots[s])}


def due_frames(traffic, rows, seed, window):
    """The frames to compare, drawn from the seed: ``{step: [stream,
    ...]}`` among the checked streams' frames after their first
    ``window`` (whose detections the engine leaves empty)."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 6])
    candidates = [(t, s) for s in rows
                  for t in range(traffic.joined[s][1] + window, traffic.t)
                  if t in traffic.outputs]
    pick = rng.choice(len(candidates), min(traffic.cell["checked_frames"],
                                           len(candidates)), replace=False)
    due = {}
    for k in sorted(pick):
        t, s = candidates[k]
        due.setdefault(t, []).append(s)
    return due


def replay(net, weights, scales, traffic, rows, due, dev, tf32=False):
    """The reference over a batch of ``capacity`` rows, each checked
    stream in its row from the step it joined (its row's state zeroed
    there), the other rows' frames zero, from the first join to the last
    step: ``({(step, stream): detections}, the checked rows' state)``,
    the detections' boxes clamped to [0, 1] and their background rows
    dropped, as the engine returns them."""
    cell, pool = traffic.cell, traffic.pool
    p = R.Params(weights, scales,
                 [torch.zeros(c, device=dev) for c in net.norms],
                 [torch.ones(c, device=dev) for c in net.norms])
    anc = D.anchors(net.taps).to(dev)
    state = net.zero_state(cell["capacity"], dev)
    start = min(traffic.joined[s][1] for s in rows)
    stride, n = cell["stride"], len(pool)
    joins = {}
    for s, r in rows.items():
        joins.setdefault(traffic.joined[s][1], []).append(r)
    x = torch.zeros((cell["capacity"], *pool.shape[1:]), dtype=torch.uint8)
    out = {}
    with torch.no_grad(), R.fp32_exact():
        for t in range(start, traffic.t):
            for v, i in state:
                v[joins.get(t, [])] = 0.0
                i[joins.get(t, [])] = 0.0
            for s, r in rows.items():
                x[r] = torch.from_numpy(
                    pool[(stride * traffic.joined[s][0] + t) % n])
            stems, state = R.step(net, x.to(dev), state, p, tf32=tf32)
            if t in due:
                cls, box = R.readout(net, stems, p, tf32=tf32)
                picked = [rows[s] for s in due[t]]
                dets = D.detect(cls[picked], box[picked], anc)
                dets = torch.cat([dets[..., :2], dets[..., 2:].clamp(0, 1)],
                                 -1).cpu().numpy()
                for s, d in zip(due[t], dets):
                    out[(t, s)] = d[d[:, 0] >= 0]
    keep = list(rows.values())
    return out, [(v[keep], i[keep]) for v, i in state]


def serve_values(got_dets, got_state, want_dets, want_state):
    """The worst compared frame's detection gap and the carried state's
    worst leaf."""
    det_gap = max((compare.detection_gap(got_dets[k], want)
                   for k, want in want_dets.items()), default=0.0)
    return {"detections": det_gap,
            "state": compare.state_gap(got_state, want_state)}


class _Slots:
    """Stands in for the engine where only the traffic is wanted: a slot
    a stream, the lowest free one first."""

    def __init__(self):
        self._slots = {}

    def add_stream(self, sid):
        used = set(self._slots.values())
        self._slots[sid] = min(k for k in range(len(used) + 1)
                               if k not in used)

    def remove_stream(self, sid):
        del self._slots[sid]


def control(ctx: session.Run, steps: int):
    """The control: the reference in TF32 put in the engine's place, over
    ``steps`` steps of the cell's traffic, against the reference."""
    cfg, cell, dev, seed = ctx.config, ctx.cell, ctx.device, ctx.seed
    net = R.Net(cfg["num_classes"], cfg["in_hw"])
    weights = inputs.weights(net.weight_shapes(), seed, dev)
    scales = inputs.scales(net.norms, dev)
    pool = inputs.frames(cell["pool"], (*cfg["in_hw"], 2), seed,
                         dev).cpu().numpy()
    traffic = Traffic(cell, pool)
    slots = _Slots()
    for _ in range(cell["capacity"]):
        traffic.join(slots, 0)
    for _ in range(steps):
        traffic.outputs[traffic.t] = None
        traffic.churn(slots)
        traffic.t += 1
    rows = checked_rows(traffic, slots._slots)
    due = due_frames(traffic, rows, seed, cfg["time_window"])
    got = replay(net, weights, scales, traffic, rows, due, dev, tf32=True)
    want = replay(net, weights, scales, traffic, rows, due, dev)
    return serve_values(*got, *want)
