#!/usr/bin/env python3
"""Run ``spiking_conv_seq`` of the tree in the current directory on one
NVIDIA GPU and save or compare what it computes, so that two trees (for
example a commit and its parent, unpacked with ``git archive``) are
compared bit for bit and timed on one card:

    (cd TREE_A && python /path/to/spiking_conv_ab.py dump a.pt)
    (cd TREE_B && python /path/to/spiking_conv_ab.py dump b.pt)
    python spiking_conv_ab.py compare a.pt b.pt [more.pt ...]
    python spiking_conv_ab.py plans plans.json
    python spiking_conv_ab.py score plans.json

``dump`` runs the kernel on the 24 cases of ``chip_smoke.py`` [3]
(``SPIKING_CONV_CASES`` x ``DTYPE_PAIRS``, the same seeded inputs) and
on [3]'s 1x1 identity case in each dtype pair and cell, saves every
output, and records each case's device time per call with [3]'s
``queued_ms`` and its bound with ``triple_bound``. Then it runs the
fused ``forward_seq`` of [7] (TinyYolo GEN1, random weights from seed 0,
B=4, T=42, fused schedule) in fp32 and in bf16 activations with e5m2
states on [7]'s first batch, saves the predictions and the final state,
and records the device time of the forward (CUDA events, median of 3)
and of its 22 ``spiking_conv_seq`` kernels (one forward under
``torch.profiler``). The cases, inputs, timing and bound are those of
the ``chip_smoke.py`` beside this script, whichever tree is run; the
kernel is the tree's.

``compare`` prints every run's times side by side (give the runs in
the order they ran, e.g. parent, change, change, parent) and exits
non-zero unless the first two runs agree bit for bit on every case: the
kernel sums each output in one order under every plan and dtype.

``plans`` times every launch plan (``spiking_conv_plans``) of each
distinct layer of the 22 fused triples of TinyYolo GEN1 at B=4, T=42
(seeded event input at a 0.2 spike share), in fp32 and in bf16 with
e5m2 states, with [3]'s ``queued_ms``, and saves the times as JSON; it
prints per layer the time of the plan ``spiking_conv_plan`` picks
against the fastest, and the 22-layer totals. ``score`` reads such a
file on any machine and does the same for the plan model
(``_plan_cost``) of the tree in the current directory, with no card.
"""

import dataclasses
import json

import importlib.util
import os
import sys

import torch

_spec = importlib.util.spec_from_file_location(
    "spiking_conv_gate", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
GATE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(GATE)

FORWARD_DTYPES = (("float32", "float32"), ("bfloat16", "float8_e5m2"))


def conv_kernels_ms(model, X):
    """Device ms of the ``spiking_conv_seq`` kernels of one forward."""
    kernels, _, _ = GATE.profiled(torch, lambda: model.forward_seq(X))
    return sum(e.time_range.elapsed_us() for e in kernels
               if "spiking_conv" in e.name) / 1e3, sum(
        "spiking_conv" in e.name for e in kernels)


def dump(path: str) -> None:
    sys.path.insert(0, os.getcwd())  # the tree under test
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": os.getcwd(), "card": GATE.nvidia_smi(), "cases": {}}
    for case in GATE.SPIKING_CONV_CASES:
        label, k, stride, cell, cin, cout, hw, _ = case
        x32, w, a, b, v32, i32 = GATE.spiking_conv_inputs(torch, case,
                                                          "cuda")
        for xd, sd in GATE.DTYPE_PAIRS:
            xt, st = getattr(torch, xd), getattr(torch, sd)
            args = (x32.to(xt), w, a, b, v32.to(st), i32.to(st), cell,
                    stride)
            got = K.spiking_conv_seq(*args)
            torch.cuda.synchronize()
            ms = GATE.queued_ms(lambda: K.spiking_conv_seq(*args))
            bound, _ = GATE.triple_bound(
                k, cin, cout, hw, GATE.conv_out_hw(k, stride, hw),
                args[0].element_size(), args[4].element_size())
            out["cases"][f"{label} {xd}/{sd}"] = dict(
                outputs=[t.cpu() for t in got], ms=ms, bound_ms=bound)
            print(f"{os.getcwd()}: {label} {xd}/{sd}: {ms:.4f} ms "
                  f"(bound {bound:.4f})", flush=True)
            del got, args
        del x32, w, a, b, v32, i32
        torch.cuda.empty_cache()
    x32, eye, a, b, v32 = GATE.identity_inputs(torch, "cuda")
    for xd, sd in GATE.DTYPE_PAIRS:
        xt, st = getattr(torch, xd), getattr(torch, sd)
        for cell in ("lif", "li"):
            got = K.spiking_conv_seq(x32.to(xt), eye, a, b, v32.to(st),
                                     v32.to(st), cell)
            out["cases"][f"identity {cell} {xd}/{sd}"] = dict(
                outputs=[t.cpu() for t in got], ms=None, bound_ms=None)
    del x32, v32
    X = torch.as_tensor(GATE.make_batches(1, seed=0)[0][0], device="cuda")
    for xd, sd in FORWARD_DTYPES:
        model = GATE.build_model(TinyYolo, xd, sd, "cuda", time_window=0,
                                 fuse_seq=True)
        with torch.inference_mode():
            (cls, box), state = model.forward_seq(X)
            torch.cuda.synchronize()
            fwd_ms = GATE.cuda_time_ms(lambda: model.forward_seq(X), reps=3,
                                       warmup=1)
            conv_ms, n = conv_kernels_ms(model, X)
        out["cases"][f"forward_seq {xd}/{sd}"] = dict(
            outputs=[cls.cpu(), box.cpu()]
            + [t.cpu() for t in GATE.state_leaves(state)],
            ms=conv_ms, bound_ms=None, forward_ms=fwd_ms,
            kernels=n)
        print(f"{os.getcwd()}: forward_seq {xd}/{sd}: forward {fwd_ms:.2f} "
              f"ms, {n} spiking_conv_seq kernels {conv_ms:.3f} ms",
              flush=True)
        del model, cls, box, state
        torch.cuda.empty_cache()
    torch.save(out, path)


def equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(((x == y) | (x.isnan() & y.isnan())).all())
        for x, y in zip(a, b))


def compare(*paths) -> int:
    runs = [torch.load(p) for p in paths]
    first, second = runs[0], runs[1]
    print("trees: " + "; ".join(f"{r['tree']} ({r['card']})" for r in runs))
    bad = 0
    for key, case in first["cases"].items():
        other = second["cases"][key]
        same = equal(case["outputs"], other["outputs"])
        bad += not same
        times = [r["cases"][key]["ms"] for r in runs]
        txt = (", ".join(f"{t:.4f}" for t in times)
               if times[0] is not None else "-")
        extra = ""
        if "forward_ms" in case:
            extra = " forward " + ", ".join(
                f"{r['cases'][key]['forward_ms']:.2f}" for r in runs) + " ms;"
        bound = (f", bound {case['bound_ms']:.4f}" if case["bound_ms"]
                 else "")
        print(f"{key:40s} {'bit-equal' if same else 'DIFFERS'};{extra} "
              f"ms by run: {txt}{bound}")
    for r in runs:
        steps = [r["cases"][f"forward_seq {xd}/{sd}"]["ms"]
                 for xd, sd in FORWARD_DTYPES]
        print(f"{r['tree']}: spiking_conv_seq kernels of one fused forward: "
              + ", ".join(f"{t:.3f} ms" for t in steps)
              + " (fp32; bf16/e5m2)")
    return int(bad > 0)


def gen1_layers(K):
    """``{(k, stride, Cin, Cout, H, W, Ho, Wo): count}`` over the 22
    fused triples of TinyYolo GEN1, in launch order."""
    from snn_for_object_detection_tpu_torch.models.compile import Block
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo

    m = TinyYolo(num_classes=2, in_hw=(240, 304), fuse_seq=True,
                 device="cpu")
    layers = {}
    for top in (m.backbone, m.neck, *(h["base"] for h in m.heads())):
        for c in GATE.fused_convs(Block, top):
            key = (c.w.shape[-1], c.stride, c.w.shape[1], c.w.shape[0],
                   *c.in_hw, *c.out_hw)
            layers[key] = layers.get(key, 0) + 1
    assert sum(layers.values()) == GATE.CELLS_PER_STEP
    return layers


def plans(path: str) -> None:
    sys.path.insert(0, os.getcwd())  # the tree under test
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels as K

    sms = K.sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": os.getcwd(), "card": GATE.nvidia_smi(), "sms": sms,
           "layers": []}
    for (k, stride, cin, cout, h, w_, ho, wo), count in \
            gen1_layers(K).items():
        x32 = (torch.rand((GATE.STEPS, GATE.BATCH, h, w_, cin),
                          generator=gen, device="cuda") < 0.2).float()
        w = torch.randn((k, k, cin, cout), generator=gen, device="cuda")
        a = torch.rand(cout, generator=gen, device="cuda") + 0.5
        b = 0.1 * torch.randn(cout, generator=gen, device="cuda")
        v = torch.zeros((GATE.BATCH, ho, wo, cout), device="cuda")
        for xd, sd in FORWARD_DTYPES:
            xt, st = getattr(torch, xd), getattr(torch, sd)
            args = (x32.to(xt), w, a, b, v.to(st), v.to(st), "lif", stride)
            times = []
            for plan in K.spiking_conv_plans(k, stride, GATE.BATCH, ho, wo,
                                             cin, cout, xt):
                ms = GATE.queued_ms(
                    lambda plan=plan: K.spiking_conv_seq_launch(*args, plan),
                    calls=5, reps=3)
                times.append([dataclasses.asdict(plan), ms])
            out["layers"].append(dict(
                k=k, stride=stride, cin=cin, cout=cout, ho=ho, wo=wo,
                count=count, x=xd, state=sd, plans=times))
            del args
        del x32
        torch.cuda.empty_cache()
    with open(path, "w") as f:
        json.dump(out, f)
    report(out, K)


def report(run, K) -> None:
    """Per layer, the plan ``K._plan_cost`` picks against the fastest
    plan of ``run``; the 22-layer totals by dtype."""
    print(f"{run['tree']} ({run['card']}): plan model "
          f"{K.__file__}")
    totals = {}
    for lay in run["layers"]:
        plans_ = [(K.ConvPlan(**p), ms) for p, ms in lay["plans"]]
        pick = min(plans_, key=lambda pm: K._plan_cost(
            pm[0], lay["k"], lay["stride"], lay["cin"], run["sms"]))
        best = min(plans_, key=lambda pm: pm[1])
        tot = totals.setdefault(lay["x"], [0.0, 0.0])
        tot[0] += lay["count"] * pick[1]
        tot[1] += lay["count"] * best[1]
        print(f"  {lay['k']}x{lay['k']} s{lay['stride']} {lay['cin']}->"
              f"{lay['cout']} {lay['ho']}x{lay['wo']} x{lay['count']} "
              f"{lay['x']}/{lay['state']}: the model's plan {pick[1]:.4f} "
              f"ms, the fastest {best[1]:.4f} ms ({pick[1] / best[1] - 1:+.1%}"
              f") of {len(plans_)}; {GATE.plan_text(pick[0])}")
    for xd, (pick, best) in totals.items():
        print(f"  22 layers {xd}: the model's plans {pick:.3f} ms, the "
              f"fastest {best:.3f} ms ({pick / best - 1:+.1%})")


def score(path: str) -> None:
    sys.path.insert(0, os.getcwd())  # the tree whose plan model to score
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels as K

    with open(path) as f:
        report(json.load(f), K)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "dump":
        dump(sys.argv[2])
    elif mode == "plans":
        plans(sys.argv[2])
    elif mode == "score":
        score(sys.argv[2])
    else:
        sys.exit(compare(*sys.argv[2:]))
