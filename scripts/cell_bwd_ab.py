#!/usr/bin/env python3
"""Run the ``temporal_cell_seq`` backward kernel of the tree in the
current directory on one NVIDIA GPU and save or compare what it
computes, so that two trees (for example a commit and its parent,
unpacked with ``git archive``) are compared bit for bit and timed on
one card:

    (cd TREE_A && python /path/to/cell_bwd_ab.py dump a.pt)
    (cd TREE_B && python /path/to/cell_bwd_ab.py dump b.pt)
    python cell_bwd_ab.py compare a.pt b.pt [more.pt ...]
    python cell_bwd_ab.py plans plans.json
    python cell_bwd_ab.py score plans.json

``dump`` runs ``temporal_cell_seq_bwd`` on every case of
``chip_smoke.py`` [10] (``cell_bwd_cases()`` x ``TRAIN_PAIRS`` x LIF and
LI x the case's starts, the same seeded inputs), saves the SHA-256 of
every output's bytes (the stage-1 gradients are 784 MB each), and
records each case's device time per call with [10]'s ``queued_ms`` and
its bound with ``cell_bwd_bound``. The cases, inputs, timing and bound
are those of the ``chip_smoke.py`` beside this script, whichever tree is
run; the kernel is the tree's.

``compare`` prints every run's times side by side (give the runs in the
order they ran: parent, change, change, parent) and exits non-zero
unless the first two runs agree bit for bit on every case.

``plans`` times every launch plan (``cell_bwd_plans``) of the chunked
LIF backward at [10]'s two T = 42 shapes, start 0, in the two training
dtype pairs and in bf16 activations with bf16 states, with
``queued_ms``; holds each plan's outputs equal to the default plan's;
saves the times as JSON and prints per case the plan ``cell_bwd_plan``
picks against the fastest. ``score`` reads such a file on any machine
and does the same for the plan model of the tree in the current
directory, with no card.
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys

import torch

_spec = importlib.util.spec_from_file_location(
    "cell_bwd_gate", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
GATE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(GATE)

SWEEP_PAIRS = GATE.TRAIN_PAIRS + (("bfloat16", "bfloat16"),)


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes, with its dtype and shape."""
    h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
    h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
             .cpu().numpy().data)
    return h.hexdigest()


def _tree():
    sys.path.insert(0, os.getcwd())  # the tree under test
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels as K

    return K


def dump(path: str) -> None:
    K = _tree()
    out = {"tree": os.getcwd(), "card": GATE.nvidia_smi(), "cases": {}}
    for label, (shape, starts) in GATE.cell_bwd_cases().items():
        draw = GATE.cell_bwd_inputs(torch, shape, "cuda")
        T, M = shape[0], draw[1].numel()
        for xd, sd in GATE.TRAIN_PAIRS:
            args = GATE.cell_bwd_args(torch, draw, xd, sd)
            for cell in ("lif", "li"):
                for start in starts:
                    got = K.temporal_cell_seq_bwd(*args, cell, start)
                    torch.cuda.synchronize()
                    ms = GATE.queued_ms(
                        lambda: K.temporal_cell_seq_bwd(*args, cell, start))
                    bound, _ = GATE.cell_bwd_bound(
                        cell, T, M, args[0].element_size(),
                        args[1].element_size())
                    key = f"{label} {cell} {xd}/{sd} start={start}"
                    out["cases"][key] = dict(
                        digests=[digest(t) for t in got], ms=ms,
                        bound_ms=bound)
                    print(f"{os.getcwd()}: {key}: {ms:.4f} ms (bound "
                          f"{bound:.4f}, {bound / ms:.0%})", flush=True)
                    del got
            del args
        del draw
        torch.cuda.empty_cache()
    torch.save(out, path)


def compare(*paths) -> int:
    runs = [torch.load(p) for p in paths]
    first, second = runs[0], runs[1]
    print("trees: " + "; ".join(f"{r['tree']} ({r['card']})" for r in runs))
    bad = 0
    for key, case in first["cases"].items():
        same = case["digests"] == second["cases"][key]["digests"]
        bad += not same
        times = [r["cases"][key]["ms"] for r in runs]
        print(f"{key:42s} {'bit-equal' if same else 'DIFFERS'}; ms by run: "
              + ", ".join(f"{t:.4f}" for t in times)
              + f"; bound {case['bound_ms']:.4f}; share by run: "
              + ", ".join(f"{case['bound_ms'] / t:.0%}" for t in times))
    return int(bad > 0)


def plans(path: str) -> None:
    K = _tree()
    out = {"tree": os.getcwd(), "card": GATE.nvidia_smi(), "cases": []}
    for label, (shape, _) in GATE.cell_bwd_cases().items():
        if shape[0] < 2:
            continue
        draw = GATE.cell_bwd_inputs(torch, shape, "cuda")
        T, M = shape[0], draw[1].numel()
        for xd, sd in SWEEP_PAIRS:
            args = GATE.cell_bwd_args(torch, draw, xd, sd)
            xt, st = args[0].dtype, args[1].dtype
            want = K.temporal_cell_seq_bwd(*args, "lif", 0)
            times = []
            for plan in K.cell_bwd_plans(T, M, xt, st):
                got = K.temporal_cell_seq_bwd(*args, "lif", 0, plan)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"{label} {xd}/{sd} {plan}: differs "
                                       "from the default plan's outputs")
                del got
                ms = GATE.queued_ms(
                    lambda plan=plan: K.temporal_cell_seq_bwd(
                        *args, "lif", 0, plan), calls=10, reps=3)
                times.append([dataclasses.asdict(plan), ms])
            bound, _ = GATE.cell_bwd_bound("lif", T, M, xt.itemsize,
                                           st.itemsize)
            out["cases"].append(dict(label=label, T=T, M=M, x=xd, state=sd,
                                     bound_ms=bound, plans=times))
            del args, want
        del draw
        torch.cuda.empty_cache()
    with open(path, "w") as f:
        json.dump(out, f)
    report(out, K)


def report(run, K) -> None:
    """Per case, the plan ``K.cell_bwd_plan`` picks against the fastest
    plan of ``run``, every plan's time and share of the bound."""
    print(f"{run['tree']} ({run['card']}): plan model {K.__file__}")
    for case in run["cases"]:
        xt, st = getattr(torch, case["x"]), getattr(torch, case["state"])
        pick = K.cell_bwd_plan(case["T"], case["M"], xt, st)
        timed = [(K.CellBwdPlan(**p), ms) for p, ms in case["plans"]]
        best = min(timed, key=lambda pm: pm[1])
        pick_ms = next(ms for p, ms in timed if p == pick)
        bound = case["bound_ms"]
        print(f"  {case['label']} T={case['T']} {case['x']}/{case['state']}"
              f": the model's plan {pick_ms:.4f} ms ({bound / pick_ms:.0%} "
              f"of the bound {bound:.4f}), the fastest {best[1]:.4f} ms "
              f"({pick_ms / best[1] - 1:+.1%}) of {len(timed)}: {pick} "
              f"against {best[0]}")
        for p, ms in sorted(timed, key=lambda pm: pm[1]):
            print(f"    {ms:.4f} ms ({bound / ms:.0%}) C={p.chunk} "
                  f"{'shared' if p.shared else 'global'} {p.threads} "
                  f"threads, {p.smem} B shared")


def score(path: str) -> None:
    K = _tree()
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
