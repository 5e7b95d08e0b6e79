#!/usr/bin/env python3
"""Time ``fused_pointwise_conv_bn_lif`` of the tree in the current
directory on one NVIDIA GPU, so that two trees (for example a commit and
its parent, unpacked with ``git archive``) are timed on one card:

    (cd TREE_A && python /path/to/pointwise_ab.py time a.json)
    (cd TREE_B && python /path/to/pointwise_ab.py time b.json --sweep)
    python pointwise_ab.py compare a.json b.json

``time`` runs the kernel on the cases of ``chip_smoke.py`` [3]
(``POINTWISE_CASES`` x ``DTYPE_PAIRS``, the same seeded inputs), holds z
and v' equal to the plain version and i' within
``pointwise_i_outside``'s gate, and records its device time per call
with [3]'s ``queued_ms``, taken twice in turn with ``torch.matmul`` of
the product alone. The cases, inputs, gate, timing and bound are those
of the ``chip_smoke.py`` beside this script, whichever tree is timed.
``--sweep`` also times every launch plan the kernel takes on the shapes
(Cout tile, rows a tile, CTAs an SM), where the tree has
``cuda_kernels.pointwise_plan``. ``compare`` prints both trees side by
side with the bound.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import torch

_spec = importlib.util.spec_from_file_location(
    "pointwise_gate", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
GATE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(GATE)


def inputs(n, cin, cout, xd, sd):
    x, w, a, b, v, i = GATE.pointwise_inputs(torch, n, cin, cout, "cuda")
    return x.to(xd), w.to(xd), a, b, v.to(sd), i.to(sd)


def agrees(K, args, got):
    """z and v' equal to the plain version, i' inside the gate."""
    want = K.fused_pointwise_conv_bn_lif_reference(*args)
    same = all(torch.equal(g.float(), w.float())
               for g, w in zip(got[:2], want[:2]))
    return same and GATE.pointwise_i_outside(got[2], want[2], *args[:3])[1] == 0


def time_tree(path, sweep):
    sys.path.insert(0, os.getcwd())  # the tree under test
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"tree": os.getcwd(), "card": smi, "cases": []}
    for n, cin, cout in GATE.POINTWISE_CASES:
        for xd, sd in GATE.DTYPE_PAIRS:
            xd, sd = getattr(torch, xd), getattr(torch, sd)
            args = inputs(n, cin, cout, xd, sd)
            fn = lambda: K.fused_pointwise_conv_bn_lif(*args)
            ok = agrees(K, args, fn())
            mm = lambda: torch.matmul(args[0], args[1])
            row = dict(n=n, cin=cin, cout=cout, x=str(xd)[6:],
                       state=str(sd)[6:], ok=ok,
                       bound_ms=GATE.pointwise_bound(
                           n, cin, cout, args[0].element_size(),
                           args[4].element_size())[0],
                       ms=[GATE.queued_ms(fn)], matmul_ms=[GATE.queued_ms(mm)])
            row["ms"].append(GATE.queued_ms(fn))
            row["matmul_ms"].append(GATE.queued_ms(mm))
            if sweep and hasattr(K, "pointwise_plan"):
                row["plan"] = str(K.pointwise_plan_on(0, n, cin, cout, xd,
                                                      sd))
                row["sweep"] = sweep_plans(K, args, n, cin, cout, xd, sd)
            print(json.dumps(row), flush=True)
            out["cases"].append(row)
            del args
            torch.cuda.empty_cache()
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def sweep_plans(K, args, n, cin, cout, xd, sd):
    """ms of every (Cout tile, rows, CTAs an SM) the kernel takes here:
    the plan's Cout tile, and at fp32 64 channels too."""
    base = K.pointwise_plan_on(0, n, cin, cout, xd, sd)
    sx, ss = K._pw_sizes(xd, sd)
    sms = K.sm_count(0)
    tiles = [base.cout_tile] + ([64] if sx == 4 and base.cout_tile > 64
                                else [])
    res = []
    for tile in tiles:
        splits = -(-cout // tile)
        for rows in K.pointwise_rows(tile, sx):
            smem = K.pointwise_smem(cin, tile, rows, sx, ss)[1]
            if smem > K.PW_MAX_SMEM:
                continue
            occ = K.pointwise_occupancy(0, xd, sd, cin, rows, tile,
                                        base.threads, smem)
            for per_sm in range(1, occ + 1):
                plan = dataclasses.replace(
                    base, rows=rows, cout_tile=tile, splits=splits,
                    smem=smem, ctas_per_sm=per_sm,
                    grid=K.pointwise_grid(n, rows, splits, sms, per_sm))
                fn = lambda: K.fused_pointwise_launch(*args, plan)
                ok = agrees(K, args, fn())
                res.append(dict(tile=tile, rows=rows, per_sm=per_sm,
                                smem=smem, ok=ok, ms=GATE.queued_ms(fn)))
    return res


def compare(a_path, b_path):
    a, b = (json.load(open(p)) for p in (a_path, b_path))
    print(f"A {a['tree']} ({a['card']}); B {b['tree']} ({b['card']})")
    for ra, rb in zip(a["cases"], b["cases"]):
        print(f"{ra['n']}x{ra['cin']}->{ra['cout']} {ra['x']}/{ra['state']}:"
              f" bound {ra['bound_ms']:.4f}; A {ra['ms'][0]:.4f} / "
              f"{ra['ms'][1]:.4f} ok={ra['ok']}; B {rb['ms'][0]:.4f} / "
              f"{rb['ms'][1]:.4f} ok={rb['ok']} "
              f"({ra['bound_ms'] / min(rb['ms']):.0%} of the bound); "
              f"matmul {min(ra['matmul_ms'] + rb['matmul_ms']):.4f}")


if __name__ == "__main__":
    if sys.argv[1] == "time":
        time_tree(sys.argv[2], "--sweep" in sys.argv)
    else:
        compare(sys.argv[2], sys.argv[3])
