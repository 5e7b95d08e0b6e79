#!/usr/bin/env python3
"""Run the streaming megakernel of the tree in the current directory on
TinyYolo GEN1 at B=1, on one NVIDIA GPU, and save or compare what it
computes. Two trees (for example a commit and its parent, unpacked with
``git archive``) are compared bit for bit and timed on one card:

    (cd TREE_A && python /path/to/megakernel_ab.py dump a.pt)
    (cd TREE_B && python /path/to/megakernel_ab.py dump b.pt)
    python megakernel_ab.py compare a.pt b.pt

``dump`` builds ``chip_smoke.py``'s TinyYolo GEN1 (random weights from
seed 0, BatchNorm gains 8) in fp32 and in bf16 activations with e5m2
states, runs the 16 frames of ``chip_smoke.py`` [8] through
``StreamingMegakernel.step`` from the zero state, saves every frame's
predictions and the final state slots, and prints the kernel's device
time per frame (CUDA events around 10 back-to-back frames, median of
10) and its phase count. ``compare`` exits non-zero unless every saved
tensor is equal.
"""

import os
import sys

import torch


def dump(path: str) -> None:
    sys.path.insert(0, os.getcwd())  # the tree under test
    import chip_smoke as cs
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        StreamingMegakernel,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    X = torch.as_tensor(cs.make_batches(1, seed=0)[0][0][:cs.MK_FRAMES, 0],
                        device="cuda")
    out = {}
    for xd, sd in (("float32", "float32"), ("bfloat16", "float8_e5m2")):
        mk = StreamingMegakernel(cs.build_model(TinyYolo, xd, sd, "cuda"))
        state, preds = None, []
        for x in X:
            (cls, box), state = mk.step(x, state)
            preds += [cls, box]
        flat = mk._flat_state(state)
        torch.cuda.synchronize()
        out[f"{xd}/{sd}"] = [t.cpu() for t in preds + flat]
        ms = cs.per_frame_ms(
            lambda: cuda_kernels.streaming_megakernel(mk.plan, X[0], flat))
        print(f"{os.getcwd()}: {xd}/{sd}: megakernel {ms:.4f} ms/frame, "
              f"{mk.plan.cuda['phases'].shape[0]} phases, grid "
              f"{mk.plan.cuda['grid']}; timeline: "
              f"{timeline(cs, mk, X[0], flat)}", flush=True)
        del mk, state, preds, flat
        torch.cuda.empty_cache()
    torch.save(out, path)


def timeline(cs, mk, x, flat) -> str:
    """The device time of one frame's phases (one launch with the
    timeline on), summed by what the phase runs: the kinds of its ops."""
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels

    cu = mk.plan.cuda
    rows, phases = cu["ops"].cpu(), cu["phases"].cpu()
    line = torch.zeros(phases.shape[0] + 1, dtype=torch.int64, device="cuda")
    cuda_kernels.streaming_megakernel(mk.plan, x, flat, timeline=line)
    torch.cuda.synchronize()
    ms = ((line[1:] - line[:-1]).double() / 1e6).tolist()
    groups = {}
    for (o0, o1, _), t in zip(phases.tolist(), ms):
        kinds = "+".join(sorted({cs.row_label(cuda_kernels.MK_FIELDS,
                                              rows[n]).split()[0][:4]
                                 for n in range(o0, o1)}))
        n, total = groups.get(kinds, (0, 0.0))
        groups[kinds] = (n + 1, total + t)
    for p, ((o0, o1, _), t) in enumerate(zip(phases.tolist(), ms)):
        print(f"  phase {p}: {t:.4f} ms: " + "; ".join(
            cs.row_label(cuda_kernels.MK_FIELDS, rows[n])
            for n in range(o0, o1)))
    return f"{sum(ms):.4f} ms in all; " + ", ".join(
        f"{k}: {n} phases {t:.4f} ms" for k, (n, t) in sorted(groups.items()))


def compare(a: str, b: str) -> int:
    ta, tb = torch.load(a), torch.load(b)
    bad = 0
    for key in ta:
        same = [torch.equal(x, y) for x, y in zip(ta[key], tb[key])]
        print(f"{key}: {sum(same)} of {len(same)} tensors bit-equal "
              f"(16 frames' predictions and the final state slots)")
        bad += len(same) - sum(same) + (len(ta[key]) != len(tb[key]))
    return int(bad > 0)


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(sys.argv[2])
    else:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
