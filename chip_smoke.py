#!/usr/bin/env python3
"""Run the PyTorch + CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` gives them;
2. build: compiles every ``csrc/*.cu`` of the port with ``nvcc``, one
   process per source, all at once;
3. kernels against their plain versions: ``temporal_cell_seq`` on the
   main path's shapes (stage 1 and a head LI) must be bit-equal to
   ``temporal_cell_seq_reference`` for LIF/LI, three dtype pairs and
   two truncation starts; prints kernel ms, plain ms and the bound;
4. main path: TinyYolo at GEN1 width (240x304, 2 classes, 4,228,544
   params, random weights from a seed) evaluated by ``Trainer(
   time_batched=True).test`` at B=4, T=42 over a few batches of seeded
   event frames and labels, in fp32 and in bf16 activations with e5m2
   states; the cell kernel must launch exactly 22 times per eval step.
   Then where one eval step's time goes: its parts on the host clock,
   device time by kernel kind, the device's idle share;
5. schedules agree: ``forward_seq`` against the per-step ``forward``;
6. streaming: ``predict`` frame by frame at B=1.

Model and data values, with their source (the YAML files are not read:
PyYAML is not a dependency of the port):
config/config.yaml:9-13 num_classes 2, in_hw [240, 304], loss_ratio
0.04, time_window 16, iou_threshold 0.4; config/config.yaml:22,25
batch_size 4, num_steps 42; config/infer_fp8.yaml:28-29 compute_dtype
bfloat16, state_dtype float8_e5m2.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every ported kernel with its launches on the main path.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

NUM_CLASSES, IN_HW, LOSS_RATIO, TIME_WINDOW, IOU = 2, (240, 304), 0.04, 16, 0.4
BATCH, STEPS = 4, 42
EVAL_BATCHES = 3
MAX_LABELS = 64
EVENT_DENSITY = 0.05  # share of pixels with an event per frame and polarity
BN_GAIN = 8.0
CELLS_PER_STEP = 22  # 19 LIF + 3 LI in TinyYolo
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# fp32 operations per element-step of the cell update (LIF: sub, add,
# fma, fma, sub, compare, select, add)
CELL_OPS = 8
DTYPE_PAIRS = (("float32", "float32"), ("bfloat16", "bfloat16"),
               ("bfloat16", "float8_e5m2"))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` runs of the device time between CUDA events
    around one call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(torch, cuda_kernels, dev):
    """Phase 3: every case bit-equal; returns per-case timings."""
    h, w = IN_HW
    shapes = {  # stage 1 cells (stride 2) and the stride-8 head LI
        "stage1": (STEPS, BATCH, h // 2, w // 2, 64),
        "head_li": (STEPS, BATCH, h // 8, w // 8, 256),
    }
    rows, worst = [], 0.0
    for label, shape in shapes.items():
        rng = np.random.default_rng(1)
        x32 = torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * 2.0).to(dev)
        v32 = torch.from_numpy(
            rng.standard_normal(shape[1:], dtype=np.float32)).to(dev)
        i32 = torch.from_numpy(
            rng.standard_normal(shape[1:], dtype=np.float32)).to(dev)
        T, M = shape[0], int(np.prod(shape[1:]))
        for xd, sd in DTYPE_PAIRS:
            x = x32.to(getattr(torch, xd))
            v0 = v32.to(getattr(torch, sd))
            i0 = i32.to(getattr(torch, sd))
            for cell in ("lif", "li"):
                for start in (0, 7):
                    got = cuda_kernels.temporal_cell_seq(x, v0, i0, cell,
                                                         start)
                    want = cuda_kernels.temporal_cell_seq_reference(
                        x, v0, i0, cell, start)
                    torch.cuda.synchronize()
                    for name, g, w in zip(("z", "v_T", "i_T"), got, want):
                        g, w = g.float(), w.float()
                        same = (g == w) | (g.isnan() & w.isnan())
                        finite = g.isfinite() & w.isfinite()
                        err = float((g - w)[finite].abs().max()) \
                            if bool(finite.any()) else 0.0
                        worst = max(worst, err)
                        check(bool(same.all()),
                              f"{label} {cell} {xd}/{sd} start={start}: "
                              f"{name} differs from the plain version "
                              f"(max abs err {err})")
                    del got, want
                    ms = cuda_time_ms(
                        lambda: cuda_kernels.temporal_cell_seq(
                            x, v0, i0, cell, start), reps=20)
                    plain_ms = cuda_time_ms(
                        lambda: cuda_kernels.temporal_cell_seq_reference(
                            x, v0, i0, cell, start), reps=5, warmup=1)
                    sx, ss = x.element_size(), v0.element_size()
                    nbytes = 2 * T * M * sx + 4 * M * ss
                    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    ops_ms = T * M * CELL_OPS / FP32_FLOPS * 1e3
                    rows.append(dict(
                        shape=label, cell=cell, x=xd, state=sd, start=start,
                        ms=ms, plain_ms=plain_ms,
                        bound_ms=max(bytes_ms, ops_ms),
                        bound_by="bytes" if bytes_ms >= ops_ms
                        else "operations",
                        gb_per_s=nbytes / ms / 1e6,
                    ))
                    print(f"  {label:7s} {cell:3s} {xd:8s}/{sd:11s} "
                          f"start={start}: bit-equal; kernel {ms:.4f} ms, "
                          f"plain {plain_ms:.3f} ms, bound "
                          f"{rows[-1]['bound_ms']:.4f} ms "
                          f"({rows[-1]['gb_per_s']:.0f} GB/s)", flush=True)
        del x32, v32, i32, x, v0, i0
        torch.cuda.empty_cache()
    return rows, worst


def make_batches(n: int, seed: int):
    """Seeded Bernoulli event frames [T, B, H, W, 2] (uint8) and random
    valid boxes padded to MAX_LABELS rows with -1."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n):
        X = (rng.random((STEPS, BATCH, *IN_HW, 2))
             < EVENT_DENSITY).astype(np.uint8)
        labels = np.full((BATCH, MAX_LABELS, 5), -1.0, np.float32)
        for b in range(BATCH):
            k = int(rng.integers(1, 9))
            xy = rng.random((k, 2)) * 0.7
            wh = rng.random((k, 2)) * 0.25 + 0.03
            labels[b, :k, 0] = rng.integers(0, NUM_CLASSES, k)
            labels[b, :k, 1:] = np.concatenate([xy, xy + wh], axis=1)
        batches.append((X, labels))
    return batches


def build_model(TinyYolo, compute_dtype, state_dtype, dev):
    """TinyYolo with seeded random conv weights. BatchNorm gains are set
    to BN_GAIN: at identity gains the untrained net never spikes on
    sparse frames, at 8 its LIF layers fire 0.2-16% of the time."""
    import torch

    model = TinyYolo(
        num_classes=NUM_CLASSES, in_hw=IN_HW, loss_ratio=LOSS_RATIO,
        time_window=TIME_WINDOW, iou_threshold=IOU,
        compute_dtype=compute_dtype, state_dtype=state_dtype,
        device=dev, seed=0,
    )
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.fill_(BN_GAIN)
    return model


def phase_main_path(torch, cuda_kernels, TinyYolo, Trainer, batches, dev):
    """Phase 4: Trainer.test in both dtype configurations, then one eval
    step's outputs checked, its parts timed and profiled. Returns the
    cell kernel's launches over the two ``test`` runs."""
    X = torch.as_tensor(batches[0][0], device=dev)
    lab = torch.as_tensor(batches[0][1], device=dev)
    total = 0
    for xd, sd in (("float32", "float32"), ("bfloat16", "float8_e5m2")):
        model = build_model(TinyYolo, xd, sd, dev)
        trainer = Trainer(limit_test_batches=EVAL_BATCHES, seed=0,
                          time_batched=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = trainer.test(model, iter(batches))
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        launches = cuda_kernels.LAUNCHES["temporal_cell_seq"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(launches == CELLS_PER_STEP * EVAL_BATCHES,
              f"{xd}/{sd}: {launches} cell launches over {EVAL_BATCHES} "
              f"eval steps, want {CELLS_PER_STEP} per step")
        check(all(np.isfinite(v) for v in metrics.values()),
              f"{xd}/{sd}: non-finite metrics {metrics}")
        total += launches

        with torch.inference_mode():
            (cls_p, box_p), _ = model.forward_seq(X, start_step=5)
            dets = model.detect((cls_p, box_p))
        a = model.num_anchors  # 13545 at GEN1
        check(tuple(cls_p.shape) == (BATCH, a, NUM_CLASSES + 1)
              and tuple(box_p.shape) == (BATCH, a, 4)
              and tuple(dets.shape) == (BATCH, 300, 6),
              "prediction shapes")
        check(bool(torch.isfinite(cls_p).all() & torch.isfinite(box_p).all()
                   & torch.isfinite(dets).all()), f"{xd}/{sd}: non-finite")
        del cls_p, box_p, dets

        parts = time_step_parts(torch, model, trainer, X, lab)
        step_ms = parts["step"]
        print(f"  {xd}/{sd}: {metrics}")
        print(f"  {xd}/{sd}: {launches} cell launches in {EVAL_BATCHES} "
              f"eval steps; eval step {step_ms:.1f} ms (median of 5, "
              f"host clock), {STEPS * BATCH / (step_ms / 1e3):.0f} "
              f"frames/s; Trainer.test {test_s:.2f} s; peak memory "
              f"{peak_gb:.2f} GB", flush=True)
        print(f"  {xd}/{sd}: parts, synchronised apart: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in parts.items() if k != "step"))
        profile_step(torch, model, trainer, X, lab, step_ms)
        del model
        torch.cuda.empty_cache()
    return total


def time_step_parts(torch, model, trainer, X, lab, reps=5):
    """Host-clock medians (after one warm-up) of the forward, the loss
    (anchor matching), detect (softmax + NMS) and the whole eval step,
    each ending in a synchronise."""

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    fwd = model.forward_fn(trainer.time_batched)
    parts = {"forward": [], "loss": [], "detect": [], "step": []}
    with torch.inference_mode():
        for _ in range(reps + 1):
            (preds, _), ms = timed(lambda: fwd(X, start_step=5))
            parts["forward"].append(ms)
            parts["loss"].append(timed(lambda: model.loss(preds, lab))[1])
            parts["detect"].append(timed(lambda: model.detect(preds))[1])
            parts["step"].append(
                timed(lambda: trainer.eval_step(model, X, lab, 5))[1])
    return {k: statistics.median(v[1:]) for k, v in parts.items()}


def phase_schedules(torch, cuda_kernels, TinyYolo, batch, dev):
    """Phase 5: forward_seq against the per-step forward at fp32.

    With cuDNN the two schedules differ in the last bits: its algorithm
    for a conv depends on the batch (T*B frames against B), and the
    untrained net amplifies a flipped spike. That run is printed. The
    asserted run turns cuDNN off: PyTorch's own conv does one GEMM of
    the same shape per frame, so both schedules see the same conv sums
    and every other op is elementwise."""
    model = build_model(TinyYolo, "float32", "float32", dev)
    X = torch.as_tensor(batch[0], device=dev)
    r = 5

    def leaves(s):
        if isinstance(s, dict):
            return [x for k in sorted(s) for x in leaves(s[k])]
        return list(s)

    for cudnn in (True, False):
        torch.backends.cudnn.enabled = cudnn
        cuda_kernels.reset_launches()
        (cs, bs), st_seq = model.forward_seq(X, start_step=r)
        (cf, bf), st_step = model.forward(X, start_step=r)
        torch.cuda.synchronize()
        check(cuda_kernels.LAUNCHES["temporal_cell_seq"]
              == CELLS_PER_STEP * (1 + STEPS - r), "schedule launch count")
        agree = [
            float(((a.float() == 0) == (b.float() == 0)).float().mean())
            for a, b in zip(leaves(st_seq)[::2], leaves(st_step)[::2])
        ]
        max_pred = max(float((cs - cf).abs().max()),
                       float((bs - bf).abs().max()))
        print(f"  cudnn={cudnn}: forward_seq vs forward (start {r}): max "
              f"|pred diff| {max_pred:.3g}; final-state spike agreement "
              f"(v == 0) min {min(agree):.6f}, mean "
              f"{statistics.mean(agree):.6f}", flush=True)
    for a, b in ((cs, cf), (bs, bf)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    torch.backends.cudnn.enabled = True
    del model


def phase_streaming(torch, cuda_kernels, TinyYolo, batch, dev, frames=8):
    """Phase 6: predict frame by frame at B=1."""
    model = build_model(TinyYolo, "float32", "float32", dev)
    X = torch.as_tensor(batch[0][:frames, 0], device=dev)
    cuda_kernels.reset_launches()
    state, times = None, []
    for t in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets, state = model.predict(X[t], state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(tuple(dets.shape) == (300, 6)
              and bool(torch.isfinite(dets).all()), "predict output")
    check(cuda_kernels.LAUNCHES["temporal_cell_seq"]
          == CELLS_PER_STEP * frames, "predict launch count")
    print(f"  predict: {frames} frames, {int((dets[:, 0] >= 0).sum())} "
          f"detections on the last; median {statistics.median(times[1:]) * 1e3:.1f} "
          f"ms/frame (host clock)")


KERNEL_KINDS = (  # (kind, substrings of a CUDA kernel's name), first match
    ("cell kernel", ("temporal_cell_kernel",)),
    ("conv layout", ("nchwtonhwc", "nhwctonchw", "transpose", "permute")),
    ("conv", ("conv", "xmma", "gemm", "cutlass", "implicit", "fprop",
              "cudnn", "winograd", "fft", "complex", "nvjet", "sm90_",
              "sm80_")),
    ("sort / top-k", ("sort", "radix", "topk")),
    ("reduction", ("reduce", "argmax", "softmax", "scan")),
    ("copy / fill", ("memcpy", "memset", "fill", "copy", "cat")),
    ("elementwise", ("elementwise",)),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile_step(torch, model, trainer, X, lab, step_ms, top=6):
    """``torch.profiler`` over one eval step: device time by kernel kind
    and for the top kernels, the device's busy time (union of kernel
    intervals) and its idle share against the unprofiled ``step_ms``,
    and the cell kernels' time against their bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from snn_for_object_detection_tpu_torch.models.compile import Cell

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.eval_step(model, X, lab, 5)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("    device time not measured (the profiler saw no kernel)")
        return
    by_kind, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        for table, key in ((by_kind, kernel_kind(e.name)), (by_name, e.name)):
            n, total = table.get(key, (0, 0.0))
            table[key] = (n + 1, total + us)
    busy_us, span_end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        busy_us += max(0.0, e - max(s, span_end))
        span_end = max(span_end, e)
    busy_ms = busy_us / 1e3
    print(f"    profiled step: {len(kernels)} device kernels, device busy "
          f"{busy_ms:.2f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f} of the unprofiled step")
    for title, table, rows in (("kind", by_kind, len(by_kind)),
                               ("kernel", by_name, top)):
        for key, (n, us) in sorted(table.items(),
                                   key=lambda kv: -kv[1][1])[:rows]:
            print(f"    {title:6s} {key[:64]:64s} {n:5d}x {us / 1e3:8.3f} ms "
                  f"({us / busy_us:.3f} of busy)")
    # the cells' bound over the step: x read and z written at every
    # step, (v, i) read and written once, per cell
    sx = torch.empty((), dtype=model.compute_dtype).element_size()
    ss = torch.empty((), dtype=model.state_dtype).element_size()
    cell_bytes = sum(
        (2 * STEPS * sx + 4 * ss) * BATCH * m.out_channels
        * m.out_hw[0] * m.out_hw[1]
        for m in model.modules() if isinstance(m, Cell))
    cell_ms = by_kind.get("cell kernel", (0, 0.0))[1] / 1e3
    print(f"    cell kernels: {cell_ms:.3f} ms against a bound of "
          f"{cell_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"({cell_bytes / 1e9:.3f} GB at 3.35 TB/s)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo
    from snn_for_object_detection_tpu_torch.ops import cuda_build
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(f"[1] device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"    cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    sources = sorted(os.path.basename(p)
                     for p in glob.glob(os.path.join(cuda_build.CSRC, "*.cu")))
    t0 = time.perf_counter()
    per_source = cuda_build.build(sources)
    print(f"[2] build: {sources} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc per source: { {k: round(v, 1) for k, v in per_source.items()} })",
          flush=True)

    print("[3] kernels against their plain versions", flush=True)
    rows, worst = phase_kernels(torch, cuda_kernels, "cuda")

    print(f"[4] main path: TinyYolo GEN1 {IN_HW}, B={BATCH}, T={STEPS}, "
          f"Trainer(time_batched=True).test over {EVAL_BATCHES} batches",
          flush=True)
    batches = make_batches(EVAL_BATCHES, seed=0)
    launches = phase_main_path(torch, cuda_kernels, TinyYolo, Trainer,
                               batches, "cuda")

    print("[5] schedules agree", flush=True)
    phase_schedules(torch, cuda_kernels, TinyYolo, batches[0], "cuda")
    print("[6] streaming", flush=True)
    phase_streaming(torch, cuda_kernels, TinyYolo, batches[0], "cuda")

    ref = next(r for r in rows if (r["shape"], r["cell"], r["x"], r["start"])
               == ("stage1", "lif", "float32", 0))
    kernels = [{
        "name": "temporal_cell_seq",
        "route": "cuda",
        "source": "snn_for_object_detection_tpu_torch/csrc/temporal_cell.cu",
        "replaces": "snn_for_object_detection_tpu/ops/pallas_kernels.py:207",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ref["ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_ms"],
        "bound_by": ref["bound_by"],
        "library_ms": None,
    }]
    print(f"done in {time.perf_counter() - t_start:.1f} s; kernel times "
          f"above are the stage-1 fp32 LIF case [42,4,120,152,64]")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
