#!/usr/bin/env python3
"""Run the PyTorch + CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --only 3,7   # [1] and the phases named, no more
                                       # (3: spiking_conv_seq, its
                                       # fetched-rows form and
                                       # fused_pointwise_conv_bn_lif)
    python3 chip_smoke.py --only 10    # [1] and the training phase
    python3 chip_smoke.py --only 11    # [1] and the CLI on recordings
    python3 chip_smoke.py --only 12,13 # [1], the trained net, hybrid,
                                       # "auto" and 1Mpx
    python3 chip_smoke.py --only 14    # [1] and the model zoo
    python3 chip_smoke.py --only 15    # [1] and the last inference options
    python3 chip_smoke.py --only 16    # [1], data parallel, mesh serving
    python3 chip_smoke.py --only 17    # [1], training extras, plotter,
                                       # summary
    python3 chip_smoke.py --only 18    # [1] and spatial sharding
    python3 chip_smoke.py --only 19    # [1] and export

Phases (any failure raises and the script exits non-zero):

1. device: needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` gives them;
2. build: compiles every ``csrc/*.cu`` of the port with ``nvcc``, one
   process per source, all at once;
3. ``neurons.fma`` on the card bit-equal to its exact emulation; the
   kernels against their plain versions, each at fp32, bf16 and
   bf16 activations with e5m2 states; prints kernel ms, plain ms and
   the bound:
   - ``temporal_cell_seq`` on the main path's shapes (stage 1 and a
     head LI) must be bit-equal to ``temporal_cell_seq_reference`` for
     LIF/LI and two truncation starts;
   - ``spiking_conv_seq`` on eight of the fused path's triples (stage-1,
     -3, -4 and -5 downsamples, the stage-1 and stage-5 bottlenecks, the
     head-0 and head-2 stems), each printed with its launch plan:
     spike agreement >= 0.999 and at most 0.1% (fp32; 1% in bf16) of
     final state elements outside rtol 1e-4, atol 1e-5 (fp32) or two
     ulps of the storage dtype, since the kernel sums the conv in
     another order than cuDNN; bit-equal with 1x1 identity weights;
     every plan of the layer (``spiking_conv_plans``) bit-equal to the
     plan's and timed, the plan's time beside the fastest; also times the same triple on the unfused path (cuDNN conv, BN
     affine, cell kernel) and cuDNN's conv alone over the T x N frames;
   - ``spiking_conv_seq``'s fetched-rows form (``pad_h=0``, a rank's
     block of a map split along H) on every one of the 22 fused triples
     of GEN1 TinyYolo at full width, B=4, T=42, fp32 and bf16/e5m2: each
     row block of 2 and of 4 ranks, launched on its rows sliced from the
     zero-padded map, bit-equal to the whole map's launch and to its
     plain version (integer weights: exact sums); each map's launch
     timed beside its largest block's;
   - ``fused_pointwise_conv_bn_lif`` (``csrc/pointwise.cu``) on five
     shapes (``POINTWISE_CASES``: GEN1 4*120*152 rows 64->64 and
     4*30*38 rows 256->256, and the three of
     ``benchmarks/bench_pallas.py``): one launch a call, z and v'
     equal, i' within rtol 1e-5, atol 1e-6 (fp32), or in bf16 two ulps
     of the storage dtype plus the bound on two fp32 sums of the same
     products in different orders (the tensor cores sum in their own
     order; ``pointwise_i_outside``); prints per case the kernel's device time (calls
     queued behind a sleep kernel), the bound and its share of it, the
     plain version, ``torch.matmul`` of the product alone and the
     launch plan. No path of the package calls it;
4. main path: TinyYolo at GEN1 width (240x304, 2 classes, 4,228,544
   params, random weights from a seed) evaluated by ``Trainer(
   time_batched=True).test`` at B=4, T=42 over a few batches of seeded
   event frames and labels, in fp32 and in bf16 activations with e5m2
   states; the cell kernel must launch exactly 22 times per eval step.
   Then where one eval step's time goes: its parts on the host clock,
   device time by kernel kind, the device's idle share;
5. schedules agree: ``forward_seq`` against the per-step ``forward``;
6. streaming: ``predict`` frame by frame at B=1;
7. fused path: TinyYolo(fuse_seq=True, time_window=0) through the same
   ``Trainer.test`` on the same batches and weights as [4], in both
   dtype configurations: exactly 22 ``spiking_conv_seq`` and no
   ``temporal_cell_seq`` launches per eval step; its eval step timed
   and profiled beside the unfused ``forward_seq`` at time_window 0,
   with each fused triple's kernel ms, bound and launch plan.
   Final-state spike agreement >= 0.99 for every cell against the
   same fused schedule run with the plain versions on the card, and at
   fp32 also against the unfused path (the kernel sums the conv in
   another order than cuDNN; the untrained net at BatchNorm gain 8
   amplifies flipped spikes). In bf16 the unfused path is another
   function, as in the JAX package: it applies the BatchNorm affine in
   bf16 with bf16 coefficients, the fused kernel in fp32 between two
   roundings, so that agreement is printed, not asserted. Beside the
   0.99 gate, the witness (``megakernel.witness_passes``, both dtype
   configurations): the fused kernels' final state and predictions no
   further from the same schedule with exact conv sums (float64,
   rounded once) than the plain versions are, within its slack;
8. megakernel: ``StreamingMegakernel.step`` (one ``csrc/megakernel.cu``
   launch per frame) on TinyYolo GEN1 at B=1 over 16 frames of [4]'s
   event data with [4]'s weights, in both dtype configurations: exactly
   one ``streaming_megakernel`` launch per frame and no other; final
   state against the plain version run on the card (spike agreement
   >= 0.99 per LIF cell; LI states within a relative L2 error of 5% at
   fp32, 10% in bf16/e5m2: the kernel sums the convs in another order,
   split along K, in bf16 on the tensor cores, the untrained net at
   BatchNorm gain 8 flips a few
   spikes, and each flipped spike moves the membranes of a whole pixel
   of a head) and, at fp32, against the
   per-step ``SODa.step`` (the same function on cuDNN and the cell
   kernel); the witness over 16 event frames of each of 3 seeds (the
   kernel no further from the exact-sum run than the plain version, on
   every seed); at most 36 phases (the convs' dependency depth);
   ``predict`` and ``to_model_state``. Prints kernel, plain and
   ``SODa.step`` ms per frame, ``predict`` split into step and detect,
   the grid, phases and barriers, the bound, and the device time of each
   phase;
9. engine: ``StreamingEngine`` (capacity 8, 6 streams, one removed and
   one added part way, 24 steps) in sync and pipelined mode, both dtype
   configurations: 22 ``temporal_cell_seq`` launches per step, every
   output ``[k, 6]`` and finite and empty during a stream's warm-up; ms
   per step and per camera-frame;
10. train: the ``temporal_cell_seq`` backward kernel against autograd
   through ``temporal_cell_seq_reference`` at GEN1 stage 1 and the
   stride-8 head, fp32 and bf16 states, LIF and LI, over the sequence
   (T = 42) at start 0 and 5 and at T = 1 (each per-step launch) at
   start 0: every element bit-equal, or at most rtol 1e-5 of the largest
   cotangent with the count of elements that differ printed; kernel ms
   (queued), bound and share, the plain backward's ms and the launch
   plan (chunk, checkpoints shared or global, their bytes). Then ``Trainer.fit`` for 3
   steps on each schedule in both training configurations (fp32, and
   bf16 states with fp32 activations, ``config/fast.yaml``) at full GEN1
   width:
   22 backward launches a time-batched step and 22 x (T - r) a per-step
   one, no ``spiking_conv_seq``, finite losses, weights and running
   stats moved; a train step's ms (CUDA events), peak memory, and the
   device idle share and cell backward kernels' ms of one profiled step;
   and at fp32 with cuDNN off
   each schedule's first-step loss and gradients against the same
   schedule's through the plain cell, gradients within rtol 2e-3;
11. the CLI on recordings: a synthetic GEN1 set (2 recordings per split,
   2000 ms, seed 0) written by the port's ``make_synthetic_dataset``, read
   by ``PropheseeDataModule`` (the native rasterizer, worker threads);
   ``python -m snn_for_object_detection_tpu_torch`` run in-process
   (``cli.main``) with ``config/config.yaml`` + ``config/synthetic.yaml``
   (full-width TinyYolo, B=4, T=24, time window 6), read by the port's
   own YAML reader: ``fit`` cut to one epoch of 4 batches and one
   validation of 2, time-batched at fp32 and per-step with
   ``config/fast.yaml``; then ``test`` from the fp32 checkpoint
   per-step, fused (``fuse_seq=true time_window=0``) and with
   ``config/infer_fp8.yaml``, and ``validate``. Gates: finite losses
   and mAP; checkpoint, config snapshot and metrics file; restored
   weights bit-equal to the saved ones; the cell kernel and its backward
   in each ``fit``, ``spiking_conv_seq`` in the fused ``test``; the
   native rasterizer used; a one-worker loader bit-equal across two
   passes. Prints the loader's ms per batch alone (1 and 4 workers, T=42
   and T=24), ``fit`` ms per step beside ``train_step`` on an in-memory
   batch, the idle share of one profiled step fed by the loader, and
   each ``test``'s ms per batch.

12. the trained net: ``nets/tiny_yolo_synth_torch/model/state.pt`` (the
   JAX-trained synthetic net, written by
   ``scripts/export_synth_net_torch.py``; read with
   ``torch.load(weights_only=True)``, no JAX) in full-width GEN1 TinyYolo:
   [7]'s gates (fused against the fused schedule on the plain versions,
   at fp32 against the unfused path, spike agreement >= 0.99 a cell, the
   witness) and [8]'s (megakernel against its plain version and
   ``SODa.step``, LI relative L2, the witness), untimed, both dtype
   configurations, each printed beside the untrained net's; the relative
   L2 distance between the three train schedules' first-step gradients
   (fp32, cuDNN off); ``python -m snn_for_object_detection_tpu_torch
   test`` with ``nets/tiny_yolo_synth_torch/config.yaml`` and
   ``--ckpt_path`` on a synthetic GEN1 set, per-step and fused: finite
   metrics and an mAP above the same runs' from a checkpoint of [4]'s
   random weights;
13. hybrid, "auto" and 1Mpx: the cell kernel and its backward at the 1Mpx
   stage-1 shape ``[42, 2, 360, 640, 64]`` (4.95 GB at fp32), LIF and
   LI, fp32 and bf16 states, start 0 and 5, with [3]'s and [10]'s rules
   (forward bit-equal; backward bit-equal or within rtol 1e-5 of the
   largest cotangent); ``Trainer(time_batched="hybrid").fit`` at GEN1
   full width at fp32 (7 backward launches over
   the sequence and 15 x (T - r) at T = 1 a step, no ``spiking_conv_seq``),
   its first-step gradients at fp32 with cuDNN off against the plain
   cell's (rtol 2e-3), its step's ms, peak memory and idle share beside
   [10]'s; "auto" at ``config/config.yaml`` + ``config/1mpx.yaml``
   (720x1280, 7 classes, T=42, B=2, fp32): each schedule's ms and peak
   memory or its out-of-memory error, train and eval step; then the CLI's
   ``fit`` (2 train batches, 1 validation) and ``test`` (1 batch) with
   ``time_batched: auto`` and ``config/fast.yaml``'s bf16 states at T=42
   on a synthetic 1Mpx set: "auto" resolves, finite losses and mAP, the
   cell kernel and its backward launched; the loader's ms per 1Mpx batch.
14. the model zoo (``config/vgg.yaml``: VggSNN with PLIF cells, widths
   64 / 128 / 256, GEN1, B=4, T=42): (a) ``plif_cell_seq``, the PLIF
   form of the cell kernels, against ``plif_cell_seq_reference`` at
   VGG's stage-1 shape ``[42, 4, 240, 304, 32]`` and its deepest
   ``[42, 4, 15, 19, 256]``, fp32, bf16 and bf16 activations with e5m2
   states: the forward bit-equal at starts 0 and 5; the backward (T = 42
   at start 5, and T = 1) with gx, gv0, gi0 bit-equal or within rtol
   1e-5 of the largest as [10], the per-channel factor gradients within
   1e-4 of the largest (the kernel sums in another order); kernel ms
   against the bytes bound, plain ms, and the chunked kernels'
   registers; (b) the eval step per step, time-batched, hybrid and
   fused: the PLIF and LI kernels' launches (the fused step's three LI
   head stems in ``spiking_conv_seq``), final-state spike agreement
   >= 0.99 a cell against the time-batched step; (c) ``python -m
   snn_for_object_detection_tpu_torch fit`` with ``config/config.yaml``
   + ``config/vgg.yaml`` on a synthetic GEN1 set (3 steps,
   time-batched) and ``test`` from its checkpoint: finite losses and
   metrics, PLIF's backward kernel in every step, the raw time constants
   moved, the weights restored; (d) the plain PyTorch cells
   (``VggSNN(neuron="alif" | "sli")`` and a net with Synapse, ConvLSTM,
   ``Pool(3, stride=2)`` and a bilinear Up): one eval and one train step
   each, timed; (e) ``YoloSNN(scale="s")``: a train and an eval step,
   then its B=1 megakernel with [8]'s gates and the witness.
15. the last inference options: (a) every kernel's e4m3-state instance
   (``float8_e4m3fn``, stored as JAX stores it: NaN with the value's sign
   past 464) against its plain version, x fp32 and bf16, on inputs where
   at least 1% of the stored values overflow: the cell forward (LIF, LI;
   [3]'s shapes), its backward (T = 42 and T = 1; NaN where autograd's
   is, finite values as [10]), PLIF's forward and backward, three
   ``spiking_conv_seq`` triples, one pointwise shape and one megakernel
   frame, the last three with integer weights so that every sum is exact
   in any order: every output bit-equal (one-byte states as uint8 views,
   NaN positions and signs included); ms against the bound; (b) TinyYolo
   with bf16 activations and e4m3 states through [7]'s and [8]'s gates,
   its eval step's ms beside e5m2 states', and 3 ``Trainer.fit`` steps
   (time-batched) against the plain cell's; (c) ``s2d_stem=True`` with
   the stem's weights on a 2^-12 grid (exact sums): per-step and
   time-batched eval bit-equal to the plain stem, a train step's
   gradients within a relative L2 of 2e-3, the fused schedule's launches
   and metrics unchanged; (d) ``forward_with_records`` (B=4, T=12): 22
   records of [T, ...], the last equal to the returned state, 22 x T cell
   launches and no plain cell, the backbone's recording sequence form a
   step at a time, and ``spike_stats`` of the trained net; (e) int8 PTQ
   of the trained net: ``calibrate`` (4 batches), ``quantize``, the int8
   convs (``torch._int_mm``) bit-equal to their float64 plain version,
   ``Trainer.test`` per-step and time-batched (mAP, agreement with the fp
   net, eval ms), ``StreamingEngine.update_weights`` with the int8
   params, and the megakernel of the int8 net with [8]'s gates.
16. data parallel and mesh serving, on the trained net at full GEN1 width:
   (a) ``Trainer(mesh=make_mesh())`` on a one-rank NCCL group, two
   time-batched fp32 train steps (B=4, T=42, start 5, cuDNN
   deterministic): losses and weights bit-equal to the mesh-less
   trainer's (an all-reduce over one rank is the identity), 22 backward
   launches a step; (b) two ranks on the one card (gloo on CUDA tensors,
   ``torch.multiprocessing.spawn``, a FileStore), two rows each of the
   same batches: weights bit-equal across the ranks after each step; with
   cuDNN off (PyTorch's own conv sums each frame alike at any batch) the
   first step's loss within rtol 1e-4, its gradients within a relative L2
   of 0.02 and the running stats within rtol 1e-4, atol 1e-6 of the
   one-rank trainer whose BatchNorm sums its moments in the ranks' order
   (``ranks_order_moments``: the trained net turns another sum order into
   flipped spikes, 5.2e-4 of the loss); printed beside it: the distances
   from the one-rank run as it is, the one rank's own between the two sum
   orders, and with cuDNN on (its algorithm depends on the batch) from
   (a)'s run; (c) ``python
   -m torch.distributed.run --nproc_per_node 1 -m
   snn_for_object_detection_tpu_torch fit --distributed`` (NCCL) on a
   synthetic GEN1 set: exit 0, a metrics line a step; (d)
   ``StreamingEngine(mesh=make_mesh(["cuda:0", "cuda:0"]))``, capacity
   8, 6 streams, 16 frames (a warm-up of 4), against the mesh-less
   engine: detections
   bit-equal with cuDNN off, final-state spike agreement >= 0.99 a cell
   with it on, 22 cell launches a replica and step; (e) (b)'s train step
   ms a rank, the same step with no collective, the share of the step's
   collectives (BatchNorm's all-gathered sums and all-reduced gradients,
   the loss's counts, the gradients: the difference of the two) and of
   the gradients' alone, (d)'s engine
   step ms, and [11]'s
   loader-fed steps' idle share at ``prefetch_batches`` 0 and 2.
17. training extras, plotter and summary: (a) ``python -m
   snn_for_object_detection_tpu_torch fit`` with ``config/config.yaml``,
   ``config/logger.yaml`` and ``config/synthetic.yaml`` (full-width
   TinyYolo, B=4, T=24, time window 6, time-batched, 6 steps and one
   validation) with ``debug_nans`` and ``profile_dir``: ``metrics.csv``
   and the event file (read back by ``train.loggers.read_scalars``) hold
   ``metrics.jsonl``'s scalars, the Chrome trace holds the cell forward
   and backward kernels, the weights equal two plain fits' (cuDNN
   deterministic; gated at the plain fits' own distance); the train
   step's ms with and without ``debug_nans``; (b) a NaN weight raises
   ``FloatingPointError`` in a one-step ``Trainer(debug_nans=True).fit``;
   (c) ``predict --config config/config.yaml`` on (a)'s checkpoint: the
   video where ``cv2`` imports; ``Plotter.apply`` draws the boxes on
   their outlines and nowhere else (without ``cv2``: its red and blue
   pixels are the frame's events); (d) ``utils.summary.summarize`` of GEN1 TinyYolo.
18. spatial sharding: ``Trainer(mesh=make_mesh(spatial=2))`` on two gloo
   ranks on the card as a (data 1 x space 2) grid (``torch.
   multiprocessing.spawn``, a FileStore; gloo on CUDA tensors), the
   trained net at full GEN1 width, B=4, T=42, start 5,
   each rank on its 120 rows of the input: a time-batched fp32 train
   step and a hybrid step, cuDNN off: the ranks' weights bit-equal
   after each step; a rank's cell backward kernel 22 times a
   time-batched step, its forward 44 (the recompute's 22 with them); the
   first step's loss within rtol 1e-6, its gradients within a relative
   L2 of 1e-5 (each leaf's within 1e-4) and the running statistics
   within rtol 1e-4 of one rank
   whose BatchNorm sums its moments and whose convs sum their outputs in
   the space blocks' order (blocks along H, ``ranks_order_moments(
   along=1)``, ``blocks_order_convs``: PyTorch's own conv picks its GEMM
   by the map's shape); printed beside it, the distance from one rank as
   it is. Prints a rank's step ms
   and peak memory beside one rank's (cuDNN on), and the halo exchanges
   of a step (the space group's collectives, wrapped): their count and
   their synchronised time's share of it. Then, cuDNN off, on the same
   ranks: ``Trainer.test`` of the trained net with ``fuse_seq=True`` at
   time window 0 (every triple on the fetched-rows form, 22 launches a
   rank and eval step), whose detections and first forward's
   predictions must be bit-equal to one rank's fused eval (its unfused
   tail convs summed in the blocks' order); and one time-batched train
   step of [14] (d)'s zoo net (a strided max Pool, a k=3 ConvLSTM and a
   bilinear Up, the layers that split last), the ranks' weights
   bit-equal after it, its loss within rtol 1e-2 and its gradients
   within a relative L2 of 0.1 of one rank's (whose LSTM conv and resize
   sum whole maps).
19. export: ``export.export_predict(..., platforms=("cuda",))`` with a
   symbolic batch of the trained net at fp32 (16 frames), of the trained
   net with ``config/infer_fp8.yaml``'s bf16 activations and e5m2 states
   and of ``config/vgg.yaml``'s VggSNN (PLIF; 4 frames each); the three
   files loaded by ``export.load_predict`` in one fresh process that
   imports nothing of ``models/``, ``train/``, ``serve``, ``data/`` or
   the CLI: at B=2 [4]'s frames give detections bit-equal to
   ``SODa.predict`` on the card, frame by frame, with one launch of the
   cell kernel (through the registered operators) a cell and frame,
   counted in that process (22 for TinyYolo); after ``reset()`` B=3 from
   the same file, bit-equal too; a batch change refused. Prints the
   export and load seconds, the file's MB and the loaded runner's ms a
   frame beside ``predict``'s.

Model and data values of [3]-[10], with their source (those phases pass
them as arguments; [11] reads the YAML files):
config/config.yaml:9-13 num_classes 2, in_hw [240, 304], loss_ratio
0.04, time_window 16, iou_threshold 0.4; config/config.yaml:22,25
batch_size 4, num_steps 42; config/infer_fp8.yaml:28-29 compute_dtype
bfloat16, state_dtype float8_e5m2.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every ported kernel with its launches on the main path.
"""

from __future__ import annotations

import functools
import glob
import importlib.util
import itertools
import json
import os
import re
import shutil
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
BACKBONE_CELLS = 7  # of them in the backbone (stages 1-2: 3 + 4 LIF)
# what [7], [8] and [10] measured, by net ("untrained": [4]'s random
# weights; "trained": [12]'s), for [12] to print side by side; and
# [10]'s and [13]'s train steps (ms, peak GB, idle share) by
# (x dtype, state dtype, schedule)
AGREEMENTS = {}
TRAIN_STEP_TIMES = {}
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores (JAX's fp32 semantics forbid TF32), dense bf16
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
# fp32 operations per element-step of the cell update (LIF: sub, add,
# fma, fma, sub, compare, select, add)
CELL_OPS = 8
DTYPE_PAIRS = (("float32", "float32"), ("bfloat16", "bfloat16"),
               ("bfloat16", "float8_e5m2"))
# fused triples of TinyYolo GEN1 checked in [3]: (label, k, stride, cell,
# Cin, Cout, input (H, W), share of input spikes)
SPIKING_CONV_CASES = (
    ("stage1_down", 3, 2, "lif", 2, 64, (240, 304), EVENT_DENSITY),
    ("stage1_bottleneck", 3, 1, "lif", 32, 32, (120, 152), 0.2),
    ("stage3_down", 3, 2, "lif", 128, 256, (60, 76), 0.2),
    ("stage4_down", 3, 2, "lif", 256, 256, (30, 38), 0.2),
    ("stage5_down", 3, 2, "lif", 256, 256, (15, 19), 0.2),
    ("stage5_bottleneck", 3, 1, "lif", 128, 128, (8, 10), 0.2),
    ("head0_stem", 1, 1, "li", 256, 256, (30, 38), 0.2),
    ("head2_stem", 1, 1, "li", 256, 256, (8, 10), 0.2),
)
# (rows, Cin, Cout) of fused_pointwise_conv_bn_lif in [3]: GEN1 at B=4
# (the stage-1 map, 64->64, and a stride-8 map, 256->256), then the
# three C2f 1x1 shapes at B=16 of benchmarks/bench_pallas.py:34-38
POINTWISE_CASES = (
    (BATCH * 120 * 152, 64, 64), (BATCH * 30 * 38, 256, 256),
    (16 * 30 * 38, 256, 128), (16 * 60 * 76, 128, 64),
    (16 * 120 * 152, 64, 64),
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def ulp(x, dtype):
    """The spacing of ``dtype`` at each value of the fp32 tensor ``x``
    (subnormal spacing below the smallest normal)."""
    import torch

    mantissa, emin = {
        torch.float32: (23, -126), torch.bfloat16: (7, -126),
        torch.float8_e5m2: (2, -14),
    }[dtype]
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** emin)))
    return torch.exp2(e - mantissa)


def outside_share(got, want, dtype) -> float:
    """Share of the elements of ``got`` outside the spiking conv's gate
    around ``want``: rtol 1e-4, atol 1e-5 at fp32, two ulps of
    ``dtype`` (the storage dtype) otherwise. Equal values (inf
    included) and NaN against NaN are inside."""
    import torch

    g, w = got.float(), want.float()
    if dtype == torch.float32:
        tol = 1e-5 + 1e-4 * w.abs()
    else:
        tol = 2 * ulp(w, dtype)
    inside = ((g - w).abs() <= tol) | (g == w) | (g.isnan() & w.isnan())
    return 1.0 - float(inside.float().mean())


def pointwise_i_outside(got, want, x, w, a):
    """Shares of the elements of the pointwise kernel's i' outside two
    gates around the plain version's: (strict, gate). Strict is rtol
    1e-5, atol 1e-6 at fp32 or two ulps of the storage dtype. With fp32
    x the gate is the strict tolerance. With bf16 x the gate adds what
    two fp32 sums of the same Cin products in different orders may
    differ by, 2 * gamma_Cin * sum_k |x_k w_k| with gamma_K = K u /
    (1 - K u), u = 2^-24, scaled by |a|: the tensor cores sum in their
    own order, and where i_dec + y cancels that difference is many ulps
    of the small i'. A dropped or misplaced product moves i' by a whole
    |x_k w_k| |a|, far past the bound."""
    import torch

    g, wf = got.float(), want.float()
    if want.dtype == torch.float32:
        tol = 1e-6 + 1e-5 * wf.abs()
    else:
        tol = 2 * ulp(wf, want.dtype)
    diff = (g - wf).abs()
    same = (g == wf) | (g.isnan() & wf.isnan())
    strict = 1.0 - float(((diff <= tol) | same).float().mean())
    if x.dtype == torch.float32:
        return strict, strict
    k = x.shape[1]
    gamma = k * 2.0 ** -24 / (1 - k * 2.0 ** -24)
    bound = 2 * gamma * (x.float().abs() @ w.float().abs()) * a.float().abs()
    gate = 1.0 - float(((diff <= tol + bound) | same).float().mean())
    return strict, gate


def pointwise_bound(n, cin, cout, sx, ss):
    """``(bound_ms, bound_by)`` of one ``fused_pointwise_conv_bn_lif``
    call at ``n`` x ``cin`` -> ``cout`` with x of ``sx`` and states of
    ``ss`` bytes: the larger of its HBM bytes (x, w, z in x's type; v, i,
    v', i' in the state's; a, b) over the HBM rate and its multiply-adds
    over the fp32 or bf16 peak."""
    ops_ms = 2 * n * cin * cout / (FP32_FLOPS if sx == 4 else BF16_FLOPS) \
        * 1e3
    bytes_ms = ((n * cin + cin * cout + n * cout) * sx + 4 * n * cout * ss
                + 8 * cout) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def relative_l2(got, want) -> float:
    """``|got - want|_2 / |want|_2`` in fp32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def spike_agreement(got, want) -> float:
    """Share of equal spikes (z != 0) in two spike tensors."""
    return float(((got.float() != 0) == (want.float() != 0)).float().mean())


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


def queued_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms per call of a short kernel: the card is kept busy (a
    sleep kernel) while ``calls`` calls are enqueued between two CUDA
    events, so the host's per-call overhead (wrapper, allocations)
    never idles the device between them; median over ``reps``."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def check_fma(torch, neurons, dev, n=1 << 22):
    """``neurons.fma`` on the card (PyTorch's contracted ``addcmul`` and
    ``add(alpha=)``) bit-equal to its exact emulation on the CPU, over
    values of mixed magnitudes and signs."""
    rng = np.random.default_rng(11)
    a, b, c = (rng.standard_normal(n).astype(np.float32)
               * np.exp2(rng.integers(-20, 20, n)).astype(np.float32)
               for _ in range(3))
    cpu = [torch.from_numpy(v) for v in (a, b, c)]
    for scalar in (False, True):
        # the cells' factors are fp32 values (neurons.euler_factors)
        bb = float(np.float32(0.1)) if scalar else cpu[1]
        want = neurons.fma(cpu[0], bb, cpu[2])
        got = neurons.fma(cpu[0].to(dev), bb if scalar else cpu[1].to(dev),
                          cpu[2].to(dev)).cpu()
        same = (got == want) | (got.isnan() & want.isnan())
        check(bool(same.all()), f"neurons.fma on the card differs from the "
              f"exact fma on {int((~same).sum())} of {n} values "
              f"({'scalar' if scalar else 'tensor'} factor)")
    print(f"  neurons.fma on the card: bit-equal to the exact emulation on "
          f"{n} values, tensor and scalar factors", flush=True)


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
                    print(f"  {label:9s} {cell:3s} {xd:8s}/{sd:11s} "
                          f"start={start}: bit-equal; kernel {ms:.4f} ms, "
                          f"plain {plain_ms:.3f} ms, bound "
                          f"{rows[-1]['bound_ms']:.4f} ms "
                          f"({rows[-1]['gb_per_s']:.0f} GB/s)", flush=True)
        del x32, v32, i32, x, v0, i0
        torch.cuda.empty_cache()
    return rows, worst


def triple_bound(k, cin, cout, in_hw, out_hw, x_bytes, state_bytes):
    """Least time (ms) of one fused [conv -> BN -> cell] over STEPS x
    BATCH frames, and what bounds it: the larger of 2 * MACs over the
    peak of the activation type (fp32 lanes for fp32, tensor cores for
    bf16) and, over the HBM rate, the bytes of x read once, z written
    once, the state read and written once and the weights once."""
    frames = STEPS * BATCH
    macs = frames * out_hw[0] * out_hw[1] * cout * cin * k * k
    peak = FP32_FLOPS if x_bytes == 4 else BF16_FLOPS
    nbytes = (frames * (in_hw[0] * in_hw[1] * cin
                        + out_hw[0] * out_hw[1] * cout) * x_bytes
              + 4 * BATCH * out_hw[0] * out_hw[1] * cout * state_bytes
              + k * k * cin * cout * x_bytes + 8 * cout)
    ops_ms = 2 * macs / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def layer_plan(cuda_kernels, k, stride, n, out_hw, cin, cout, x_dtype):
    """The launch plan ``spiking_conv_seq`` takes on this card."""
    return cuda_kernels.spiking_conv_plan(k, stride, n, *out_hw, cin, cout,
                                          x_dtype, cuda_kernels.sm_count(0))


def plan_text(plan) -> str:
    """One launch plan of ``spiking_conv_seq`` (cuda_kernels.ConvPlan)."""
    return (f"{plan.co} channels x {plan.th}x{plan.tw} px x 4 "
            f"steps a CTA, {plan.threads} threads, {plan.kc} input channels "
            f"a stage, weights {'resident' if plan.resident else 'streamed'}"
            f", {plan.smem} B shared, {plan.grid} CTAs")


def max_abs_err(got, want) -> float:
    g, w = got.float(), want.float()
    finite = g.isfinite() & w.isfinite()
    return float((g - w)[finite].abs().max()) if bool(finite.any()) else 0.0


def unfused_triple(torch, C, neurons, k, stride, cell, cin, cout, in_hw,
                   sd, w, a, b):
    """The same triple on the port's unfused path: the compiler's Conv
    (cuDNN), Norm (the affine in the activation dtype) and Cell
    (``temporal_cell_seq``) modules, with BatchNorm set so that its
    folded affine is exactly (a, b)."""
    conv = C.Conv(cin, cout, k, stride, in_hw).to(w.device)
    norm = C.Norm(cout, conv.out_hw, True, 0.0).to(w.device)
    layer = C.Cell(cell, cout, conv.out_hw, sd)
    state_t = neurons.LIFState if cell == "lif" else neurons.LIState
    with torch.no_grad():
        conv.w.copy_(w.permute(3, 2, 0, 1))
        norm.scale.copy_(a)
        norm.bias.copy_(b)
    ctx = C.Ctx()

    def run(x, v0, i0):
        y, _ = conv.seq(x, (), ctx)
        y, _ = norm.seq(y, (), ctx)
        return layer.seq(y, state_t(v0, i0), ctx)

    return run


def conv_alone(torch, x, w, stride):
    """cuDNN's conv alone on the triple's input, as ``Conv.seq`` runs it:
    one ``F.conv2d`` over the T x N frames of a channels-last view (TF32
    off: [1] turns it off for the whole run). The yardstick of the
    fused kernel's conv; no path of the port calls it so."""
    import torch.nn.functional as F

    T, n, h, wd, cin = x.shape
    frames = x.reshape(T * n, h, wd, cin).permute(0, 3, 1, 2)
    w_oihw = w.to(x.dtype).permute(3, 2, 0, 1).contiguous()
    return lambda: F.conv2d(frames, w_oihw, stride=stride,
                            padding=w.shape[0] // 2)


def conv_out_hw(k, stride, hw):
    return tuple((d + 2 * (k // 2) - k) // stride + 1 for d in hw)


def spiking_conv_inputs(torch, case, dev):
    """Seeded fp32 ``(x, w, a, b, v0, i0)`` of one ``SPIKING_CONV_CASES``
    triple at [T, B] = [42, 4]: Bernoulli event input at the case's
    density, weights giving a conv output of about unit spread before
    the BN affine, the affine away from identity, states around 0."""
    _, k, stride, _, cin, cout, hw, density = case
    gen = torch.Generator(device=dev).manual_seed(2)
    x32 = (torch.rand((STEPS, BATCH, *hw, cin), generator=gen,
                      device=dev) < density).float()
    w = torch.randn((k, k, cin, cout), generator=gen, device=dev) \
        / (k * k * cin * density) ** 0.5
    a = torch.rand(cout, generator=gen, device=dev) + 0.5
    b = 0.1 * torch.randn(cout, generator=gen, device=dev)
    state = (BATCH, *conv_out_hw(k, stride, hw), cout)
    v32 = 0.3 * torch.randn(state, generator=gen, device=dev)
    i32 = 0.3 * torch.randn(state, generator=gen, device=dev)
    return x32, w, a, b, v32, i32


def identity_inputs(torch, dev, c=256):
    """Seeded ``(x, w, a, b, v0)`` of [3]'s 1x1 identity case: normal x
    [42, 4, 30, 38, 256], identity weights (an exact conv)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x32 = 2.0 * torch.randn((STEPS, BATCH, 30, 38, c), generator=gen,
                            device=dev)
    eye = torch.eye(c, device=dev)[None, None]
    a = torch.rand(c, generator=gen, device=dev) + 0.5
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    v32 = 0.3 * torch.randn((BATCH, 30, 38, c), generator=gen, device=dev)
    return x32, eye, a, b, v32


def phase_spiking_conv(torch, cuda_kernels, C, neurons, dev):
    """Phase 3, spiking_conv_seq: the gates on eight triples of the
    fused path, every plan of the layer bit-equal to the plan's and
    timed, the identity case bit-equal; returns per-case timings."""
    rows, worst = [], 0.0
    for case in SPIKING_CONV_CASES:
        label, k, stride, cell, cin, cout, hw, _ = case
        out_hw = conv_out_hw(k, stride, hw)
        x32, w, a, b, v32, i32 = spiking_conv_inputs(torch, case, dev)
        for xd, sd in DTYPE_PAIRS:
            xd, sd = getattr(torch, xd), getattr(torch, sd)
            x, v0, i0 = x32.to(xd), v32.to(sd), i32.to(sd)
            args = (x, w, a, b, v0, i0, cell, stride)
            got = cuda_kernels.spiking_conv_seq(*args)
            want = cuda_kernels.spiking_conv_seq_reference(*args)
            torch.cuda.synchronize()
            limit = 0.001 if xd == torch.float32 else 0.01
            tag = f"{label} {xd}/{sd}"
            if cell == "lif":
                agree = spike_agreement(got[0], want[0])
                check(agree >= 0.999, f"{tag}: spike agreement {agree}")
                check(0 < float(want[0].float().mean()) < 1,
                      f"{tag}: the plain version never or always spikes")
            else:
                agree = 1.0 - outside_share(got[0], want[0], xd)
                check(agree >= 1.0 - limit, f"{tag}: LI output {agree}")
            outside = [outside_share(g, w_, sd)
                       for g, w_ in zip(got[1:], want[1:])]
            check(max(outside) <= limit,
                  f"{tag}: final state outside its tolerance on "
                  f"{outside} (limit {limit})")
            err = max(max_abs_err(g, w_) for g, w_ in zip(got, want))
            worst = max(worst, err)
            del want
            # every plan sums in the same order: bit-equal to the plan's
            # launch; each plan's time beside the plan's choice
            plan = layer_plan(cuda_kernels, k, stride, BATCH, out_hw, cin,
                              cout, xd)
            plans = cuda_kernels.spiking_conv_plans(k, stride, BATCH,
                                                    *out_hw, cin, cout, xd)
            plan_ms = []
            for alt in plans:
                other = cuda_kernels.spiking_conv_seq_launch(*args, alt)
                torch.cuda.synchronize()
                check(all(bool(((g == o) | (g.isnan() & o.isnan())).all())
                          for g, o in zip(got, other)),
                      f"{tag}: plan {plan_text(alt)} differs from the "
                      f"plan's")
                del other
                plan_ms.append(cuda_time_ms(
                    lambda alt=alt: cuda_kernels.spiking_conv_seq_launch(
                        *args, alt), reps=3, warmup=1))
            del got
            ms = cuda_time_ms(lambda: cuda_kernels.spiking_conv_seq(*args),
                              reps=10)
            plain_ms = cuda_time_ms(
                lambda: cuda_kernels.spiking_conv_seq_reference(*args),
                reps=3, warmup=1)
            unfused = unfused_triple(torch, C, neurons, k, stride, cell,
                                     cin, cout, hw, sd, w, a, b)
            with torch.inference_mode():
                unfused_ms = cuda_time_ms(lambda: unfused(x, v0, i0),
                                          reps=10)
                conv_ms = cuda_time_ms(conv_alone(torch, x, w, stride),
                                       reps=10)
            bound_ms, bound_by = triple_bound(
                k, cin, cout, hw, out_hw, x.element_size(),
                v0.element_size())
            rows.append(dict(shape=label, x=str(xd), state=str(sd),
                             ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
                             conv_ms=conv_ms, bound_ms=bound_ms,
                             bound_by=bound_by, plan=plan_text(plan),
                             plan_ms=plan_ms))
            best = min(range(len(plans)), key=plan_ms.__getitem__)
            chosen = plan_ms[plans.index(plan)]
            print(f"  spiking_conv_seq {label:17s} {k}x{k} s{stride} {cell:3s} "
                  f"{cin}->{cout} {str(xd)[6:]:8s}/{str(sd)[6:]:11s}: "
                  f"{'spikes' if cell == 'lif' else 'LI out'} {agree:.6f}, "
                  f"states outside {max(outside):.2e}, max abs err "
                  f"{err:.3g}; kernel {ms:.4f} ms ({bound_ms / ms:.0%} of "
                  f"bound {bound_ms:.4f} ms, {bound_by}), plain "
                  f"{plain_ms:.3f} ms, unfused triple {unfused_ms:.4f} ms, "
                  f"cuDNN conv alone {conv_ms:.4f} ms; plan: "
                  f"{rows[-1]['plan']}; {len(plans)} plans bit-equal, "
                  f"the plan {chosen:.4f} ms among them, the fastest "
                  f"{plan_ms[best]:.4f} ms: {plan_text(plans[best])}",
                  flush=True)
            del x, v0, i0, args
        del x32, v32, i32
        torch.cuda.empty_cache()

    # 1x1 identity weights: the conv is exact, so kernel == plain version
    x32, eye, a, b, v32 = identity_inputs(torch, dev)
    for xd, sd in DTYPE_PAIRS:
        xd, sd = getattr(torch, xd), getattr(torch, sd)
        for cell in ("lif", "li"):
            args = (x32.to(xd), eye, a, b, v32.to(sd), v32.to(sd), cell)
            got = cuda_kernels.spiking_conv_seq(*args)
            want = cuda_kernels.spiking_conv_seq_reference(*args)
            torch.cuda.synchronize()
            for name, g, w_ in zip(("z", "v_T", "i_T"), got, want):
                g, w_ = g.float(), w_.float()
                check(bool(((g == w_) | (g.isnan() & w_.isnan())).all()),
                      f"identity {cell} {xd}/{sd}: {name} differs from the "
                      f"plain version (max abs err {max_abs_err(g, w_)})")
    print("  spiking_conv_seq 1x1 identity [42,4,30,38,256]: bit-equal for "
          "lif/li at fp32, bf16, bf16/e5m2", flush=True)
    del x32, v32
    torch.cuda.empty_cache()
    return rows, worst


# [3] (b): spiking_conv_seq's fetched-rows form on the row blocks of
# this many ranks (halo.row_blocks), every fused triple of GEN1 TinyYolo
ROW_BLOCK_RANKS = (2, 4)


def phase_spiking_conv_rows(torch, cuda_kernels, C, TinyYolo, dev):
    """[3] (b): ``spiking_conv_seq(pad_h=0)``, the form a rank of a
    ``(data, space)`` grid runs in fused eval ([18]), on each of the
    CELLS_PER_STEP fused triples of GEN1 TinyYolo at full width (T, B =
    STEPS, BATCH; fp32 and bf16/e5m2): the whole map's launch, then each
    block of every ROW_BLOCK_RANKS split of the output rows launched on
    its input rows sliced from the zero-padded map (what ``Conv.
    rows_read`` fetches: the halo and the zero rows in place). Weights on
    a 1/8 grid of small integers (``int_weights``) make every conv sum
    exact, so the kernel meets its plain version with exact sums
    (``exact_sums=True``: cuDNN may take Winograd's inexact transforms
    for a 3x3 map of some shapes) bit for bit. Gates each block's z, v
    and i bit-equal to the whole map's rows and to the plain version's
    ``pad_h=0`` form on the same rows, and the whole map to its plain
    version. Times (CUDA events, median of 5) each map's
    launch beside its largest block's at each split; returns the rows."""
    import torch.nn.functional as F

    from snn_for_object_detection_tpu_torch.parallel import row_blocks

    t0 = time.perf_counter()
    model = build_model(TinyYolo, "float32", "float32", dev)
    triples = [t for block in (model.backbone, model.neck,
                               *(h["base"] for h in model.heads()))
               for t in fused_triples(C.Block, block)]
    check(len(triples) == CELLS_PER_STEP,
          f"[3] (b): {len(triples)} fused triples, want {CELLS_PER_STEP}")
    del model
    rows_out = []
    spiking = cuda_kernels.spiking_conv_seq
    plain = functools.partial(cuda_kernels.spiking_conv_seq_reference,
                              exact_sums=True)
    for n, (conv, _, cell) in enumerate(triples):
        k, s = conv.k, conv.stride
        cout, cin = conv.w.shape[:2]
        (h, wd), ho = conv.in_hw, conv.out_hw[0]
        p = k // 2
        gen = torch.Generator(device=dev).manual_seed(100 + n)
        density = EVENT_DENSITY if cin == 2 else 0.2
        x32 = (torch.rand((STEPS, BATCH, h, wd, cin), generator=gen,
                          device=dev) < density).float()
        w = int_weights(torch, (k, k, cin, cout), dev, 100 + n) * 0.125
        a = torch.rand(cout, generator=gen, device=dev) + 0.5
        b = 0.1 * torch.randn(cout, generator=gen, device=dev)
        state = (BATCH, ho, conv.out_hw[1], cout)
        v32 = 0.3 * torch.randn(state, generator=gen, device=dev)
        i32 = 0.3 * torch.randn(state, generator=gen, device=dev)
        for xd, sd in (("float32", "float32"), ("bfloat16", "float8_e5m2")):
            xd, sd = getattr(torch, xd), getattr(torch, sd)
            x, v0, i0 = x32.to(xd), v32.to(sd), i32.to(sd)
            tag = (f"[3] (b) {conv.name} {k}x{k} s{s} {cell.kind} "
                   f"{cin}->{cout} {h}x{wd} {str(xd)[6:]}/{str(sd)[6:]}")
            whole = spiking(x, w, a, b, v0, i0, cell.kind, s)
            check(all(bits_equal(g, r) for g, r in zip(
                whole, plain(x, w, a, b, v0, i0, cell.kind, s))),
                f"{tag}: the whole map differs from its plain version")
            whole_ms = cuda_time_ms(
                lambda: spiking(x, w, a, b, v0, i0, cell.kind, s), reps=5)
            padded = F.pad(x, (0, 0, 0, 0, p, p + s))
            row = dict(name=conv.name, k=k, stride=s, cell=cell.kind,
                       cin=cin, cout=cout, in_hw=(h, wd), x=str(xd),
                       state=str(sd), whole_ms=whole_ms)
            for ranks in ROW_BLOCK_RANKS:
                for j, (o0, o1) in enumerate(row_blocks(ho, ranks)):
                    args = (padded[:, :, o0 * s:(o1 - 1) * s + k]
                            .contiguous(), w, a, b,
                            v0[:, o0:o1].contiguous(),
                            i0[:, o0:o1].contiguous(), cell.kind, s)
                    got = spiking(*args, pad_h=0)
                    want = (whole[0][:, :, o0:o1], whole[1][:, o0:o1],
                            whole[2][:, o0:o1])
                    check(all(bits_equal(g, r) for g, r in zip(got, want)),
                          f"{tag}: block {j} of {ranks} (rows {o0}-{o1}) "
                          f"differs from the whole map's rows")
                    check(all(bits_equal(g, r) for g, r in zip(
                        got, plain(*args, pad_h=0))),
                        f"{tag}: block {j} of {ranks} differs from its "
                        f"plain version")
                    if j == 0:  # the largest block: the slowest rank
                        row[f"block_ms_{ranks}"] = cuda_time_ms(
                            lambda args=args: spiking(*args, pad_h=0),
                            reps=5)
                    del got, args
            rows_out.append(row)
            print(f"  {tag}: whole map {whole_ms:.4f} ms; largest block of "
                  + ", of ".join(f"{r} ranks {row[f'block_ms_{r}']:.4f} ms"
                                 for r in ROW_BLOCK_RANKS)
                  + "; every block bit-equal to the whole map's rows and "
                  "to its plain version", flush=True)
            del x, v0, i0, whole, padded
        del x32, v32, i32
        torch.cuda.empty_cache()
    for xd in ("torch.float32", "torch.bfloat16"):
        sel = [r for r in rows_out if r["x"] == xd]
        print(f"  [3] (b) {xd[6:]}: the {len(sel)} triples' whole maps "
              f"{sum(r['whole_ms'] for r in sel):.3f} ms; their largest "
              f"blocks " + ", ".join(
                  f"of {n} ranks "
                  f"{sum(r[f'block_ms_{n}'] for r in sel):.3f} ms"
                  for n in ROW_BLOCK_RANKS), flush=True)
    print(f"  [3] (b) in {time.perf_counter() - t0:.1f} s", flush=True)
    return rows_out


def pointwise_plan_text(plan) -> str:
    """One launch plan of ``fused_pointwise_conv_bn_lif``."""
    return (f"{plan.rows} rows x {plan.cout_tile} channels a tile "
            f"({plan.splits} Cout split{'s' if plan.splits > 1 else ''}), "
            f"{plan.smem} B shared, {plan.grid} CTAs "
            f"({plan.ctas_per_sm} an SM)")


def pointwise_inputs(torch, n, cin, cout, dev):
    """Seeded fp32 ``(x, w, a, b, v, i)`` of one pointwise case: w scaled
    by Cin^-1/2 and the states around 0.5, so that some neurons spike."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((n, cin), generator=gen, device=dev)
    w = torch.randn((cin, cout), generator=gen, device=dev) / cin ** 0.5
    a = torch.rand(cout, generator=gen, device=dev) + 0.5
    b = 0.1 * torch.randn(cout, generator=gen, device=dev)
    v = 0.4 * torch.randn((n, cout), generator=gen, device=dev) + 0.5
    i = 0.4 * torch.randn((n, cout), generator=gen, device=dev) + 0.5
    return x, w, a, b, v, i


def phase_pointwise(torch, cuda_kernels, dev):
    """Phase 3, fused_pointwise_conv_bn_lif: z and v' equal, i' within
    its gate (``pointwise_i_outside``: rtol 1e-5, atol 1e-6 with fp32 x),
    one launch a call; returns per-case timings."""
    rows, worst = [], 0.0
    for n, cin, cout in POINTWISE_CASES:
        x32, w32, a, b, v32, i32 = pointwise_inputs(torch, n, cin, cout, dev)
        for xd, sd in DTYPE_PAIRS:
            xd, sd = getattr(torch, xd), getattr(torch, sd)
            args = (x32.to(xd), w32.to(xd), a, b, v32.to(sd), i32.to(sd))
            cuda_kernels.reset_launches()
            z, v, i = cuda_kernels.fused_pointwise_conv_bn_lif(*args)
            check(cuda_kernels.LAUNCHES["fused_pointwise_conv_bn_lif"] == 1,
                  "fused_pointwise_conv_bn_lif: not one launch a call")
            wz, wv, wi = cuda_kernels.fused_pointwise_conv_bn_lif_reference(
                *args)
            torch.cuda.synchronize()
            tag = f"pointwise {n}x{cin}->{cout} {xd}/{sd}"
            check(0 < float(wz.float().mean()) < 1, f"{tag}: no spikes")
            check(bool((z.float() == wz.float()).all()
                       & (v.float() == wv.float()).all()),
                  f"{tag}: z or v' differs from the plain version")
            strict, outside = pointwise_i_outside(i, wi, *args[:3])
            err = max_abs_err(i, wi)
            check(outside == 0.0, f"{tag}: i' outside its gate on "
                  f"{outside:.3g} of the elements (max abs err {err})")
            worst = max(worst, err)
            del z, v, i, wz, wv, wi
            plan = cuda_kernels.pointwise_plan_on(0, n, cin, cout, xd, sd)
            ms = queued_ms(
                lambda: cuda_kernels.fused_pointwise_conv_bn_lif(*args))
            plain_ms = cuda_time_ms(
                lambda: cuda_kernels.fused_pointwise_conv_bn_lif_reference(
                    *args), reps=5, warmup=1)
            matmul_ms = queued_ms(lambda: torch.matmul(args[0], args[1]))
            bound_ms, bound_by = pointwise_bound(
                n, cin, cout, args[0].element_size(), args[4].element_size())
            rows.append(dict(n=n, cin=cin, cout=cout, x=str(xd),
                             state=str(sd), ms=ms, plain_ms=plain_ms,
                             matmul_ms=matmul_ms, bound_ms=bound_ms,
                             bound_by=bound_by,
                             plan=pointwise_plan_text(plan)))
            print(f"  fused_pointwise_conv_bn_lif {n}x{cin}->{cout} "
                  f"{str(xd)[6:]:8s}/{str(sd)[6:]:11s}: z, v' equal, i' max "
                  f"abs err {err:.3g} ({strict:.2g} of the elements past "
                  + ("rtol 1e-5, atol 1e-6" if xd == torch.float32 else
                     "two storage ulps, none past the sum-order gate")
                  + f"); kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({rows[-1]['bound_by']}, "
                  f"{bound_ms / ms:.0%} of it), plain {plain_ms:.3f} ms, "
                  f"torch.matmul alone {matmul_ms:.4f} ms; plan: "
                  f"{rows[-1]['plan']}", flush=True)
            del args
        del x32, w32, v32, i32
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


def build_model(TinyYolo, compute_dtype, state_dtype, dev,
                time_window=TIME_WINDOW, fuse_seq=False, weights=None, **kw):
    """TinyYolo with seeded random conv weights. BatchNorm gains are set
    to BN_GAIN: at identity gains the untrained net never spikes on
    sparse frames, at 8 its LIF layers fire 0.2-16% of the time.
    ``weights``: a checkpoint payload (``params``, ``stats``) to load
    instead, e.g. the trained net of [12]. ``kw``: more of TinyYolo's
    arguments ([15]: ``s2d_stem``, ``state_storage``)."""
    import torch

    model = TinyYolo(
        num_classes=NUM_CLASSES, in_hw=IN_HW, loss_ratio=LOSS_RATIO,
        time_window=time_window, iou_threshold=IOU,
        compute_dtype=compute_dtype, state_dtype=state_dtype,
        fuse_seq=fuse_seq, device=dev, seed=0, **kw,
    )
    with torch.no_grad():
        if weights is not None:
            for name, value in weights["params"].items():
                model.get_parameter(name).copy_(value)
            for name, value in weights["stats"].items():
                model.get_buffer(name).copy_(value)
            return model
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
        profile_step(torch, cuda_kernels, model, trainer, X, lab)
        del model
        torch.cuda.empty_cache()
    return total


def time_step_parts(torch, model, trainer, X, lab, start=5, reps=5):
    """Host-clock medians (after one warm-up) of the forward, the loss
    (anchor matching), detect (softmax + NMS) and the whole eval step
    from truncation start ``start``, each ending in a synchronise."""

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
            (preds, _), ms = timed(lambda: fwd(X, start_step=start))
            parts["forward"].append(ms)
            parts["loss"].append(timed(lambda: model.loss(preds, lab))[1])
            parts["detect"].append(timed(lambda: model.detect(preds))[1])
            parts["step"].append(
                timed(lambda: trainer.eval_step(model, X, lab, start))[1])
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
    ("cell backward kernel", ("temporal_cell_bwd",)),
    ("spiking conv kernel", ("spiking_conv_kernel",)),
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


def fused_triples(Block, block):
    """``(conv, norm, cell)`` of every fused triple under ``block``, in
    the order ``forward_seq`` runs them (branch by branch, nested blocks
    where they stand)."""
    for bi, starts in enumerate(block.fused_plan):
        layers = list(getattr(block, f"b{bi}").values())
        for li, layer in enumerate(layers):
            if li in starts:
                yield tuple(layers[li:li + 3])
            elif isinstance(layer, Block):
                yield from fused_triples(Block, layer)


def fused_convs(Block, block):
    """The Conv of every fused triple under ``block``, in the order
    ``forward_seq`` runs them."""
    return [conv for conv, _, _ in fused_triples(Block, block)]


def device_events(torch, prof):
    """The device's events (kernels, copies, fills) of a finished
    ``torch.profiler`` run, each with its demangled ``name`` and its
    ``time_range`` in us, as ``prof.events()`` gives them, but read from
    the raw Kineto results: ``prof.events()`` builds every host op's
    event and their tree first, tens of seconds for a per-step train
    step's ~1e5 ops, none of which is read here."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval

    results = prof.profiler.kineto_results
    base = results.trace_start_ns()  # ns since the epoch overflow a
    out = []                         # double's us: subtract in integers
    for e in results.events():
        if e.device_type() != DeviceType.CUDA \
                or getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        out.append(SimpleNamespace(
            name=torch._C._demangle(name) if len(name) > 1 else name,
            time_range=Interval((e.start_ns() - base) / 1e3,
                                (e.end_ns() - base) / 1e3)))
    return out


def profiled(torch, fn):
    """One call of ``fn`` under ``torch.profiler`` between two CUDA
    events: its device kernels, the device's busy ms (union of the
    kernels' intervals) and the ms between the events, both of this one
    call (the profiler's host overhead included). Fails if the profiler
    saw no kernel: every step profiled here runs on the card."""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    kernels = device_events(torch, prof)
    check(bool(kernels), "the profiler saw no device kernel in a step")
    busy_us, span_end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        busy_us += max(0.0, e - max(s, span_end))
        span_end = max(span_end, e)
    return kernels, busy_us / 1e3, start.elapsed_time(end)


def profile_step(torch, cuda_kernels, model, trainer, X, lab, start=5,
                 top=6):
    """``torch.profiler`` over one eval step: device time by kernel kind
    and for the top kernels, the device's busy time and its idle share
    of that same step (``profiled``), and the cell and spiking conv
    kernels' time against their bound."""
    from snn_for_object_detection_tpu_torch.models.compile import Block, Cell

    kernels, busy_ms, wall_ms = profiled(
        torch, lambda: trainer.eval_step(model, X, lab, start))
    by_kind, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        for table, key in ((by_kind, kernel_kind(e.name)), (by_name, e.name)):
            n, total = table.get(key, (0, 0.0))
            table[key] = (n + 1, total + us)
    busy_us = busy_ms * 1e3
    print(f"    profiled step: {len(kernels)} device kernels, device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.2f} ms between CUDA events, idle "
          f"share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for title, table, rows in (("kind", by_kind, len(by_kind)),
                               ("kernel", by_name, top)):
        for key, (n, us) in sorted(table.items(),
                                   key=lambda kv: -kv[1][1])[:rows]:
            print(f"    {title:6s} {key[:64]:64s} {n:5d}x {us / 1e3:8.3f} ms "
                  f"({us / busy_us:.3f} of busy)")
    sx = torch.empty((), dtype=model.compute_dtype).element_size()
    ss = torch.empty((), dtype=model.state_dtype).element_size()
    if model.fuse_seq:
        # the fused triples in launch order, each kernel's time against
        # its bound (triple_bound)
        convs = [c for top in (model.backbone, model.neck,
                               *(h["base"] for h in model.heads()))
                 for c in fused_convs(Block, top)]
        bounds = [triple_bound(c.w.shape[-1], c.w.shape[1], c.w.shape[0],
                               c.in_hw, c.out_hw, sx, ss)[0] for c in convs]
        launches = sorted((e for e in kernels
                           if kernel_kind(e.name) == "spiking conv kernel"),
                          key=lambda e: e.time_range.start)
        conv_ms = by_kind.get("spiking conv kernel", (0, 0.0))[1] / 1e3
        print(f"    spiking conv kernels: {conv_ms:.3f} ms against a bound "
              f"of {sum(bounds):.3f} ms; per triple, kernel ms (bound ms), "
              f"launch plan:", flush=True)
        if len(launches) == len(convs):
            for c, e, b in zip(convs, launches, bounds):
                k, cin, cout = c.w.shape[-1], c.w.shape[1], c.w.shape[0]
                plan = layer_plan(cuda_kernels, k, c.stride, X.shape[1],
                                  c.out_hw, cin, cout, model.compute_dtype)
                print(f"      {k}x{k} s{c.stride} {cin}->{cout} "
                      f"{c.out_hw[0]}x{c.out_hw[1]} "
                      f"{e.time_range.elapsed_us() / 1e3:.3f} ({b:.3f}); "
                      f"{plan_text(plan)}", flush=True)
        return
    # the cells' bound over the step: x read and z written at every
    # step, (v, i) read and written once, per cell
    cell_bytes = sum(
        (2 * STEPS * sx + 4 * ss) * BATCH * m.out_channels
        * m.out_hw[0] * m.out_hw[1]
        for m in model.modules() if isinstance(m, Cell))
    cell_ms = by_kind.get("cell kernel", (0, 0.0))[1] / 1e3
    print(f"    cell kernels: {cell_ms:.3f} ms against a bound of "
          f"{cell_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"({cell_bytes / 1e9:.3f} GB at 3.35 TB/s)", flush=True)


def state_leaves(s):
    """Neuron state leaves in the JAX pytree order (sorted dict keys)."""
    if isinstance(s, dict):
        return [x for k in sorted(s) for x in state_leaves(s[k])]
    return list(s)


def spike_agreements(a, b):
    """Per cell, the share of neurons whose final membrane is 0 (spiked
    at the last step) in both states or in neither; and the largest
    prediction difference."""
    (ca, ba), sa = a
    (cb, bb), sb = b
    agree = [spike_agreement(x == 0, y == 0) for x, y in
             zip(state_leaves(sa)[::2], state_leaves(sb)[::2])]
    return agree, max(float((ca - cb).abs().max()),
                      float((ba - bb).abs().max()))


def phase_fused_path(torch, cuda_kernels, C, TinyYolo, Trainer, batches,
                     dev, weights=None, timed=True, net="untrained",
                     pairs=(("float32", "float32"),
                            ("bfloat16", "float8_e5m2"))):
    """Phase 7: Trainer.test of the fused model (time_window 0) and of
    the unfused one on the same batches and weights, in both dtype
    configurations; each eval step timed and profiled (``timed``); the
    fused final states against the fused schedule on the plain versions
    and against the unfused schedule, and the witness: the fused kernels
    no further from the exact-sum run than the plain versions. Each
    agreement goes into AGREEMENTS under ``net``. ``weights``: the
    trained net's payload ([12]) instead of [4]'s random weights;
    ``pairs``: the (activation, state) dtype configurations ([15] runs
    e4m3 states). Returns the spiking conv kernel's launches over the
    fused ``test`` runs."""
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        model_cells,
        run_distance,
        witness_passes,
    )

    X = torch.as_tensor(batches[0][0], device=dev)
    lab = torch.as_tensor(batches[0][1], device=dev)
    total = 0
    for xd, sd in pairs:
        outs = {}
        for fuse in (True, False):
            name = f"{xd}/{sd} {'fused' if fuse else 'unfused'}"
            model = build_model(TinyYolo, xd, sd, dev, time_window=0,
                                fuse_seq=fuse, weights=weights)
            trainer = Trainer(limit_test_batches=EVAL_BATCHES, seed=0,
                              time_batched=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_kernels.reset_launches()
            metrics = trainer.test(model, iter(batches))
            torch.cuda.synchronize()
            launches = dict(cuda_kernels.LAUNCHES)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            want = {k: 0 for k in launches}
            want.update(spiking_conv_seq=CELLS_PER_STEP * EVAL_BATCHES * fuse,
                        temporal_cell_seq=CELLS_PER_STEP * EVAL_BATCHES
                        * (not fuse))
            check(launches == want, f"{name}: launches {launches} over "
                  f"{EVAL_BATCHES} eval steps, want {want}")
            check(all(np.isfinite(v) for v in metrics.values()),
                  f"{name}: non-finite metrics {metrics}")
            if fuse:
                total += launches["spiking_conv_seq"]
            with torch.inference_mode():
                outs[fuse] = model.forward_seq(X)
                if fuse:  # the same schedule on the plain versions, and
                    # on the plain versions with exact conv sums
                    ref = cuda_kernels.spiking_conv_seq_reference
                    exact_ref = functools.partial(ref, exact_sums=True)
                    for key, fn in (("plain", ref), ("exact", exact_ref)):
                        C.spiking_conv_seq = fn
                        try:
                            outs[key] = model.forward_seq(X)
                        finally:
                            C.spiking_conv_seq = \
                                cuda_kernels.spiking_conv_seq
                    exact = (list(outs["exact"][0]),
                             model_cells(model, outs["exact"][1]))
                    dist = {key: run_distance(
                        list(outs[key][0]), model_cells(model, outs[key][1]),
                        *exact) for key in outs if key not in (False,
                                                               "exact")}
            print(f"  {name}: {metrics}; launches {launches}",
                  flush=True)
            if timed:
                parts = time_step_parts(torch, model, trainer, X, lab,
                                        start=0)
                step_ms = parts["step"]
                print(f"  {name}: eval step {step_ms:.1f} ms (median of 5, "
                      f"host clock), {STEPS * BATCH / (step_ms / 1e3):.0f} "
                      f"frames/s; peak memory {peak_gb:.2f} GB; parts, "
                      "synchronised apart: " + ", ".join(
                          f"{k} {v:.2f} ms" for k, v in parts.items()
                          if k != "step"), flush=True)
                profile_step(torch, cuda_kernels, model, trainer, X, lab,
                             start=0)
            del model
            torch.cuda.empty_cache()
        check(all(bool(torch.isfinite(t).all()) for t in outs[True][0]),
              f"{xd}/{sd}: fused predictions not finite")
        for other, gated in (("plain", True),
                             (False, xd == "float32")):
            agree, max_pred = spike_agreements(outs[True], outs[other])
            what = ("the fused schedule on the plain versions"
                    if other == "plain" else "the unfused schedule")
            print(f"  {xd}/{sd}: fused kernels vs {what}: final-state "
                  f"spike agreement (v == 0) min {min(agree):.6f}, mean "
                  f"{statistics.mean(agree):.6f} over {len(agree)} cells; "
                  f"max |pred diff| {max_pred:.3g}"
                  f"{'' if gated else ' (not asserted)'}", flush=True)
            check(len(agree) == CELLS_PER_STEP, "cell count")
            AGREEMENTS[net, f"[7] {xd}/{sd} fused vs {what}"] = min(agree)
            check(not gated or min(agree) >= 0.99,
                  f"{xd}/{sd}: fused vs {what}: spike agreement {agree}")
        ok = witness_passes(dist[True], dist["plain"])
        AGREEMENTS[net, f"[7] {xd}/{sd} witness"] = ok
        print(f"  {xd}/{sd}: witness, distance from the exact-sum run "
              f"(conv sums in float64): fused kernels: {dist[True]}; plain "
              f"versions: {dist['plain']}; {'passes' if ok else 'FAILS'}",
              flush=True)
        check(ok, f"{xd}/{sd}: the fused kernels are further from the "
              f"exact-sum run than the plain versions: {dist}")
        del outs
        torch.cuda.empty_cache()
    return total


MK_FRAMES = 16  # [8]: frames of the B=1 megakernel run
MK_WITNESS_SEEDS = (0, 1, 2)  # [8]: seeds of the witness's event frames
MK_MAX_PHASES = 36  # [8]: the convs' dependency depth in TinyYolo GEN1
ENGINE_CAPACITY, ENGINE_STREAMS, ENGINE_STEPS = 8, 6, 24  # [9]


def per_frame_ms(fn, frames: int = 10, reps: int = 10) -> float:
    """Device ms per call: CUDA events around ``frames`` back-to-back
    calls (so the host's enqueue of one call overlaps the device's work on
    the one before), median over ``reps`` runs, divided by ``frames``."""
    return cuda_time_ms(lambda: [fn() for _ in range(frames)], reps=reps,
                        warmup=1) / frames


def megakernel_bound(plan, x_bytes, state_bytes):
    """Least time (ms) of one megakernel frame and what bounds it: the
    larger of 2 * the convs' multiply-adds over the peak of the
    activation type and, over the HBM rate, the bytes the function must
    move: the frame (uint8) read, the weights read once, the state read
    and written once and the fp32 predictions written once."""
    macs = sum(op.k * op.k * plan.buffers[op.src].shape[2]
               * plan.buffers[op.dst].numel
               for op in plan.ops if op.kind == "conv")
    weights = sum(op.k * op.k * plan.buffers[op.src].shape[2]
                  * plan.buffers[op.dst].shape[2]
                  + (2 * plan.buffers[op.dst].shape[2] if op.norm else 0)
                  for op in plan.ops if op.kind == "conv")
    state = sum(int(np.prod(s.shape)) for s in plan.slots)
    nbytes = (plan.buffers[0].numel + weights * x_bytes
              + 2 * state * state_bytes + 4 * plan.preds_numel)
    ops_ms = 2 * macs / (FP32_FLOPS if x_bytes == 4 else BF16_FLOPS) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", macs, nbytes)


def row_label(fields, row):
    """A short description of one op of a megakernel op table."""
    f = dict(zip(fields, row.tolist()))
    kind = ("conv", "ew", "pool", "up", "add", "copy")[f["kind"]]
    if kind != "conv":
        return f"{kind} {f['ho']}x{f['wo']}x{f['cin']}"
    chain = "+".join(x for x in (
        "norm" if f["nk_off"] >= 0 else "",
        {-1: "", 0: "lif", 1: "li"}[f["cell"]],
        ("", "relu", "silu", "tanh")[f["act"]],
        "res" if f["res_space"] >= 0 else "") if x)
    return (f"conv{f['k']}x{f['k']}s{f['stride']} {f['cin']}->{f['cout']} "
            f"{f['ho']}x{f['wo']}" + (f" +{chain}" if chain else "")
            + (f" split {f['split']}" if f["split"] > 1 else ""))


def megakernel_witness(torch, cuda_kernels, mk, tag, dev):
    """The witness of [8]: over 16 seeded event frames from the zero
    state, for each of three seeds, the kernel must be no further from
    the exact-sum run (conv sums in float64, rounded once) than the plain
    version is (``megakernel.witness_passes``). Prints each seed's
    distances; returns the seeds where the kernel fails."""
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        plan_cells,
        run_distance,
        streaming_megakernel_reference,
        witness_passes,
    )

    plan = mk.plan
    runs = {
        "kernel": lambda x, s: cuda_kernels.streaming_megakernel(plan, x, s),
        "plain": lambda x, s: streaming_megakernel_reference(plan, x, s),
        "exact": lambda x, s: streaming_megakernel_reference(
            plan, x, s, exact_sums=True),
    }
    failed = []
    for seed in MK_WITNESS_SEEDS:
        rng = np.random.default_rng(100 + seed)
        frames = torch.from_numpy(
            (rng.random((MK_FRAMES, *IN_HW, 2)) < EVENT_DENSITY)
            .astype(np.uint8)).to(dev)
        out = {}
        for name, fn in runs.items():
            state, preds = mk._flat_state(None), []
            for x in frames:
                cls, box, state = fn(x, state)
                preds += [cls, box]
            out[name] = (preds, plan_cells(plan, state))
        kernel = run_distance(*out["kernel"], *out["exact"])
        plain = run_distance(*out["plain"], *out["exact"])
        ok = witness_passes(kernel, plain)
        print(f"  {tag}: witness, seed {seed}: distance from the exact-sum "
              f"run: kernel: {kernel}; plain version: {plain}; "
              f"{'passes' if ok else 'FAILS'}", flush=True)
        if not ok:
            failed.append(seed)
        del out
    torch.cuda.empty_cache()
    return failed


def phase_megakernel(torch, cuda_kernels, TinyYolo, batch, dev,
                     weights=None, timed=True, net="untrained",
                     pairs=(("float32", "float32"),
                            ("bfloat16", "float8_e5m2")), prepare=None):
    """Phase 8: the B=1 streaming megakernel on TinyYolo GEN1, in both
    dtype configurations, through ``StreamingMegakernel.step``: one
    launch per frame and nothing else; the final state against the plain
    version on the card and (fp32) against the per-step ``SODa.step``;
    then (``timed``) ``predict`` and ``to_model_state``, timings and the
    per-phase timeline. Agreements go into AGREEMENTS under ``net``;
    ``weights`` and ``pairs`` as in ``phase_fused_path``; ``prepare``
    turns the built model into the one to run ([15]: its int8 form, which
    the megakernel dequantizes at build time while ``SODa.step`` runs
    int8 convs: another function, so not compared). Returns (launches,
    fp32 row of the kernels line)."""
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        StreamingMegakernel,
        streaming_megakernel_reference,
    )

    X = torch.as_tensor(batch[0][:MK_FRAMES, 0], device=dev)  # uint8
    fields = cuda_kernels.MK_FIELDS
    total, row = 0, None
    for xd, sd in pairs:
        tag = f"{xd}/{sd}"
        model = build_model(TinyYolo, xd, sd, dev, weights=weights)
        if prepare is not None:
            model = prepare(model)
        mk = StreamingMegakernel(model)
        plan = mk.plan
        cuda_kernels.reset_launches()
        state = None
        for t in range(MK_FRAMES):
            (cls_p, box_p), state = mk.step(X[t], state)
        torch.cuda.synchronize()
        launches = dict(cuda_kernels.LAUNCHES)
        want = {k: 0 for k in launches}
        want["streaming_megakernel"] = MK_FRAMES
        check(launches == want, f"{tag}: launches {launches}, want {want}")
        total += launches["streaming_megakernel"]
        check(tuple(cls_p.shape) == (1, model.num_anchors, NUM_CLASSES + 1)
              and tuple(box_p.shape) == (1, model.num_anchors, 4)
              and bool(torch.isfinite(cls_p).all()
                       & torch.isfinite(box_p).all()),
              f"{tag}: megakernel predictions")

        plain = mk._flat_state(None)
        for t in range(MK_FRAMES):
            pc, pb, plain = streaming_megakernel_reference(plan, X[t], plain)
        got = mk._flat_state(state)
        agree, active, li_out, li_rel = [], [], [], []
        for g, w, slot in zip(got, plain, plan.slots):
            if "head" in slot.path[0]:  # LI membranes and currents
                li_out.append(outside_share(g, w, plan.state_dtype))
                li_rel.append(relative_l2(g, w))
            elif slot.field == 0:
                agree.append(spike_agreement(g == 0, w == 0))
                active.append(float((w != 0).float().mean()))
        err = max(max_abs_err(a, b) for a, b in
                  [(cls_p, pc), (box_p, pb)] + list(zip(got, plain)))
        print(f"  {tag}: {MK_FRAMES} frames, {launches['streaming_megakernel']}"
              f" megakernel launches and no other; vs the plain version on "
              f"the card: final-state spike agreement (v == 0) min "
              f"{min(agree):.6f} over {len(agree)} LIF cells (membranes "
              f"nonzero: min {min(active):.3f}, mean "
              f"{statistics.mean(active):.3f}); LI states: relative L2 "
              f"error max {max(li_rel):.4f}, share outside rtol 1e-4 / two "
              f"ulps max {max(li_out):.4f}; max abs err {err:.3g}",
              flush=True)
        failed = megakernel_witness(torch, cuda_kernels, mk, tag, dev)
        AGREEMENTS[net, f"[8] {tag} vs plain"] = min(agree)
        AGREEMENTS[net, f"[8] {tag} LI relative L2"] = max(li_rel)
        AGREEMENTS[net, f"[8] {tag} witness"] = not failed
        check(min(agree) >= 0.99, f"{tag}: spike agreement {agree}")
        li_limit = 0.05 if xd == "float32" else 0.1
        check(max(li_rel) <= li_limit, f"{tag}: LI states' relative L2 "
              f"error {li_rel} (limit {li_limit})")
        check(not failed, f"{tag}: the kernel is further from the "
              f"exact-sum run than the plain version on seeds {failed}")

        if xd == "float32" and prepare is None:
            # the same function per step (cuDNN, cell)
            ss = None
            cuda_kernels.reset_launches()
            for t in range(MK_FRAMES):
                (sc, sb), ss = model.step(X[t][None], ss)
            torch.cuda.synchronize()
            check(cuda_kernels.LAUNCHES["temporal_cell_seq"]
                  == CELLS_PER_STEP * MK_FRAMES, "SODa.step launches")
            agree_s, pred_diff = spike_agreements(((cls_p, box_p), state),
                                                  ((sc, sb), ss))
            print(f"  {tag}: vs SODa.step: final-state spike agreement min "
                  f"{min(agree_s):.6f}, mean {statistics.mean(agree_s):.6f} "
                  f"over {len(agree_s)} cells; max |pred diff| "
                  f"{pred_diff:.3g}", flush=True)
            AGREEMENTS[net, f"[8] {tag} vs SODa.step"] = min(agree_s)
            check(min(agree_s) >= 0.99, f"{tag}: vs SODa.step {agree_s}")
        if not timed:
            del model, mk, plan, state, plain, got
            torch.cuda.empty_cache()
            continue

        # predict and the flat state
        dets, flat = mk.predict(X[0], got)
        check(tuple(dets.shape) == (300, 6)
              and bool(torch.isfinite(dets).all()), f"{tag}: predict")
        tree = mk.to_model_state(flat)
        (c1, _), _ = mk.step(X[1], tree)
        (c2, _), _ = mk.step(X[1], flat)
        check(bool(torch.equal(c1, c2))
              and [tuple(x.shape) for x in state_leaves(tree)]
              == [tuple(x.shape) for x in state_leaves(state)],
              f"{tag}: to_model_state")

        st = mk._flat_state(state)
        ms = per_frame_ms(
            lambda: cuda_kernels.streaming_megakernel(plan, X[0], st))
        plain_ms = per_frame_ms(
            lambda: streaming_megakernel_reference(plan, X[0], st), reps=3)
        with torch.inference_mode():
            step_ms = per_frame_ms(lambda: model.step(X[0][None], state))
        parts = {"predict": [], "step": [], "detect": []}
        for _ in range(6):
            for name, fn in (("predict", lambda: mk.predict(X[0], st)),
                             ("step", lambda: mk.step(X[0], st)),
                             ("detect", lambda: model.detect((cls_p, box_p)))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                parts[name].append((time.perf_counter() - t0) * 1e3)
        parts = {k: statistics.median(v[1:]) for k, v in parts.items()}
        cu = plan.cuda
        rows, phases = cu["ops"].cpu(), cu["phases"].cpu()
        n_phases = phases.shape[0]
        line = torch.zeros(n_phases + 1, dtype=torch.int64, device=dev)
        cuda_kernels.streaming_megakernel(plan, X[0], st, timeline=line)
        torch.cuda.synchronize()
        phase_ms = (line[1:] - line[:-1]).double().cpu().numpy() / 1e6
        sx = torch.empty((), dtype=plan.compute_dtype).element_size()
        ss_ = torch.empty((), dtype=plan.state_dtype).element_size()
        bound_ms, bound_by, macs, nbytes = megakernel_bound(plan, sx, ss_)
        n_split = int((rows[:, fields.index("split")] > 1).sum())
        check(n_phases <= MK_MAX_PHASES, f"{tag}: {n_phases} phases, want "
              f"at most {MK_MAX_PHASES}")
        print(f"  {tag}: megakernel {ms:.4f} ms/frame (CUDA events around "
              f"10 back-to-back frames, median of 10), plain version "
              f"{plain_ms:.2f} ms, SODa.step "
              f"{step_ms:.2f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
              f"{2 * macs / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); grid "
              f"{cu['grid']} blocks ({cu['blocks_per_sm']} per SM x "
              f"{cu['sms']} SMs), {len(rows)} ops ({n_split} convs split "
              f"along K, summed by their last slice) in {n_phases} phases, "
              f"{n_phases - 1} grid barriers per frame; workspace "
              f"{plan.ws_numel} elements", flush=True)
        print(f"  {tag}: predict {parts['predict']:.2f} ms/frame = step "
              f"{parts['step']:.2f} + detect {parts['detect']:.2f} ms "
              f"(host clock, synchronised apart, median of 5)", flush=True)
        labels = [[row_label(fields, rows[n]) for n in range(o0, o1)]
                  for o0, o1, _ in phases.tolist()]
        top = np.argsort(-phase_ms)[:8]
        print(f"  {tag}: timeline (one launch, +1 barrier): "
              f"{phase_ms.sum():.3f} ms over {n_phases} phases; slowest: "
              + "; ".join(f"[{p}] {phase_ms[p]:.3f} ms "
                          f"{', '.join(labels[p][:3])}" for p in top),
              flush=True)
        conv_ms = sum(phase_ms[p] for p in range(n_phases)
                      if any(x.startswith("conv") for x in labels[p]))
        print(f"  {tag}: phases with a conv {conv_ms:.3f} ms; phases under "
              f"10 us: "
              f"{int((phase_ms < 0.01).sum())}", flush=True)
        if xd == "float32":
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, max_abs_err=err, step_ms=step_ms)
        del model, mk, plan, state, plain, got
        torch.cuda.empty_cache()
    return total, row


def phase_engine(torch, cuda_kernels, TinyYolo, dev,
                 pairs=(("float32", "float32"), ("bfloat16", "float8_e5m2")),
                 modes=(False, True), weights=None, update=None):
    """Phase 9: StreamingEngine on TinyYolo GEN1, capacity 8, 6 streams
    (one removed and one added part way) over 24 steps, sync and
    pipelined, both dtype configurations: 22 cell launches per step,
    every output [k, 6] and finite, empty during a stream's warm-up.
    [15] passes the trained net's ``weights`` and ``update``, called with
    each new engine before its first step (``update_weights``)."""
    from snn_for_object_detection_tpu_torch.serve import StreamingEngine

    rng = np.random.default_rng(9)
    frames = (rng.random((ENGINE_STEPS, ENGINE_STREAMS + 1, *IN_HW, 2))
              < EVENT_DENSITY).astype(np.uint8)
    for xd, sd in pairs:
        model = build_model(TinyYolo, xd, sd, dev, weights=weights)
        for pipelined in modes:
            tag = f"{xd}/{sd} {'pipelined' if pipelined else 'sync'}"
            eng = StreamingEngine(model, capacity=ENGINE_CAPACITY,
                                  pipelined=pipelined)
            if update is not None:
                update(eng)
            ages, snaps, outs, times = {}, [], [], []
            for n in range(ENGINE_STREAMS):
                eng.add_stream(f"cam{n}")
                ages[f"cam{n}"] = 0
            cuda_kernels.reset_launches()
            for t in range(ENGINE_STEPS):
                if t == 8:
                    eng.remove_stream("cam2")
                    ages.pop("cam2")
                if t == 12:
                    eng.add_stream(f"cam{ENGINE_STREAMS}")
                    ages[f"cam{ENGINE_STREAMS}"] = 0
                batch = {sid: frames[t, int(sid[3:])] for sid in ages}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = eng.step(batch)
                times.append((time.perf_counter() - t0) * 1e3)
                for sid in ages:
                    ages[sid] += 1
                snaps.append(dict(ages))
                outs.append(out)
            outs.append(eng.flush())
            torch.cuda.synchronize()
            launches = dict(cuda_kernels.LAUNCHES)
            check(launches["temporal_cell_seq"]
                  == CELLS_PER_STEP * ENGINE_STEPS
                  and sum(launches.values()) == launches["temporal_cell_seq"],
                  f"{tag}: launches {launches}, want {CELLS_PER_STEP} cell "
                  "launches a step")
            # which step's detections each returned dict holds
            results = outs[1:] if pipelined else outs[:-1]
            check(outs[0] == {} if pipelined else outs[-1] == {},
                  f"{tag}: pipelined shift")
            n_dets = 0
            for snap, out in zip(snaps, results):
                check(sorted(out) == sorted(snap), f"{tag}: streams")
                for sid, d in out.items():
                    check(d.ndim == 2 and d.shape[1] == 6
                          and bool(np.isfinite(d).all()), f"{tag}: {sid}")
                    if snap[sid] <= model.time_window:
                        check(d.shape[0] == 0, f"{tag}: {sid} warm-up")
                    n_dets += d.shape[0]
            step_ms = statistics.median(times[1:])
            print(f"  {tag}: {ENGINE_STEPS} steps, {launches['temporal_cell_seq']}"
                  f" cell launches ({CELLS_PER_STEP} a step); {n_dets} "
                  f"detections after warm-up; step {step_ms:.1f} ms (host "
                  f"clock, median), {step_ms / ENGINE_STREAMS:.2f} ms per "
                  f"camera-frame at {ENGINE_STREAMS} streams, capacity "
                  f"{ENGINE_CAPACITY}", flush=True)
        del model, eng
        torch.cuda.empty_cache()


# [10]: training. (x, state) dtypes of the two training configurations
# (config/config.yaml; config/fast.yaml: bf16 states, fp32 activations),
# train steps of Trainer.fit per schedule and configuration, the start r
# of the timed step and of the gradient comparison, and the fp32
# operations per element-step of the backward kernel (LIF: the forward
# re-run in pass 1, then sub, add, fma, sub, abs, mul, add, mul, div,
# select, add, mul, add, mul, add, add and the two carry adds; LI:
# add, mul, add, mul, add, add and the carries)
TRAIN_PAIRS = (("float32", "float32"), ("float32", "bfloat16"))
TRAIN_STEPS = 3
TRAIN_START = 5
CELL_BWD_OPS = {"lif": CELL_OPS + 18, "li": 8}


def cell_bwd_bound(cell, T, M, sx, ss):
    """Least time (ms) of the cell backward and what bounds it: the bytes
    it must move (gz read, gx written, gvT, giT read, gv0, gi0 written;
    LIF also reads x, v0, i0: LI's gradient depends on neither) over the
    HBM rate, against its operations over the fp32 peak."""
    nbytes = 2 * T * M * sx + 4 * M * ss
    if cell == "lif":
        nbytes += T * M * sx + 2 * M * ss
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = T * M * CELL_BWD_OPS[cell] / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def cell_bwd_cases():
    """[10]'s backward cases: label -> (shape, starts). GEN1 stage 1 and
    the stride-8 head over the sequence (T = 42, the time-batched
    schedule) at start 0 and 5, and at T = 1 (the per-step schedule's
    every launch) at start 0."""
    h, w = IN_HW
    return {"stage1": ((STEPS, BATCH, h // 2, w // 2, 64), (0, TRAIN_START)),
            "head_li": ((STEPS, BATCH, h // 8, w // 8, 256),
                        (0, TRAIN_START)),
            "stage1_t1": ((1, BATCH, h // 2, w // 2, 64), (0,)),
            "head_t1": ((1, BATCH, h // 8, w // 8, 256), (0,))}


def cell_bwd_inputs(torch, shape, dev):
    """[10]'s seeded fp32 draws for one shape: x, v0, i0, gz, gv, gi."""
    rng = np.random.default_rng(2)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                             * scale).to(dev)
            for s, scale in ((shape, 2.0), (shape[1:], 1.0),
                             (shape[1:], 1.0), (shape, 1.0),
                             (shape[1:], 1.0), (shape[1:], 1.0))]


def cell_bwd_args(torch, draw, xd, sd):
    """The draws in one (x, state) dtype pair, in the backward's order."""
    x, gz = (a.to(getattr(torch, xd)) for a in draw[0::3])
    v0, i0, gv, gi = (a.to(getattr(torch, sd))
                      for a in (draw[1], draw[2], draw[4], draw[5]))
    return x, v0, i0, gz, gv, gi


def cell_bwd_plan_text(cuda_kernels, cell, x, v0) -> str:
    """The launch plan the backward takes for these arguments."""
    T, m = x.shape[0], v0.numel()
    if cell != "lif" or T < 2:
        return "one reverse pass, no checkpoints"
    p = cuda_kernels.cell_bwd_plan(T, m, x.dtype, v0.dtype,
                                   m % (16 // x.element_size()) == 0)
    where = "shared" if p.shared else "global"
    return (f"C={p.chunk}, {p.rows} checkpoints a state in {where} memory "
            f"({p.ckpt_bytes / 1e6:.1f} MB, {p.smem} B shared a CTA), "
            f"{p.threads} threads{'' if p.vec else ', scalar'}")


def phase_cell_backward(torch, cuda_kernels, dev):
    """[10] first part: the backward kernel against autograd through the
    plain version on ``cell_bwd_cases()``, both training state dtypes,
    LIF and LI. The gate: every element bit-equal (the kernel sums in
    autograd's order); a run that is not prints the elements that
    differ and fails past rtol 1e-5 of the largest cotangent. Prints
    each case's launch plan. Returns per-case rows and the worst
    error."""
    rows, worst = [], 0.0
    for label, (shape, starts) in cell_bwd_cases().items():
        draw = cell_bwd_inputs(torch, shape, dev)
        T, M = shape[0], int(np.prod(shape[1:]))
        for xd, sd in TRAIN_PAIRS:
            x, v0, i0, gz, gv, gi = cell_bwd_args(torch, draw, xd, sd)
            for cell in ("lif", "li"):
                for start in starts:
                    cuda_kernels.reset_launches()
                    got = cuda_kernels.temporal_cell_seq_bwd(
                        x, v0, i0, gz, gv, gi, cell, start)
                    torch.cuda.synchronize()
                    check(cuda_kernels.LAUNCHES["temporal_cell_seq_bwd"] == 1,
                          "one backward launch a call")
                    leaves = [a.detach().requires_grad_()
                              for a in (x, v0, i0)]
                    outs = cuda_kernels.temporal_cell_seq_reference(
                        *leaves, cell, start)
                    want = torch.autograd.grad(outs, leaves, (gz, gv, gi),
                                               retain_graph=True)
                    differ = 0
                    for name, g, wnt in zip(("gx", "gv0", "gi0"), got, want):
                        g, wnt = g.float(), wnt.float()
                        same = (g == wnt) | (g.isnan() & wnt.isnan())
                        differ += int((~same).sum())
                        err = float((g - wnt).abs().max())
                        worst = max(worst, err)
                        scale = float(wnt.abs().max())
                        check(err <= 1e-5 * scale,
                              f"{label} {cell} {xd}/{sd} start={start}: {name} "
                              f"max abs err {err} past rtol 1e-5 of {scale}")
                    # queued behind a busy card: the wrapper's host time
                    # (checks, allocations) is a tenth of a head case
                    ms = queued_ms(lambda: cuda_kernels.temporal_cell_seq_bwd(
                        x, v0, i0, gz, gv, gi, cell, start))
                    plain_ms = cuda_time_ms(lambda: torch.autograd.grad(
                        outs, leaves, (gz, gv, gi), retain_graph=True),
                        reps=3, warmup=1)
                    del got, want, outs, leaves
                    bound_ms, by = cell_bwd_bound(cell, T, M, x.element_size(),
                                                  v0.element_size())
                    rows.append(dict(shape=label, cell=cell, x=xd, state=sd,
                                     start=start, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=by,
                                     differ=differ))
                    print(f"  {label:9s} {cell:3s} {xd}/{sd:8s} start={start}: "
                          f"{'bit-equal' if not differ else f'{differ} elements differ'}"
                          f"; kernel {ms:.4f} ms (queued), bound "
                          f"{bound_ms:.4f} ms "
                          f"({by}, {bound_ms / ms:.0%} of it), plain backward "
                          f"{plain_ms:.3f} ms; plan: "
                          f"{cell_bwd_plan_text(cuda_kernels, cell, x, v0)}",
                          flush=True)
        del draw, x, gz, v0, i0, gv, gi
        torch.cuda.empty_cache()
    return rows, worst


class _Batches:
    """``Trainer.fit``'s data: [10]'s event batches, over and over."""

    def __init__(self, batches):
        self.batches = batches

    def train_loader(self):
        return itertools.cycle(self.batches)

    val_loader = train_loader


def first_step_grads(torch, model, schedule, X, lab, start):
    """The loss and every parameter's gradient of one train forward."""
    model.zero_grad()
    preds, _ = model.forward_fn(schedule)(X, start_step=start, train=True)
    loss = model.loss(preds, lab)
    loss.backward()
    return float(loss.detach()), {
        n: p.grad.detach().clone() if p.grad is not None
        else torch.zeros_like(p) for n, p in model.named_parameters()}


def kind_ms(kernels):
    """Device ms of profiled kernels by kernel kind."""
    by_kind = {}
    for e in kernels:
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_kind


def backward_launches(schedule, r):
    """Cell backward launches of one train step from start r: one a cell
    over the sequence (time-batched), one a cell and active step (per
    step), or the backbone's cells over the sequence and the neck's and
    heads' a step (hybrid)."""
    if schedule == "hybrid":
        return BACKBONE_CELLS + (CELLS_PER_STEP - BACKBONE_CELLS) * (STEPS - r)
    return CELLS_PER_STEP * (1 if schedule else STEPS - r)


SCHEDULE_NAMES = {False: "per-step", True: "time-batched",
                  "hybrid": "hybrid"}


def fit_schedule(torch, cuda_kernels, TinyYolo, Trainer, batches, dev, xd,
                 sd, schedule):
    """``Trainer.fit`` for TRAIN_STEPS steps on one schedule and training
    configuration at full GEN1 width: ``backward_launches`` a step and
    no spiking conv kernel; finite losses; the weights and the running
    stats moved. Then one train step from r = TRAIN_START timed (CUDA
    events, median of 3), its peak memory, and the device idle share of
    one more step under ``torch.profiler``. Returns the fit's launches
    and the step's numbers."""
    from snn_for_object_detection_tpu_torch.models import compile as C

    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke_train")
    X = torch.as_tensor(batches[0][0], device=dev)
    lab = torch.as_tensor(batches[0][1], device=dev)
    tag = f"{xd}/{sd} {SCHEDULE_NAMES[schedule]}"
    model = build_model(TinyYolo, xd, sd, dev)
    w0 = [p.detach().clone() for p in model.parameters()]
    s0 = [b.clone() for n, b in model.named_buffers()
          if n.endswith((".mean", ".var"))]
    out_dir = os.path.join(out_root, f"{xd}_{sd}_{schedule}")
    shutil.rmtree(out_dir, ignore_errors=True)
    trainer = Trainer(max_epochs=1, limit_train_batches=TRAIN_STEPS,
                      check_val_every_n_epoch=10 ** 6,
                      log_every_n_steps=1, out_dir=out_dir, seed=0,
                      time_batched=schedule)
    starts = []
    draw = trainer.draw_start
    trainer.draw_start = lambda m, g: starts.append(draw(m, g)) \
        or starts[-1]
    # the forward launches by sequence length (the kernel's own count
    # is LAUNCHES["temporal_cell_seq"])
    lengths = []
    kernel_cell = C.temporal_cell_seq

    def counted(x, *args, **kwargs):
        lengths.append(x.shape[0])
        return kernel_cell(x, *args, **kwargs)

    C.temporal_cell_seq = counted
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer.fit(model, _Batches(batches))
    finally:
        C.temporal_cell_seq = kernel_cell
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    n = dict(cuda_kernels.LAUNCHES)
    want = sum(backward_launches(schedule, r) for r in starts)
    check(n["temporal_cell_seq_bwd"] == want,
          f"{tag}: {n['temporal_cell_seq_bwd']} backward launches "
          f"for starts {starts}, want {want}")
    check(n["spiking_conv_seq"] == 0, f"{tag}: a fused launch")
    check(n["temporal_cell_seq"] == len(lengths), f"{tag}: forward launches")
    by_len = {t: lengths.count(t) for t in sorted(set(lengths))}
    if schedule == "hybrid":
        # every backbone cell over T, every neck and head cell a step,
        # each run again at most once by the backward's recompute
        seq_min = BACKBONE_CELLS * TRAIN_STEPS
        step_min = sum(backward_launches(schedule, r) - BACKBONE_CELLS
                       for r in starts)
        check(set(by_len) == {1, STEPS}
              and seq_min <= by_len[STEPS] <= 2 * seq_min
              and step_min <= by_len[1] <= 2 * step_min,
              f"{tag}: forward launches by length {by_len}, want "
              f"{seq_min}-{2 * seq_min} over T={STEPS} and "
              f"{step_min}-{2 * step_min} at T=1")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        losses = [r["train_loss"] for r in map(json.loads, f)
                  if "train_loss" in r]
    check(len(losses) == TRAIN_STEPS
          and all(np.isfinite(v) for v in losses),
          f"{tag}: train losses {losses}")
    moved = sum(not torch.equal(p, q)
                for p, q in zip(model.parameters(), w0))
    stats_moved = sum(not torch.equal(b, q) for b, q in zip(
        (b for n_, b in model.named_buffers()
         if n_.endswith((".mean", ".var"))), s0))
    check(moved >= 0.9 * len(w0) and stats_moved >= 0.9 * len(s0),
          f"{tag}: {moved} of {len(w0)} weights and {stats_moved} of "
          f"{len(s0)} running stats moved")

    def step():
        trainer.train_step(model, X, lab, TRAIN_START)

    torch.cuda.reset_peak_memory_stats()
    # no warm-up call: the fit's steps just ran this step's kernels and
    # allocations (its last one from r = TRAIN_START)
    step_ms = cuda_time_ms(step, reps=3, warmup=0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernels, busy, wall = profiled(torch, step)
    by_kind = kind_ms(kernels)
    bwd_n = sum(kernel_kind(e.name) == "cell backward kernel"
                for e in kernels)
    idle = max(0.0, 1 - busy / wall)
    print(f"  {tag}: fit {TRAIN_STEPS} steps in {fit_s:.1f} s, starts "
          f"{starts}, losses {[round(v, 4) for v in losses]}; "
          f"launches {n['temporal_cell_seq']} forward (by sequence length "
          f"{by_len}; remat recomputes them), {n['temporal_cell_seq_bwd']} "
          f"backward; train step from r={TRAIN_START} {step_ms:.1f} ms (CUDA "
          f"events, median of 3), {STEPS * BATCH / (step_ms / 1e3):.0f}"
          f" frames/s, peak memory {peak_gb:.2f} GB; one step under "
          f"the profiler: device busy {busy:.1f} of {wall:.1f} ms, "
          f"idle share {idle:.3f}; {bwd_n} cell "
          f"backward kernels {by_kind.get('cell backward kernel', 0):.2f}"
          f" ms; device ms by kind: " + ", ".join(
              f"{k} {v:.1f}" for k, v in sorted(
                  by_kind.items(), key=lambda kv: -kv[1])[:6]),
          flush=True)
    TRAIN_STEP_TIMES[xd, sd, schedule] = (step_ms, peak_gb, idle)
    del model, trainer, w0, s0
    torch.cuda.empty_cache()
    return n["temporal_cell_seq_bwd"]


def plain_cell_grads(torch, cuda_kernels, TinyYolo, schedules, X, lab, dev):
    """At fp32 with cuDNN off, each schedule's first-step loss and
    gradients from r = TRAIN_START against the same schedule's with
    ``compile.temporal_cell_seq`` swapped for the plain version: the
    losses within 1e-6, the gradients within rtol 2e-3, atol 1e-7.
    Returns the kernels' runs by schedule."""
    from snn_for_object_detection_tpu_torch.models import compile as C

    kernel_cell = C.temporal_cell_seq
    torch.backends.cudnn.enabled = False
    runs = {}
    try:
        model = build_model(TinyYolo, "float32", "float32", dev)
        for schedule in schedules:
            for how in ("kernel", "plain"):
                C.temporal_cell_seq = kernel_cell if how == "kernel" \
                    else cuda_kernels.temporal_cell_seq_reference
                cuda_kernels.reset_launches()
                runs[schedule, how] = first_step_grads(
                    torch, model, schedule, X, lab, TRAIN_START)
                n = cuda_kernels.LAUNCHES
                want = backward_launches(schedule, TRAIN_START)
                check((n["temporal_cell_seq_bwd"], n["temporal_cell_seq"] > 0)
                      == ((want, True) if how == "kernel" else (0, False)),
                      f"{how} cell: {n['temporal_cell_seq']} forward and "
                      f"{n['temporal_cell_seq_bwd']} backward launches")
    finally:
        C.temporal_cell_seq = kernel_cell
        torch.backends.cudnn.enabled = True
    for schedule in schedules:
        (l_k, g_k), (l_p, g_p) = runs[schedule, "kernel"], runs[schedule,
                                                               "plain"]
        check(abs(l_k - l_p) <= 1e-6 * abs(l_p),
              f"losses {l_k} (kernels) and {l_p} (plain cell)")
        same, worst = 0, 0.0
        for name, a in g_k.items():
            b = g_p[name]
            torch.testing.assert_close(a, b, rtol=2e-3, atol=1e-7,
                                       msg=lambda m: f"{name}: {m}")
            same += bool(torch.equal(a, b))
            worst = max(worst, float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30))
        print(f"  {SCHEDULE_NAMES[schedule]} at fp32, cuDNN off, "
              f"r={TRAIN_START}: the kernels' first step against "
              f"the plain cell's: losses {l_k!r} / {l_p!r}, {same} of "
              f"{len(g_k)} gradients bit-equal, every one within rtol 2e-3, "
              f"atol 1e-7 (max difference over a tensor's largest entry "
              f"{worst:.3g})", flush=True)
    del model
    torch.cuda.empty_cache()
    return {s: runs[s, "kernel"] for s in schedules}


def grads_distance(a, b) -> float:
    """Relative L2 distance of two runs' whole gradients."""
    import torch

    fa = torch.cat([g.flatten() for g in a.values()])
    fb = torch.cat([b[n].flatten() for n in a])
    return float((fa - fb).norm() / fb.norm())


def phase_train(torch, cuda_kernels, TinyYolo, Trainer, batches, dev):
    """[10] second part: ``fit_schedule`` on the per-step and the
    time-batched schedule in both training configurations, then
    ``plain_cell_grads`` of both. The two schedules are not compared with
    each other there: their BatchNorm moments round apart (one batched
    reduction against one a step, as in JAX), and on this untrained net
    at gains 8 one flipped spike moves the gradients past any tolerance;
    the CPU tests hold both schedules against JAX and each other at
    narrow width. Returns the backward kernel's launches over the fit
    runs."""
    total = 0
    for xd, sd in TRAIN_PAIRS:
        for schedule in (False, True):
            total += fit_schedule(torch, cuda_kernels, TinyYolo, Trainer,
                                  batches, dev, xd, sd, schedule)
    X = torch.as_tensor(batches[0][0], device=dev)
    lab = torch.as_tensor(batches[0][1], device=dev)
    runs = plain_cell_grads(torch, cuda_kernels, TinyYolo, (False, True), X,
                            lab, dev)
    (l_s, g_s), (l_b, g_b) = runs[False], runs[True]
    AGREEMENTS["untrained", "[10] gradients' relative L2, per-step vs "
               "time-batched"] = grads_distance(g_s, g_b)
    print(f"  the two schedules, not a gate: losses {l_s:.6f} / {l_b:.6f}, "
          f"gradients' relative L2 distance {grads_distance(g_s, g_b):.3g}",
          flush=True)
    return total


# [11]: the CLI on recordings. Synthetic GEN1 set (recordings per split,
# ms each, seed), the fit runs' cut (train batches, validation batches),
# test batches, and the loader timings: (label, num_steps, time_shift,
# num_load_file) of config/config.yaml and config/synthetic.yaml, the
# worker counts, and the batches timed after the warm-up ones
CLI_RECORDINGS, CLI_DURATION_MS, CLI_SEED = 2, 2000, 0
CLI_TRAIN_BATCHES, CLI_VAL_BATCHES, CLI_TEST_BATCHES = 4, 2, 4
LOADER_CASES = (("config.yaml T=42", 42, 16, 8),
                ("synthetic.yaml T=24", 24, 0, 4))
LOADER_WORKERS = (1, 4)
LOADER_WARMUP, LOADER_TIMED = 2, 10


def loader_ms(PropheseeDataModule, data_dir, num_steps, time_shift,
              num_load_file, workers, dataset="gen1", batch_size=BATCH):
    """Host ms of the loader alone (uint8 frames): from making it to its
    first batch, and per batch after its warm-up batches."""
    t0 = time.perf_counter()
    loader = PropheseeDataModule(
        data_dir=data_dir, dataset=dataset, batch_size=batch_size,
        num_workers=workers, num_load_file=num_load_file,
        num_steps=num_steps, time_shift=time_shift).train_loader()
    try:
        next(loader)
        first_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(LOADER_WARMUP - 1):
            next(loader)
        t0 = time.perf_counter()
        for _ in range(LOADER_TIMED):
            next(loader)
        return first_ms, (time.perf_counter() - t0) * 1e3 / LOADER_TIMED
    finally:
        loader.close()


def check_finite(metrics, tag):
    check(bool(metrics) and all(np.isfinite(v) for v in metrics.values()),
          f"{tag}: metrics {metrics}")


def eval_loop_ms(torch, run, sub) -> float:
    """Host ms of the CLI's eval loop over all its batches: ``sub``
    (``test`` or ``validate``) of the trainer ``cli.main`` built, run
    again on the model it restored and a loader made anew, with one
    synchronise at the end."""
    loader = run.data.test_loader() if sub == "test" else \
        run.data.val_loader()
    t0 = time.perf_counter()
    getattr(run.trainer, sub)(run.model, loader)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_cli(torch, cuda_kernels, smi):
    """[11] the CLI on recordings: a synthetic GEN1 set written by the
    port's ``make_synthetic_dataset``, then ``python -m
    snn_for_object_detection_tpu_torch`` run in-process on it through
    ``cli.main``: ``fit`` of full-width TinyYolo with
    ``config/config.yaml`` + ``config/synthetic.yaml`` (240x304, B=4,
    T=24, time window 6), cut to one epoch of CLI_TRAIN_BATCHES batches
    and one validation of CLI_VAL_BATCHES, time-batched at fp32 and
    per-step with ``config/fast.yaml``'s bf16 states; then ``test`` from
    the fp32 run's checkpoint per-step, fused (``fuse_seq=true
    time_window=0``, time-batched) and with ``config/infer_fp8.yaml``,
    and ``validate``. Gates: finite losses and mAP; the checkpoint, the
    config snapshot and the metrics file; each ``test`` restores the
    saved weights bit for bit; the cell kernel and its backward in each
    fit (22 backward launches a time-batched step), ``spiking_conv_seq``
    in the fused test (22 a batch); the native rasterizer loaded and
    called; two passes of a one-worker loader with one seed bit-equal.
    Prints the loader's ms per batch alone, the CLI's fit ms per step
    beside ``train_step`` on an in-memory batch, the idle share of one
    profiled step fed by the loader and of one on an in-memory batch, and
    each eval run's ``cli.main`` time and its eval loop's ms per batch
    (run again, timed whole)."""
    from snn_for_object_detection_tpu_torch import cli
    from snn_for_object_detection_tpu_torch.data import PropheseeDataModule
    from snn_for_object_detection_tpu_torch.data.synthetic import (
        make_synthetic_dataset,
    )
    from snn_for_object_detection_tpu_torch.native import COUNTS
    from snn_for_object_detection_tpu_torch.train.checkpoint import (
        load_single,
    )

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data_dir = make_synthetic_dataset(
        os.path.join(root, "data"), records_per_split=CLI_RECORDINGS,
        duration_ms=CLI_DURATION_MS, seed=CLI_SEED)
    print(f"  synthetic GEN1 set: {CLI_RECORDINGS} recordings of "
          f"{CLI_DURATION_MS} ms per split, seed {CLI_SEED}, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def config(name):
        return ["--config", os.path.join(repo, "config", name)]

    base = [*config("config.yaml"), *config("synthetic.yaml"),
            f"--data.init_args.data_dir={data_dir}",
            "--trainer.max_epochs=1",
            f"--trainer.limit_train_batches={CLI_TRAIN_BATCHES}",
            f"--trainer.limit_val_batches={CLI_VAL_BATCHES}",
            f"--trainer.limit_test_batches={CLI_TEST_BATCHES}",
            "--trainer.check_val_every_n_epoch=1",
            "--trainer.log_every_n_steps=1"]

    # the loader alone
    for label, steps, shift, files in LOADER_CASES:
        for workers in LOADER_WORKERS:
            first, ms = loader_ms(PropheseeDataModule, data_dir, steps,
                                  shift, files, workers)
            print(f"  loader alone, {label} B={BATCH}, num_workers "
                  f"{workers}: {ms:.2f} ms per batch (host clock, "
                  f"{LOADER_TIMED} batches after {LOADER_WARMUP}); first "
                  f"batch {first:.2f} ms after making it [{smi}]",
                  flush=True)
    passes = []
    for _ in range(2):
        loader = PropheseeDataModule(
            data_dir=data_dir, batch_size=BATCH, num_workers=1,
            num_load_file=4, num_steps=24, time_shift=0,
            seed=3).train_loader()
        passes.append([next(loader) for _ in range(3)])
        loader.close()
    check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
              for a, b in zip(*passes)),
          "two passes of a one-worker loader with one seed differ")

    fits = {}
    for tag, extra in (
        ("fp32 time-batched", ["--trainer.time_batched=true"]),
        ("bf16 states per-step", [*config("fast.yaml"),
                                  "--trainer.time_batched=false"]),
    ):
        out_dir = os.path.join(root, "fit_" + tag.replace(" ", "_"))
        cuda_kernels.reset_launches()
        rasterized = COUNTS["rasterize_records"]
        t0 = time.perf_counter()
        run = cli.main(["fit", *base, *extra,
                        f"--trainer.out_dir={out_dir}"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        n = dict(cuda_kernels.LAUNCHES)
        last = os.path.join(out_dir, "checkpoints", "last")
        for path in (last, os.path.join(out_dir, "config.yaml"),
                     os.path.join(out_dir, "metrics.jsonl")):
            check(os.path.exists(path), f"fit {tag}: no {path}")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        steps = [r for r in records if "train_loss" in r]
        losses = [r["train_loss"] for r in steps]
        check(len(losses) == CLI_TRAIN_BATCHES
              and all(np.isfinite(v) for v in losses),
              f"fit {tag}: train losses {losses}")
        val = [r for r in records if "val_loss" in r]
        check(len(val) == 1, f"fit {tag}: {len(val)} validations")
        check_finite({k: v for k, v in val[0].items()
                      if k not in ("step", "time")}, f"fit {tag} val")
        check(n["temporal_cell_seq"] > 0 and n["temporal_cell_seq_bwd"] > 0,
              f"fit {tag}: launches {n}")
        if run.trainer.time_batched:
            check(n["temporal_cell_seq_bwd"]
                  == CELLS_PER_STEP * CLI_TRAIN_BATCHES,
                  f"fit {tag}: {n['temporal_cell_seq_bwd']} backward "
                  f"launches, want {CELLS_PER_STEP * CLI_TRAIN_BATCHES}")
        check(COUNTS["loads"] >= 1
              and COUNTS["rasterize_records"] > rasterized,
              f"fit {tag}: the native rasterizer was not used ({COUNTS})")
        saved = load_single(last)["params"]
        check(all(torch.equal(saved[name].to(p.device), p.detach())
                  for name, p in run.model.named_parameters()),
              f"fit {tag}: the checkpoint is not the trained weights")
        gaps = np.diff([r["time"] for r in steps]) * 1e3
        fit_ms, fit_median = float(np.mean(gaps)), float(np.median(gaps))

        # train_step on an in-memory batch of the same shape, then one
        # step fed by the loader under the profiler
        loader = run.data.train_loader()
        X, lab = next(loader)
        dev = run.model.device
        X = torch.as_tensor(X, device=dev)
        lab = torch.as_tensor(lab, device=dev)
        r = run.model.time_window // 2

        def step():
            run.trainer.train_step(run.model, X, lab, r)

        step_ms = cuda_time_ms(step, reps=3, warmup=1)

        def fed_step():
            Xb, labb = next(loader)
            run.trainer.train_step(
                run.model, torch.as_tensor(Xb, device=dev),
                torch.as_tensor(labb, device=dev), r)

        fed_step()
        _, busy, wall = profiled(torch, fed_step)
        _, mem_busy, mem_wall = profiled(torch, step)
        loader.close()
        fits[tag] = out_dir
        print(f"  fit {tag}: {CLI_TRAIN_BATCHES} steps and a validation "
              f"in {fit_s:.1f} s; losses {[round(v, 4) for v in losses]}; "
              f"val {val[0]['val_loss']:.4f}, mAP {val[0]['map']:.4f}; "
              f"launches {n['temporal_cell_seq']} cell, "
              f"{n['temporal_cell_seq_bwd']} backward, "
              f"{n['spiking_conv_seq']} fused; CLI fit {fit_ms:.1f} ms per "
              f"step (host clock from logged step 1 to "
              f"{CLI_TRAIN_BATCHES} over {len(gaps)} steps; median "
              f"{fit_median:.1f}, each {[round(g, 1) for g in gaps]}), "
              f"train_step on an in-memory batch from r={r} "
              f"{step_ms:.1f} ms (CUDA events, median of 3), gap "
              f"{fit_ms - step_ms:.1f} ms; one step fed by the loader "
              f"under the profiler: busy {busy:.1f} of {wall:.1f} ms, "
              f"idle share {1 - busy / wall:.3f} (an in-memory "
              f"batch: busy {mem_busy:.1f} of {mem_wall:.1f} ms, idle share "
              f"{1 - mem_busy / mem_wall:.3f}) [{smi}]",
              flush=True)
        del run, loader, X, lab
        torch.cuda.empty_cache()

    ckpt = os.path.join(fits["fp32 time-batched"], "checkpoints", "last")
    saved = load_single(ckpt)["params"]
    for sub, tag, extra in (
        ("test", "per-step", ["--trainer.time_batched=false"]),
        ("test", "fused", ["--model.init_args.fuse_seq=true",
                           "--model.init_args.time_window=0",
                           "--trainer.time_batched=true"]),
        ("test", "infer_fp8", config("infer_fp8.yaml")),
        ("validate", "time-batched", ["--trainer.time_batched=true"]),
    ):
        out_dir = os.path.join(root, f"{sub}_{tag}")
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        run = cli.main([sub, *base, *extra, f"--ckpt_path={ckpt}",
                        f"--trainer.out_dir={out_dir}"])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        n = dict(cuda_kernels.LAUNCHES)
        check_finite(run.result, f"{sub} {tag}")
        check(all(torch.equal(saved[name].to(p.device), p.detach())
                  for name, p in run.model.named_parameters()),
              f"{sub} {tag}: restored weights differ from the checkpoint")
        limit = CLI_VAL_BATCHES if sub == "validate" else CLI_TEST_BATCHES
        if tag == "fused":
            check(n["spiking_conv_seq"] == CELLS_PER_STEP * limit
                  and n["temporal_cell_seq"] == 0,
                  f"{sub} {tag}: launches {n}")
        else:
            check(n["temporal_cell_seq"] > 0 and n["spiking_conv_seq"] == 0,
                  f"{sub} {tag}: launches {n}")
        loop_ms = eval_loop_ms(torch, run, sub)
        print(f"  {sub} {tag} ({run.model.compute_dtype} activations, "
              f"{run.model.state_dtype} states): "
              + ", ".join(f"{k} {v:.4f}" for k, v in run.result.items())
              + f"; cli.main {main_s:.2f} s (set-up and checkpoint "
              f"included); its eval loop again {loop_ms:.1f} ms over "
              f"{limit} batches, {loop_ms / limit:.1f} ms per batch (host "
              f"clock, loader included, one synchronise at the end); "
              f"launches {n['temporal_cell_seq']} cell, "
              f"{n['spiking_conv_seq']} fused [{smi}]", flush=True)
        del run
        torch.cuda.empty_cache()
    print(f"  native rasterizer: {COUNTS['loads']} load, "
          f"{COUNTS['rasterize_records']} windows rasterized", flush=True)


# [12]: the JAX-trained synthetic net (scripts/export_synth_net_torch.py),
# and the test batches of its CLI runs
TRAINED_NET = os.path.join("nets", "tiny_yolo_synth_torch")
TRAINED_PARAMS = 4_228_544
TRAINED_TEST_BATCHES = 4


def phase_trained_net(torch, cuda_kernels, C, TinyYolo, Trainer, batches,
                      smi, dev):
    """[12] the trained net: ``nets/tiny_yolo_synth_torch/model/state.pt``
    (read by ``torch.load(weights_only=True)``, no JAX) in full-width GEN1
    TinyYolo. [7]'s gates (``phase_fused_path``, both dtype
    configurations) and [8]'s (``phase_megakernel``) on those weights,
    untimed; every agreement printed beside the untrained net's. The
    relative L2 distance of the three train schedules' first-step
    gradients (fp32, cuDNN off, r = TRAIN_START). Then ``python -m
    snn_for_object_detection_tpu_torch test`` (``cli.main``) with the
    net's config and ``--ckpt_path`` on a synthetic GEN1 set, per-step
    and fused, against the same runs from a checkpoint of [4]'s random
    weights: finite metrics, and a higher mAP for the trained net on both
    schedules (the weights crossed)."""
    from snn_for_object_detection_tpu_torch import cli
    from snn_for_object_detection_tpu_torch.data.synthetic import (
        make_synthetic_dataset,
    )
    from snn_for_object_detection_tpu_torch.train.checkpoint import (
        load_single,
        save_single,
    )

    repo = os.path.dirname(os.path.abspath(__file__))
    net = os.path.join(repo, TRAINED_NET)
    weights = load_single(os.path.join(net, "model"))
    n = sum(v.numel() for v in weights["params"].values())
    check(n == TRAINED_PARAMS, f"the trained net has {n} params")
    print(f"  {TRAINED_NET}/model: step {weights['step']}, epoch "
          f"{weights['epoch']}, {n} params", flush=True)
    phase_fused_path(torch, cuda_kernels, C, TinyYolo, Trainer, batches, dev,
                     weights=weights, timed=False, net="trained")
    phase_megakernel(torch, cuda_kernels, TinyYolo, batches[0], dev,
                     weights=weights, timed=False, net="trained")

    X = torch.as_tensor(batches[0][0], device=dev)
    lab = torch.as_tensor(batches[0][1], device=dev)
    model = build_model(TinyYolo, "float32", "float32", dev, weights=weights)
    torch.backends.cudnn.enabled = False
    try:
        runs = {s: first_step_grads(torch, model, s, X, lab, TRAIN_START)
                for s in (False, True, "hybrid")}
    finally:
        torch.backends.cudnn.enabled = True
    for a, b in ((False, True), (True, "hybrid"), (False, "hybrid")):
        d = grads_distance(runs[a][1], runs[b][1])
        key = (f"[10] gradients' relative L2, {SCHEDULE_NAMES[a]} vs "
               f"{SCHEDULE_NAMES[b]}")
        AGREEMENTS["trained", key] = d
    print("  first-step losses at fp32, cuDNN off, r=" + str(TRAIN_START)
          + ": " + ", ".join(f"{SCHEDULE_NAMES[s]} {runs[s][0]:.6f}"
                             for s in runs), flush=True)
    del model, runs
    torch.cuda.empty_cache()
    print("  agreements, [4]'s untrained net (random weights, BatchNorm "
          "gain 8) / the trained net:", flush=True)
    for key in sorted({k for _, k in AGREEMENTS}):
        a, b = (AGREEMENTS.get((w, key), "not run")
                for w in ("untrained", "trained"))
        print(f"    {key}: {a} / {b}", flush=True)

    root = os.path.join(repo, "build", "chip_smoke_trained")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = make_synthetic_dataset(
        os.path.join(root, "data"), records_per_split=CLI_RECORDINGS,
        duration_ms=CLI_DURATION_MS, seed=CLI_SEED)
    random_net = build_model(TinyYolo, "float32", "float32", dev)
    random_ckpt = os.path.join(root, "random")
    save_single(random_ckpt, {
        "params": {k: p.detach() for k, p in random_net.named_parameters()},
        "stats": {k: b for k, b in random_net.named_buffers()
                  if k.endswith((".mean", ".var"))}})
    del random_net
    results = {}
    for which, ckpt in (("trained", os.path.join(net, "model")),
                        ("random", random_ckpt)):
        for tag, extra in (
            ("per-step", ["--trainer.time_batched=false"]),
            ("fused", ["--model.init_args.fuse_seq=true",
                       "--model.init_args.time_window=0",
                       "--trainer.time_batched=true"]),
        ):
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            run = cli.main([
                "test", "--config", os.path.join(net, "config.yaml"),
                f"--data.init_args.data_dir={data_dir}",
                f"--trainer.limit_test_batches={TRAINED_TEST_BATCHES}",
                *extra, f"--ckpt_path={ckpt}",
                f"--trainer.out_dir={os.path.join(root, which + '_' + tag)}"])
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = dict(cuda_kernels.LAUNCHES)
            check_finite(run.result, f"test {which} {tag}")
            if tag == "fused":
                check(launches["spiking_conv_seq"]
                      == CELLS_PER_STEP * TRAINED_TEST_BATCHES
                      and launches["temporal_cell_seq"] == 0,
                      f"test {which} {tag}: launches {launches}")
            else:
                check(launches["temporal_cell_seq"] > 0
                      and launches["spiking_conv_seq"] == 0,
                      f"test {which} {tag}: launches {launches}")
            results[which, tag] = run.result
            print(f"  test {which} {tag} ({run.model.state_dtype} states, "
                  f"B={run.data.batch_size}, T={run.data.num_steps}, "
                  f"{TRAINED_TEST_BATCHES} batches): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in run.result.items())
                  + f"; cli.main {main_s:.2f} s [{smi}]", flush=True)
            del run
            torch.cuda.empty_cache()
    for tag in ("per-step", "fused"):
        got, rnd = results["trained", tag]["map"], results["random", tag]["map"]
        check(got > rnd, f"test {tag}: the trained net's mAP {got} is not "
              f"above the random weights' {rnd}")


# [13]: the 1Mpx geometry (config/1mpx.yaml: 720x1280, 7 classes, B=2,
# time_batched: auto). The cell kernels at its stage-1 shape; the synthetic
# 1Mpx set of the CLI runs (recordings per split, ms each); the loader's T
# (config/config.yaml's 42), the CLI runs' T (cut to half: "auto" times
# every schedule at it) and cut (train, validation, test batches)
MPX_HW, MPX_CLASSES, MPX_BATCH = (720, 1280), 7, 2
MPX_STAGE1 = (STEPS, MPX_BATCH, MPX_HW[0] // 2, MPX_HW[1] // 2, 64)
MPX_RECORDINGS, MPX_DURATION_MS = 2, 3000
MPX_STEPS, MPX_CLI_STEPS = 42, 21
MPX_TRAIN_BATCHES, MPX_VAL_BATCHES, MPX_TEST_BATCHES = 2, 1, 1
MPX_LOADER_WORKERS = (1, 4)
MPX_H_CHUNKS = 4  # slices of H that autograd's plain backward runs apart


def mpx_cell_cases(torch, cuda_kernels, dev):
    """[13] the cell kernel and its backward at the 1Mpx stage-1 shape
    ``[42, 2, 360, 640, 64]`` (1.24e9 elements, 4.95 GB at fp32: offsets
    past 2**32 bytes), fp32 x with fp32 and bf16 states, LIF and LI,
    start 0 and TRAIN_START: the forward bit-equal to its plain version;
    the backward bit-equal to autograd through the plain version, or
    within rtol 1e-5 of the largest cotangent ([10]'s rule). The cell is
    elementwise over (B, H, W, C), so autograd's plain backward runs on
    MPX_H_CHUNKS slices of H and each slice of the kernel's gradient is
    held against it. Prints each kernel's ms (CUDA events, median), its
    bound and its share. Returns the worst error."""
    gen = torch.Generator(device=dev).manual_seed(2)
    T, M = MPX_STAGE1[0], int(np.prod(MPX_STAGE1[1:]))

    def draw(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x, gz = draw(MPX_STAGE1, 2.0), draw(MPX_STAGE1)
    state = [draw(MPX_STAGE1[1:]) for _ in range(4)]
    worst = 0.0
    rows = MPX_STAGE1[2]
    for xd, sd in TRAIN_PAIRS:
        v0, i0, gv, gi = (a.to(getattr(torch, sd)) for a in state)
        for cell in ("lif", "li"):
            for start in (0, TRAIN_START):
                tag = f"{cell} {xd}/{sd} start={start}"
                got = cuda_kernels.temporal_cell_seq(x, v0, i0, cell, start)
                want = cuda_kernels.temporal_cell_seq_reference(
                    x, v0, i0, cell, start)
                for name, g, w in zip(("z", "v_T", "i_T"), got, want):
                    same = (g == w) | (g.isnan() & w.isnan())
                    check(bool(same.all()), f"1Mpx stage 1 {tag}: {name} "
                          f"differs from the plain version on "
                          f"{int((~same).sum())} elements")
                del got, want
                fwd_ms = cuda_time_ms(lambda: cuda_kernels.temporal_cell_seq(
                    x, v0, i0, cell, start), reps=5, warmup=1)
                sx, ss = x.element_size(), v0.element_size()
                fwd_bytes = 2 * T * M * sx + 4 * M * ss
                fwd_bound = max(fwd_bytes / HBM_BYTES_PER_S,
                                T * M * CELL_OPS / FP32_FLOPS) * 1e3

                cuda_kernels.reset_launches()
                got = cuda_kernels.temporal_cell_seq_bwd(
                    x, v0, i0, gz, gv, gi, cell, start)
                torch.cuda.synchronize()
                check(cuda_kernels.LAUNCHES["temporal_cell_seq_bwd"] == 1,
                      "one backward launch a call")
                differ, errs = 0, {}
                for h0 in range(0, rows, rows // MPX_H_CHUNKS):
                    sl = slice(h0, h0 + rows // MPX_H_CHUNKS)
                    leaves = [a.detach().requires_grad_()
                              for a in (x[:, :, sl], v0[:, sl], i0[:, sl])]
                    outs = cuda_kernels.temporal_cell_seq_reference(
                        *leaves, cell, start)
                    want = torch.autograd.grad(
                        outs, leaves, (gz[:, :, sl], gv[:, sl], gi[:, sl]))
                    del outs, leaves
                    parts = (got[0][:, :, sl], got[1][:, sl], got[2][:, sl])
                    for name, g, w in zip(("gx", "gv0", "gi0"), parts, want):
                        g, w = g.float(), w.float()
                        differ += int(((g != w)
                                       & ~(g.isnan() & w.isnan())).sum())
                        err, scale = errs.get(name, (0.0, 0.0))
                        errs[name] = (max(err, float((g - w).abs().max())),
                                      max(scale, float(w.abs().max())))
                    del want, parts
                for name, (err, scale) in errs.items():
                    worst = max(worst, err)
                    check(err <= 1e-5 * scale, f"1Mpx stage 1 {tag}: {name} "
                          f"max abs err {err} past rtol 1e-5 of {scale}")
                del got
                bwd_ms = cuda_time_ms(lambda: cuda_kernels.temporal_cell_seq_bwd(
                    x, v0, i0, gz, gv, gi, cell, start), reps=3, warmup=1)
                bwd_bound, by = cell_bwd_bound(cell, T, M, sx, ss)
                print(f"  1Mpx stage 1 {list(MPX_STAGE1)} {tag}: forward "
                      f"bit-equal, kernel {fwd_ms:.3f} ms, bound "
                      f"{fwd_bound:.3f} ms ({fwd_bound / fwd_ms:.0%}); "
                      f"backward {'bit-equal' if not differ else f'{differ} elements differ'}"
                      f", kernel {bwd_ms:.3f} ms, bound {bwd_bound:.3f} ms "
                      f"({by}, {bwd_bound / bwd_ms:.0%}); plan: "
                      f"{cell_bwd_plan_text(cuda_kernels, cell, x, v0)}",
                      flush=True)
        del v0, i0, gv, gi
    del x, gz, state
    torch.cuda.empty_cache()
    return worst


def schedule_table(trainer) -> str:
    """"auto"'s measurements, mode by mode: each schedule's ms and peak
    memory, or its out-of-memory error."""
    out = []
    for mode, results in trainer.schedule_timings.items():
        for sched, r in results.items():
            what = (f"OOM ({r['oom'][:90]})" if r["oom"] else
                    f"{r['ms']:.0f} ms, peak {r['peak_gb']:.2f} GB")
            out.append(f"{mode} {SCHEDULE_NAMES[sched]}: {what}")
        if mode in trainer._auto_schedule:
            out.append(f"{mode} -> "
                       f"{SCHEDULE_NAMES[trainer._auto_schedule[mode]]}")
    return "; ".join(out)


def phase_hybrid_auto_1mpx(torch, cuda_kernels, TinyYolo, Trainer, batches,
                           smi, dev):
    """[13] hybrid, "auto" and 1Mpx: ``mpx_cell_cases``; then
    ``fit_schedule`` on the hybrid schedule in both training
    configurations at GEN1 full width (7 backward launches over the
    sequence and 15 a step, each forward launch over T or at T = 1, no
    fused launch) and its fp32 first-step gradients against the plain
    cell's (``plain_cell_grads``), its step beside [10]'s two schedules.
    Then "auto" at ``config/config.yaml`` + ``config/1mpx.yaml``
    (full-width TinyYolo, 720x1280, 7 classes, T=42, B=2, fp32): every
    schedule's ms and peak memory or its OOM, for the train and the eval
    step (no gate on the winner). Then the CLI's ``fit`` and ``test``
    with that ``time_batched: auto`` and ``config/fast.yaml``'s bf16
    states on a synthetic 1Mpx set written by ``make_synthetic_dataset``,
    at T = MPX_CLI_STEPS: "auto" resolves, finite losses and mAP, the
    cell kernel and its backward launched. Prints the loader's ms per
    1Mpx batch (T = MPX_STEPS). Returns the hybrid fits' backward
    launches."""
    from snn_for_object_detection_tpu_torch import cli
    from snn_for_object_detection_tpu_torch.data import PropheseeDataModule
    from snn_for_object_detection_tpu_torch.data.synthetic import (
        make_synthetic_dataset,
    )
    from snn_for_object_detection_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    mpx_cell_cases(torch, cuda_kernels, dev)
    print(f"  1Mpx cell cases in {time.perf_counter() - t0:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    total = 0
    for xd, sd in TRAIN_PAIRS:
        total += fit_schedule(torch, cuda_kernels, TinyYolo, Trainer,
                              batches, dev, xd, sd, "hybrid")
    X = torch.as_tensor(batches[0][0], device=dev)
    lab = torch.as_tensor(batches[0][1], device=dev)
    plain_cell_grads(torch, cuda_kernels, TinyYolo, ("hybrid",), X, lab, dev)
    for (xd, sd, sched), (ms, gb, idle) in sorted(
            TRAIN_STEP_TIMES.items(), key=lambda kv: str(kv[0])):
        print(f"  train step {xd}/{sd} {SCHEDULE_NAMES[sched]}: {ms:.1f} ms, "
              f"peak {gb:.2f} GB, idle share {idle:.3f} [{smi}]", flush=True)
    print(f"  hybrid at GEN1 in {time.perf_counter() - t0:.1f} s", flush=True)

    repo = os.path.dirname(os.path.abspath(__file__))

    def config(name):
        return os.path.join(repo, "config", name)

    t0 = time.perf_counter()
    cfg = load_config([config("config.yaml"), config("1mpx.yaml")])
    model, data, trainer = cli.build(cfg, dev)
    check(trainer.time_batched == "auto" and model.in_hw == MPX_HW
          and model.num_classes == MPX_CLASSES
          and data.batch_size == MPX_BATCH, "config/1mpx.yaml")
    Xz = torch.zeros((data.num_steps, data.batch_size, *model.in_hw,
                      model.in_channels), dtype=torch.uint8, device=dev)
    labz = torch.full((data.batch_size, data.max_labels, 5), -1.0,
                      device=dev)
    for train in (True, False):
        try:
            trainer._schedule_for(model, Xz, labz, train)
        except RuntimeError as e:
            if "no schedule compiled" not in str(e):
                raise
            print(f"  {e}", flush=True)
    print(f"  auto at 1Mpx, T={data.num_steps}, B={data.batch_size}, fp32 "
          f"({model.num_anchors} anchors): {schedule_table(trainer)} "
          f"[{smi}]; measured in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del model, trainer, Xz, labz
    torch.cuda.empty_cache()

    root = os.path.join(repo, "build", "chip_smoke_1mpx")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data_dir = make_synthetic_dataset(
        os.path.join(root, "data"), dataset="1mpx",
        records_per_split=MPX_RECORDINGS, duration_ms=MPX_DURATION_MS,
        height=MPX_HW[0], width=MPX_HW[1], num_classes=MPX_CLASSES,
        seed=CLI_SEED)
    print(f"  synthetic 1Mpx set: {MPX_RECORDINGS} recordings of "
          f"{MPX_DURATION_MS} ms per split written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for workers in MPX_LOADER_WORKERS:
        first, ms = loader_ms(PropheseeDataModule, data_dir, MPX_STEPS, 16,
                              8, workers, dataset="1mpx",
                              batch_size=MPX_BATCH)
        print(f"  loader alone, 1Mpx T={MPX_STEPS} B={MPX_BATCH}, "
              f"num_workers {workers}: {ms:.2f} ms per batch (host clock, "
              f"{LOADER_TIMED} batches after {LOADER_WARMUP}); first batch "
              f"{first:.2f} ms [{smi}]", flush=True)
    base = ["--config", config("config.yaml"), "--config",
            config("1mpx.yaml"), "--config", config("fast.yaml"),
            f"--data.init_args.data_dir={data_dir}",
            f"--data.init_args.num_steps={MPX_CLI_STEPS}",
            "--trainer.max_epochs=1",
            f"--trainer.limit_train_batches={MPX_TRAIN_BATCHES}",
            f"--trainer.limit_val_batches={MPX_VAL_BATCHES}",
            f"--trainer.limit_test_batches={MPX_TEST_BATCHES}",
            "--trainer.check_val_every_n_epoch=1",
            "--trainer.log_every_n_steps=1",
            f"--trainer.out_dir={os.path.join(root, 'run')}"]
    for sub in ("fit", "test"):
        extra = [] if sub == "fit" else [
            f"--ckpt_path={os.path.join(root, 'run', 'checkpoints', 'last')}"]
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        run = cli.main([sub, *base, *extra])
        torch.cuda.synchronize()
        sub_s = time.perf_counter() - t0
        n = dict(cuda_kernels.LAUNCHES)
        modes = {"fit": {"train", "eval"}, "test": {"eval"}}[sub]
        check(set(run.trainer._auto_schedule) == modes,
              f"{sub}: 'auto' resolved {run.trainer._auto_schedule}")
        check(n["temporal_cell_seq"] > 0
              and (sub == "test" or n["temporal_cell_seq_bwd"] > 0),
              f"{sub}: launches {n}")
        if sub == "fit":
            with open(os.path.join(root, "run", "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            losses = [r["train_loss"] for r in records if "train_loss" in r]
            val = [r for r in records if "val_loss" in r]
            check(len(losses) == MPX_TRAIN_BATCHES
                  and all(np.isfinite(v) for v in losses) and len(val) == 1,
                  f"fit: losses {losses}, validations {len(val)}")
            check_finite({k: v for k, v in val[0].items()
                          if k not in ("step", "time")}, "fit val")
            result = f"losses {[round(v, 4) for v in losses]}, val " + \
                ", ".join(f"{k} {v:.4f}" for k, v in val[0].items()
                          if k not in ("step", "time"))
        else:
            check_finite(run.result, "test")
            result = ", ".join(f"{k} {v:.4f}" for k, v in run.result.items())
        print(f"  {sub} 1Mpx ({run.model.state_dtype} states, "
              f"T={MPX_CLI_STEPS},"
              f" B={MPX_BATCH}) with time_batched auto in {sub_s:.1f} s: "
              f"{result}; {schedule_table(run.trainer)}; launches "
              f"{n['temporal_cell_seq']} cell, {n['temporal_cell_seq_bwd']} "
              f"backward [{smi}]", flush=True)
        del run
        torch.cuda.empty_cache()
    return total


# [14]: the model zoo. config/vgg.yaml: VggSNN with neuron plif, widths
# (64, 128, 256) at GEN1 (config/config.yaml's 240x304, B=4, T=42). The
# PLIF kernel's shapes: VGG's stage-1 cell (Conv 32 at 240x304) and its
# deepest (Conv 256 after three pools, 15x19); the raw time constants
# drawn around their init (inverse softplus of 200 and 100) so that every
# channel has its own factors; the starts of the forward check; the
# reduced-depth nets of (d) and YoloSNN's scale in (e)
VGG_WIDTHS = (64, 128, 256)
PLIF_SHAPES = {
    "vgg_stage1": (STEPS, BATCH, IN_HW[0], IN_HW[1], VGG_WIDTHS[0] // 2),
    "vgg_deep": (STEPS, BATCH, 15, 19, VGG_WIDTHS[2]),
}
PLIF_STARTS = (0, TRAIN_START)
PLIF_RAW_SPREAD = (40.0, 20.0)  # std of raw_tau_syn, raw_tau_mem draws
PLIF_FACTOR_TOL = 1e-4  # [C] gradients: atol of the largest |gradient|
CELL_BWD_REGS_MAX = 255  # a thread's registers at the launch bounds
YOLO_SCALE = "s"


def plif_factors(torch, neurons, ch, dev, seed=5):
    """Per-channel ``(c_mem, c_syn)`` of raw time constants drawn around
    their init, as the model computes them (``neurons.plif_factors``)."""
    rng = np.random.default_rng(seed)
    init = neurons.plif_params_init(ch)
    raw = neurons.PLIFParams(*(
        (p + torch.from_numpy(rng.normal(0.0, sd, ch).astype(np.float32))
         ).to(dev) for p, sd in zip(init, PLIF_RAW_SPREAD)))
    return neurons.plif_factors(raw)


def plif_bound(T, M, C, sx, ss, backward=False):
    """Least time (ms) of PLIF's forward or backward and what bounds it:
    the forward's bytes as ``temporal_cell_seq``'s plus the two [C]
    factor vectors; the backward's as ``cell_bwd_bound``'s LIF plus the
    factors read and the two fp32 [M] factor sums written, and two
    more operations an element-step (the factor products)."""
    if not backward:
        nbytes = 2 * T * M * sx + 4 * M * ss + 2 * C * 4
        ops = T * M * CELL_OPS
    else:
        nbytes = 3 * T * M * sx + 6 * M * ss + 2 * C * 4 + 2 * M * 4
        ops = T * M * (CELL_BWD_OPS["lif"] + 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def plif_plan_text(cuda_kernels, x, v0) -> str:
    T, m = x.shape[0], v0.numel()
    if T < 2:
        return "one reverse pass, no checkpoints"
    p = cuda_kernels.plif_bwd_plan(T, m, x.dtype, v0.dtype,
                                   m % (16 // x.element_size()) == 0)
    where = "shared" if p.shared else "global"
    return (f"C={p.chunk}, {p.rows} checkpoints a state in {where} memory "
            f"({p.ckpt_bytes / 1e6:.1f} MB, {p.smem} B shared a CTA), "
            f"{p.threads} threads{'' if p.vec else ', scalar'}")


def phase_plif_kernels(torch, cuda_kernels, neurons, dev):
    """[14] (a): ``plif_cell_seq`` against ``plif_cell_seq_reference`` at
    ``PLIF_SHAPES``, fp32, bf16 and bf16 activations with e5m2 states.
    Forward at starts 0 and 5: every output bit-equal (the same ops in
    the same order). Backward (the per-step T = 1 launch too, on the
    stage-1 shape): gx, gv0, gi0 against autograd through the plain
    version, bit-equal or within rtol 1e-5 of the largest cotangent as
    [10]; the [C] factor gradients (the kernel sums each element over t,
    then the rows; autograd sums each step over the rows, then the
    steps) within ``PLIF_FACTOR_TOL`` of the largest. Times the kernels
    with CUDA events beside their bytes bound and the plain versions;
    prints the registers of the chunked kernels (the plan model's
    ``_PLIF_BWD_REGS_SEEN``). Returns forward rows, backward rows and
    the worst errors."""
    regs = {}
    for xd, sd, vec in itertools.product(
            ("float32", "bfloat16"), ("float32", "bfloat16", "float8_e5m2"),
            (True, False)):
        width = 16 // getattr(torch, xd).itemsize if vec else 1
        regs[width] = max(regs.get(width, 0), cuda_kernels.
                          plif_bwd_regs_on_card(getattr(torch, xd),
                                                getattr(torch, sd), vec))
    print(f"  plif chunked backward: registers a thread by elements a "
          f"thread, the most over the state types: {regs} (the plan "
          f"model's {cuda_kernels._PLIF_BWD_REGS_SEEN})", flush=True)
    check(all(r < CELL_BWD_REGS_MAX for r in regs.values()),
          f"plif chunked backward spills: {regs} registers")
    fwd_rows, bwd_rows, worst_f, worst_b = [], [], 0.0, 0.0
    for label, shape in PLIF_SHAPES.items():
        T, M, ch = shape[0], int(np.prod(shape[1:])), shape[-1]
        c_mem, c_syn = plif_factors(torch, neurons, ch, dev)
        draw = cell_bwd_inputs(torch, shape, dev)
        for xd, sd in DTYPE_PAIRS:
            x, v0, i0, gz, gv, gi = cell_bwd_args(torch, draw, xd, sd)
            for start in PLIF_STARTS:
                got = cuda_kernels.plif_cell_seq(x, v0, i0, c_mem, c_syn,
                                                 start)
                want = cuda_kernels.plif_cell_seq_reference(
                    x, v0, i0, c_mem, c_syn, start)
                torch.cuda.synchronize()
                for name, g, w in zip(("z", "v_T", "i_T"), got, want):
                    g, w = g.float(), w.float()
                    same = (g == w) | (g.isnan() & w.isnan())
                    finite = g.isfinite() & w.isfinite()
                    err = float((g - w)[finite].abs().max()) \
                        if bool(finite.any()) else 0.0
                    worst_f = max(worst_f, err)
                    check(bool(same.all()),
                          f"plif {label} {xd}/{sd} start={start}: {name} "
                          f"differs from the plain version (max abs err "
                          f"{err}, {int((~same).sum())} elements)")
                spikes = float(got[0].float().mean())
                del got, want
            ms = cuda_time_ms(lambda: cuda_kernels.plif_cell_seq(
                x, v0, i0, c_mem, c_syn), reps=10)
            plain_ms = cuda_time_ms(lambda: cuda_kernels.
                                    plif_cell_seq_reference(
                                        x, v0, i0, c_mem, c_syn),
                                    reps=2, warmup=1)
            bound_ms, by, nbytes = plif_bound(T, M, ch, x.element_size(),
                                              v0.element_size())
            fwd_rows.append(dict(shape=label, x=xd, state=sd, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=by, gb=nbytes / 1e9))
            print(f"  plif forward {label} {xd}/{sd}: bit-equal at starts "
                  f"{PLIF_STARTS} (spike share {spikes:.3f}); kernel "
                  f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({by}, "
                  f"{nbytes / 1e9:.3f} GB, {bound_ms / ms:.0%} of it), "
                  f"plain {plain_ms:.2f} ms", flush=True)
            cases = [(x, v0, i0, gz, gv, gi, TRAIN_START, "T=42")]
            if label == "vgg_stage1":
                cases.append((x[:1].contiguous(), v0, i0,
                              gz[:1].contiguous(), gv, gi, 0, "T=1"))
            for bx, bv, bi, bgz, bgv, bgi, start, tag in cases:
                cuda_kernels.reset_launches()
                got = cuda_kernels.plif_cell_seq_bwd(
                    bx, bv, bi, c_mem, c_syn, bgz, bgv, bgi, start)
                gcm, gcs = cuda_kernels.plif_factor_grads(*got[3:])
                torch.cuda.synchronize()
                check(cuda_kernels.LAUNCHES["plif_cell_seq_bwd"] == 1,
                      "one PLIF backward launch a call")
                leaves = [a.detach().requires_grad_()
                          for a in (bx, bv, bi, c_mem, c_syn)]
                outs = cuda_kernels.plif_cell_seq_reference(*leaves, start)
                want = torch.autograd.grad(outs, leaves, (bgz, bgv, bgi),
                                           retain_graph=True)
                differ = 0
                for name, g, wnt in zip(("gx", "gv0", "gi0"), got[:3],
                                        want[:3]):
                    g, wnt = g.float(), wnt.float()
                    same = (g == wnt) | (g.isnan() & wnt.isnan())
                    differ += int((~same).sum())
                    err = float((g - wnt).abs().max())
                    worst_b = max(worst_b, err)
                    scale = float(wnt.abs().max())
                    check(err <= 1e-5 * scale,
                          f"plif {label} {tag} {xd}/{sd}: {name} max abs "
                          f"err {err} past rtol 1e-5 of {scale}")
                factor_err = []
                for name, g, wnt in (("c_mem", gcm, want[3]),
                                     ("c_syn", gcs, want[4])):
                    err = float((g - wnt).abs().max())
                    scale = float(wnt.abs().max())
                    factor_err.append(err / max(scale, 1e-30))
                    check(scale > 0 and err <= PLIF_FACTOR_TOL * scale,
                          f"plif {label} {tag} {xd}/{sd}: the {name} "
                          f"gradient max abs err {err} past "
                          f"{PLIF_FACTOR_TOL} of {scale}")
                ms = cuda_time_ms(lambda: cuda_kernels.plif_cell_seq_bwd(
                    bx, bv, bi, c_mem, c_syn, bgz, bgv, bgi, start), reps=10)
                plain_ms = cuda_time_ms(lambda: torch.autograd.grad(
                    outs, leaves, (bgz, bgv, bgi), retain_graph=True),
                    reps=2, warmup=1)
                del got, want, outs, leaves
                bound_ms, by, nbytes = plif_bound(
                    bx.shape[0], M, ch, bx.element_size(), bv.element_size(),
                    backward=True)
                bwd_rows.append(dict(shape=label, tag=tag, x=xd, state=sd,
                                     ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=by,
                                     differ=differ))
                print(f"  plif backward {label} {tag} {xd}/{sd} start="
                      f"{start}: gx/gv0/gi0 "
                      f"{'bit-equal' if not differ else f'{differ} elements differ'}"
                      f", [C] gradients within {max(factor_err):.2e} of the "
                      f"largest; kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({by}, {bound_ms / ms:.0%} of it), plain backward "
                      f"{plain_ms:.1f} ms; plan: "
                      f"{plif_plan_text(cuda_kernels, bx, bv)}", flush=True)
            del x, v0, i0, gz, gv, gi
        del draw
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows, worst_f, worst_b


PLIF_LAYERS, LI_HEADS = 6, 3  # VggSNN's cells: 2 + 4 PLIF, 3 head LI
ZOO_FIT_BATCHES, ZOO_VAL_BATCHES, ZOO_TEST_BATCHES = 3, 1, 1
ZOO_REPS = 3  # timed calls (after one warm-up) of each (b)/(d)/(e) step


def build_vgg(torch, VggSNN, neuron, dev, time_window=TIME_WINDOW,
              fuse_seq=False, widths=VGG_WIDTHS):
    """VggSNN at GEN1 with seeded random weights, BatchNorm gains at
    BN_GAIN (as [4]'s TinyYolo: at identity gains the untrained net
    hardly spikes on sparse frames) and, for PLIF, raw time constants
    spread around their init (``PLIF_RAW_SPREAD``), every channel its own
    factors; fp32."""
    model = VggSNN(num_classes=NUM_CLASSES, in_hw=IN_HW,
                   loss_ratio=LOSS_RATIO, time_window=time_window,
                   iou_threshold=IOU, neuron=neuron, widths=widths,
                   fuse_seq=fuse_seq, device=dev, seed=0)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.fill_(BN_GAIN)
            elif name.endswith(("raw_tau_syn", "raw_tau_mem")):
                sd = PLIF_RAW_SPREAD[name.endswith("raw_tau_mem")]
                p.add_(torch.from_numpy(rng.normal(0.0, sd, p.shape)
                                        .astype(np.float32)).to(dev))
    return model


def timed_ms(torch, fn, reps=ZOO_REPS):
    """Host-clock median (ms) of ``reps`` synchronised calls after one
    warm-up, and the peak device memory (GB) over them."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), torch.cuda.max_memory_allocated() / 1e9


def print_profile(torch, fn, tag):
    """One call of ``fn`` under the profiler: device busy time, idle
    share and time by kernel kind; returns (count, ms) by kind."""
    kernels, busy_ms, wall_ms = profiled(torch, fn)
    by_kind = {}
    for e in kernels:
        n, us = by_kind.get(kernel_kind(e.name), (0, 0.0))
        by_kind[kernel_kind(e.name)] = (n + 1, us + e.time_range.elapsed_us())
    print(f"    {tag}: profiled: device busy {busy_ms:.2f} ms of "
          f"{wall_ms:.2f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; by kind: " + "; ".join(
              f"{k} {n}x {us / 1e3:.2f} ms" for k, (n, us) in sorted(
                  by_kind.items(), key=lambda kv: -kv[1][1])[:6]),
          flush=True)
    return {k: (n, us / 1e3) for k, (n, us) in by_kind.items()}


def zoo_eval(torch, cuda_kernels, C, VggSNN, batch, dev):
    """[14] (b): the PLIF VggSNN's eval step (``Trainer.eval_step``, time
    window 0) per step, time-batched, hybrid and fused on one batch, the
    same weights. Launches per step: PLIF ``plif_cell_seq`` and the head
    LI ``temporal_cell_seq`` (T a cell per step, one a sequence), the
    fused step ``spiking_conv_seq`` on the three LI head stems and no
    ``temporal_cell_seq``. Final-state spike agreement (v == 0) a cell
    against the time-batched step >= 0.99, as [7] gates TinyYolo at fp32
    (cuDNN sums a conv in another order at another batch, and the fused
    kernel in its own). Prints each step's ms and peak memory."""
    X = torch.as_tensor(batch[0], device=dev)
    lab = torch.as_tensor(batch[1], device=dev)
    outs, T = {}, X.shape[0]
    want_launches = {
        False: dict(plif_cell_seq=PLIF_LAYERS * T,
                    temporal_cell_seq=LI_HEADS * T),
        True: dict(plif_cell_seq=PLIF_LAYERS, temporal_cell_seq=LI_HEADS),
        "hybrid": dict(plif_cell_seq=2 + (PLIF_LAYERS - 2) * T,
                       temporal_cell_seq=LI_HEADS * T),
        "fused": dict(plif_cell_seq=PLIF_LAYERS, spiking_conv_seq=LI_HEADS),
    }
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    for schedule in (True, False, "hybrid", "fused"):
        fused = schedule == "fused"
        model = build_vgg(torch, VggSNN, "plif", dev, time_window=0,
                          fuse_seq=fused)
        trainer = Trainer(seed=0, time_batched=True if fused else schedule)
        cuda_kernels.reset_launches()
        with torch.inference_mode():
            outs[schedule] = model.forward_fn(trainer.time_batched)(X)
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
        check(launches == want_launches[schedule],
              f"[14] (b) {schedule}: launches {launches}, want "
              f"{want_launches[schedule]}")
        check(all(bool(torch.isfinite(t).all()) for t in outs[schedule][0]),
              f"[14] (b) {schedule}: predictions not finite")
        ms, peak = timed_ms(torch, lambda: trainer.eval_step(model, X, lab,
                                                              0))
        agree = ""
        if schedule is not True:
            a, diff = spike_agreements(outs[schedule], outs[True])
            check(len(a) == PLIF_LAYERS + LI_HEADS, "cell count")
            check(min(a) >= 0.99, f"[14] (b) {schedule} vs time-batched: "
                  f"spike agreement {a}")
            agree = (f"; vs time-batched: spike agreement min {min(a):.6f}, "
                     f"mean {statistics.mean(a):.6f} over {len(a)} cells, "
                     f"max |pred diff| {diff:.3g}")
        print(f"  (b) eval {schedule}: launches {launches}; eval step "
              f"{ms:.1f} ms (host clock, median of {ZOO_REPS}), peak "
              f"{peak:.2f} GB{agree}", flush=True)
        if schedule is True:
            by_kind = print_profile(
                torch, lambda: trainer.eval_step(model, X, lab, 0),
                "eval time-batched")
            # the cells' bound over the step: x read and z written at
            # every step, (v, i) read and written once, the factors
            cells = [m for m in model.modules()
                     if isinstance(m, (C.Cell, C.PLIF))]
            nbytes = sum(plif_bound(T, X.shape[1] * m.out_hw[0]
                                    * m.out_hw[1] * m.out_channels,
                                    m.out_channels, 4, 4)[2] for m in cells)
            seen, cell_ms = by_kind.get("cell kernel", (0, 0.0))
            print(f"    cell kernels: {seen} of the step's {len(cells)} "
                  f"launches in the profile, {cell_ms:.3f} ms; the "
                  f"{len(cells)}'s bound {nbytes / HBM_BYTES_PER_S * 1e3:.3f}"
                  f" ms ({nbytes / 1e9:.3f} GB)", flush=True)
        if schedule is False:
            # as [5]: cuDNN picks its conv algorithm by batch (T*B frames
            # against B), and at BatchNorm gain 8 a flipped spike moves
            # the heads; PyTorch's own conv sums both schedules alike
            torch.backends.cudnn.enabled = False
            try:
                with torch.inference_mode():
                    off = {s: model.forward_fn(s)(X) for s in (False, True)}
            finally:
                torch.backends.cudnn.enabled = True
            a, diff = spike_agreements(off[False], off[True])
            print(f"  (b) per-step vs time-batched with cuDNN off: spike "
                  f"agreement min {min(a):.6f}, max |pred diff| {diff:.3g}",
                  flush=True)
            check(min(a) == 1.0 and diff <= 1e-4, "[14] (b) per-step vs "
                  f"time-batched with cuDNN off: agreement {a}, pred diff "
                  f"{diff}")
        del model
        torch.cuda.empty_cache()
    return {"plif_cell_seq": sum(want_launches[s]["plif_cell_seq"]
                                 for s in want_launches)}


def zoo_cli(torch, cuda_kernels, smi):
    """[14] (c): ``python -m snn_for_object_detection_tpu_torch fit`` with
    ``config/config.yaml`` + ``config/vgg.yaml`` (VggSNN PLIF, widths 64 /
    128 / 256, GEN1, B=4, T=42) on a synthetic GEN1 set, time-batched,
    cut to one epoch of ZOO_FIT_BATCHES batches and one validation; then
    ``test`` from its checkpoint. Gates: finite losses and metrics; in
    ``fit`` PLIF's forward and backward kernels (6 backward launches a
    step) and the head LI's (3), no plain cell; the raw time constants
    moved; ``test`` restores every weight bit for bit. Returns the
    launches of both runs."""
    from snn_for_object_detection_tpu_torch import cli
    from snn_for_object_detection_tpu_torch.data.synthetic import (
        make_synthetic_dataset,
    )
    from snn_for_object_detection_tpu_torch.models import VggSNN

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_zoo")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = make_synthetic_dataset(
        os.path.join(root, "data"), records_per_split=CLI_RECORDINGS,
        duration_ms=CLI_DURATION_MS, seed=CLI_SEED)
    out_dir = os.path.join(root, "fit")
    base = ["--config", os.path.join(repo, "config", "config.yaml"),
            "--config", os.path.join(repo, "config", "vgg.yaml"),
            f"--data.init_args.data_dir={data_dir}",
            "--trainer.max_epochs=1", "--trainer.min_epochs=0",
            f"--trainer.limit_train_batches={ZOO_FIT_BATCHES}",
            f"--trainer.limit_val_batches={ZOO_VAL_BATCHES}",
            f"--trainer.limit_test_batches={ZOO_TEST_BATCHES}",
            "--trainer.check_val_every_n_epoch=1",
            "--trainer.log_every_n_steps=1", "--trainer.time_batched=true",
            f"--trainer.out_dir={out_dir}"]
    init = VggSNN(num_classes=NUM_CLASSES, in_hw=IN_HW, neuron="plif",
                  device="cpu")
    raw0 = {n: p.detach().clone() for n, p in init.named_parameters()
            if "raw_tau" in n}
    del init
    cuda_kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = cli.main(["fit", *base])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_n = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(type(run.model) is VggSNN and run.model.neuron == "plif",
          f"[14] (c): the model is {type(run.model).__name__}")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    check(len(losses) == ZOO_FIT_BATCHES
          and all(np.isfinite(v) for v in losses),
          f"[14] (c) fit: train losses {losses}")
    want = dict(plif_cell_seq_bwd=PLIF_LAYERS * ZOO_FIT_BATCHES,
                temporal_cell_seq_bwd=LI_HEADS * ZOO_FIT_BATCHES)
    check(all(fit_n.get(k) == v for k, v in want.items())
          and fit_n.get("plif_cell_seq", 0) > 0
          and fit_n.get("temporal_cell_seq", 0) > 0
          and "spiking_conv_seq" not in fit_n,
          f"[14] (c) fit: launches {fit_n}, want {want} backward launches")
    moved = {n: float((p.detach().cpu() - raw0[n]).abs().max())
             for n, p in run.model.named_parameters() if "raw_tau" in n}
    check(len(moved) == 2 * PLIF_LAYERS and all(
        np.isfinite(v) for v in moved.values()) and max(moved.values()) > 0,
          f"[14] (c) fit: the raw time constants did not move: {moved}")
    trained = {n: p.detach().clone() for n, p in run.model.named_parameters()}
    del run
    torch.cuda.empty_cache()
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    test = cli.main(["test", *base, "--ckpt_path="
                     + os.path.join(out_dir, "checkpoints", "last")])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_n = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
    check_finite(test.result, "[14] (c) test")
    check(all(torch.equal(trained[n], p.detach())
              for n, p in test.model.named_parameters()),
          "[14] (c) test: the checkpoint's weights were not restored")
    check(test_n.get("plif_cell_seq", 0) > 0 and "plif_cell_seq_bwd"
          not in test_n, f"[14] (c) test: launches {test_n}")
    print(f"  (c) fit (config/config.yaml + config/vgg.yaml, time-batched, "
          f"{ZOO_FIT_BATCHES} steps + {ZOO_VAL_BATCHES} validation batch): "
          f"{fit_s:.1f} s, losses {[round(v, 4) for v in losses]}, peak "
          f"{peak:.2f} GB; launches {fit_n}; raw time constants moved by "
          f"at most {max(moved.values()):.3g} (median "
          f"{statistics.median(moved.values()):.3g} over "
          f"{len(moved)} tensors); test from its checkpoint: {test_s:.1f} "
          f"s, {test.result}; launches {test_n} [{smi}]", flush=True)
    del test
    torch.cuda.empty_cache()
    return {k: fit_n.get(k, 0) + test_n.get(k, 0)
            for k in ("plif_cell_seq", "plif_cell_seq_bwd")}


def zoo_net(C, SODa, S):
    """[14] (d)'s net of the other plain leaves at GEN1: Synapse after a
    spiking stem, max Pool(3, stride=2), a k=3 ConvLSTM, two taps with a
    bilinear Up between (240x304 -> 120x152 -> 59x75 -> 30x38, 15x19 ->
    30x38)."""

    class ZooNet(SODa):
        def backbone_cfgs(self):
            return [S.Conv(16, 3, 2), S.Norm(), S.LIF(),
                    S.Conv(16, 3, 1), S.Norm(), S.Synapse(),
                    S.Pool("M", 3, 2), S.LSTM(hidden_size=16, kernel_size=3)]

        def neck_cfgs(self):
            return [S.Conv(32, 3, 2), S.Norm(), S.LIF(), S.Return(),
                    S.Conv(32, 3, 2), S.Norm(), S.LIF(),
                    S.Up(2, "bilinear"), S.Conv(32, 3, 1), S.Norm(),
                    S.LIF(), S.Return()]

        def head_cfgs(self, box_out, cls_out):
            return [[S.Conv(kernel_size=1), S.Norm(), S.LI(), S.Tanh()],
                    [S.Conv(box_out, 1)], [S.Conv(cls_out, 1)]]

    return ZooNet


def zoo_plain_cells(torch, cuda_kernels, C, batch, dev):
    """[14] (d): the cells JAX runs as ``lax.scan`` and the port as plain
    PyTorch on the card: ``VggSNN(neuron="alif" | "sli")`` and
    ``zoo_net`` (Synapse, ConvLSTM, Pool(3, 2), bilinear Up), fp32 at
    GEN1, B=4, T=42: one eval step and one train step each (time-
    batched); finite loss and predictions. Prints each step's ms and peak
    memory. Returns the rows (name, eval ms, train ms, peak GB)."""
    from snn_for_object_detection_tpu_torch.models import VggSNN, spec as S
    from snn_for_object_detection_tpu_torch.models.detector import SODa
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    X = torch.as_tensor(batch[0], device=dev)
    lab = torch.as_tensor(batch[1], device=dev)
    rows = []
    for name in ("alif", "sli", "zoo_net"):
        if name == "zoo_net":
            model = zoo_net(C, SODa, S)(
                num_classes=NUM_CLASSES, in_hw=IN_HW, device=dev, seed=0)
            with torch.no_grad():
                for pn, p in model.named_parameters():
                    if pn.endswith(".scale"):
                        p.fill_(BN_GAIN)
        else:
            model = build_vgg(torch, VggSNN, name, dev)
        trainer = Trainer(seed=0, time_batched=True)
        trainer.configure(model)
        loss = float(trainer.train_step(model, X, lab, TRAIN_START))
        check(np.isfinite(loss), f"[14] (d) {name}: loss {loss}")
        with torch.inference_mode():
            (cls_p, box_p), _ = model.forward_seq(X)
        check(bool(torch.isfinite(cls_p).all() & torch.isfinite(box_p).all()),
              f"[14] (d) {name}: predictions not finite")
        eval_ms, eval_gb = timed_ms(
            torch, lambda: trainer.eval_step(model, X, lab, 0))
        train_ms, train_gb = timed_ms(
            torch, lambda: trainer.train_step(model, X, lab, TRAIN_START))
        cells = sorted({type(m).__name__ for m in model.modules()
                        if isinstance(m, C.STATEFUL_LAYERS)})
        rows.append((name, eval_ms, train_ms, max(eval_gb, train_gb)))
        print(f"  (d) {name} ({', '.join(cells)}; plain PyTorch cells on "
              f"the card): eval step {eval_ms:.1f} ms, peak {eval_gb:.2f} "
              f"GB; train step {train_ms:.1f} ms (start {TRAIN_START}), "
              f"peak {train_gb:.2f} GB; loss {loss:.4f}", flush=True)
        del model, trainer
        torch.cuda.empty_cache()
    return rows


def zoo_yolo(torch, cuda_kernels, batch, dev):
    """[14] (e): ``YoloSNN(scale="s")`` at GEN1 (B=4, T=42, fp32): one
    train step and one eval step, time-batched, finite. Then the B=1
    ``StreamingMegakernel`` (JAX's accepts the net): one launch a frame
    and no other; [8]'s gates on one frame from the zero state (spike
    agreement >= 0.99 a LIF cell and LI relative L2 <= 5% against the
    plain version on the card, >= 0.99 against ``SODa.step``); the same
    agreements after MK_FRAMES frames, printed (on the untrained net at
    BatchNorm gain 8, 24 LIF cells deep, the order of the convs' sums
    flips spikes that add up over the frames); the witness on
    MK_WITNESS_SEEDS, MK_FRAMES frames each; per-frame ms of the kernel,
    its plain version and ``SODa.step`` beside the bound."""
    from snn_for_object_detection_tpu_torch.models import YoloSNN
    from snn_for_object_detection_tpu_torch.models.compile import Cell
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        StreamingMegakernel,
        streaming_megakernel_reference,
    )
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    X = torch.as_tensor(batch[0], device=dev)
    lab = torch.as_tensor(batch[1], device=dev)
    model = build_model(functools.partial(YoloSNN, scale=YOLO_SCALE),
                        "float32", "float32", dev)
    params = sum(p.numel() for p in model.parameters())
    cells = sum(isinstance(m, Cell) for m in model.modules())
    trainer = Trainer(seed=0, time_batched=True)
    trainer.configure(model)
    loss = float(trainer.train_step(model, X, lab, TRAIN_START))
    check(np.isfinite(loss), f"[14] (e): loss {loss}")
    train_ms, train_gb = timed_ms(
        torch, lambda: trainer.train_step(model, X, lab, TRAIN_START), reps=1)
    eval_ms, eval_gb = timed_ms(
        torch, lambda: trainer.eval_step(model, X, lab, 0), reps=1)
    print(f"  (e) YoloSNN(scale={YOLO_SCALE!r}) GEN1: {params} params, "
          f"{cells} cells, plans {model.backbone_plan} + {model.neck_plan}; "
          f"train step {train_ms:.1f} ms, peak {train_gb:.2f} GB, loss "
          f"{loss:.4f}; eval step {eval_ms:.1f} ms, peak {eval_gb:.2f} GB",
          flush=True)
    del trainer, model
    torch.cuda.empty_cache()

    # the megakernel on the seeded weights, as [8], not the trained ones
    model = build_model(functools.partial(YoloSNN, scale=YOLO_SCALE),
                        "float32", "float32", dev)
    frames = X[:MK_FRAMES, 0]
    mk = StreamingMegakernel(model)
    plan = mk.plan
    cuda_kernels.reset_launches()
    runs = {"kernel": (None, []), "plain": (mk._flat_state(None), []),
            "step": (None, [])}
    agreement = {}
    for t in range(MK_FRAMES):
        state, _ = runs["kernel"]
        (cls_p, box_p), state = mk.step(frames[t], state)
        runs["kernel"] = (state, [cls_p, box_p])
        if t == 0:
            torch.cuda.synchronize()
            launches = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
        pc, pb, plain = streaming_megakernel_reference(
            plan, frames[t], runs["plain"][0])
        runs["plain"] = (plain, [pc, pb])
        with torch.inference_mode():
            preds, ss = model.step(frames[t][None], runs["step"][0])
        runs["step"] = (ss, list(preds))
        if t in (0, MK_FRAMES - 1):
            agree, li_rel = [], []
            for g, w, slot in zip(mk._flat_state(state), plain, plan.slots):
                if "head" in slot.path[0]:
                    li_rel.append(relative_l2(g, w))
                elif slot.field == 0:
                    agree.append(spike_agreement(g == 0, w == 0))
            agree_s, _ = spike_agreements(((cls_p, box_p), state),
                                          (tuple(preds), ss))
            agreement[t + 1] = (min(agree), max(li_rel), min(agree_s),
                                len(agree))
    check(launches == {"streaming_megakernel": 1},
          f"[14] (e) megakernel: launches {launches} for one frame")
    # [8]'s gates on one frame from the zero state; after MK_FRAMES
    # frames (as [8] runs TinyYolo) the agreements are printed: the
    # witness below tells order noise from a fault
    one, many = agreement[1], agreement[MK_FRAMES]
    check(one[0] >= 0.99 and one[1] <= 0.05 and one[2] >= 0.99,
          f"[14] (e) megakernel, one frame: agreement with the plain "
          f"version {one[0]}, LI relative L2 {one[1]}, with SODa.step "
          f"{one[2]}")
    failed = megakernel_witness(torch, cuda_kernels, mk, "(e) YoloSNN", dev)
    check(not failed, f"[14] (e): the megakernel is further from the "
          f"exact-sum run than the plain version on seeds {failed}")
    st = mk._flat_state(runs["kernel"][0])
    ms = per_frame_ms(lambda: cuda_kernels.streaming_megakernel(
        plan, frames[0], st))
    plain_ms = per_frame_ms(lambda: streaming_megakernel_reference(
        plan, frames[0], st), frames=2, reps=3)
    with torch.inference_mode():
        step_ms = per_frame_ms(lambda: model.step(frames[0][None],
                                                  runs["step"][0]),
                               frames=4, reps=3)
    bound_ms, by, macs, nbytes = megakernel_bound(plan, 4, 4)
    phases = plan.cuda["phases"].shape[0]
    print(f"  (e) megakernel: one launch a frame; after 1 / {MK_FRAMES} "
          f"frames, vs the plain version: spike agreement min "
          f"{one[0]:.6f} / {many[0]:.6f} over {one[3]} LIF cells, LI "
          f"relative L2 max {one[1]:.4f} / {many[1]:.4f}; vs SODa.step "
          f"min {one[2]:.6f} / {many[2]:.6f}; witness passes; "
          f"{ms:.4f} ms/frame, plain {plain_ms:.2f} ms, SODa.step "
          f"{step_ms:.2f} ms; bound {bound_ms:.4f} ms ({by}, "
          f"{2 * macs / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
          f"{phases} phases, {len(plan.slots)} state "
          f"slots", flush=True)
    del model, mk, plan
    torch.cuda.empty_cache()
    return MK_FRAMES


def phase_zoo(torch, cuda_kernels, C, neurons, smi, batches, dev):
    """[14]: the model zoo at GEN1. (a) the PLIF kernels against their
    plain versions; (b) the PLIF VggSNN's eval step on the four
    schedules; (c) ``fit`` and ``test`` through the CLI on
    ``config/vgg.yaml``; (d) the plain cells; (e) YoloSNN and its
    megakernel. Returns (a)'s rows and worst errors and the launches of
    the PLIF kernels on the ``config/vgg.yaml`` path ((b) and (c))."""
    from snn_for_object_detection_tpu_torch.models import VggSNN

    t0 = time.perf_counter()
    fwd_rows, bwd_rows, worst_f, worst_b = phase_plif_kernels(
        torch, cuda_kernels, neurons, dev)
    print(f"  [14] (a) in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = zoo_eval(torch, cuda_kernels, C, VggSNN, batches[0], dev)
    print(f"  [14] (b) in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fit = zoo_cli(torch, cuda_kernels, smi)
    launches["plif_cell_seq"] += fit["plif_cell_seq"]
    launches["plif_cell_seq_bwd"] = fit["plif_cell_seq_bwd"]
    print(f"  [14] (c) in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    zoo_plain_cells(torch, cuda_kernels, C, batches[0], dev)
    print(f"  [14] (d) in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    zoo_yolo(torch, cuda_kernels, batches[0], dev)
    print(f"  [14] (e) in {time.perf_counter() - t0:.1f} s", flush=True)
    return fwd_rows, bwd_rows, worst_f, worst_b, launches


# [15]: the last inference options. e4m3 states (float8_e4m3fn, stored
# as JAX stores them: NaN, sign kept, past 464), the space-to-depth stem,
# state recording, int8 post-training quantization. (a)'s inputs: the
# scale of the cells' x and of the initial states, so that at least
# E4M3_MIN_NAN of the stored values overflow; integer weights (from
# E4M3_INT_WEIGHTS, a share E4M3_INT_DENSITY of them nonzero) make every
# conv sum exact, in any order, so each kernel must equal its plain
# version bit for bit.
E4M3 = "float8_e4m3fn"
E4M3_X_SCALE, E4M3_STATE_SCALE, E4M3_GRAD_SCALE = 100.0, 250.0, 600.0
E4M3_MIN_NAN = 0.01
E4M3_Y_STD = 90.0  # the spread of a conv's BN output in (a)
E4M3_INT_WEIGHTS, E4M3_INT_DENSITY = (-2, -1, 1, 2), 0.25
E4M3_CONV_CASES = ("stage1_down", "stage3_down", "head0_stem")
S2D_GRID = 2.0 ** -12  # (c): the stem weights on this grid sum exactly
REC_STEPS = 12  # (d): T of the recording run
PTQ_BATCHES = 4  # (e): calibration batches
PTQ_CHECKED_STEPS = 2  # (e): per-step frames whose int8 convs are checked


def bits_equal(got, want) -> bool:
    """One-byte tensors equal as uint8 views; wider ones equal where
    finite, NaN at the same places with the same sign bit (NaN payloads
    differ between the kernels' and PyTorch's widening)."""
    import torch

    if got.element_size() == 1:
        return bool(torch.equal(got.view(torch.uint8), want.view(torch.uint8)))
    g, w = got.float(), want.float()
    nan = g.isnan() & w.isnan() & (torch.signbit(g) == torch.signbit(w))
    return bool(((g == w) | nan).all())


def nan_share(*tensors) -> float:
    """Share of NaN values over the tensors."""
    n = sum(int(t.float().isnan().sum()) for t in tensors)
    return n / sum(t.numel() for t in tensors)


def int_weights(torch, shape, dev, seed):
    """Integer-valued fp32 weights: E4M3_INT_WEIGHTS at E4M3_INT_DENSITY,
    else 0 (products and sums of binary or integer inputs exact)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.tensor(E4M3_INT_WEIGHTS, dtype=torch.float32, device=dev)
    pick = vals[torch.randint(len(vals), shape, generator=gen, device=dev)]
    keep = torch.rand(shape, generator=gen, device=dev) < E4M3_INT_DENSITY
    return pick * keep


def big_states(torch, neurons, shape, dev, seed):
    """(v0, i0) in e4m3: fp32 draws of spread E4M3_STATE_SCALE stored as
    the state is (``neurons.to_state``), so a share is NaN already."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [neurons.to_state(E4M3_STATE_SCALE * torch.randn(
        shape, generator=gen, device=dev), torch.float8_e4m3fn)
        for _ in range(2)]


def check_grads_nan_aware(got, want, tag):
    """The backward's gate with NaNs: NaN at the same places with the same
    sign bit; the finite values bit-equal or within rtol 1e-5 of the
    largest finite cotangent ([10]'s rule). Returns (elements that
    differ, worst finite error)."""
    import torch

    differ, worst = 0, 0.0
    for name, g, w in zip(("gx", "gv0", "gi0"), got, want):
        g, w = g.float(), w.float()
        check(torch.equal(g.isnan(), w.isnan())
              and torch.equal(torch.signbit(g[g.isnan()]),
                              torch.signbit(w[w.isnan()])),
              f"{tag}: {name} NaN positions or signs differ")
        fin = w.isfinite()
        check(torch.equal(fin, g.isfinite()), f"{tag}: {name} infs differ")
        if bool(fin.any()):
            d = (g[fin] - w[fin]).abs()
            differ += int((d != 0).sum())
            err = float(d.max())
            scale = float(w[fin].abs().max())
            worst = max(worst, err)
            check(err <= 1e-5 * scale, f"{tag}: {name} max abs err {err} "
                  f"past rtol 1e-5 of {scale}")
    return differ, worst


def e4m3_cells(torch, cuda_kernels, neurons, dev):
    """(a) the cell kernels with e4m3 states: the forward on [3]'s shapes
    (LIF and LI, starts 0 and 7), the backward on [10]'s (T = 42 at start
    5 and T = 1), PLIF's forward and backward on [14]'s deepest shape;
    x fp32 and bf16. Returns the forward rows of the timed cases."""
    h, w = IN_HW
    rows = []
    e4 = torch.float8_e4m3fn
    for label, shape in (("stage1", (STEPS, BATCH, h // 2, w // 2, 64)),
                         ("head_li", (STEPS, BATCH, h // 8, w // 8, 256))):
        gen = torch.Generator(device=dev).manual_seed(1)
        x32 = E4M3_X_SCALE * torch.randn(shape, generator=gen, device=dev)
        v0, i0 = big_states(torch, neurons, shape[1:], dev, 1)
        T, M = shape[0], int(np.prod(shape[1:]))
        for xd in ("float32", "bfloat16"):
            x = x32.to(getattr(torch, xd))
            for cell, start in itertools.product(("lif", "li"), (0, 7)):
                tag = f"{label} {cell} {xd}/{E4M3} start={start}"
                got = cuda_kernels.temporal_cell_seq(x, v0, i0, cell, start)
                want = cuda_kernels.temporal_cell_seq_reference(
                    x, v0, i0, cell, start)
                torch.cuda.synchronize()
                share = nan_share(want[1], want[2])
                check(all(bits_equal(g, wt) for g, wt in zip(got, want)),
                      f"{tag}: differs from the plain version")
                check(share >= E4M3_MIN_NAN, f"{tag}: NaN share {share}")
                msg = f"  {tag}: bit-equal, NaN share of v_T, i_T {share:.3f}"
                if start == 0:
                    ms = cuda_time_ms(lambda: cuda_kernels.temporal_cell_seq(
                        x, v0, i0, cell, start), reps=20)
                    plain_ms = cuda_time_ms(
                        lambda: cuda_kernels.temporal_cell_seq_reference(
                            x, v0, i0, cell, start), reps=3, warmup=1)
                    nbytes = 2 * T * M * x.element_size() + 4 * M
                    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    ops_ms = T * M * CELL_OPS / FP32_FLOPS * 1e3
                    bound = max(bytes_ms, ops_ms)
                    rows.append(dict(shape=label, cell=cell, x=xd, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound))
                    msg += (f"; kernel {ms:.4f} ms, bound {bound:.4f} ms "
                            f"({bound / ms:.0%}), plain {plain_ms:.2f} ms")
                print(msg, flush=True)
                del got, want
        del x32, x
        torch.cuda.empty_cache()

    for label, shape, start in (
            ("stage1", (STEPS, BATCH, h // 2, w // 2, 64), TRAIN_START),
            ("stage1_t1", (1, BATCH, h // 2, w // 2, 64), 0)):
        draw = cell_bwd_inputs(torch, shape, dev)
        for xd in ("float32", "bfloat16"):
            x = (E4M3_X_SCALE * draw[0]).to(getattr(torch, xd))
            gz = draw[3].to(x.dtype)
            v0, i0 = (neurons.to_state(E4M3_STATE_SCALE * d, e4)
                      for d in draw[1:3])
            gv, gi = (neurons.to_state(E4M3_GRAD_SCALE * d, e4)
                      for d in draw[4:6])
            for cell in ("lif", "li"):
                tag = f"backward {label} {cell} {xd}/{E4M3} start={start}"
                cuda_kernels.reset_launches()
                got = cuda_kernels.temporal_cell_seq_bwd(
                    x, v0, i0, gz, gv, gi, cell, start)
                torch.cuda.synchronize()
                check(cuda_kernels.LAUNCHES["temporal_cell_seq_bwd"] == 1,
                      f"{tag}: one launch")
                leaves = [a.detach().requires_grad_() for a in (x, v0, i0)]
                outs = cuda_kernels.temporal_cell_seq_reference(
                    *leaves, cell, start)
                want = torch.autograd.grad(outs, leaves, (gz, gv, gi))
                differ, err = check_grads_nan_aware(got, want, tag)
                ms = queued_ms(lambda: cuda_kernels.temporal_cell_seq_bwd(
                    x, v0, i0, gz, gv, gi, cell, start))
                bound, by = cell_bwd_bound(cell, shape[0], v0.numel(),
                                           x.element_size(), 1)
                print(f"  {tag}: "
                      f"{'bit-equal' if not differ else f'{differ} differ'}"
                      f" (max finite err {err:.3g}), NaN share of the "
                      f"cotangents {nan_share(*want):.3f}; kernel {ms:.4f} "
                      f"ms (queued), bound {bound:.4f} ms ({by}, "
                      f"{bound / ms:.0%})", flush=True)
                del got, want, outs, leaves
        del draw
        torch.cuda.empty_cache()

    shape = PLIF_SHAPES["vgg_deep"]
    c_mem, c_syn = plif_factors(torch, neurons, shape[-1], dev)
    draw = cell_bwd_inputs(torch, shape, dev)
    for xd in ("float32", "bfloat16"):
        x = (E4M3_X_SCALE * draw[0]).to(getattr(torch, xd))
        v0, i0 = (neurons.to_state(E4M3_STATE_SCALE * d, e4)
                  for d in draw[1:3])
        tag = f"plif vgg_deep {xd}/{E4M3}"
        got = cuda_kernels.plif_cell_seq(x, v0, i0, c_mem, c_syn, TRAIN_START)
        want = cuda_kernels.plif_cell_seq_reference(x, v0, i0, c_mem, c_syn,
                                                    TRAIN_START)
        torch.cuda.synchronize()
        share = nan_share(want[1], want[2])
        check(all(bits_equal(g, wt) for g, wt in zip(got, want))
              and share >= E4M3_MIN_NAN,
              f"{tag}: forward differs (NaN share {share})")
        gz = draw[3].to(x.dtype)
        gv, gi = (neurons.to_state(E4M3_GRAD_SCALE * d, e4)
                  for d in draw[4:6])
        gx = cuda_kernels.plif_cell_seq_bwd(x, v0, i0, c_mem, c_syn, gz, gv,
                                            gi, TRAIN_START)[:3]
        leaves = [a.detach().requires_grad_() for a in (x, v0, i0)]
        outs = cuda_kernels.plif_cell_seq_reference(*leaves, c_mem, c_syn,
                                                    TRAIN_START)
        want_g = torch.autograd.grad(outs, leaves, (gz, gv, gi))
        differ, err = check_grads_nan_aware(gx, want_g, tag)
        print(f"  {tag} start={TRAIN_START}: forward bit-equal (NaN share "
              f"{share:.3f}); backward "
              f"{'bit-equal' if not differ else f'{differ} differ'} (max "
              f"finite err {err:.3g})", flush=True)
    del draw
    torch.cuda.empty_cache()
    return rows


def e4m3_spiking_conv(torch, cuda_kernels, neurons, dev):
    """(a) ``spiking_conv_seq`` with e4m3 states on three of [3]'s triples,
    x fp32 and bf16, integer weights (exact sums in the kernel and in the
    plain version, cuDNN off): bit-equal."""
    rows = []
    for case in SPIKING_CONV_CASES:
        label, k, stride, cell, cin, cout, hw, density = case
        if label not in E4M3_CONV_CASES:
            continue
        x32, _, a, b, _, _ = spiking_conv_inputs(torch, case, dev)
        w = int_weights(torch, (k, k, cin, cout), dev, 7)
        y_std = (density * k * k * cin * E4M3_INT_DENSITY * 2.5) ** 0.5
        a = a * (E4M3_Y_STD / y_std)
        v0, i0 = big_states(torch, neurons,
                            (BATCH, *conv_out_hw(k, stride, hw), cout), dev, 3)
        for xd in ("float32", "bfloat16"):
            x = x32.to(getattr(torch, xd))
            tag = f"spiking_conv_seq {label} {xd}/{E4M3}"
            got = cuda_kernels.spiking_conv_seq(x, w, a, b, v0, i0, cell,
                                                stride)
            torch.backends.cudnn.enabled = False
            try:
                want = cuda_kernels.spiking_conv_seq_reference(
                    x, w, a, b, v0, i0, cell, stride)
            finally:
                torch.backends.cudnn.enabled = True
            torch.cuda.synchronize()
            share = nan_share(want[1], want[2])
            check(all(bits_equal(g, wt) for g, wt in zip(got, want)),
                  f"{tag}: differs from the plain version")
            check(share >= E4M3_MIN_NAN, f"{tag}: NaN share {share}")
            ms = cuda_time_ms(lambda: cuda_kernels.spiking_conv_seq(
                x, w, a, b, v0, i0, cell, stride), reps=5)
            bound, by = triple_bound(k, cin, cout, hw,
                                     conv_out_hw(k, stride, hw),
                                     x.element_size(), 1)
            rows.append(dict(shape=label, x=xd, ms=ms, bound_ms=bound))
            print(f"  {tag}: bit-equal (integer weights), NaN share of "
                  f"v_T, i_T {share:.3f}; kernel {ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}, {bound / ms:.0%})", flush=True)
            del got, want
        torch.cuda.empty_cache()
    return rows


def e4m3_pointwise(torch, cuda_kernels, neurons, dev):
    """(a) ``fused_pointwise_conv_bn_lif`` with e4m3 states on [3]'s GEN1
    stage-1 shape, x fp32 and bf16: integer x and w (exact sums in the
    kernel's order and cuBLAS's), bit-equal."""
    n, cin, cout = POINTWISE_CASES[0]
    _, _, a, b, _, _ = pointwise_inputs(torch, n, cin, cout, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    x32 = torch.randint(-2, 3, (n, cin), generator=gen, device=dev).float()
    w32 = int_weights(torch, (cin, cout), dev, 8)
    a = a * (E4M3_Y_STD / (cin * 2 * E4M3_INT_DENSITY * 2.5) ** 0.5)
    v, i = big_states(torch, neurons, (n, cout), dev, 4)
    for xd in ("float32", "bfloat16"):
        x, w = x32.to(getattr(torch, xd)), w32.to(getattr(torch, xd))
        tag = f"fused_pointwise_conv_bn_lif {n}x{cin}->{cout} {xd}/{E4M3}"
        got = cuda_kernels.fused_pointwise_conv_bn_lif(x, w, a, b, v, i)
        want = cuda_kernels.fused_pointwise_conv_bn_lif_reference(
            x, w, a, b, v, i)
        torch.cuda.synchronize()
        share = nan_share(want[1], want[2])
        check(all(bits_equal(g, wt) for g, wt in zip(got, want))
              and share >= E4M3_MIN_NAN,
              f"{tag}: differs from the plain version (NaN share {share})")
        ms = queued_ms(lambda: cuda_kernels.fused_pointwise_conv_bn_lif(
            x, w, a, b, v, i))
        bound, by = pointwise_bound(n, cin, cout, x.element_size(), 1)
        print(f"  {tag}: bit-equal (integer x and w), NaN share of v', i' "
              f"{share:.3f}; kernel {ms:.4f} ms (queued), bound "
              f"{bound:.4f} ms ({by}, {bound / ms:.0%})", flush=True)


def e4m3_megakernel(torch, cuda_kernels, neurons, TinyYolo, batch, dev):
    """(a) one GEN1 frame of the megakernel with e4m3 states, fp32 and bf16
    activations: integer conv weights (every conv sum exact in any order,
    split-K and tensor cores included), initial state slots of spread
    E4M3_STATE_SCALE; bit-equal to the plain version (cuDNN off)."""
    from snn_for_object_detection_tpu_torch.models import compile as C
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        StreamingMegakernel,
        streaming_megakernel_reference,
    )

    x = torch.as_tensor(batch[0][0, 0], device=dev)
    for xd in ("float32", "bfloat16"):
        model = build_model(TinyYolo, xd, E4M3, dev)
        with torch.no_grad():
            for n, m in enumerate(model.modules()):
                if isinstance(m, C.Conv):
                    m.w.copy_(int_weights(torch, tuple(m.w.shape), dev, n))
        mk = StreamingMegakernel(model)
        vals = [big_states(torch, neurons, tuple(s.shape), dev, n)[0]
                for n, s in enumerate(mk._flat_state(None))]
        cuda_kernels.reset_launches()
        cls, box, got = cuda_kernels.streaming_megakernel(mk.plan, x, vals)
        torch.cuda.synchronize()
        check(cuda_kernels.LAUNCHES["streaming_megakernel"] == 1,
              "one megakernel launch")
        torch.backends.cudnn.enabled = False
        try:
            pc, pb, want = streaming_megakernel_reference(mk.plan, x, vals)
        finally:
            torch.backends.cudnn.enabled = True
        share = nan_share(*want)
        same = [bits_equal(g, w) for g, w in zip(got, want)]
        tag = f"streaming_megakernel {xd}/{E4M3}"
        check(all(same), f"{tag}: {same.count(False)} of {len(same)} state "
              f"slots differ from the plain version")
        check(share >= E4M3_MIN_NAN, f"{tag}: NaN share {share}")
        check(bits_equal(cls, pc) and bits_equal(box, pb),
              f"{tag}: predictions differ")
        ms = per_frame_ms(
            lambda: cuda_kernels.streaming_megakernel(mk.plan, x, vals))
        bound, by, _, _ = megakernel_bound(
            mk.plan, torch.empty((), dtype=mk.plan.compute_dtype
                                 ).element_size(), 1)
        print(f"  {tag}: one frame, bit-equal over {len(same)} state slots "
              f"and the predictions (integer weights), NaN share "
              f"{share:.3f}; kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({by})", flush=True)
        del model, mk, vals, got, want
        torch.cuda.empty_cache()


def options_e4m3_kernels(torch, cuda_kernels, neurons, TinyYolo, batch, dev):
    """[15] (a): every e4m3 kernel instance against its plain version.
    Prints the seconds of each part (the first builds the sources)."""
    rows, t0 = [], time.perf_counter()
    for part, fn in (
        ("cells", lambda: e4m3_cells(torch, cuda_kernels, neurons, dev)),
        ("spiking_conv_seq", lambda: e4m3_spiking_conv(
            torch, cuda_kernels, neurons, dev)),
        ("pointwise", lambda: e4m3_pointwise(torch, cuda_kernels, neurons,
                                             dev) or []),
        ("megakernel", lambda: e4m3_megakernel(
            torch, cuda_kernels, neurons, TinyYolo, batch, dev) or []),
    ):
        rows += fn()
        print(f"  (a) {part} in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
    return rows


def eval_step_ms(torch, model, X, lab, reps=3):
    """Host-clock ms of one ``Trainer.eval_step`` (time-batched, start 0)
    ending in a synchronise, median of ``reps`` after a warm-up."""
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    trainer = Trainer(time_batched=True)
    times = []
    for n in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.eval_step(model, X, lab, 0)
        torch.cuda.synchronize()
        if n:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fit_losses(torch, cuda_kernels, C, TinyYolo, Trainer, batches, dev, sd,
               plain):
    """The losses of TRAIN_STEPS ``Trainer.fit`` steps, time-batched, fp32
    activations, ``sd`` states, from [4]'s weights, cuDNN deterministic;
    ``plain``: the cell through its plain version (autograd through it)
    instead of the kernels. Returns (losses, backward launches)."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_e4m3_fit")
    shutil.rmtree(out_dir, ignore_errors=True)
    model = build_model(TinyYolo, "float32", sd, dev)
    trainer = Trainer(max_epochs=1, limit_train_batches=TRAIN_STEPS,
                      check_val_every_n_epoch=10 ** 6, log_every_n_steps=1,
                      out_dir=out_dir, seed=0, time_batched=True)
    losses = []
    step = trainer.train_step
    trainer.train_step = lambda *a: losses.append(step(*a)) or losses[-1]
    if plain:
        C.temporal_cell_seq = cuda_kernels.temporal_cell_seq_reference
    # cuDNN's backward convs pick algorithms that sum with atomics: the two
    # runs differ then by more than the cell, whose kernels are bit-equal
    # to their plain versions
    torch.backends.cudnn.deterministic = True
    cuda_kernels.reset_launches()
    try:
        trainer.fit(model, _Batches(batches))
    finally:
        C.temporal_cell_seq = cuda_kernels.temporal_cell_seq
        torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    n = cuda_kernels.LAUNCHES["temporal_cell_seq_bwd"]
    del model
    torch.cuda.empty_cache()
    return [float(x) for x in losses], n


def nan_agreement(got, want) -> float:
    """Share of elements NaN in both tensors or in neither."""
    return float((got.float().isnan() == want.float().isnan()).float()
                 .mean())


def options_e4m3_model(torch, cuda_kernels, C, TinyYolo, Trainer, batches,
                       smi, dev):
    """[15] (b): full-width TinyYolo with bf16 activations and e4m3 states
    on [4]'s frames and weights, where some states pass 464 and turn NaN
    (JAX's e4m3 store), so a prediction or a loss may be NaN: the gates
    hold the kernels to their plain versions NaN for NaN. ``Trainer.test``
    fused ([7]'s 22 ``spiking_conv_seq`` launches a step, no cell) and
    time-batched (22 cell launches a step), each against the same
    schedule with the plain versions (the metrics NaN where theirs are,
    else equal within rtol 1e-5; per cell, final-state spike agreement
    and NaN agreement >= 0.99 fused, where the kernel sums the conv in
    another order, every state bit-equal unfused); the megakernel over
    MK_FRAMES frames against its plain version ([8]'s 0.99 per LIF cell
    and NaN agreement >= 0.99 a slot on the first frame, the witness over
    all of them, as [14] (e)); the eval step's ms beside e5m2
    states'; TRAIN_STEPS ``Trainer.fit`` steps, time-batched, on the
    kernels and on the plain cell: every loss NaN where the plain run's
    is, the finite ones within rtol 1e-3."""
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        StreamingMegakernel,
        plan_cells,
        run_distance,
        streaming_megakernel_reference,
        witness_passes,
    )

    X = torch.as_tensor(batches[0][0], device=dev)
    lab = torch.as_tensor(batches[0][1], device=dev)
    for fuse in (True, False):
        tag = f"bfloat16/{E4M3} {'fused' if fuse else 'time-batched'}"
        model = build_model(TinyYolo, "bfloat16", E4M3, dev, time_window=0,
                            fuse_seq=fuse)
        name = "spiking_conv_seq" if fuse else "temporal_cell_seq"
        kernel = getattr(C, name)
        runs = {}
        for plain in (False, True):
            if plain:
                setattr(C, name, getattr(cuda_kernels, name + "_reference"))
            cuda_kernels.reset_launches()
            try:
                metrics = Trainer(limit_test_batches=EVAL_BATCHES, seed=0,
                                  time_batched=True).test(model,
                                                          iter(batches))
                with torch.inference_mode():
                    out = model.forward_seq(X)
            finally:
                setattr(C, name, kernel)
            torch.cuda.synchronize()
            runs[plain] = (metrics, out, dict(cuda_kernels.LAUNCHES))
        launches = runs[False][2]
        want = {k: 0 for k in launches}
        want[name] = CELLS_PER_STEP * (EVAL_BATCHES + 1)
        check(launches == want, f"{tag}: launches {launches}, want {want}")
        (m_k, out_k, _), (m_p, out_p, _) = runs[False], runs[True]
        check(all(np.isnan(m_k[k]) == np.isnan(m_p[k])
                  and (np.isnan(m_k[k]) or abs(m_k[k] - m_p[k])
                       <= 1e-5 * abs(m_p[k]) + 1e-6) for k in m_p),
              f"{tag}: metrics {m_k} against the plain versions' {m_p}")
        sk, sp = state_leaves(out_k[1]), state_leaves(out_p[1])
        nan_share_ = nan_share(*sk)
        if fuse:
            agree = [spike_agreement(a == 0, b == 0)
                     for a, b in zip(sk[::2], sp[::2])]
            nans = [nan_agreement(a, b) for a, b in zip(sk, sp)]
            check(min(agree) >= 0.99 and min(nans) >= 0.99,
                  f"{tag}: spike agreement {agree}, NaN agreement {nans}")
            gate = (f"spike agreement min {min(agree):.6f}, NaN agreement "
                    f"min {min(nans):.6f} over {len(agree)} cells")
        else:
            same = [bits_equal(a, b) for a, b in zip(
                sk + list(out_k[0]), sp + list(out_p[0]))]
            check(all(same), f"{tag}: {same.count(False)} outputs differ")
            gate = f"{len(same)} states and predictions bit-equal"
        print(f"  {tag}: {launches[name]} {name} launches over "
              f"{EVAL_BATCHES + 1} eval steps; vs the plain versions: "
              f"{gate}; NaN share of the final states {nan_share_:.4f}; "
              f"metrics {m_k}", flush=True)
        del model, runs, out_k, out_p
        torch.cuda.empty_cache()

    model = build_model(TinyYolo, "bfloat16", E4M3, dev)
    mk = StreamingMegakernel(model)
    plan = mk.plan
    frames = torch.as_tensor(batches[0][0][:MK_FRAMES, 0], device=dev)
    runs = {"kernel": lambda x, s: cuda_kernels.streaming_megakernel(
                plan, x, s),
            "plain": lambda x, s: streaming_megakernel_reference(plan, x, s),
            "exact": lambda x, s: streaming_megakernel_reference(
                plan, x, s, exact_sums=True)}
    out, first = {}, {}
    cuda_kernels.reset_launches()
    for name, fn in runs.items():
        state, preds = mk._flat_state(None), []
        for t in range(MK_FRAMES):
            cls, box, state = fn(frames[t], state)
            preds += [cls, box]
            if t == 0:
                first[name] = state
        out[name] = (preds, plan_cells(plan, state), state)
    torch.cuda.synchronize()
    check(cuda_kernels.LAUNCHES["streaming_megakernel"] == MK_FRAMES,
          "megakernel launches")

    def gates(got, want):
        agree = [spike_agreement(g == 0, w == 0)
                 for g, w, slot in zip(got, want, plan.slots)
                 if "head" not in slot.path[0] and slot.field == 0]
        return agree, [nan_agreement(g, w) for g, w in zip(got, want)]

    agree1, nans1 = gates(first["kernel"], first["plain"])
    agree, nans = gates(out["kernel"][2], out["plain"][2])
    kernel = run_distance(*out["kernel"][:2], *out["exact"][:2])
    plainw = run_distance(*out["plain"][:2], *out["exact"][:2])
    ok = witness_passes(kernel, plainw)
    # [8]'s gates on the first frame and the witness over MK_FRAMES, as
    # [14] (e) holds YoloSNN's megakernel
    check(min(agree1) >= 0.99 and min(nans1) >= 0.99 and min(nans) >= 0.99
          and ok, f"megakernel e4m3: first frame {agree1} / {nans1}; "
          f"{MK_FRAMES} frames NaN agreement {nans}; witness {kernel} "
          f"against {plainw}")
    print(f"  streaming_megakernel bfloat16/{E4M3}: {MK_FRAMES} frames, one "
          f"launch each; vs the plain version: first frame spike agreement "
          f"min {min(agree1):.6f}; after {MK_FRAMES} frames spike agreement "
          f"min {min(agree):.6f} over {len(agree)} LIF cells (not "
          f"asserted), NaN agreement min {min(nans):.6f}; NaN share "
          f"{nan_share(*out['kernel'][2]):.4f}; witness, distance from the "
          f"exact-sum run: kernel {kernel}, plain version {plainw}: "
          f"{'passes' if ok else 'FAILS'}", flush=True)
    del model, mk, out, first
    times = {}
    for sd in ("float8_e5m2", E4M3):
        model = build_model(TinyYolo, "bfloat16", sd, dev)
        times[sd] = eval_step_ms(torch, model, X, lab)
        del model
    print(f"  eval step, time-batched, bf16 activations, B={BATCH}, "
          f"T={STEPS}: e4m3 states {times[E4M3]:.1f} ms, e5m2 states "
          f"{times['float8_e5m2']:.1f} ms (host clock, median of 3) "
          f"[{smi}]", flush=True)
    got, n = fit_losses(torch, cuda_kernels, C, TinyYolo, Trainer, batches,
                        dev, E4M3, plain=False)
    want, _ = fit_losses(torch, cuda_kernels, C, TinyYolo, Trainer, batches,
                         dev, E4M3, plain=True)
    check(n == CELLS_PER_STEP * TRAIN_STEPS, f"fit e4m3: {n} backward "
          f"launches, want {CELLS_PER_STEP * TRAIN_STEPS}")
    check([np.isnan(x) for x in got] == [np.isnan(x) for x in want]
          and all(abs(g - w) <= 1e-3 * abs(w) for g, w in zip(got, want)
                  if np.isfinite(w)),
          f"fit e4m3: losses {got} against the plain cell's {want}")
    print(f"  Trainer.fit, time-batched, fp32 activations, e4m3 states, "
          f"{TRAIN_STEPS} steps: losses {got} ({n} backward launches); on "
          f"the plain cell {want}", flush=True)
    torch.cuda.empty_cache()


def state_at(state, name):
    """The state a record names (``backbone/b0/l2``) in a model's state
    tree."""
    node = state
    for key in name.split("/"):
        node = node[key]
    return node


def options_s2d(torch, cuda_kernels, TinyYolo, Trainer, batches, dev):
    """[15] (c): full-width TinyYolo with ``s2d_stem=True`` and [4]'s
    weights, the stem's rounded to S2D_GRID (its sums then exact in any
    order), fp32, cuDNN off: per-step and time-batched eval bit-equal to
    ``s2d_stem=False`` (predictions and every state); a train step's
    gradients (time-batched, r = TRAIN_START) within a relative L2 of
    2e-3 (the port's gradient bar: the stem's weight gradient sums the
    packed taps in another order); and under ``fuse_seq=True`` [7]'s
    launches (22 ``spiking_conv_seq`` a step, no cell) and metrics equal
    to the unpacked fused model's, which runs the same kernels on the
    same unpacked weights."""
    X = torch.as_tensor(batches[0][0], device=dev)
    lab = torch.as_tensor(batches[0][1], device=dev)
    models = {}
    for s2d in (False, True):
        m = build_model(TinyYolo, "float32", "float32", dev, s2d_stem=s2d)
        with torch.no_grad():
            w = m.backbone.b0.l0.w
            w.copy_(torch.round(w / S2D_GRID) * S2D_GRID)
        models[s2d] = m
    check(models[True].backbone.b0.l0.s2d, "the stem is not s2d")
    torch.backends.cudnn.enabled = False
    try:
        for schedule in (False, True):
            outs = {s2d: models[s2d].forward_fn(schedule)(X)
                    for s2d in (False, True)}
            same = [bits_equal(a, b) for a, b in zip(
                list(outs[True][0]) + state_leaves(outs[True][1]),
                list(outs[False][0]) + state_leaves(outs[False][1]))]
            check(all(same), f"s2d {SCHEDULE_NAMES[schedule]}: "
                  f"{same.count(False)} of {len(same)} outputs differ")
            print(f"  s2d_stem {SCHEDULE_NAMES[schedule]} eval: predictions "
                  f"and {len(same) - 2} state tensors bit-equal to "
                  f"s2d_stem=False", flush=True)
        grads = {s2d: first_step_grads(torch, models[s2d], True, X, lab,
                                       TRAIN_START) for s2d in (False, True)}
    finally:
        torch.backends.cudnn.enabled = True
    d = grads_distance(grads[True][1], grads[False][1])
    stem = relative_l2(grads[True][1]["backbone.b0.l0.w"],
                       grads[False][1]["backbone.b0.l0.w"])
    check(grads[True][0] == grads[False][0] and d <= 2e-3,
          f"s2d train step: losses {grads[True][0]} / {grads[False][0]}, "
          f"gradients' relative L2 {d}")
    print(f"  s2d_stem train step (time-batched, r={TRAIN_START}): loss "
          f"{grads[True][0]:.6f} equal; gradients' relative L2 {d:.3g} (the "
          f"stem's weight {stem:.3g})", flush=True)
    del models, grads
    metrics = {}
    for s2d in (False, True):
        model = build_model(TinyYolo, "float32", "float32", dev,
                            time_window=0, fuse_seq=True, s2d_stem=s2d)
        cuda_kernels.reset_launches()
        metrics[s2d] = Trainer(limit_test_batches=EVAL_BATCHES, seed=0,
                               time_batched=True).test(model, iter(batches))
        torch.cuda.synchronize()
        launches = dict(cuda_kernels.LAUNCHES)
        want = {k: 0 for k in launches}
        want["spiking_conv_seq"] = CELLS_PER_STEP * EVAL_BATCHES
        check(launches == want, f"s2d={s2d} fused: launches {launches}")
        del model
    check(metrics[True] == metrics[False],
          f"fused s2d: {metrics[True]} against {metrics[False]}")
    print(f"  s2d_stem fused (fuse_seq=True): {CELLS_PER_STEP} "
          f"spiking_conv_seq launches a step and no cell launch, as [7]; "
          f"metrics equal to s2d_stem=False: {metrics[True]}", flush=True)
    torch.cuda.empty_cache()


def trained_weights():
    from snn_for_object_detection_tpu_torch.train.checkpoint import (
        load_single,
    )

    repo = os.path.dirname(os.path.abspath(__file__))
    return load_single(os.path.join(repo, TRAINED_NET, "model"))


def options_records(torch, cuda_kernels, C, TinyYolo, batches, dev):
    """[15] (d): ``forward_with_records`` on full-width TinyYolo with
    ``state_storage=True`` ([4]'s weights, fp32), B=4, T=REC_STEPS: a
    record for each of the 22 cells, every leaf [T, ...], the last step's
    state bit-equal to the returned state, 22 x T cell kernel launches
    and no call of the plain cell; then the backbone's sequence form with
    ``Ctx(record=True)``: its 7 cells a step at a time (7 x T launches at
    T = 1). ``spike_stats`` of the trained net's records printed."""
    from snn_for_object_detection_tpu_torch.utils.analysis import (
        print_spike_report,
        spike_stats,
    )

    X = torch.as_tensor(batches[0][0][:REC_STEPS], device=dev)
    model = build_model(TinyYolo, "float32", "float32", dev,
                        state_storage=True)
    plain = cuda_kernels.temporal_cell_seq_reference

    def refuse(*args, **kwargs):
        raise RuntimeError("the plain cell ran")

    cuda_kernels.temporal_cell_seq_reference = refuse
    cuda_kernels.reset_launches()
    try:
        preds, state, records = model.forward_with_records(X)
        torch.cuda.synchronize()
        n = cuda_kernels.LAUNCHES["temporal_cell_seq"]
        ctx = C.Ctx(record=True)
        cuda_kernels.reset_launches()
        _, seq_state = model.backbone.seq(X.float(), model.init_state(
            BATCH)["backbone"], ctx)
        torch.cuda.synchronize()
        n_seq = cuda_kernels.LAUNCHES["temporal_cell_seq"]
    finally:
        cuda_kernels.temporal_cell_seq_reference = plain
    check(n == CELLS_PER_STEP * REC_STEPS, f"records: {n} cell launches")
    check(len(records) == CELLS_PER_STEP, f"{len(records)} records")
    for name, (st, out) in records.items():
        check(out.shape[0] == REC_STEPS and out.dtype == torch.float32
              and all(f.shape[0] == REC_STEPS for f in st), f"{name} shapes")
        last = state_at(state, name)
        check(all(bits_equal(f[-1], g) for f, g in zip(st, last)),
              f"{name}: the last record is not the returned state")
    check(n_seq == BACKBONE_CELLS * REC_STEPS
          and len(ctx.records) == BACKBONE_CELLS
          and all(out.shape[0] == REC_STEPS
                  for _, out in ctx.records.values()),
          f"sequence records: {n_seq} launches, {len(ctx.records)} records")
    rates = spike_stats(records)
    print(f"  forward_with_records, B={BATCH}, T={REC_STEPS}: "
          f"{len(records)} records of [T, ...], the last equal to the "
          f"returned state, {n} cell launches ({CELLS_PER_STEP} x T), no "
          f"plain cell; the backbone's sequence form: {n_seq} launches at "
          f"T = 1 ({BACKBONE_CELLS} x T); firing rates "
          f"{min(r['firing_rate'] for r in rates.values()):.4f}-"
          f"{max(r['firing_rate'] for r in rates.values()):.4f}",
          flush=True)
    del model, records, state
    model = build_model(TinyYolo, "float32", "float32", dev,
                        weights=trained_weights(), state_storage=True)
    _, _, records = model.forward_with_records(X)
    print(f"  spike_stats of the trained net ({TRAINED_NET}) over "
          f"[{REC_STEPS}, {BATCH}] frames:", flush=True)
    print_spike_report(records)
    del model, records
    torch.cuda.empty_cache()


def options_int8(torch, cuda_kernels, TinyYolo, Trainer, smi, dev):
    """[15] (e): int8 PTQ on the trained net: ``python -m
    snn_for_object_detection_tpu_torch test`` with its config and
    checkpoint on a synthetic GEN1 set (as [12]; B=4, T=12, bf16 states)
    restores the fp32 net; ``calibrate`` on PTQ_BATCHES of its test
    batches and ``quantize``; every int8 conv of the first
    PTQ_CHECKED_STEPS per-step frames bit-equal to its float64 plain
    version; ``Trainer.test`` time-batched and per-step on those batches
    (mAP of both nets, the int8 net's class agreement with the fp net);
    the eval step's ms against the fp net on [4]'s frames; the int8 conv
    alone beside cuDNN's; ``StreamingEngine.update_weights`` with the
    int8 params over [9]'s streams; the megakernel of the int8 net
    (dequantized at build) with [8]'s gates. No int8 conv runs its plain
    version on the card."""
    from snn_for_object_detection_tpu_torch import cli
    from snn_for_object_detection_tpu_torch.data.synthetic import (
        make_synthetic_dataset,
    )
    from snn_for_object_detection_tpu_torch.models.convert import (
        model_params,
        model_stats,
    )
    from snn_for_object_detection_tpu_torch.ops import quantize as Q

    repo = os.path.dirname(os.path.abspath(__file__))
    net = os.path.join(repo, TRAINED_NET)
    root = os.path.join(repo, "build", "chip_smoke_ptq")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = make_synthetic_dataset(
        os.path.join(root, "data"), records_per_split=CLI_RECORDINGS,
        duration_ms=CLI_DURATION_MS, seed=CLI_SEED)
    run = cli.main([
        "test", "--config", os.path.join(net, "config.yaml"),
        f"--data.init_args.data_dir={data_dir}",
        f"--trainer.limit_test_batches={PTQ_BATCHES}",
        f"--ckpt_path={os.path.join(net, 'model')}",
        f"--trainer.out_dir={os.path.join(root, 'out')}"])
    model = run.model
    loader = iter(run.data.test_loader())
    batches = list(itertools.islice(loader, PTQ_BATCHES))
    getattr(loader, "close", lambda: None)()
    check(len(batches) == PTQ_BATCHES, f"{len(batches)} synthetic batches")
    t0 = time.perf_counter()
    absmax = Q.calibrate(model, [x for x, _ in batches])
    cal_s = time.perf_counter() - t0
    qmodel = Q.quantize(model, absmax)
    convs = [m for m in qmodel.modules() if hasattr(m, "quantized")]
    n_q = sum(m.quantized for m in convs)
    X = torch.as_tensor(np.asarray(batches[0][0]), device=dev)
    print(f"  the trained net restored by the CLI's test ({run.model.state_dtype}"
          f" states): {run.result}; calibrate: {len(absmax)} convs over "
          f"{PTQ_BATCHES} synthetic batches of {tuple(X.shape[:2])} in "
          f"{cal_s:.1f} s ({sum(a == 0 for a in absmax.values())} never saw "
          f"a nonzero input); quantize: {n_q} of {len(convs)} convs int8",
          flush=True)
    check(n_q > 0, "no conv quantized")

    conv = Q.int8_conv
    checked = []

    def checking(x, w, stride, pads):
        y = conv(x, w, stride, pads)
        checked.append(bool(torch.equal(
            y, Q.int8_conv_reference(x, w, stride, pads))))
        return y

    Q.int8_conv = checking
    try:
        st = None
        for t in range(PTQ_CHECKED_STEPS):
            _, st = qmodel.step(X[t], st)
    finally:
        Q.int8_conv = conv
    torch.cuda.synchronize()
    check(len(checked) == n_q * PTQ_CHECKED_STEPS and all(checked),
          f"int8 convs: {checked.count(False)} of {len(checked)} differ from "
          f"the float64 plain version")
    print(f"  {len(checked)} int8 convs ({PTQ_CHECKED_STEPS} frames x {n_q}"
          f") bit-equal to the float64 plain version (torch._int_mm, int32 "
          f"sums)", flush=True)

    for schedule in (True, False):
        res = {}
        for tag, m in (("fp32", model), ("int8", qmodel)):
            Q.CALLS.update(int_mm=0, plain=0)
            res[tag] = Trainer(limit_test_batches=PTQ_BATCHES, seed=0,
                               time_batched=schedule).test(m, iter(batches))
            calls = dict(Q.CALLS)
            check(calls["plain"] == 0 and (calls["int_mm"] > 0)
                  == (tag == "int8"), f"{tag}: int8 conv calls {calls}")
        with torch.inference_mode():
            (cf, _), _ = model.forward_fn(schedule)(X)
            (cq, _), _ = qmodel.forward_fn(schedule)(X)
        agree = float((cf.argmax(-1) == cq.argmax(-1)).float().mean())
        print(f"  Trainer.test {SCHEDULE_NAMES[schedule]} on the "
              f"{PTQ_BATCHES} synthetic batches: int8 map "
              f"{res['int8']['map']:.4f}, fp32 {res['fp32']['map']:.4f}; "
              f"class agreement with the fp32 net {agree:.4f}, relative L2 "
              f"of the class logits {relative_l2(cq, cf):.4f}", flush=True)
        check(all(np.isfinite(v) for v in res["int8"].values()),
              f"int8 metrics {res['int8']}")
    gen1 = make_batches(1, seed=0)[0]
    X4 = torch.as_tensor(gen1[0], device=dev)
    lab4 = torch.as_tensor(gen1[1], device=dev)
    ms = {tag: eval_step_ms(torch, m, X4, lab4)
          for tag, m in (("fp32", model), ("int8", qmodel))}
    print(f"  eval step, time-batched, B={BATCH}, T={STEPS}: int8 "
          f"{ms['int8']:.1f} ms, fp32 {ms['fp32']:.1f} ms (host clock, "
          f"median of 3) [{smi}]", flush=True)

    # the int8 conv alone (a library call: JAX runs it in XLA) at [3]'s
    # stage-3 downsample over the T x B frames, beside cuDNN's conv
    _, k, stride, _, cin, cout, hw, _ = next(
        c for c in SPIKING_CONV_CASES if c[0] == "stage3_down")
    gen = torch.Generator(device=dev).manual_seed(12)
    xq = torch.randint(-127, 128, (STEPS, BATCH, *hw, cin), generator=gen,
                       device=dev).to(torch.int8)
    wq = torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                       device=dev).to(torch.int8)
    frames = xq.reshape(STEPS * BATCH, *hw, cin)
    int8_ms = cuda_time_ms(lambda: Q.int8_conv(frames, wq, stride,
                                               (1, 1, 1, 1)), reps=5)
    fp_ms = {dt: cuda_time_ms(conv_alone(torch, xq.to(getattr(torch, dt)),
                                         wq.permute(2, 3, 1, 0).float(),
                                         stride), reps=5)
             for dt in ("float32", "bfloat16")}
    print(f"  int8 conv (im2col + torch._int_mm) at stage3_down "
          f"[{STEPS * BATCH}, {hw[0]}, {hw[1]}, {cin}] -> {cout}: "
          f"{int8_ms:.3f} ms; cuDNN's conv alone {fp_ms['float32']:.3f} ms "
          f"fp32, {fp_ms['bfloat16']:.3f} ms bf16 (CUDA events, median of "
          f"5) [{smi}]", flush=True)
    del xq, wq, frames

    qparams, stats = model_params(qmodel), model_stats(qmodel)
    Q.CALLS.update(int_mm=0, plain=0)
    weights = trained_weights()
    phase_engine(torch, cuda_kernels, TinyYolo, dev,
                 pairs=(("float32", "float32"),), modes=(False,),
                 weights=weights,
                 update=lambda eng: eng.update_weights(qparams, stats))
    check(Q.CALLS["int_mm"] == n_q * ENGINE_STEPS and Q.CALLS["plain"] == 0,
          f"engine: int8 conv calls {Q.CALLS}")
    print(f"  StreamingEngine.update_weights(int8 params): {Q.CALLS['int_mm']}"
          f" int8 convs over {ENGINE_STEPS} steps", flush=True)
    del model, qmodel, run
    torch.cuda.empty_cache()
    phase_megakernel(torch, cuda_kernels, TinyYolo, gen1, dev,
                     weights=weights, timed=False, net="int8",
                     prepare=lambda m: Q.quantize(m, absmax))


def phase_options(torch, cuda_kernels, C, neurons, TinyYolo, Trainer,
                  batches, smi, dev):
    """[15]: the last inference options, (a)-(e). Returns (a)'s rows."""
    t0 = time.perf_counter()
    rows = options_e4m3_kernels(torch, cuda_kernels, neurons, TinyYolo,
                                batches[0], dev)
    print(f"  [15] (a) in {time.perf_counter() - t0:.1f} s", flush=True)
    for part, fn in (
        ("b", lambda: options_e4m3_model(torch, cuda_kernels, C, TinyYolo,
                                         Trainer, batches, smi, dev)),
        ("c", lambda: options_s2d(torch, cuda_kernels, TinyYolo, Trainer,
                                  batches, dev)),
        ("d", lambda: options_records(torch, cuda_kernels, C, TinyYolo,
                                      batches, dev)),
        ("e", lambda: options_int8(torch, cuda_kernels, TinyYolo, Trainer,
                                   smi, dev)),
    ):
        t0 = time.perf_counter()
        fn()
        print(f"  [15] ({part}) in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return rows


# [16]: data parallel and mesh serving. (a), (b): time-batched fp32 train
# steps from TRAIN_START on [4]'s first batches, the trained net's
# weights; (b) two ranks on the one card (gloo on CUDA tensors), and its
# gates against (a)'s one-rank step; (d) mesh serving; (e) the loader-fed
# steps profiled at each prefetch depth
DP_STEPS, DP_RANKS, DP_TIMED = 2, 2, 3
DP_LOSS_RTOL, DP_GRAD_L2, DP_STATS_RTOL = 1e-4, 0.02, 1e-4
DP_FRAMES, DP_FEED_STEPS, DP_FEED_START = 16, 3, 3
DP_ENGINE_WINDOW = 4  # (d): the streams' warm-up, so 12 frames detect
DP_RANK_TIMEOUT_S = 300


def dp_state(torch, model):
    """A model's weights and BatchNorm running statistics, on the host."""
    return ({n: p.detach().cpu().clone() for n, p in model.named_parameters()},
            {n: b.detach().cpu().clone() for n, b in model.named_buffers()
             if n.endswith((".mean", ".var"))})


def dp_sha(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(params):
        h.update(params[name].numpy().tobytes())
    return h.hexdigest()


class ranks_order_moments:
    """Within: every train BatchNorm's moments as the ranks of [16] (b)
    or [18] sum them (``compile.global_moments``), in one process: the
    map in ``blocks`` blocks (``halo.row_blocks``) along ``dims[along]``
    (0: the batch's rows, [16]; 1: H, [18]'s space blocks), each block's
    fp32 sums added in fp64 in block order (as the ranks add them after
    their all-gather), the mean first, then the squared deviations. The
    trained net at full width turns any other sum order into flipped
    spikes: in one process, ``var_mean`` and this form move the first
    step's loss by 5.2e-4 on an H100, more than (b)'s gate (the yardstick
    line (b) prints)."""

    def __init__(self, torch, C, blocks=DP_RANKS, along=0):
        self.torch, self.C, self.blocks = torch, C, blocks
        self.along = along

    def __enter__(self):
        from snn_for_object_detection_tpu_torch.parallel import row_blocks

        self.saved = self.C.Norm.__dict__["_moments"]

        def moments(x, dims, group, n):
            d = dims[self.along]
            blocks = [x.narrow(d, lo, hi - lo).contiguous()
                      for lo, hi in row_blocks(x.shape[d], self.blocks)]

            def summed(parts):
                out = parts[0].double()
                for p in parts[1:]:
                    out = out + p.double()
                return out.float()

            mean = summed([b.sum(dim=dims, keepdim=True) for b in blocks]) / n
            var = summed([((b - mean) ** 2).sum(dim=dims, keepdim=True)
                          for b in blocks]) / n
            return mean, var

        self.C.Norm._moments = staticmethod(moments)
        return self

    def __exit__(self, *exc):
        self.C.Norm._moments = self.saved


def on_card(torch, X, lab):
    """A host batch on the card as it is."""
    return (torch.as_tensor(np.ascontiguousarray(X), device="cuda"),
            torch.as_tensor(np.ascontiguousarray(lab), device="cuda"))


def dp_train(torch, TinyYolo, Trainer, batches, trainer_kw, place=None,
             schedule=True, steps=DP_STEPS, model=None):
    """``steps`` fp32 train steps of the trained net on ``schedule``
    from TRAIN_START: each step's loss, the weights after it and its
    kernel launches, the first step's gradients as the optimizer saw
    them and the running statistics after it. ``place(X, lab)`` puts
    this rank's part of a host batch on the card ([16] (b): its rows of
    B; [18]: its rows of H, ``shard_batch`` on the grid); by default the
    whole batch. ``model``: another net to train ([18]'s zoo net).
    Returns the run, the trainer and model, to go on, and the last batch
    as it went in."""
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels

    if model is None:
        model = build_model(TinyYolo, "float32", "float32", "cuda",
                            weights=trained_weights())
    trainer = Trainer(seed=0, time_batched=schedule, prefetch_batches=0,
                      **trainer_kw)
    trainer.configure(model)
    seen = []
    step = trainer.opt.step

    def record(grads):
        if not seen:
            seen.append({n: g.detach().cpu().clone() for (n, _), g in
                         zip(model.named_parameters(), grads)})
        return step(grads)

    trainer.opt.step = record
    run = {"losses": [], "weights": [], "launches": []}
    for s in range(steps):
        if place is None:
            X, lab = on_card(torch, *batches[s])
        else:
            X, lab = place(*batches[s])
        cuda_kernels.reset_launches()
        loss = trainer.train_step(model, X, lab, TRAIN_START)
        run["launches"].append(dict(cuda_kernels.LAUNCHES))
        run["losses"].append(loss.cpu())
        params, stats = dp_state(torch, model)
        run["weights"].append(params)
        if s == 0:
            run["stats"] = stats
    trainer.opt.step = step
    run["grads"] = seen[0]
    return run, trainer, model, (X, lab)


def dp_rank(rank, world, store, out):
    """(b): one of two ranks on the one card, gloo on CUDA tensors."""
    import torch

    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo
    from snn_for_object_detection_tpu_torch.parallel import distributed
    from snn_for_object_detection_tpu_torch.parallel import make_mesh
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    distributed.initialize(f"file://{store}", num_processes=world,
                           process_id=rank, backend="gloo", device="cuda:0",
                           timeout_s=DP_RANK_TIMEOUT_S)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = make_mesh()
    runs = {}
    for cudnn in (False, True):
        torch.backends.cudnn.enabled = cudnn
        run, trainer, model, (X, lab) = dp_train(
            torch, TinyYolo, Trainer, make_batches(DP_STEPS, seed=0),
            {"mesh": mesh}, lambda X, lab: on_card(
                torch, distributed.local_rows(X, 1),
                distributed.local_rows(lab, 0)))
        run["sha"] = [dp_sha(w) for w in run["weights"]]
        if rank:  # rank 0's weights stand for both (the shas compare them)
            run["weights"] = run["grads"] = None
        runs[cudnn] = run
    torch.backends.cudnn.deterministic = False
    step_ms = cuda_time_ms(
        lambda: trainer.train_step(model, X, lab, TRAIN_START),
        reps=DP_TIMED, warmup=1)

    def local_step():
        """The train step on this rank's rows with no collective: the
        forward and loss without the group, no all-reduce of the
        gradients."""
        preds, _ = model.forward_fn(True)(X, start_step=TRAIN_START,
                                          train=True)
        grads = torch.autograd.grad(model.loss(preds, lab),
                                    trainer.opt.params, allow_unused=True)
        trainer.opt.step(list(grads))

    local_ms = cuda_time_ms(local_step, reps=DP_TIMED, warmup=1)
    # the collectives of one train step: every all-reduce and
    # all-gather, those in autograd functions included
    saved = {k: getattr(torch.distributed, k)
             for k in ("all_reduce", "all_gather")}
    calls = {k: [] for k in saved}

    def counted(kind):
        def call(*args, **kwargs):
            x = args[0] if kind == "all_reduce" else args[1]
            calls[kind].append(x.numel())
            return saved[kind](*args, **kwargs)
        return call

    for kind in saved:
        setattr(torch.distributed, kind, counted(kind))
    trainer.train_step(model, X, lab, TRAIN_START)
    for kind, fn in saved.items():
        setattr(torch.distributed, kind, fn)
    grads = [torch.zeros_like(p) for p in model.parameters()]
    grads.append(torch.zeros(1, device="cuda"))
    reduce_ms = cuda_time_ms(
        lambda: distributed.all_reduce_sum(grads, mesh.group),
        reps=DP_TIMED, warmup=1)
    runs.update(step_ms=step_ms, local_ms=local_ms, reduce_ms=reduce_ms,
                reduces=len(calls["all_reduce"]),
                gathers=len(calls["all_gather"]),
                largest=max(calls["all_reduce"]),
                rows=int(X.shape[1]))
    torch.save(runs, os.path.join(out, f"rank{rank}.pt"))
    distributed.barrier("dp_done")
    torch.distributed.destroy_process_group()


def dp_distances(torch, got, want):
    """(b)'s distances from a one-rank run, all of the first step (a
    second step starts from weights the first moved apart): the loss's
    relative difference, the gradients' relative L2, and the running
    stats' largest difference beyond rtol DP_STATS_RTOL (atol 1e-6: some
    running means are ~0)."""
    a, b = float(got["losses"][0]), float(want["losses"][0])
    loss = abs(a - b) / abs(b)
    stats = max(float(((got["stats"][n] - v).abs()
                       - DP_STATS_RTOL * v.abs()).max())
                for n, v in want["stats"].items())
    return loss, grads_distance(got["grads"], want["grads"]), stats


def dp_two_ranks(torch, one, smi):
    """(b): ``torch.multiprocessing.spawn`` of two ranks on a FileStore,
    each on its two rows of [4]'s batches, cuDNN off, then on. Gated with
    cuDNN off (PyTorch's own conv sums each frame alike at any batch)
    against the one-rank run whose BatchNorm sums its moments in the
    ranks' order, ``one["order"]``; printed against the one-rank run as
    it is (``one[False]``, ``var_mean``), beside the one rank's own
    distance between the two sum orders, and with cuDNN on (its algorithm
    depends on the batch) against ``one[True]``."""
    import torch.multiprocessing as mp

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_dp")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.perf_counter()
    mp.spawn(dp_rank, args=(DP_RANKS, os.path.join(out, "store"), out),
             nprocs=DP_RANKS, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_RANKS)]
    for cudnn in (False, True):
        for s in range(DP_STEPS):
            check(len({r[cudnn]["sha"][s] for r in ranks}) == 1,
                  f"(b) cudnn={cudnn}: the ranks' weights differ after step "
                  f"{s + 1}")
    print(f"  (b) {DP_RANKS} ranks on one card (gloo on CUDA tensors, "
          f"{ranks[0]['rows']} rows a rank, spawned and done in "
          f"{spawn_s:.1f} s): weights bit-equal across the ranks after "
          f"each of {DP_STEPS} steps, cuDNN off and on", flush=True)
    for tag, got, want in (
        ("cuDNN off, vs one rank summing BN in the ranks' order (gated)",
         ranks[0][False], one["order"]),
        ("cuDNN off, vs one rank as it is (var_mean)", ranks[0][False],
         one[False]),
        ("one rank, cuDNN off: ranks' order vs var_mean (yardstick)",
         one["order"], one[False]),
        ("cuDNN on, vs (a)'s one rank", ranks[0][True], one[True]),
    ):
        loss_err, grad_l2, stats_over = dp_distances(torch, got, want)
        print(f"  (b) {tag}: first-step loss rel {loss_err:.3g} (gate "
              f"{DP_LOSS_RTOL}), gradients relative L2 {grad_l2:.3g} (gate "
              f"{DP_GRAD_L2}), BN running stats beyond rtol "
              f"{DP_STATS_RTOL}: {max(stats_over, 0.0):.3g} (gate 1e-6); "
              f"losses {[float(v) for v in got['losses']]} vs "
              f"{[float(v) for v in want['losses']]}", flush=True)
        if want is one["order"] and got is ranks[0][False]:
            gates = [(loss_err <= DP_LOSS_RTOL,
                      f"(b): loss {loss_err:.3g} from one rank"),
                     (grad_l2 <= DP_GRAD_L2,
                      f"(b): gradients {grad_l2:.3g} from one rank"),
                     (stats_over <= 1e-6,
                      f"(b): running stats {stats_over:.3g} beyond rtol")]
    for ok, msg in gates:
        check(ok, msg)
    for r, run in enumerate(ranks):
        inside = run["step_ms"] - run["local_ms"]
        print(f"  (e) rank {r}: train step {run['step_ms']:.1f} ms (CUDA "
              f"events, median of {DP_TIMED}, {run['rows']} rows, two "
              f"ranks sharing the card, cuDNN on); the same step with no "
              f"collective {run['local_ms']:.1f} ms; the step's "
              f"{run['gathers']} all-gathers (BatchNorm's sums, 2 a train "
              f"Norm's forward, again in the recompute) and "
              f"{run['reduces']} all-reduces (2 a train Norm's backward; "
              f"the loss's counts; the gradients and loss shares in one "
              f"buffer of {run['largest']} values) {inside:.1f} ms, share "
              f"{inside / run['step_ms']:.3f}; the gradients' all-reduce "
              f"alone {run['reduce_ms']:.1f} ms, share "
              f"{run['reduce_ms'] / run['step_ms']:.3f} [{smi}]", flush=True)


def dp_cli(torch, data_dir, root):
    """(c): ``python -m torch.distributed.run --nproc_per_node 1 -m
    snn_for_object_detection_tpu_torch fit --distributed`` (NCCL) on a
    synthetic GEN1 set: exits 0, a metrics line a step."""
    repo = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "fit_distributed")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "snn_for_object_detection_tpu_torch",
           "fit", "--distributed",
           "--config", os.path.join(repo, "config", "config.yaml"),
           "--config", os.path.join(repo, "config", "synthetic.yaml"),
           f"--data.init_args.data_dir={data_dir}",
           "--trainer.max_epochs=1", "--trainer.limit_train_batches=2",
           "--trainer.limit_val_batches=1",
           "--trainer.check_val_every_n_epoch=1",
           "--trainer.log_every_n_steps=1", "--trainer.time_batched=true",
           f"--trainer.out_dir={out_dir}"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                         text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0,
          f"(c): torchrun fit --distributed exited {res.returncode}:\n"
          f"{(res.stdout + res.stderr)[-3000:]}")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r["step"] for r in records if "train_loss" in r]
    check(steps == [1, 2], f"(c): steps logged {steps}")
    check(all(np.isfinite(r["train_loss"]) for r in records
              if "train_loss" in r), "(c): train losses")
    check(os.path.exists(os.path.join(out_dir, "checkpoints", "last")),
          "(c): no checkpoint")
    print(f"  (c) torchrun --nproc_per_node 1 fit --distributed (NCCL): "
          f"exit 0 in {cli_s:.1f} s (start-up and the build's load "
          f"included); steps logged {steps}, losses "
          f"{[round(r['train_loss'], 4) for r in records if 'train_loss' in r]}",
          flush=True)


def dp_engine_run(torch, StreamingEngine, model, frames, mesh=None):
    """(d): an engine, capacity ENGINE_CAPACITY, ENGINE_STREAMS streams,
    DP_FRAMES steps: its outputs, final state (the replicas' rows in slot
    order) and step ms (host clock, synchronised, median)."""
    eng = StreamingEngine(model, capacity=ENGINE_CAPACITY, mesh=mesh)
    for n in range(ENGINE_STREAMS):
        eng.add_stream(f"cam{n}")
    outs, times = [], []
    for t in range(DP_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(eng.step({f"cam{n}": frames[t, n]
                              for n in range(ENGINE_STREAMS)}))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    leaves = [torch.cat(block) for block in
              zip(*(state_leaves(s) for s in eng._states))]
    return outs, leaves, statistics.median(times[1:])


def dp_serving(torch, cuda_kernels, TinyYolo, weights, smi):
    """(d): ``StreamingEngine(mesh=make_mesh(["cuda:0", "cuda:0"]))``
    against the mesh-less engine on the trained net: bit-equal
    detections with cuDNN off; with it on, final-state spike agreement
    per cell >= 0.99. Returns the mesh engine's cell launches and step
    ms."""
    from snn_for_object_detection_tpu_torch.parallel import make_mesh
    from snn_for_object_detection_tpu_torch.serve import StreamingEngine

    rng = np.random.default_rng(16)
    frames = (rng.random((DP_FRAMES, ENGINE_STREAMS, *IN_HW, 2))
              < EVENT_DENSITY).astype(np.uint8)
    model = build_model(TinyYolo, "float32", "float32", "cuda",
                        time_window=DP_ENGINE_WINDOW, weights=weights)
    mesh = make_mesh(["cuda:0", "cuda:0"])
    launches = 0
    for cudnn in (False, True):
        torch.backends.cudnn.enabled = cudnn
        one, one_state, one_ms = dp_engine_run(torch, StreamingEngine, model,
                                               frames)
        cuda_kernels.reset_launches()
        two, two_state, two_ms = dp_engine_run(torch, StreamingEngine, model,
                                               frames, mesh)
        n = cuda_kernels.LAUNCHES["temporal_cell_seq"]
        check(n == CELLS_PER_STEP * mesh.size * DP_FRAMES,
              f"(d): {n} cell launches, want {CELLS_PER_STEP} a replica "
              "and step")
        launches += n
        same = all(a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a) for a, b in zip(one, two))
        agree = [spike_agreement(x == 0, y == 0) for x, y in
                 zip(one_state[::2], two_state[::2])]
        n_dets = sum(len(d) for out in two for d in out.values())
        print(f"  (d) cudnn={cudnn}: mesh of {mesh.size} replicas on cuda:0 "
              f"vs one engine, {DP_FRAMES} frames, {ENGINE_STREAMS} streams: "
              f"detections bit-equal {same} ({n_dets} after warm-up); "
              f"final-state spike agreement min {min(agree):.6f}; engine "
              f"step {two_ms:.1f} ms mesh, {one_ms:.1f} ms one engine (host "
              f"clock, median) [{smi}]", flush=True)
        check(n_dets > 0, "(d): no detections after the warm-up")
        if not cudnn:
            check(same, "(d): cuDNN off, the mesh engine's detections "
                  "differ from the one engine's")
        else:
            check(min(agree) >= 0.99, f"(d): spike agreement {min(agree)}")
            step_ms = two_ms
    torch.backends.cudnn.enabled = True
    return launches, step_ms


def dp_loader_idle(torch, TinyYolo, Trainer, data_dir, weights, smi):
    """(e): [11]'s loader-fed train step (``config/synthetic.yaml``'s
    loader: B=4, T=24, 2 workers) at prefetch depth 0 and 2: the device
    idle share of DP_FEED_STEPS steps under the profiler."""
    from snn_for_object_detection_tpu_torch.data import PropheseeDataModule
    from snn_for_object_detection_tpu_torch.parallel import (
        make_mesh,
        prefetch_to_device,
    )

    model = build_model(TinyYolo, "float32", "float32", "cuda",
                        time_window=6, weights=weights)
    trainer = Trainer(seed=0, time_batched=True)
    trainer.configure(model)
    mesh = make_mesh(["cuda"])
    for depth in (0, 2):
        data = PropheseeDataModule(data_dir=data_dir, batch_size=BATCH,
                                   num_steps=24, time_shift=0,
                                   num_load_file=4, num_workers=2)
        it = prefetch_to_device(data.train_loader(), mesh, depth)

        def steps():
            for _ in range(DP_FEED_STEPS):
                X, lab = next(it)
                trainer.train_step(model, X, lab, DP_FEED_START)

        steps()  # warm: the loader's first batches, the schedule
        _, busy, wall = profiled(torch, steps)
        it.close()
        print(f"  (e) loader-fed, prefetch_batches {depth}: {DP_FEED_STEPS} "
              f"steps busy {busy:.1f} of {wall:.1f} ms, idle share "
              f"{1 - busy / wall:.3f} [{smi}]", flush=True)


def phase_data_parallel(torch, cuda_kernels, TinyYolo, Trainer, batches,
                        smi):
    """[16]: (a) one-rank NCCL group, (b) two ranks on the card, (c) the
    CLI under torchrun, (d) mesh serving, (e) their numbers. Returns the
    backward kernel's launches in (a)'s mesh run and the cell kernel's in
    (d)'s mesh engines."""
    from snn_for_object_detection_tpu_torch.data.synthetic import (
        make_synthetic_dataset,
    )
    from snn_for_object_detection_tpu_torch.models import compile as C
    from snn_for_object_detection_tpu_torch.parallel import (
        distributed,
        make_mesh,
    )

    weights = trained_weights()
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    one = {}
    torch.backends.cudnn.enabled = False  # (b)'s references
    one[False], _, _, _ = dp_train(torch, TinyYolo, Trainer, batches, {})
    with ranks_order_moments(torch, C):
        one["order"], _, _, _ = dp_train(torch, TinyYolo, Trainer, batches,
                                         {})
    torch.backends.cudnn.enabled = True
    one[True], _, _, _ = dp_train(torch, TinyYolo, Trainer, batches, {})
    mesh = make_mesh()
    check(distributed.world_size() == 1
          and torch.distributed.get_backend() == "nccl",
          "(a): not a one-rank NCCL group")
    run, _, _, _ = dp_train(torch, TinyYolo, Trainer, batches,
                            {"mesh": mesh})
    bwd = sum(n["temporal_cell_seq_bwd"] for n in run["launches"])
    torch.backends.cudnn.deterministic = False
    torch.distributed.destroy_process_group()
    check(bwd == CELLS_PER_STEP * DP_STEPS,
          f"(a): {bwd} backward launches, want {CELLS_PER_STEP} a step")
    same = all(torch.equal(a, b) for a, b in zip(run["losses"],
                                                  one[True]["losses"]))
    same_w = all(torch.equal(run["weights"][s][n], w)
                 for s in range(DP_STEPS) for n, w in
                 one[True]["weights"][s].items())
    print(f"  (a) one-rank NCCL group: {DP_STEPS} time-batched fp32 steps "
          f"(trained net, B={BATCH}, T={STEPS}, start {TRAIN_START}, cuDNN "
          f"deterministic) against the mesh-less trainer: losses bit-equal "
          f"{same}, weights bit-equal {same_w}; {bwd} backward launches "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(same and same_w, "(a): the one-rank mesh differs from no mesh")

    t0 = time.perf_counter()
    dp_two_ranks(torch, one, smi)
    print(f"  (b) in {time.perf_counter() - t0:.1f} s", flush=True)

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_dp_cli")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = make_synthetic_dataset(
        os.path.join(root, "data"), records_per_split=CLI_RECORDINGS,
        duration_ms=CLI_DURATION_MS, seed=CLI_SEED)
    t0 = time.perf_counter()
    dp_cli(torch, data_dir, root)
    print(f"  (c) in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    launches, _ = dp_serving(torch, cuda_kernels, TinyYolo, weights, smi)
    print(f"  (d) in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dp_loader_idle(torch, TinyYolo, Trainer, data_dir, weights, smi)
    print(f"  (e) loader in {time.perf_counter() - t0:.1f} s", flush=True)
    return bwd, launches


# [17]: the CLI's fit on config.yaml + logger.yaml + synthetic.yaml
EXTRAS_TRAIN_BATCHES = 6


def extras_fit(cli, config, data_dir, out_dir, extra=()):
    """``fit`` through the CLI on synthetic GEN1 (``config/synthetic.yaml``:
    T=24, time window 6), full-width TinyYolo, B=4, time-batched, one
    loader worker (its batches in one order every run), one epoch of
    EXTRAS_TRAIN_BATCHES steps and one validation batch."""
    return cli.main(["fit", *config("config.yaml"), *extra,
                     *config("synthetic.yaml"),
                     f"--data.init_args.data_dir={data_dir}",
                     "--data.init_args.num_workers=1",
                     "--trainer.max_epochs=1",
                     f"--trainer.limit_train_batches={EXTRAS_TRAIN_BATCHES}",
                     "--trainer.limit_val_batches=1",
                     "--trainer.check_val_every_n_epoch=1",
                     "--trainer.log_every_n_steps=1",
                     "--trainer.time_batched=true",
                     f"--trainer.out_dir={out_dir}"])


def weights_distance(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def trace_kernels(path):
    """The device kernels' names in a Chrome trace ``torch.profiler``
    wrote, with their counts."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {}
    for e in events:
        if e.get("cat") == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    return names


def plotter_check(P, frame) -> str:
    """[17] (c)'s gate on ``Plotter.apply`` (``P``: the port's
    ``utils.plotter``) for one ``[H, W, 2]`` event frame. With ``cv2``: a
    ground-truth box (2 px) and a prediction (1 px, its confidence above
    it) change the bare frame on each box's outline (at least its
    perimeter in pixels), the label, and nowhere else; the box's edge is
    its class's colour; a prediction under the threshold draws nothing.
    Without ``cv2``: the frame's red and blue pixels are its events, and
    boxes draw nothing (the JAX Plotter's fallback)."""
    h, w = frame.shape[:2]
    bare = P.Plotter().apply(frame)
    target = np.array([[1, 0.1, 0.2, 0.45, 0.6], [-1, 0, 0, 0, 0]],
                      np.float32)
    preds = np.array([[0, 0.95, 0.55, 0.3, 0.9, 0.85],
                      [1, 0.5, 0.0, 0.0, 0.5, 0.5]], np.float32)
    changed = (P.Plotter().apply(frame, preds, target) != bare).any(-1)
    if not P._HAS_CV2:
        red = int((bare[..., 2] == 255).sum())
        blue = int((bare[..., 0] == 255).sum())
        check(red == int((frame[..., 1] > 0).sum())
              and blue == int((frame[..., 0] > 0).sum())
              and not changed.any(),
              "(c): Plotter.apply without cv2 is not the frame's events")
        return f"no cv2: {red} red and {blue} blue pixels, its events"
    yy, xx = np.mgrid[:h, :w]

    def outline(box, r=3):  # pixels within r of the box's outline
        x1, y1, x2, y2 = (int(box[0] * w), int(box[1] * h),
                          int(box[2] * w), int(box[3] * h))
        near = (xx >= x1 - r) & (xx <= x2 + r) & (yy >= y1 - r) & (
            yy <= y2 + r)
        inner = (xx > x1 + r) & (xx < x2 - r) & (yy > y1 + r) & (
            yy < y2 - r)
        return near & ~inner, 2 * (x2 - x1 + y2 - y1), (x1, y1, x2, y2)

    gt, gt_per, (gx1, gy1, gx2, _) = outline(target[0, 1:])
    pr, pr_per, (px1, py1, _, _) = outline(preds[0, 2:])
    label = (xx >= px1 - 2) & (xx <= px1 + 60) & (yy >= py1 - 20) & (
        yy <= py1) & ~pr
    drawn = P.Plotter().apply(frame, preds, target)
    n_gt, n_pr, n_label = (int(changed[gt].sum()), int(changed[pr].sum()),
                           int(changed[label].sum()))
    n_else = int(changed[~(gt | pr | label)].sum())
    edge = tuple(int(c) for c in drawn[gy1, (gx1 + gx2) // 2])
    check(n_gt >= gt_per and n_pr >= pr_per and n_label > 0 and n_else == 0
          and edge == P._TABLEAU_BGR[1],
          f"(c): Plotter.apply's boxes: {n_gt} pixels on the ground "
          f"truth's outline (perimeter {gt_per}), {n_pr} on the "
          f"prediction's ({pr_per}), {n_label} in its label, {n_else} "
          f"elsewhere; edge colour {edge}")
    return (f"boxes change {n_gt} pixels on the ground truth's outline "
            f"(perimeter {gt_per}), {n_pr} on the prediction's "
            f"({pr_per}), {n_label} in its label, 0 elsewhere")


def phase_extras(torch, cuda_kernels, TinyYolo, Trainer, batches, smi):
    """[17] training extras, plotter and summary: (a) ``python -m
    snn_for_object_detection_tpu_torch fit`` with config/config.yaml,
    config/logger.yaml and config/synthetic.yaml (``extras_fit``) with
    ``debug_nans`` and ``profile_dir``: metrics.csv's rows and the event
    file's (tag, step, value) triples are metrics.jsonl's, the Chrome
    trace holds the cell kernels (forward and backward), and the weights
    equal those of the same fit without logger.yaml, debug_nans and the
    profiler (cuDNN deterministic), gated at the distance between two
    such plain fits; the train step's ms with and without debug_nans;
    (b) a one-step ``Trainer(debug_nans=True).fit`` with a NaN weight
    raises ``FloatingPointError``; (c) ``predict --config
    config/config.yaml`` on (a)'s checkpoint: the video where ``cv2``
    imports, and ``plotter_check`` on a frame of its data; (d) ``summarize`` of GEN1 TinyYolo."""
    from snn_for_object_detection_tpu_torch import cli
    from snn_for_object_detection_tpu_torch.data.synthetic import (
        make_synthetic_dataset,
    )
    from snn_for_object_detection_tpu_torch.train.loggers import read_scalars
    from snn_for_object_detection_tpu_torch.utils import plotter as P
    from snn_for_object_detection_tpu_torch.utils.summary import summarize

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_extras")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = make_synthetic_dataset(
        os.path.join(root, "data"), records_per_split=CLI_RECORDINGS,
        duration_ms=CLI_DURATION_MS, seed=CLI_SEED)

    def config(name):
        return ["--config", os.path.join(repo, "config", name)]

    # (a) two plain fits (their distance is the gate), then the fit with
    # the extras
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        plain = []
        for i in range(2):
            run = extras_fit(cli, config, data_dir,
                             os.path.join(root, f"plain{i}"))
            plain.append([p.detach().clone()
                          for p in run.model.parameters()])
            del run
        noise = weights_distance(*plain)
        trace_dir = os.path.join(root, "trace")
        cuda_kernels.reset_launches()
        run = extras_fit(cli, config, data_dir, os.path.join(root, "extras"),
                         [*config("logger.yaml"),
                          "--trainer.debug_nans=true",
                          f"--trainer.profile_dir={trace_dir}"])
        torch.cuda.synchronize()
        n = dict(cuda_kernels.LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = False
    fit_s = time.perf_counter() - t0
    check(n["temporal_cell_seq"] > 0
          and n["temporal_cell_seq_bwd"]
          == CELLS_PER_STEP * EXTRAS_TRAIN_BATCHES,
          f"(a): launches {n}")
    dist_w = weights_distance(
        [p.detach() for p in run.model.parameters()], plain[0])
    check(dist_w <= noise, f"(a): the weights with logger, debug_nans and "
          f"the profiler are {dist_w:.3g} from the plain fit's (two plain "
          f"fits: {noise:.3g})")
    out = os.path.join(root, "extras")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    scalars = [(k, r["step"], v) for r in records for k, v in r.items()
               if k not in ("step", "time")]
    with open(os.path.join(out, "metrics.csv")) as f:
        header, *rows = [line.rstrip("\n").split(",") for line in f]
    check(len(rows) == len(records) and all(
        {k: float(v) for k, v in zip(header, row) if v}
        == {"step": r["step"], **{k: float(v) for k, v in r.items()
                                  if k not in ("step", "time")}}
        for row, r in zip(rows, records)), "(a): metrics.csv differs from "
          "metrics.jsonl")
    (events,) = glob.glob(os.path.join(out, "tb", "events.out.tfevents.*"))
    check(read_scalars(events) == [(k, s, float(np.float32(v)))
                                   for k, s, v in scalars],
          "(a): the event file differs from metrics.jsonl")
    (trace,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    kernels = trace_kernels(trace)
    fwd = sum(c for k, c in kernels.items() if "temporal_cell_kernel" in k)
    bwd = sum(c for k, c in kernels.items() if "temporal_cell_bwd" in k)
    check(fwd > 0 and bwd > 0, f"(a): the trace holds {fwd} cell forward "
          f"and {bwd} cell backward kernels")
    bwd_names = sorted({m for k in kernels
                        for m in re.findall(r"temporal_cell_bwd\w*", k)})
    print(f"  (a) fit with config.yaml + logger.yaml + synthetic.yaml, "
          f"debug_nans, profile_dir: {EXTRAS_TRAIN_BATCHES} steps and a "
          f"validation; three fits in {fit_s:.1f} s; {len(records)} "
          f"payloads, metrics.csv and {len(scalars)} event-file scalars "
          f"equal to metrics.jsonl's; weights {dist_w:.3g} from the plain "
          f"fit's (two plain fits {noise:.3g}); launches "
          f"{n['temporal_cell_seq']} cell, {n['temporal_cell_seq_bwd']} "
          f"backward; trace {os.path.getsize(trace) / 1e6:.1f} MB, "
          f"{sum(kernels.values())} kernel events, cell {fwd} forward and "
          f"{bwd} backward ({bwd_names})", flush=True)

    loader = run.data.train_loader()
    X, lab = (torch.as_tensor(a, device=run.model.device)
              for a in next(loader))
    loader.close()
    r = run.model.time_window // 2
    trainer = run.trainer
    ms = {True: [], False: []}
    for check_nans in (False, True, False, True):
        trainer._check_nans = check_nans
        ms[check_nans].append(cuda_time_ms(
            lambda: trainer.train_step(run.model, X, lab, r), reps=3,
            warmup=1))
    trainer._check_nans = False
    print(f"  (a) train step (time-batched, fp32, B={BATCH}, T=24, r={r}; "
          f"CUDA events, median of 3, two rounds each): debug_nans off "
          f"{ms[False]} ms, on {ms[True]} ms [{smi}]", flush=True)
    ckpt = os.path.join(out, "checkpoints", "last")
    del run, trainer, X, lab, plain
    torch.cuda.empty_cache()

    # (b) a NaN weight on the card
    model = build_model(TinyYolo, "float32", "float32", "cuda")
    with torch.no_grad():
        next(p for name, p in model.named_parameters()
             if name.endswith(".w")).view(-1)[0] = float("nan")
    trainer = Trainer(max_epochs=1, limit_train_batches=1,
                      check_val_every_n_epoch=10 ** 6, debug_nans=True,
                      time_batched=True, prefetch_batches=0,
                      out_dir=os.path.join(root, "nan"))
    try:
        trainer.fit(model, _Batches(batches))
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    check(raised is not None, "(b): a NaN weight did not raise")
    print(f"  (b) one step with a NaN weight: FloatingPointError: {raised}",
          flush=True)
    del model, trainer
    torch.cuda.empty_cache()

    # (c) predict on config.yaml
    video_dir = os.path.join(root, "video")
    t0 = time.perf_counter()
    run = cli.main(["predict", *config("config.yaml"),
                    f"--data.init_args.data_dir={data_dir}",
                    f"--trainer.out_dir={os.path.join(root, 'predict')}",
                    f"--ckpt_path={ckpt}",
                    f"--plotter.init_args.file_path={video_dir}"])
    predict_s = time.perf_counter() - t0
    videos = glob.glob(os.path.join(video_dir, "*.avi"))
    if P._HAS_CV2:
        check(len(videos) == 1 and os.path.getsize(videos[0]) > 0,
              f"(c): videos {videos}")
    else:
        check(not videos, f"(c): videos written without cv2: {videos}")
    loader = run.data.predict_loader()
    frame = np.asarray(next(loader)[0])[-1, 0]
    loader.close()
    drawn = plotter_check(P, frame)
    # information only, and not imported: the port writes its own events
    has_tbx = importlib.util.find_spec("tensorboardX") is not None
    print(f"  (c) predict --config config/config.yaml on (a)'s checkpoint "
          f"in {predict_s:.1f} s: cv2 imports: {P._HAS_CV2}; videos "
          f"{[(os.path.basename(v), os.path.getsize(v)) for v in videos]}; "
          f"Plotter.apply on a frame: {drawn}; "
          f"tensorboardX installed: {has_tbx} (not used)", flush=True)
    del run

    # (d) the summary
    s = summarize(build_model(TinyYolo, "float32", "float32", "cuda"))
    check(s["params"] == TRAINED_PARAMS, f"(d): {s['params']} params")
    print(f"  (d) summarize(TinyYolo GEN1): {s['params']:,} params, "
          f"{s['conv_flops_per_frame'] / 1e9:.4f} conv GFLOPs a frame "
          f"({len(s['rows'])} convs)", flush=True)
    torch.cuda.empty_cache()

# [18]: spatial sharding. Two gloo ranks on the one card as a (data 1 x
# space 2) grid, on the trained net (B=4, T=42, start 5): a time-batched
# fp32 train step and a hybrid step against one rank whose BatchNorm
# sums its moments in the space blocks' order; the fused test over
# SP_TEST_BATCHES batches; a train step of [14] (d)'s zoo net
SP_RANKS, SP_STEPS, SP_TIMED, SP_TEST_BATCHES = 2, 1, 2, 1
SP_RANK_TIMEOUT_S = 600
# the reference sums as the ranks do, so a sound grid reads about its
# bits (loss 0, gradients relative L2 7.9e-8 / 2.0e-7 on an H100): the
# gates sit just above that, where a halo row's gradient left off its
# owner shows (PERF.md, PR 17); the running stats keep [16] (b)'s rtol
SP_LOSS_RTOL, SP_GRAD_L2, SP_LEAF_L2 = 1e-6, 1e-5, 1e-4
# the zoo net's step against one rank whose LSTM conv and resize sum the
# whole map (the ranks: their blocks): ten times the distance of one rank
# summing every conv over the whole map in PR 17 ([18]'s yardstick, loss
# 8.3e-4, gradients 0.0147 on the trained TinyYolo)
SP_ZOO_LOSS_RTOL, SP_ZOO_GRAD_L2 = 1e-2, 0.1


def leaf_distance(a, b):
    """The largest relative L2 distance of one gradient leaf between two
    runs, and its name: a fault in a few rows of one layer shows here
    where the whole gradient's distance dilutes it."""
    worst = (0.0, "")
    for n, g in a.items():
        ref = b[n].norm()
        if ref > 0:
            worst = max(worst, (float((g - b[n]).norm() / ref), n))
    return worst


class blocks_order_convs:
    """Within: every Conv (but the s2d plan) computes its output map in
    the ``blocks`` row blocks of ``halo.row_blocks`` and concatenates
    them, each block from the rows of the zero-padded input it reads,
    as the ranks of [18] compute theirs: the same conv shapes, so the
    same sums (PyTorch's own conv picks its GEMM by shape: over the
    whole map its sums are another order, and the trained net turns
    that into flipped spikes as it does BatchNorm's)."""

    def __init__(self, torch, C, blocks):
        self.torch, self.C, self.blocks = torch, C, blocks

    def __enter__(self):
        from snn_for_object_detection_tpu_torch.parallel import row_blocks

        torch, C = self.torch, self.C
        self.saved = C.Conv._conv

        def conv(layer, x, w, space=None):
            if space is not None or layer.s2d:
                return self.saved(layer, x, w, space)
            s, p, k = layer.stride, layer.padding, layer.k
            rows = layer.out_hw[0]
            below = max((rows - 1) * s - p + k - x.shape[1], 0)
            padded = torch.nn.functional.pad(x, (0, 0, 0, 0, p, below))
            parts = [C._conv_nhwc(
                padded[:, o0 * s:(o1 - 1) * s + k].contiguous(), w, s,
                (0, p)) for o0, o1 in row_blocks(rows, self.blocks)]
            return torch.cat(parts, dim=1)

        C.Conv._conv = conv
        return self

    def __exit__(self, *exc):
        self.C.Conv._conv = self.saved


def sp_step_numbers(torch, mesh, trainer, model, X, lab):
    """A train step's ms (CUDA events, median of SP_TIMED after one),
    its peak memory, and the halo exchanges of one step: the space
    group's collectives (``halo.fetch_rows``' ``all_to_all_single``,
    ``gather_rows``' ``all_gather``), counted and each synchronised and
    timed by wrapping ``torch.distributed``'s functions for that step:
    their count by kind, their host ms and the step's (cuDNN on). A
    fetch made while autograd runs the backward pass is the recompute's
    or a fetch's backward."""
    dist = torch.distributed

    def step():
        trainer.train_step(model, X, lab, TRAIN_START)

    ms = cuda_time_ms(step, reps=SP_TIMED, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    step()
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts = {"fetch": 0, "fetch_in_backward": 0, "gather": 0}
    halo_ms = [0.0]
    saved = {k: getattr(dist, k) for k in ("all_to_all_single", "all_gather")}

    def timed(kind):
        def call(*args, **kwargs):
            if kind == "all_gather":
                if kwargs.get("group") is not mesh.space_group:
                    return saved[kind](*args, **kwargs)  # BatchNorm's sums
                counts["gather"] += 1
            elif torch._C._current_graph_task_id() == -1:
                counts["fetch"] += 1
            else:
                counts["fetch_in_backward"] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[kind](*args, **kwargs)
            torch.cuda.synchronize()
            halo_ms[0] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    for kind in saved:
        setattr(dist, kind, timed(kind))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for kind, fn in saved.items():
            setattr(dist, kind, fn)
    return {"ms": ms, "peak_gb": peak, "exchanges": counts,
            "halo_ms": halo_ms[0], "timed_wall_ms": wall}


def sp_fused_test(torch, TinyYolo, Trainer, batches, mesh=None):
    """[18]: ``Trainer.test`` of the trained net with ``fuse_seq=True`` at
    time window 0 over SP_TEST_BATCHES batches, on the grid ``mesh`` (each
    rank on its rows) or on one rank: the detections of each eval step,
    the predictions of ``forward_seq`` on the first batch, the metrics
    and the kernel launches of the test."""
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels
    from snn_for_object_detection_tpu_torch.parallel import shard_batch

    model = build_model(TinyYolo, "float32", "float32", "cuda",
                        time_window=0, fuse_seq=True,
                        weights=trained_weights())
    trainer = Trainer(seed=0, time_batched=True,
                      limit_test_batches=SP_TEST_BATCHES,
                      **({} if mesh is None else {"mesh": mesh}))
    dets = []
    step = trainer.eval_step

    def record(*args):
        loss, d = step(*args)
        dets.append(d.cpu())
        return loss, d

    trainer.eval_step = record
    cuda_kernels.reset_launches()
    metrics = trainer.test(model, iter(batches[:SP_TEST_BATCHES]))
    torch.cuda.synchronize()
    launches = dict(cuda_kernels.LAUNCHES)
    X, lab = batches[0]
    X = on_card(torch, X, lab)[0] if mesh is None \
        else shard_batch(mesh, X, lab)[0]
    with torch.inference_mode():
        (cls, box), _ = model.forward_seq(
            X, space=None if mesh is None else mesh.space_ctx)
    return {"dets": dets, "preds": (cls.cpu(), box.cpu()),
            "metrics": metrics, "launches": launches}


def sp_zoo_net(torch, C):
    """[14] (d)'s zoo net (``zoo_net``: a strided max Pool, a k=3
    ConvLSTM, a bilinear Up) at GEN1 with its BatchNorm gains at
    BN_GAIN, on the card."""
    from snn_for_object_detection_tpu_torch.models import spec as S
    from snn_for_object_detection_tpu_torch.models.detector import SODa

    model = zoo_net(C, SODa, S)(num_classes=NUM_CLASSES, in_hw=IN_HW,
                                device="cuda", seed=0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.fill_(BN_GAIN)
    return model


def sp_rank(rank, world, store, out):
    """One rank of the (data 1 x space 2) grid on the one card, gloo on
    CUDA tensors."""
    import torch

    from snn_for_object_detection_tpu_torch.models import compile as C
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo
    from snn_for_object_detection_tpu_torch.parallel import (
        distributed,
        make_mesh,
        shard_batch,
    )
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    distributed.initialize(f"file://{store}", num_processes=world,
                           process_id=rank, backend="gloo", device="cuda:0",
                           timeout_s=SP_RANK_TIMEOUT_S)
    mesh = make_mesh(spatial=world)
    batches = make_batches(SP_STEPS, seed=0)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.enabled = False
    runs = {"shape": mesh.shape}
    for schedule, steps in ((True, SP_STEPS), ("hybrid", 1)):
        run, trainer, model, (X, lab) = dp_train(
            torch, TinyYolo, Trainer, batches, {"mesh": mesh},
            lambda X, lab: shard_batch(mesh, X, lab), schedule, steps)
        run["sha"] = [dp_sha(w) for w in run["weights"]]
        run["weights"] = None  # the shas compare them
        if rank:
            run["grads"] = None
        runs[schedule] = run
        if schedule is True:
            keep = trainer, model, X, lab
            runs["rows"] = int(X.shape[2])
        del trainer, model
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.deterministic = False
    runs["numbers"] = sp_step_numbers(torch, mesh, *keep)
    del keep
    torch.backends.cudnn.enabled = False
    torch.backends.cudnn.deterministic = True
    runs["fused"] = sp_fused_test(torch, TinyYolo, Trainer, batches, mesh)
    zoo, _, _, _ = dp_train(
        torch, TinyYolo, Trainer, batches, {"mesh": mesh},
        lambda X, lab: shard_batch(mesh, X, lab), True, 1,
        model=sp_zoo_net(torch, C))
    zoo["sha"] = [dp_sha(w) for w in zoo["weights"]]
    zoo["weights"] = None
    if rank:
        zoo["grads"] = None
    runs["zoo"] = zoo
    torch.save(runs, os.path.join(out, f"rank{rank}.pt"))
    distributed.barrier("sp_done")
    torch.distributed.destroy_process_group()


def phase_spatial(torch, C, TinyYolo, Trainer, smi):
    """[18]: ``Trainer(mesh=make_mesh(spatial=2))`` on two gloo ranks on
    the one card (``torch.multiprocessing.spawn``, a FileStore), each on
    its rows of H of the same batches (120/120 rows of the input, 8/7 of
    the 15-row map), cuDNN off and deterministic: SP_STEPS time-batched
    fp32 train steps and one hybrid step of the trained net; the ranks'
    weights bit-equal after every step; each rank's cell backward kernel
    CELLS_PER_STEP times a time-batched step and its forward twice that
    (the step's and the recompute's); the first
    step's loss, gradients (whole and each leaf) and running statistics
    within SP_LOSS_RTOL, SP_GRAD_L2, SP_LEAF_L2 and [16] (b)'s
    DP_STATS_RTOL of one rank whose BatchNorm sums its moments and whose convs
    sum their outputs in the space blocks' order
    (``ranks_order_moments(along=1)``, ``blocks_order_convs``); printed
    beside it, the distance from one rank as it is. Then, cuDNN on, a
    rank's step ms and peak memory beside the one rank's, and the halo
    exchanges of a step: their count and their share of it. Then, cuDNN
    off: the fused ``Trainer.test`` on the ranks (``sp_fused_test``), its
    detections and first predictions bit-equal to one rank's (whose
    unfused tail convs sum in the blocks' order), 22 ``spiking_conv_seq``
    launches a rank and eval step and no cell kernel; and a time-batched
    train step of the zoo net (``sp_zoo_net``): the ranks' weights
    bit-equal after it, the cell kernels launched, its loss and gradients
    within SP_ZOO_LOSS_RTOL and SP_ZOO_GRAD_L2 of one rank's (BatchNorm
    and the convs in the blocks' order; the LSTM conv and the resize over
    the whole map). Returns the ranks' forward and backward cell launches
    in their train steps and their fused kernel launches."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    batches = make_batches(SP_STEPS, seed=0)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.enabled = False
    one, plain = {}, {}
    with ranks_order_moments(torch, C, SP_RANKS, along=1), \
            blocks_order_convs(torch, C, SP_RANKS):
        for schedule, steps in ((True, SP_STEPS), ("hybrid", 1)):
            one[schedule], _, _, _ = dp_train(torch, TinyYolo, Trainer,
                                              batches, {}, None, schedule,
                                              steps)
        zoo_one, _, _, _ = dp_train(torch, TinyYolo, Trainer, batches, {},
                                    None, True, 1, model=sp_zoo_net(torch, C))
        fused_one = sp_fused_test(torch, TinyYolo, Trainer, batches)
    plain[True], _, _, _ = dp_train(torch, TinyYolo, Trainer, batches, {},
                                    steps=1)
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.deterministic = False
    _, trainer, model, (X, lab) = dp_train(torch, TinyYolo, Trainer,
                                           batches, {}, steps=1)
    one_ms = cuda_time_ms(
        lambda: trainer.train_step(model, X, lab, TRAIN_START),
        reps=SP_TIMED, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(model, X, lab, TRAIN_START)
    one_gb = torch.cuda.max_memory_allocated() / 1e9
    del trainer, model, X, lab
    torch.cuda.empty_cache()
    print(f"  [18] one rank (references and timing) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_sp")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.perf_counter()
    mp.spawn(sp_rank, args=(SP_RANKS, os.path.join(out, "store"), out),
             nprocs=SP_RANKS, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(SP_RANKS)]
    check(ranks[0]["shape"] == {"data": 1, "space": SP_RANKS},
          f"[18]: grid {ranks[0]['shape']}")
    fwd = bwd = 0
    gates = []
    for schedule, steps in ((True, SP_STEPS), ("hybrid", 1)):
        name = SCHEDULE_NAMES[schedule]
        for s in range(steps):
            gates.append((len({r[schedule]["sha"][s] for r in ranks}) == 1,
                          f"[18] {name}: the ranks' weights differ after "
                          f"step {s + 1}"))
        for r, got in enumerate(ranks):
            for s, n in enumerate(got[schedule]["launches"]):
                f, b = n["temporal_cell_seq"], n["temporal_cell_seq_bwd"]
                fwd, bwd = fwd + f, bwd + b
                if schedule is True:
                    # the forward runs again in the backward (remat)
                    gates.append((
                        f == 2 * CELLS_PER_STEP and b == CELLS_PER_STEP,
                        f"[18] rank {r} step {s + 1}: {f} forward and {b} "
                        f"backward cell launches, want 2 x {CELLS_PER_STEP} "
                        f"and {CELLS_PER_STEP}"))
                else:
                    gates.append((f > 0 and b > 0
                                  and not n["spiking_conv_seq"],
                                  f"[18] rank {r} hybrid: launches {n}"))
        if schedule is True:
            yard = dp_distances(torch, ranks[0][True], plain[True])
            print(f"  [18] time-batched, yardstick: {SP_RANKS} ranks vs one "
                  f"rank as it is (var_mean, convs over the whole map), "
                  f"cuDNN off: first-step loss rel {yard[0]:.3g}, gradients "
                  f"relative L2 {yard[1]:.3g}, BN running stats beyond rtol "
                  f"{max(yard[2], 0.0):.3g}", flush=True)
        loss_err, grad_l2, stats_over = dp_distances(
            torch, ranks[0][schedule], one[schedule])
        leaf_l2, leaf = leaf_distance(ranks[0][schedule]["grads"],
                                      one[schedule]["grads"])
        launches = [(n["temporal_cell_seq"], n["temporal_cell_seq_bwd"])
                    for n in ranks[0][schedule]["launches"]]
        print(f"  [18] {name}: {SP_RANKS} ranks ({ranks[0]['rows']} and "
              f"{ranks[1]['rows']} input rows) vs one rank summing BN and "
              f"the convs in the space blocks' order, cuDNN off: first-step "
              f"loss rel "
              f"{loss_err:.3g} (gate {SP_LOSS_RTOL}), gradients relative L2 "
              f"{grad_l2:.3g} (gate {SP_GRAD_L2}), worst leaf {leaf_l2:.3g} "
              f"({leaf}; gate {SP_LEAF_L2}), BN running stats beyond "
              f"rtol {DP_STATS_RTOL}: {max(stats_over, 0.0):.3g} (gate "
              f"1e-6); losses "
              f"{[float(v) for v in ranks[0][schedule]['losses']]} vs "
              f"{[float(v) for v in one[schedule]['losses']]}; weights "
              f"bit-equal across the ranks after each of {steps} steps; "
              f"(forward, backward) cell launches a step of rank 0 "
              f"{launches}", flush=True)
        gates += [(loss_err <= SP_LOSS_RTOL,
                   f"[18] {name}: loss {loss_err:.3g} from one rank"),
                  (grad_l2 <= SP_GRAD_L2,
                   f"[18] {name}: gradients {grad_l2:.3g} from one rank"),
                  (leaf_l2 <= SP_LEAF_L2,
                   f"[18] {name}: gradient of {leaf} {leaf_l2:.3g} from "
                   "one rank"),
                  (stats_over <= 1e-6,
                   f"[18] {name}: running stats {stats_over:.3g} beyond "
                   "rtol")]
    # the fused test on the grid against one rank's
    fwd_conv = 0
    for r, got in enumerate(ranks):
        f = got["fused"]
        n = f["launches"]
        fwd_conv += n["spiking_conv_seq"]
        pred_err = max(float((a - b).abs().max())
                       for a, b in zip(f["preds"], fused_one["preds"]))
        gates += [
            (n["spiking_conv_seq"] == CELLS_PER_STEP * SP_TEST_BATCHES
             and not n["temporal_cell_seq"],
             f"[18] rank {r} fused test: launches {n}"),
            (len(f["dets"]) == len(fused_one["dets"]) == SP_TEST_BATCHES
             and all(torch.equal(a, b) for a, b in
                     zip(f["dets"], fused_one["dets"])),
             f"[18] rank {r} fused test: detections differ from one "
             f"rank's"),
            (all(torch.equal(a, b) for a, b in
                 zip(f["preds"], fused_one["preds"])),
             f"[18] rank {r} fused forward_seq: predictions differ from "
             f"one rank's (max abs {pred_err:.3g})"),
            (all(np.isfinite(v) for v in f["metrics"].values()),
             f"[18] rank {r} fused test: metrics {f['metrics']}")]
    n_spikes = int((fused_one["preds"][0].abs() > 0).sum())
    print(f"  [18] fused Trainer.test at window 0, {SP_TEST_BATCHES} "
          f"batch(es), cuDNN off: {SP_RANKS} ranks on their rows "
          f"(spiking_conv_seq pad_h=0) vs one rank (the whole map's "
          f"launches, its tail convs in the blocks' order): detections "
          f"and first predictions bit-equal on every rank "
          f"({n_spikes} nonzero class scores); spiking_conv_seq launches "
          f"a rank "
          f"{[got['fused']['launches']['spiking_conv_seq'] for got in ranks]}"
          f"; metrics {ranks[0]['fused']['metrics']} vs "
          f"{fused_one['metrics']}", flush=True)
    # the zoo net's train step on the grid against one rank's
    zoo = [r["zoo"] for r in ranks]
    z_loss, z_grad, _ = dp_distances(torch, zoo[0], zoo_one)
    z_launch = zoo[0]["launches"][0]
    fwd += sum(z["launches"][0]["temporal_cell_seq"] for z in zoo)
    bwd += sum(z["launches"][0]["temporal_cell_seq_bwd"] for z in zoo)
    gates += [
        (len({z["sha"][0] for z in zoo}) == 1,
         "[18] zoo net: the ranks' weights differ after the step"),
        (all(np.isfinite(float(z["losses"][0])) for z in zoo),
         f"[18] zoo net: losses {[float(z['losses'][0]) for z in zoo]}"),
        (all(z["launches"][0]["temporal_cell_seq"] > 0
             and z["launches"][0]["temporal_cell_seq_bwd"] > 0 for z in zoo),
         f"[18] zoo net: launches {z_launch}"),
        (z_loss <= SP_ZOO_LOSS_RTOL,
         f"[18] zoo net: loss {z_loss:.3g} from one rank"),
        (z_grad <= SP_ZOO_GRAD_L2,
         f"[18] zoo net: gradients {z_grad:.3g} from one rank")]
    print(f"  [18] zoo net (Synapse, Pool(M, 3, 2), ConvLSTM k=3, bilinear "
          f"Up) time-batched train step, {SP_RANKS} ranks vs one rank "
          f"(BN and the convs in the blocks' order, the LSTM conv and the "
          f"resize over the whole map), cuDNN off: loss "
          f"{float(zoo[0]['losses'][0]):.6f} vs "
          f"{float(zoo_one['losses'][0]):.6f}, rel {z_loss:.3g} (gate "
          f"{SP_ZOO_LOSS_RTOL}), gradients relative L2 {z_grad:.3g} (gate "
          f"{SP_ZOO_GRAD_L2}); weights bit-equal across the ranks; rank 0 "
          f"launches {z_launch}", flush=True)
    print(f"  [18] ranks spawned and done in {spawn_s:.1f} s", flush=True)
    for r, got in enumerate(ranks):
        nb = got["numbers"]
        ex = nb["exchanges"]
        print(f"  [18] rank {r}: time-batched fp32 train step {nb['ms']:.1f} "
              f"ms (CUDA events, median of {SP_TIMED}, two ranks sharing the "
              f"card, cuDNN on) vs one rank {one_ms:.1f} ms; peak "
              f"{nb['peak_gb']:.2f} GB vs one rank {one_gb:.2f} GB; halo "
              f"exchanges a step: {ex['fetch']} fetches in the forward "
              f"pass, {ex['fetch_in_backward']} in the backward pass (the "
              f"recompute's and the fetches' backward), {ex['gather']} "
              f"gathers, "
              f"{nb['halo_ms']:.1f} ms of a {nb['timed_wall_ms']:.1f} ms "
              f"step (each exchange synchronised, host clock), share "
              f"{nb['halo_ms'] / nb['timed_wall_ms']:.3f} [{smi}]",
              flush=True)
    for ok, msg in gates:
        check(ok, msg)
    return fwd, bwd, fwd_conv


# [19]: export. The trained net at fp32 (EXPORT_FRAMES[0] frames) and with
# config/infer_fp8.yaml's bf16 activations and e5m2 states, and
# config/vgg.yaml's VggSNN (PLIF, [14]'s random weights), the last two
# over EXPORT_FRAMES[1] frames; [4]'s event frames at B=2, then B=3 from
# the same file after reset(); each runner and predict timed over
# EXPORT_TIMED frames
EXPORT_FRAMES = (16, 4)
EXPORT_B, EXPORT_B3 = 2, 3
EXPORT_TIMED = 5
EXPORT_CASES = ("trained fp32", "trained bf16/e5m2", "vgg plif")

# what each export process runs: one case's model built as the parent
# builds it, exported for the card with a symbolic batch
EXPORT_ONE = r"""
import json, sys, time
import torch
import chip_smoke
from snn_for_object_detection_tpu_torch import export

model = chip_smoke.export_case_model(torch, int(sys.argv[1]))
t0 = time.perf_counter()
export.export_predict(model, sys.argv[2], platforms=("cuda",))
print(json.dumps({"export_s": time.perf_counter() - t0}))
"""

# what each fresh serving process runs: load one file with no model code,
# serve its frames at B=2 (the cell launches counted), reset and serve
# B=3, check that a batch change is refused, save the detections and the
# carried state's leaves after each run; then,
# when the parent says so (the other processes are done), time
# EXPORT_TIMED more frames alone on the card
EXPORT_SERVE = r"""
import json, os, statistics, sys, time
import numpy as np
import torch
from snn_for_object_detection_tpu_torch.export import load_predict
from snn_for_object_detection_tpu_torch.ops import cuda_kernels

job = json.loads(sys.argv[1])
t0 = time.perf_counter()
runner = load_predict(job["path"])
load_s = time.perf_counter() - t0
frames, frames3 = np.load(job["frames"]), np.load(job["frames3"])
cuda_kernels.reset_launches()
dets = [runner(x) for x in frames]
torch.cuda.synchronize()
launches = dict(cuda_kernels.LAUNCHES)
state = [t.cpu() for t in runner.state]
runner.reset()
dets3 = [runner(x) for x in frames3]
state3 = [t.cpu() for t in runner.state]
try:
    runner(frames[0])
    refused = ""
except ValueError as e:
    refused = str(e)
torch.save({"dets": torch.stack(dets).cpu(), "state": state,
            "dets3": torch.stack(dets3).cpu(), "state3": state3},
           job["out"])
open(job["out"] + ".ready", "w").close()
while not os.path.exists(job["out"] + ".go"):
    time.sleep(0.05)
runner.reset()
ms = []
for x in frames[:job["timed"]]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner(x)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"load_s": load_s, "launches": launches,
                  "ms": statistics.median(ms), "refused": refused,
                  "modules": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "yaml")
    or m.startswith(tuple("snn_for_object_detection_tpu_torch." + p for p in
                          ("models", "train", "serve", "data", "cli"))))}))
"""


def export_case_model(torch, case: int):
    """[19]'s models, built alike in the parent and in each export
    process: the trained net at fp32, the trained net with bf16
    activations and e5m2 states, [14]'s VggSNN PLIF."""
    if case == 2:
        from snn_for_object_detection_tpu_torch.models import VggSNN

        return build_vgg(torch, VggSNN, "plif", "cuda")
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo

    xd, sd = ((torch.float32, torch.float32),
              (torch.bfloat16, torch.float8_e5m2))[case]
    return build_model(TinyYolo, xd, sd, "cuda", weights=trained_weights())


def _start(script, args, log, repo):
    """A ``python -c script args`` process from the repo's root, its
    output to ``log`` + ".out" / ".err"."""
    return subprocess.Popen(
        [sys.executable, "-c", script, *args], cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo),
        stdout=open(log + ".out", "w"), stderr=open(log + ".err", "w"))


def _wait_all(procs, logs, what, timeout=900):
    """The last stdout line of each process as JSON, or a failed check
    naming ``what``; a process past ``timeout`` is killed, all of them
    then."""
    outs = []
    for k, (proc, log) in enumerate(zip(procs, logs)):
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        with open(log + ".err") as f:
            err = f.read()
        check(proc.returncode == 0, f"[19] {what} {k} failed: "
              f"{err[-3000:]}")
        with open(log + ".out") as f:
            outs.append(json.loads(f.read().strip().splitlines()[-1]))
    return outs


DISPATCH_SHAPE = (1, 1, 15, 19, 256)  # [19]: a T = 1 cell, GEN1's deepest
DISPATCH_CALLS, DISPATCH_REPS = 200, 5


def cell_call_host_us(torch, cuda_kernels, smi):
    """[19]'s host cost of one cell kernel call at T = 1 on a map so small
    that the host's work bounds the calls (DISPATCH_SHAPE), in four
    forms: the raw ctypes launch (``_launch_forward``); the wrapper
    ``temporal_cell_seq`` under ``no_grad`` (predict, the engine, eval:
    its checks and the launch); the registered operator
    ``soda_torch::temporal_cell_seq`` under ``no_grad`` (a loaded
    program's node); the wrapper with an input that needs a gradient
    (the per-step and hybrid train steps' forward: the operator and an
    autograd node). Each the median over DISPATCH_REPS of DISPATCH_CALLS
    calls back to back between two synchronisations (host clock). Not
    launches of the main path; no gate."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(DISPATCH_SHAPE, generator=gen, device="cuda")
    v0 = torch.zeros(DISPATCH_SHAPE[1:], device="cuda")
    i0 = torch.zeros_like(v0)
    xg = x.clone().requires_grad_()

    def raw():
        cuda_kernels._launch_forward(x, v0, i0, "lif", 0)

    def wrapper():
        with torch.no_grad():
            cuda_kernels.temporal_cell_seq(x, v0, i0, "lif", 0)

    def operator():
        with torch.no_grad():
            torch.ops.soda_torch.temporal_cell_seq(x, v0, i0, "lif", 0)

    def wrapper_grad():
        cuda_kernels.temporal_cell_seq(xg, v0, i0, "lif", 0)

    out = {}
    for name, fn in (("raw launch", raw), ("wrapper, no grad", wrapper),
                     ("operator, no grad", operator),
                     ("wrapper, input needs grad", wrapper_grad)):
        for _ in range(20):
            fn()
        reps = []
        for _ in range(DISPATCH_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) / DISPATCH_CALLS * 1e6)
        out[name] = statistics.median(reps)
    print(f"  host us a cell call at T=1 {list(DISPATCH_SHAPE)} (median of "
          f"{DISPATCH_REPS} x {DISPATCH_CALLS} calls, host clock): " +
          ", ".join(f"{k} {v:.1f}" for k, v in out.items()) + f" [{smi}]",
          flush=True)
    return out


def phase_export(torch, cuda_kernels, C, batches, smi):
    """[19] export on the card: ``export.export_predict(...,
    platforms=("cuda",))`` with a symbolic batch of EXPORT_CASES: (a) the
    trained net at fp32, (b) the trained net with bf16 activations and
    e5m2 states (``config/infer_fp8.yaml``: fp8 state leaves in the
    file), (c) ``config/vgg.yaml``'s VggSNN (PLIF), each traced in a
    process of its own, the three at once (a trace is host-bound Python).
    Each file is then loaded by ``load_predict`` in a fresh process
    (``EXPORT_SERVE``, the three at once), where no module of
    ``models/``, ``train/``, ``serve``, ``data/`` or the CLI may be
    imported, and serves [4]'s frames at B=2: its detections bit-equal
    to ``SODa.predict`` on the same card, frame by frame (the same
    kernels, and the same cuDNN convs under the same settings), and its
    carried state after the last frame bit-equal to predict's, leaf by
    leaf; a launch of the cell kernel a cell and frame (TinyYolo: 22
    ``temporal_cell_seq``; VggSNN: PLIF_LAYERS ``plif_cell_seq`` and
    LI_HEADS ``temporal_cell_seq``), counted in that process; then,
    after ``reset()``, B=3 from the same file, detections and state
    bit-equal to ``predict`` at B=3, and a batch change refused with
    ``ValueError``. Prints each file's export and load seconds, its MB,
    and the loaded runner's ms a frame (timed one process at a time)
    beside ``predict``'s (CUDA-synchronised, median of EXPORT_TIMED).
    First, while the host is quiet, ``cell_call_host_us``. Returns the
    cell launches the loaded programs made (by kernel)."""
    from torch.utils import _pytree

    cell_call_host_us(torch, cuda_kernels, smi)
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    X = batches[0][0]
    jobs = []
    for k, tag in enumerate(EXPORT_CASES):
        n = EXPORT_FRAMES[0] if k == 0 else EXPORT_FRAMES[1]
        job = {"path": os.path.join(root, f"predict{k}.pt2"),
               "frames": os.path.join(root, f"frames{k}.npy"),
               "frames3": os.path.join(root, f"frames3_{k}.npy"),
               "out": os.path.join(root, f"dets{k}.pt"),
               "timed": EXPORT_TIMED}
        np.save(job["frames"], np.ascontiguousarray(X[:n, :EXPORT_B]))
        np.save(job["frames3"], np.ascontiguousarray(
            X[:EXPORT_FRAMES[1], :EXPORT_B3]))
        jobs.append(job)
    t0 = time.perf_counter()
    export_logs = [os.path.join(root, f"export{k}") for k in range(len(jobs))]
    exporters = [_start(EXPORT_ONE, [str(k), job["path"]], log, repo)
                 for k, (job, log) in enumerate(zip(jobs, export_logs))]
    # meanwhile: predict's detections and state leaves, the parent's
    # yardstick
    wants = []
    for k in range(len(EXPORT_CASES)):
        model = export_case_model(torch, k)
        dets, leaves = {}, {}
        for b, name in ((EXPORT_B, "frames"), (EXPORT_B3, "frames3")):
            state, out = None, []
            for x in np.load(jobs[k][name]):
                d, state = model.predict(torch.from_numpy(x).to("cuda"),
                                         state)
                out.append(d.cpu())
            dets[b] = torch.stack(out)
            leaves[b] = [t.cpu() for t in _pytree.tree_leaves(state)]
        cells = sum(isinstance(m, C.Cell) for m in model.modules())
        plifs = sum(isinstance(m, C.PLIF) for m in model.modules())
        wants.append((dets, leaves, cells, plifs))
        del model
    exported = _wait_all(exporters, export_logs, "export process")
    export_wall = time.perf_counter() - t0
    for k, (tag, res) in enumerate(zip(EXPORT_CASES, exported)):
        print(f"  ({'abc'[k]}) {tag}: export_predict(platforms=('cuda',), "
              f"batch 'b') {res['export_s']:.1f} s, "
              f"{os.path.getsize(jobs[k]['path']) / 1e6:.1f} MB", flush=True)
    print(f"  the three exports at once in {export_wall:.1f} s", flush=True)
    t0 = time.perf_counter()
    serve_logs = [os.path.join(root, f"serve{k}") for k in range(len(jobs))]
    servers = [_start(EXPORT_SERVE, [json.dumps(job)], log, repo)
               for job, log in zip(jobs, serve_logs)]
    deadline = time.perf_counter() + 600
    while not all(os.path.exists(j["out"] + ".ready") for j in jobs):
        failed = [k for k, p in enumerate(servers) if p.poll() is not None]
        if failed or time.perf_counter() > deadline:
            for p in servers:
                p.kill()
            _wait_all([servers[k] for k in failed],
                      [serve_logs[k] for k in failed], "serving process")
            check(False, f"[19] the serving processes are not ready after "
                  f"{time.perf_counter() - t0:.0f} s")
        time.sleep(0.1)
    ready_s = time.perf_counter() - t0
    served = []
    for job, proc, log in zip(jobs, servers, serve_logs):
        open(job["out"] + ".go", "w").close()
        served += _wait_all([proc], [log], "serving process")
    print(f"  three fresh processes loaded and served the files in "
          f"{ready_s:.1f} s (at once), then timed them one at a time; "
          f"their model-code and JAX modules: "
          f"{[r['modules'] for r in served]}", flush=True)
    launched = {"temporal_cell_seq": 0, "plif_cell_seq": 0}
    for k, (tag, job, res, (want, want_leaves, cells, plifs)) in enumerate(
            zip(EXPORT_CASES, jobs, served, wants)):
        check(res["modules"] == [], f"[19] {tag}: the serving process "
              f"imported {res['modules']}")
        n = len(want[EXPORT_B])
        n_fwd = res["launches"]
        check(n_fwd["temporal_cell_seq"] == cells * n
              and n_fwd["plif_cell_seq"] == plifs * n
              and all(v == 0 for name, v in n_fwd.items()
                      if name not in ("temporal_cell_seq", "plif_cell_seq")),
              f"[19] {tag}: launches {n_fwd}, want {cells} cell and "
              f"{plifs} PLIF launches a frame over {n} frames")
        for name in launched:
            launched[name] += n_fwd[name]
        check("batch changed" in res["refused"],
              f"[19] {tag}: a batch change was not refused")
        got = torch.load(job["out"])
        for b, key in ((EXPORT_B, "dets"), (EXPORT_B3, "dets3")):
            differ = [t for t in range(len(want[b]))
                      if not torch.equal(got[key][t], want[b][t])]
            check(not differ, f"[19] {tag}: the loaded program's detections "
                  f"at B={b} differ from predict's at frames {differ}")
        # the carried state, leaf by leaf and bit for bit (fp8 leaves
        # included): with no detection above the threshold, the
        # detections alone would compare padding
        for b, key in ((EXPORT_B, "state"), (EXPORT_B3, "state3")):
            mine, theirs = got[key], want_leaves[b]
            check(len(mine) == len(theirs), f"[19] {tag}: {len(mine)} state "
                  f"leaves at B={b}, predict carries {len(theirs)}")
            differ = [j for j, (g, w) in enumerate(zip(mine, theirs))
                      if (g.dtype, g.shape) != (w.dtype, w.shape)
                      or not torch.equal(g.contiguous().view(torch.uint8),
                                         w.contiguous().view(torch.uint8))]
            check(not differ, f"[19] {tag}: state leaves {differ} at B={b} "
                  f"differ from predict's after {len(want[b])} frames")
        model = export_case_model(torch, k)
        state, ms = None, []
        for x in np.load(job["frames"])[:EXPORT_TIMED]:
            xt = torch.from_numpy(x).to("cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state = model.predict(xt, state)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        del model
        found = int((got["dets"][..., 0] >= 0).sum())
        print(f"  ({'abc'[k]}) {tag}: {n} frames at B={EXPORT_B} bit-equal "
              f"to predict ({found} detections; the "
              f"{len(want_leaves[EXPORT_B])} state leaves bit-equal after "
              f"the last), then {len(want[EXPORT_B3])} at B={EXPORT_B3} "
              f"bit-equal, state included, after reset(), a batch change "
              f"refused; launches in the fresh "
              f"process {cells} cell + {plifs} PLIF a frame "
              f"({n_fwd['temporal_cell_seq']} temporal_cell_seq, "
              f"{n_fwd['plif_cell_seq']} plif_cell_seq); export "
              f"{exported[k]['export_s']:.1f} s, load {res['load_s']:.1f} s, "
              f"{os.path.getsize(job['path']) / 1e6:.1f} MB; a frame: "
              f"loaded runner {res['ms']:.2f} ms, predict "
              f"{statistics.median(ms):.2f} ms (host clock, "
              f"CUDA-synchronised, median of {EXPORT_TIMED}) [{smi}]",
              flush=True)
    torch.cuda.empty_cache()
    return launched


def phase_seconds(k: int, t0: float) -> float:
    """Prints phase [k]'s seconds since ``t0``; returns the time now."""
    now = time.perf_counter()
    print(f"  [{k}] in {now - t0:.1f} s", flush=True)
    return now


def main(argv) -> int:
    import torch

    # --only 3,7,8: the device line and those phases (of [3] its
    # spiking_conv_seq and pointwise parts), for quick runs; no kernels
    # line and no result line
    only = ({int(p) for p in argv[argv.index("--only") + 1].split(",")}
            if "--only" in argv else None)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from snn_for_object_detection_tpu_torch.models import compile as C
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo
    from snn_for_object_detection_tpu_torch.ops import cuda_build
    from snn_for_object_detection_tpu_torch.ops import cuda_kernels, neurons
    from snn_for_object_detection_tpu_torch.train.loop import Trainer

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(f"[1] device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    # for the library calls timed beside the kernels; the model's own
    # convs run full fp32 whatever these say (models/compile.py _Conv2d)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"    cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    if only is not None:
        sources = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(cuda_build.CSRC, "*.cu")))
        t0 = time.perf_counter()
        per_source = cuda_build.build(sources)
        print(f"[2] build: {sources} in {time.perf_counter() - t0:.1f} s "
              f"(nvcc per source: "
              f"{ {k: round(v, 1) for k, v in per_source.items()} })",
              flush=True)
        batches = make_batches(EVAL_BATCHES, seed=0)
        if 3 in only:
            print("[3] spiking_conv_seq and fused_pointwise_conv_bn_lif",
                  flush=True)
            phase_spiking_conv(torch, cuda_kernels, C, neurons, "cuda")
            phase_spiking_conv_rows(torch, cuda_kernels, C, TinyYolo,
                                    "cuda")
            phase_pointwise(torch, cuda_kernels, "cuda")
        if 7 in only:
            print("[7] fused path", flush=True)
            phase_fused_path(torch, cuda_kernels, C, TinyYolo, Trainer,
                             batches, "cuda")
        if 8 in only:
            print("[8] megakernel", flush=True)
            phase_megakernel(torch, cuda_kernels, TinyYolo, batches[0],
                             "cuda")
        if 10 in only:
            print("[10] train", flush=True)
            phase_cell_backward(torch, cuda_kernels, "cuda")
            phase_train(torch, cuda_kernels, TinyYolo, Trainer, batches,
                        "cuda")
        if 11 in only:
            print("[11] the CLI on recordings", flush=True)
            phase_cli(torch, cuda_kernels, smi)
        if 12 in only:
            t0 = time.perf_counter()
            print("[12] the trained net", flush=True)
            phase_trained_net(torch, cuda_kernels, C, TinyYolo, Trainer,
                              batches, smi, "cuda")
            print(f"  [12] in {time.perf_counter() - t0:.1f} s", flush=True)
        if 13 in only:
            t0 = time.perf_counter()
            print("[13] hybrid, auto and 1Mpx", flush=True)
            phase_hybrid_auto_1mpx(torch, cuda_kernels, TinyYolo, Trainer,
                                   batches, smi, "cuda")
            print(f"  [13] in {time.perf_counter() - t0:.1f} s", flush=True)
        if 14 in only:
            t0 = time.perf_counter()
            print("[14] the model zoo", flush=True)
            phase_zoo(torch, cuda_kernels, C, neurons, smi, batches,
                      "cuda")
            print(f"  [14] in {time.perf_counter() - t0:.1f} s", flush=True)
        if 15 in only:
            t0 = time.perf_counter()
            print("[15] the last inference options", flush=True)
            phase_options(torch, cuda_kernels, C, neurons, TinyYolo, Trainer,
                          batches, smi, "cuda")
            print(f"  [15] in {time.perf_counter() - t0:.1f} s", flush=True)
        if 16 in only:
            t0 = time.perf_counter()
            print("[16] data parallel and mesh serving", flush=True)
            phase_data_parallel(torch, cuda_kernels, TinyYolo, Trainer,
                                batches, smi)
            print(f"  [16] in {time.perf_counter() - t0:.1f} s", flush=True)
        if 17 in only:
            t0 = time.perf_counter()
            print("[17] training extras, plotter and summary", flush=True)
            phase_extras(torch, cuda_kernels, TinyYolo, Trainer, batches,
                         smi)
            print(f"  [17] in {time.perf_counter() - t0:.1f} s", flush=True)
        if 18 in only:
            t0 = time.perf_counter()
            print("[18] spatial sharding", flush=True)
            phase_spatial(torch, C, TinyYolo, Trainer, smi)
            print(f"  [18] in {time.perf_counter() - t0:.1f} s", flush=True)
        if 19 in only:
            t0 = time.perf_counter()
            print("[19] export", flush=True)
            phase_export(torch, cuda_kernels, C, batches, smi)
            print(f"  [19] in {time.perf_counter() - t0:.1f} s", flush=True)
        print(f"partial run of phases {sorted(only)} done in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0

    sources = sorted(os.path.basename(p)
                     for p in glob.glob(os.path.join(cuda_build.CSRC, "*.cu")))
    t0 = time.perf_counter()
    per_source = cuda_build.build(sources)
    print(f"[2] build: {sources} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc per source: { {k: round(v, 1) for k, v in per_source.items()} })",
          flush=True)

    t0 = time.perf_counter()
    print("[3] kernels against their plain versions", flush=True)
    check_fma(torch, neurons, "cuda")
    rows, worst = phase_kernels(torch, cuda_kernels, "cuda")
    conv_rows, conv_worst = phase_spiking_conv(torch, cuda_kernels, C,
                                               neurons, "cuda")
    phase_spiking_conv_rows(torch, cuda_kernels, C, TinyYolo, "cuda")
    pw_rows, pw_worst = phase_pointwise(torch, cuda_kernels, "cuda")
    t0 = phase_seconds(3, t0)

    print(f"[4] main path: TinyYolo GEN1 {IN_HW}, B={BATCH}, T={STEPS}, "
          f"Trainer(time_batched=True).test over {EVAL_BATCHES} batches",
          flush=True)
    batches = make_batches(EVAL_BATCHES, seed=0)
    launches = phase_main_path(torch, cuda_kernels, TinyYolo, Trainer,
                               batches, "cuda")
    t0 = phase_seconds(4, t0)

    print("[5] schedules agree", flush=True)
    phase_schedules(torch, cuda_kernels, TinyYolo, batches[0], "cuda")
    t0 = phase_seconds(5, t0)
    print("[6] streaming", flush=True)
    phase_streaming(torch, cuda_kernels, TinyYolo, batches[0], "cuda")
    t0 = phase_seconds(6, t0)
    print(f"[7] fused path: TinyYolo(fuse_seq=True, time_window=0) "
          f"through Trainer(time_batched=True).test, B={BATCH}, T={STEPS}",
          flush=True)
    conv_launches = phase_fused_path(torch, cuda_kernels, C, TinyYolo,
                                     Trainer, batches, "cuda")
    t0 = phase_seconds(7, t0)
    print(f"[8] megakernel: TinyYolo GEN1 {IN_HW} at B=1, {MK_FRAMES} frames "
          f"through StreamingMegakernel.step", flush=True)
    mk_launches, mk_row = phase_megakernel(torch, cuda_kernels, TinyYolo,
                                           batches[0], "cuda")
    t0 = phase_seconds(8, t0)
    print(f"[9] engine: StreamingEngine on TinyYolo GEN1, capacity "
          f"{ENGINE_CAPACITY}, {ENGINE_STREAMS} streams, {ENGINE_STEPS} steps",
          flush=True)
    phase_engine(torch, cuda_kernels, TinyYolo, "cuda")
    t0 = phase_seconds(9, t0)
    print(f"[10] train: the cell backward kernel against autograd through "
          f"its plain version, then Trainer.fit on TinyYolo GEN1 {IN_HW}, "
          f"B={BATCH}, T={STEPS}, {TRAIN_STEPS} steps a schedule and "
          f"configuration", flush=True)
    bwd_rows, bwd_worst = phase_cell_backward(torch, cuda_kernels, "cuda")
    bwd_launches = phase_train(torch, cuda_kernels, TinyYolo, Trainer,
                               batches, "cuda")
    t0 = phase_seconds(10, t0)
    print(f"[11] the CLI on recordings: python -m "
          f"snn_for_object_detection_tpu_torch fit / test / validate with "
          f"config/config.yaml + config/synthetic.yaml on synthetic GEN1 "
          f"recordings, TinyYolo {IN_HW}, B={BATCH}", flush=True)
    phase_cli(torch, cuda_kernels, smi)
    phase_seconds(11, t0)
    t0 = time.perf_counter()
    print(f"[12] the trained net: {TRAINED_NET}/model/state.pt in TinyYolo "
          f"GEN1 {IN_HW}: [7]'s and [8]'s gates, the schedules' gradients, "
          f"the CLI's test against random weights", flush=True)
    phase_trained_net(torch, cuda_kernels, C, TinyYolo, Trainer, batches,
                      smi, "cuda")
    print(f"  [12] in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(f"[13] hybrid, auto and 1Mpx: the cell kernels at "
          f"{list(MPX_STAGE1)}, Trainer(time_batched='hybrid').fit at GEN1, "
          f"'auto' and the CLI at config/1mpx.yaml {MPX_HW}", flush=True)
    bwd_launches += phase_hybrid_auto_1mpx(torch, cuda_kernels, TinyYolo,
                                           Trainer, batches, smi, "cuda")
    print(f"  [13] in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(f"[14] the model zoo: the PLIF kernels at {PLIF_SHAPES}, VggSNN "
          f"PLIF (config/vgg.yaml) at GEN1 {IN_HW}: eval on four "
          f"schedules, fit and test through the CLI; the plain cells; "
          f"YoloSNN(scale={YOLO_SCALE!r}) and its megakernel", flush=True)
    plif_fwd, plif_bwd, plif_worst_f, plif_worst_b, plif_launches = \
        phase_zoo(torch, cuda_kernels, C, neurons, smi, batches, "cuda")
    print(f"  [14] in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(f"[15] the last inference options: e4m3 states in every kernel, "
          f"TinyYolo GEN1 {IN_HW} with e4m3 states, s2d_stem, "
          f"forward_with_records and spike_stats, int8 PTQ of the trained "
          f"net", flush=True)
    phase_options(torch, cuda_kernels, C, neurons, TinyYolo, Trainer,
                  batches, smi, "cuda")
    print(f"  [15] in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(f"[16] data parallel and mesh serving: Trainer(mesh=make_mesh()) "
          f"on a one-rank NCCL group and on {DP_RANKS} gloo ranks on the "
          f"card, fit --distributed under torchrun, StreamingEngine(mesh=) "
          f"on the trained net, TinyYolo GEN1 {IN_HW}", flush=True)
    dp_bwd, dp_cells = phase_data_parallel(torch, cuda_kernels, TinyYolo,
                                           Trainer, batches, smi)
    bwd_launches += dp_bwd
    launches += dp_cells
    print(f"  [16] in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(f"[17] training extras, plotter and summary: fit through the CLI "
          f"with config/logger.yaml, debug_nans and the profiler, a NaN on "
          f"the card, predict with config/config.yaml's plotter, the model "
          f"summary, TinyYolo GEN1 {IN_HW}", flush=True)
    phase_extras(torch, cuda_kernels, TinyYolo, Trainer, batches, smi)
    print(f"  [17] in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(f"[18] spatial sharding: Trainer(mesh=make_mesh(spatial="
          f"{SP_RANKS})) on {SP_RANKS} gloo ranks on the card, the trained "
          f"net, TinyYolo GEN1 {IN_HW}, B={BATCH}, T={STEPS}", flush=True)
    sp_fwd, sp_bwd, sp_conv = phase_spatial(torch, C, TinyYolo, Trainer, smi)
    launches += sp_fwd
    bwd_launches += sp_bwd
    conv_launches += sp_conv
    print(f"  [18] in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(f"[19] export: export_predict(platforms=('cuda',)) of the trained "
          f"net (fp32; bf16 activations, e5m2 states) and of VggSNN PLIF, "
          f"TinyYolo GEN1 {IN_HW}, each loaded and served in a fresh "
          f"process against SODa.predict", flush=True)
    ex = phase_export(torch, cuda_kernels, C, batches, smi)
    launches += ex["temporal_cell_seq"]
    plif_launches["plif_cell_seq"] += ex["plif_cell_seq"]
    print(f"  [19] in {time.perf_counter() - t0:.1f} s", flush=True)

    ref = next(r for r in rows if (r["shape"], r["cell"], r["x"], r["start"])
               == ("stage1", "lif", "float32", 0))
    conv_ref = next(r for r in conv_rows
                    if (r["shape"], r["x"]) == ("stage3_down", "torch.float32"))
    pw_ref = next(r for r in pw_rows
                  if (r["n"], r["cin"], r["cout"], r["x"])
                  == (BATCH * 120 * 152, 64, 64, "torch.float32"))
    # no single PyTorch call computes any of these functions (the cell's
    # VJP is autograd through its plain version): library_ms is null,
    # but for spiking_conv_seq, where cuDNN's conv alone (no BatchNorm,
    # no cell) is the nearest call
    bwd_ref = next(r for r in bwd_rows
                   if (r["shape"], r["cell"], r["state"], r["start"])
                   == ("stage1", "lif", "float32", 0))
    # the PLIF form of the cell: the VGG stage-1 fp32 case
    plif_fwd_ref = next(r for r in plif_fwd if (r["shape"], r["x"])
                        == ("vgg_stage1", "float32"))
    plif_bwd_ref = next(r for r in plif_bwd if (r["shape"], r["tag"], r["x"])
                        == ("vgg_stage1", "T=42", "float32"))
    kernels = []
    for name, source, line, n, err, r in (
        ("temporal_cell_seq", "temporal_cell.cu", 207, launches, worst, ref),
        ("temporal_cell_seq_bwd", "temporal_cell.cu", 356, bwd_launches,
         bwd_worst, bwd_ref),
        ("plif_cell_seq", "plif_cell.cu", 207,
         plif_launches["plif_cell_seq"], plif_worst_f, plif_fwd_ref),
        ("plif_cell_seq_bwd", "plif_cell.cu", 356,
         plif_launches["plif_cell_seq_bwd"], plif_worst_b, plif_bwd_ref),
        ("spiking_conv_seq", "spiking_conv.cu", 657, conv_launches,
         conv_worst, conv_ref),
        ("fused_pointwise_conv_bn_lif", "pointwise.cu", 88, 0, pw_worst,
         pw_ref),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"snn_for_object_detection_tpu_torch/csrc/{source}",
            "replaces":
                f"snn_for_object_detection_tpu/ops/pallas_kernels.py:{line}",
            "launches": n,
            "max_abs_err": err,
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("conv_ms"),
        })
    # no single PyTorch call computes the network either
    kernels.append({
        "name": "streaming_megakernel",
        "route": "cuda",
        "source": "snn_for_object_detection_tpu_torch/csrc/megakernel.cu",
        "replaces": "snn_for_object_detection_tpu/ops/megakernel.py:454",
        "launches": mk_launches,
        "max_abs_err": mk_row["max_abs_err"],
        "ms": mk_row["ms"],
        "plain_ms": mk_row["plain_ms"],
        "bound_ms": mk_row["bound_ms"],
        "bound_by": mk_row["bound_by"],
        "library_ms": None,
    })
    print(f"done in {time.perf_counter() - t_start:.1f} s; kernel times "
          f"below: temporal_cell_seq the stage-1 fp32 LIF case "
          f"[42,4,120,152,64]; spiking_conv_seq the stage-3 downsample at "
          f"fp32 (3x3 s2, 128->256, [42,4,60,76] -> [30,38]; library_ms "
          f"cuDNN's conv alone); "
          f"fused_pointwise_conv_bn_lif {BATCH * 120 * 152} rows, 64->64, "
          f"fp32; streaming_megakernel one GEN1 frame at fp32 (SODa.step, "
          f"its per-layer yardstick: {mk_row['step_ms']:.3f} ms); "
          f"temporal_cell_seq_bwd the stage-1 fp32 LIF case at start 0; "
          f"plif_cell_seq and plif_cell_seq_bwd (the PLIF form of the "
          f"cell, csrc/plif_cell.cu; JAX runs PLIF as a lax.scan, "
          f"models/compile.py:599) VggSNN's stage-1 fp32 case "
          f"{list(PLIF_SHAPES['vgg_stage1'])}, the backward at start "
          f"{TRAIN_START}. "
          f"Launches: temporal_cell_seq in [4], [16] (d)'s mesh "
          f"engines, [18]'s ranks and [19]'s loaded programs (counted in "
          f"their process), spiking_conv_seq in [7] and "
          f"[18]'s fused test on the grid (the fetched-rows form), "
          f"streaming_megakernel in [8] (both dtype configurations), "
          f"temporal_cell_seq_bwd in [10]'s and [13]'s Trainer.fit runs "
          f"(the three schedules, both training configurations), "
          f"[16] (a)'s one-rank mesh and [18]'s ranks; "
          f"plif_cell_seq in [14] (b)'s four eval schedules and (c)'s "
          f"fit and test of config/vgg.yaml and [19] (c)'s loaded "
          f"VggSNN, plif_cell_seq_bwd in (c)'s "
          f"fit; fused_pointwise_conv_bn_lif has no path")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
