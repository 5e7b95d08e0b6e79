#!/usr/bin/env python3
"""Where the time of ``csrc/pointwise.cu`` goes, on one NVIDIA GPU.

    python scripts/pointwise_phases.py

Builds a copy of the kernel (under ``build/pointwise_phases/``) in which
thread 0 of each CTA reads the device's global timer after each barrier
of the row-tile loop, and sums per CTA the time spent in: the barrier at
the top of a tile (waiting for the slowest thread's stores of the tile
before), issuing the next tile's copies, waiting for this tile's copies,
the product, the epilogue and the store pass; also the prologue (the
weight slab) and the loop as a whole. Prints the mean over CTAs for a
few shapes and launch plans, beside the device time of the timed copy
(CUDA events around calls queued behind a sleep kernel). The timers cost
a little: compare the copy's time with ``chip_smoke.py`` [3]'s.
"""

import ctypes
import dataclasses
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import pointwise_ab as AB  # noqa: E402
from snn_for_object_detection_tpu_torch.ops import (  # noqa: E402
    cuda_build,
    cuda_kernels as K,
)

PHASES = ("top barrier", "issue", "wait", "product", "epilogue",
          "store pass")
# (N, Cin, Cout, x dtype, state dtype, plans): None is the plan
# pointwise_plan_on picks, a tuple (rows, CTAs an SM) another
CASES = (
    (291840, 64, 64, torch.bfloat16, torch.float8_e5m2, [None, (64, 2)]),
    (291840, 64, 64, torch.float32, torch.float32, [None, (64, 1)]),
    (72960, 64, 64, torch.float32, torch.float32, [None]),
    (72960, 128, 64, torch.float32, torch.float32, [None]),
    (4560, 256, 256, torch.float32, torch.float32, [None]),
    (18240, 256, 128, torch.float32, torch.float32, [None]),
)
MARKS = (  # (anchor in the source, text inserted after it)
    ('#include "cell_math.cuh"\n',
     "__device__ unsigned long long* g_phases;\n"
     "__device__ __forceinline__ unsigned long long now_ns() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n"
     "#define MARK(q) if (tid == 0) { const unsigned long long tn = "
     "now_ns(); ph[q] += tn - tp; tp = tn; }\n"),
    ("  const int tid = threadIdx.x;\n",
     "  const unsigned long long t_kernel = now_ns();\n"),
    ("  const int c_item = (tid % nch) * CH;\n",
     "  unsigned long long ph[6] = {0, 0, 0, 0, 0, 0}, tp = now_ns();\n"
     "  const unsigned long long t_loop = tp;\n"),
    ("    __syncthreads();  // slot (k + 1) % 2, tile k - 1's, is consumed\n",
     "    MARK(0)\n"),
    ("    cp_async_commit();\n    cp_async_wait<kStages - 1>();",
     None),  # handled below: MARK(1) before the wait
    ("    __syncthreads();               // everyone's have\n",
     "    MARK(2)\n"),
    ("      __syncthreads();  // every warp is done with x: its slot takes z\n",
     "      MARK(3)\n"),
    ("      __syncthreads();  // every thread is done with x: its slot takes "
     "z\n", "      MARK(3)\n"),
    ("    __syncthreads();  // z, v', i' are in the stage\n", "    MARK(4)\n"),
    ("  cp_async_wait<0>();  // no copy outlives the CTA (empty groups "
     "only)\n", None),  # handled below: the record before the last wait
)


def instrumented_source() -> str:
    path = os.path.join(cuda_build.CSRC, "pointwise.cu")
    with open(path) as f:
        src = f.read()
    for anchor, after in MARKS:
        assert src.count(anchor) == 1, f"anchor not found once: {anchor!r}"
        if after is not None:
            src = src.replace(anchor, anchor + after)
    src = src.replace(
        "    cp_async_commit();\n    cp_async_wait<kStages - 1>();",
        "    cp_async_commit();\n    MARK(1)\n"
        "    cp_async_wait<kStages - 1>();")
    # the store pass ends the loop body: MARK(5) before the loop's end,
    # then every CTA writes its sums
    src = src.replace(
        "  cp_async_wait<0>();  // no copy outlives the CTA (empty groups "
        "only)\n",
        "  if (tid == 0) {\n"
        "    unsigned long long* out = g_phases + blockIdx.x * 10;\n"
        "    for (int q = 0; q < 6; ++q) out[q] = ph[q];\n"
        "    out[6] = now_ns() - t_loop;\n"
        "    out[7] = count;\n"
        "    out[8] = t_loop - t_kernel;\n"
        "  }\n"
        "  cp_async_wait<0>();\n")
    anchor = "      store_ch<S, CH>(i_out + o, so, nv, p.ovec);\n    }\n"
    assert src.count(anchor) == 1
    src = src.replace(anchor, anchor + "    MARK(5)\n")
    return src + ('\nextern "C" int set_phases(void* p) {\n'
                  "  return static_cast<int>(cudaMemcpyToSymbol(g_phases, "
                  "&p, sizeof(p)));\n}\n")


def build():
    out_dir = os.path.join(ROOT, "build", "pointwise_phases")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "pointwise_phases.cu")
    lib = os.path.join(out_dir, "libpointwise_phases.so")
    with open(src, "w") as f:
        f.write(instrumented_source())
    done = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{cuda_build.CSRC}",
         "-o", lib, src], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(done.stdout + done.stderr)
    dll = ctypes.CDLL(lib)
    dll.fused_pointwise_launch.argtypes = K._pointwise_lib(
        "fused_pointwise_launch").argtypes
    dll.fused_pointwise_launch.restype = ctypes.c_int
    dll.set_phases.argtypes = [ctypes.c_void_p]
    return dll


def launch(dll, args, plan):
    x, w, a, b, v, i = args
    z = torch.empty(v.shape, dtype=x.dtype, device="cuda")
    v_out, i_out = torch.empty_like(v), torch.empty_like(i)
    c_mem, c_syn = K._euler("lif")
    rc = dll.fused_pointwise_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), v.data_ptr(),
        i.data_ptr(), z.data_ptr(), v_out.data_ptr(), i_out.data_ptr(),
        x.shape[0], x.shape[1], w.shape[1], plan.rows, plan.cout_tile,
        plan.threads, plan.smem, plan.grid, K._CODES[x.dtype],
        K._CODES[v.dtype], c_mem, c_syn,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed ({rc})")


def main():
    dll = build()
    sms = K.sm_count(0)
    for n, cin, cout, xd, sd, plans in CASES:
        args = AB.inputs(n, cin, cout, xd, sd)
        base = K.pointwise_plan_on(0, n, cin, cout, xd, sd)
        sx, ss = K._pw_sizes(xd, sd)
        for other in plans:
            plan = base
            if other is not None:
                rows, per_sm = other
                smem = K.pointwise_smem(cin, base.cout_tile, rows, sx,
                                        ss)[1]
                plan = dataclasses.replace(
                    base, rows=rows, smem=smem, ctas_per_sm=per_sm,
                    grid=K.pointwise_grid(n, rows, base.splits, sms, per_sm))
            buf = torch.zeros(plan.grid * 10, dtype=torch.int64,
                              device="cuda")
            if dll.set_phases(buf.data_ptr()) != 0:
                raise RuntimeError("set_phases failed")
            ms = AB.GATE.queued_ms(lambda: launch(dll, args, plan))
            buf.zero_()
            launch(dll, args, plan)
            torch.cuda.synchronize()
            ph = buf.view(plan.grid, 10).double() / 1e3  # us
            parts = ", ".join(f"{name} {float(ph[:, q].mean()):.1f}"
                              for q, name in enumerate(PHASES))
            print(f"{n}x{cin}->{cout} {str(xd)[6:]}/{str(sd)[6:]} "
                  f"{'plan' if other is None else 'other'} {plan.rows} rows/"
                  f"{plan.ctas_per_sm} an SM/"
                  f"{plan.threads} threads: {ms:.4f} ms "
                  f"(timed copy); per CTA, us: prologue "
                  f"{float(ph[:, 8].mean()):.1f}, loop "
                  f"{float(ph[:, 6].mean()):.1f} over "
                  f"{float(ph[:, 7].mean()) * 1e3:.1f} tiles: {parts}",
                  flush=True)
        del args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
