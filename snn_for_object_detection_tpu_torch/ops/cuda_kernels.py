"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Counterpart of ``snn_for_object_detection_tpu/ops/pallas_kernels.py``.
Each wrapper runs its kernel on a CUDA tensor and the plain PyTorch
version, kept in this module, on a CPU tensor; there is no fallback
from one to the other. Each wrapper counts its launches in
``LAUNCHES`` so that a run can show its path went through the kernel.
The cell kernels' CUDA forms are also registered ``torch.library``
operators (``soda_torch::temporal_cell_seq``,
``soda_torch::plif_cell_seq``), which ``torch.export`` traces
(``export.py``) and autograd records; the other kernels are called
through ctypes only.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import itertools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from snn_for_object_detection_tpu_torch.ops import cuda_build, neurons

# launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "temporal_cell_seq": 0,
    "temporal_cell_seq_bwd": 0,
    "plif_cell_seq": 0,
    "plif_cell_seq_bwd": 0,
    "spiking_conv_seq": 0,
    "fused_pointwise_conv_bn_lif": 0,
    "streaming_megakernel": 0,
}

# type codes of the C entry points
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e5m2: 2,
          torch.float8_e4m3fn: 3}
X_DTYPES = (torch.float32, torch.bfloat16)
STATE_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e5m2,
                torch.float8_e4m3fn)
_CELLS = {"lif": 0, "li": 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _temporal_lib(name: str = "temporal_cell_seq_launch"):
    # PLIF's entry points are plif_cell.cu's, LIF's and LI's
    # temporal_cell.cu's (one header of kernels, two sources built at once)
    source = "plif_cell.cu" if name.startswith("plif") else "temporal_cell.cu"
    fn = getattr(cuda_build.load(source), name)
    if fn.argtypes is None and name.startswith("plif"):
        fn.argtypes = {
            # 6 pointers, cm, cs; T, M; C, start, x and state type codes
            "plif_cell_seq_launch": [ctypes.c_void_p] * 8
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4,
            # 10 pointers, cm, cs, gcm, gcs; T, M; C, start, x and state
            # type codes; alpha; chunk, threads, vec, smem
            "plif_cell_seq_bwd_launch": [ctypes.c_void_p] * 14
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
            + [ctypes.c_float] + [ctypes.c_int] * 4,
            "plif_cell_bwd_regs": [ctypes.c_int] * 3,
        }[name] + ([] if name == "plif_cell_bwd_regs" else [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    elif fn.argtypes is None:
        # pointers (6 forward, 10 backward); T, M; start, cell, x and
        # state type codes; c_mem, c_syn (and alpha; then the backward's
        # plan: chunk, threads, vec, smem); stream
        bwd = name == "temporal_cell_seq_bwd_launch"
        fn.argtypes = (
            [ctypes.c_void_p] * (10 if bwd else 6)
            + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 4
            + [ctypes.c_float] * (3 if bwd else 2)
            + [ctypes.c_int] * (4 if bwd else 0)
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _spiking_conv_lib():
    fn = cuda_build.load("spiking_conv.cu").spiking_conv_seq_launch
    if fn.argtypes is None:
        # 9 pointers; T, N, H, W, Cin, Ho, Wo, Cout, k, stride, pad_h; the
        # plan's resident, co, th, tw, threads, kc, smem; grid; cell, x and
        # state type codes; c_mem, c_syn; stream
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 18
                       + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _pointwise_lib(name: str):
    fn = getattr(cuda_build.load("pointwise.cu"), name)
    if fn.argtypes is None:
        if name == "pointwise_occupancy":
            fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
        else:
            # 9 pointers; n; Cin, Cout, rows, Cout_tile, threads, smem;
            # grid; x and state type codes; c_mem, c_syn; stream
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 6 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _euler(cell: str) -> Tuple[float, float]:
    return neurons.euler_factors(
        neurons.LIFParams() if cell == "lif" else neurons.LIParams()
    )


def _require_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_state_dtypes(v, i) -> None:
    if v.dtype not in STATE_DTYPES or i.dtype != v.dtype:
        raise TypeError(
            f"state dtypes ({v.dtype}, {i.dtype}) must match and be one "
            f"of {STATE_DTYPES}"
        )


def _check_cell_args(x_seq, v0, i0, cell):
    if cell not in _CELLS:
        raise ValueError(f"unsupported cell {cell!r}")
    if x_seq.dtype not in X_DTYPES:
        raise TypeError(f"x_seq dtype {x_seq.dtype} not in {X_DTYPES}")
    _check_state_dtypes(v0, i0)
    if x_seq.dim() < 1 or x_seq.shape[1:] != v0.shape \
            or v0.shape != i0.shape:
        raise ValueError(
            f"shapes x {tuple(x_seq.shape)}, v0 {tuple(v0.shape)}, "
            f"i0 {tuple(i0.shape)}: want x = [T, *state]"
        )
    if not (x_seq.device == v0.device == i0.device):
        raise ValueError("x_seq, v0 and i0 must be on one device")


class _StoreRound(torch.autograd.Function):
    """``x`` (fp32) rounded to the state's storage dtype and widened
    back, and its gradient rounded the same way: the state and its
    cotangent are both stored in that dtype between steps, as the JAX
    scan's ``astype(state_dtype)`` / ``astype(f32)`` pair rounds them
    (``neurons.to_state``: e4m3 overflow gives NaN, as in JAX)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return neurons.to_state(x, dtype).to(torch.float32, copy=True)

    @staticmethod
    def backward(ctx, g):
        return neurons.to_state(g, ctx.dtype).float(), None


def temporal_cell_seq_reference(
    x_seq: torch.Tensor, v0: torch.Tensor, i0: torch.Tensor,
    cell: str = "lif", start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`temporal_cell_seq`: a loop over T
    of ``neurons.lif_step`` / ``li_step`` in fp32, the state cast to its
    storage dtype every step and frozen for ``t < start`` (the output is
    still emitted from the frozen state).

    Autograd through it is the plain version of the kernel's backward
    and is JAX's VJP of ``_temporal_scan_reference``: each step takes
    its state through a :class:`_StoreRound`, so the state cotangent a
    step hands back is rounded to the storage dtype, and a frozen step
    holds the carried state through one more, so its cotangent is the
    carried one plus the rounded cotangent of the step's output, rounded
    once more (JAX's ``where(keep, new, old)`` summed in the storage
    dtype).
    """
    _check_cell_args(x_seq, v0, i0, cell)
    step = neurons.lif_step if cell == "lif" else neurons.li_step
    return _cell_loop(step, x_seq, v0, i0, start)


def _cell_loop(step, x_seq, v0, i0, start):
    """The plain versions' time loop: ``step(x_t, (v, i))`` in fp32, the
    state through :class:`_StoreRound` into and out of every step, held
    for ``t < start``."""
    sd = v0.dtype
    v, i = neurons.from_state(v0), neurons.from_state(i0)
    z = []
    for t, x_t in enumerate(x_seq.unbind(0)):
        out, (v_new, i_new) = step(
            x_t.float(),
            (_StoreRound.apply(v, sd), _StoreRound.apply(i, sd)))
        z.append(out.to(x_seq.dtype))
        if t >= start:
            v, i = _StoreRound.apply(v_new, sd), _StoreRound.apply(i_new, sd)
        else:
            v, i = _StoreRound.apply(v, sd), _StoreRound.apply(i, sd)
    z = torch.stack(z) if z else torch.empty_like(x_seq)
    return z, neurons.to_state(v, sd), neurons.to_state(i, sd)


def _launch_forward(x_seq, v0, i0, cell, start):
    _require_contiguous(x_seq=x_seq, v0=v0, i0=i0)
    z = torch.empty_like(x_seq)
    v_t = torch.empty_like(v0)
    i_t = torch.empty_like(i0)
    c_mem, c_syn = _euler(cell)
    with torch.cuda.device(x_seq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _temporal_lib()(
            x_seq.data_ptr(), v0.data_ptr(), i0.data_ptr(),
            z.data_ptr(), v_t.data_ptr(), i_t.data_ptr(),
            x_seq.shape[0], v0.numel(), int(start), _CELLS[cell],
            _CODES[x_seq.dtype], _CODES[v0.dtype],
            c_mem, c_syn, stream,
        )
    if rc != 0:
        raise RuntimeError(f"temporal_cell_seq launch failed (code {rc})")
    LAUNCHES["temporal_cell_seq"] += 1
    return z, v_t, i_t


# ---- the launch plan of the cell backward (csrc/temporal_cell.cu) ----

CELL_BWD_CHUNKS = (2, 4, 6, 8, 12, 16)  # chunk lengths the source builds
CELL_BWD_THREADS = (256, 128)
CELL_BWD_MAX_SMEM = 232448  # kMaxSmem: 227 KB, the most a CTA can have
CELL_BWD_SM_SMEM = 233472  # 228 KB an SM, of which the card keeps
CELL_BWD_CTA_RESERVED = 1024  # per CTA
CELL_BWD_REGS = 255  # registers a thread at most (launch bounds of 256)
# a thread's s values (chunk x elements a thread) that the source builds
# on the vector paths (chunk_built): beyond them ptxas spills at 255
# registers; the scalar path builds every chunk
CELL_BWD_MAX_S = 48
# registers a thread of each chunked kernel built, by elements a thread
# (1, 4 for fp32 x, 8 for bf16 x) and chunk: what ptxas -v reports for
# sm_90a (CUDA 12.8), the most over the state types
_CELL_BWD_REGS_SEEN = {
    1: {2: 40, 4: 44, 6: 52, 8: 62, 12: 80, 16: 94},
    4: {2: 71, 4: 100, 6: 128, 8: 166, 12: 233},
    8: {2: 124, 4: 172, 6: 232},
}


@dataclasses.dataclass(frozen=True)
class CellBwdPlan:
    """How ``csrc/temporal_cell.cu``'s chunked backward runs LIF at T >=
    2: chunks of ``chunk`` steps, ``threads`` threads a CTA, a thread's
    16 bytes of x at a time (``vec``) or one element; ``rows`` =
    ceil(T / chunk) - 2 checkpoints a state, in shared memory
    (``shared``: ``smem`` bytes a CTA) or in global rows ``[2, rows,
    M]`` that the wrapper allocates; ``ckpt_bytes`` of checkpoints in
    all."""

    chunk: int
    threads: int
    shared: bool
    rows: int
    vec: bool
    smem: int
    ckpt_bytes: int


def cell_bwd_built(chunk: int, width: int) -> bool:
    """Whether the source builds the chunked kernel for ``chunk`` steps a
    chunk and ``width`` elements a thread (its ``chunk_built``)."""
    return chunk in CELL_BWD_CHUNKS and (
        width == 1 or chunk * width <= CELL_BWD_MAX_S)


def cell_bwd_regs(chunk: int, width: int) -> int:
    """Registers a thread of a built chunked kernel takes at ``chunk``
    steps a chunk and ``width`` elements a thread
    (``_CELL_BWD_REGS_SEEN``): mostly the chunk's s (fp32) and its loads
    of x and gz, which pass 2 keeps in flight."""
    return _CELL_BWD_REGS_SEEN[width][chunk]


def cell_bwd_plan_of(T: int, m: int, x_dtype: torch.dtype,
                     state_dtype: torch.dtype, chunk: int, threads: int,
                     shared: bool, vec: bool = True) -> CellBwdPlan:
    """The plan of ``chunk`` steps a chunk (one of ``CELL_BWD_CHUNKS``;
    longer than T gives one short chunk), ``threads`` threads and the
    checkpoints in shared or global memory, for LIF over ``T >= 2``
    steps of ``m`` elements (no checkpoints, so nothing global, where
    T takes at most two chunks)."""
    xb, ss = x_dtype.itemsize, state_dtype.itemsize
    width = 16 // xb if vec and m % (16 // xb) == 0 else 1
    rows = max(0, -(-T // chunk) - 2)
    shared = shared or rows == 0
    smem = threads * rows * 2 * width * ss if shared else 0
    return CellBwdPlan(chunk, threads, shared, rows, width > 1, smem,
                       2 * rows * m * ss)


def cell_bwd_plans(T: int, m: int, x_dtype: torch.dtype,
                   state_dtype: torch.dtype,
                   vec: bool = True) -> List[CellBwdPlan]:
    """Every plan the chunked kernel takes for LIF over ``T >= 2`` steps
    of ``m`` elements: a chunk no longer than T that the source builds
    for the width (:func:`cell_bwd_built`), 256 or 128 threads, the
    checkpoints in shared memory where they fit a CTA, and in global
    memory. Every plan gives the same bits."""
    if T < 2:
        raise ValueError(f"T = {T}: the chunked backward runs T >= 2")
    xb = x_dtype.itemsize
    width = 16 // xb if vec and m % (16 // xb) == 0 else 1
    plans = []
    for chunk in (c for c in CELL_BWD_CHUNKS if c <= T):
        if not cell_bwd_built(chunk, width):
            continue
        for threads, shared in itertools.product(CELL_BWD_THREADS,
                                                 (True, False)):
            plan = cell_bwd_plan_of(T, m, x_dtype, state_dtype, chunk,
                                    threads, shared, vec)
            if plan.smem <= CELL_BWD_MAX_SMEM and plan not in plans:
                plans.append(plan)
    return plans


def _cell_bwd_cost(plan: CellBwdPlan, T: int, m: int, x_bytes: int,
                   regs: Optional[int] = None) -> float:
    """Relative time of a plan, fitted to every plan's time at
    ``chip_smoke.py`` [10]'s two T = 42 shapes on the H100
    (``scripts/cell_bwd_ab.py plans``; PERF.md): the bytes it
    moves (x over every chunk but the last in pass 1 and again in pass
    2, gz, gx; global checkpoints written and read) at the card's rate,
    slowed in proportion where an SM holds fewer than 3 warps for each
    element a thread (12 warps with fp32 x, 24 with bf16 x: a thread's
    math grows with its elements, its bytes do not). The warps an SM
    are the CTAs that fit its registers (``regs`` a thread, default
    LIF's kernel's), shared memory and threads."""
    width = 16 // x_bytes if plan.vec else 1
    chunks = -(-T // plan.chunk)
    nbytes = m * x_bytes * (T + (chunks - 1) * plan.chunk + 2 * T)
    if not plan.shared:
        nbytes += 2 * plan.ckpt_bytes
    if regs is None:
        regs = cell_bwd_regs(plan.chunk, width)
    regs = -(-regs // 8) * 8
    ctas = min(65536 // (regs * plan.threads), 2048 // plan.threads,
               CELL_BWD_SM_SMEM // (plan.smem + CELL_BWD_CTA_RESERVED))
    warps = ctas * plan.threads // 32
    return nbytes / min(1.0, warps / (3 * width))


@functools.lru_cache(maxsize=256)
def cell_bwd_plan(T: int, m: int, x_dtype: torch.dtype,
                  state_dtype: torch.dtype, vec: bool = True) -> CellBwdPlan:
    """The launch plan of the LIF backward over ``T >= 2`` steps of ``m``
    elements: of :func:`cell_bwd_plans`, the one of least
    :func:`_cell_bwd_cost` (the first of equals). At GEN1's T = 42 with
    fp32 x: chunks of 6, 5 checkpoints a state in shared memory; with
    bf16 x: chunks of 2 with global checkpoints (fewer registers, more
    warps). The plan never changes results (``chip_smoke.py`` [10] and
    ``scripts/cell_bwd_ab.py plans`` hold every plan bit-equal)."""
    plans = cell_bwd_plans(T, m, x_dtype, state_dtype, vec)
    return min(plans, key=lambda p: _cell_bwd_cost(p, T, m,
                                                   x_dtype.itemsize))


def _bwd_vec(x_seq, v0, tensors_x, tensors_state) -> bool:
    """Whether the backward can take 16-byte loads of x: the flat size a
    multiple of the width and every pointer aligned (as the entry point
    checks)."""
    width = 16 // x_seq.element_size()
    sv = width * v0.element_size()
    return (v0.numel() % width == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors_x)
            and all(t.data_ptr() % sv == 0 for t in tensors_state))


def temporal_cell_seq_bwd(
    x_seq: torch.Tensor, v0: torch.Tensor, i0: torch.Tensor,
    gz: torch.Tensor, gv: torch.Tensor, gi: torch.Tensor,
    cell: str = "lif", start: int = 0, plan: Optional[CellBwdPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The VJP of :func:`temporal_cell_seq` on the card: ``(gx, gv0,
    gi0)`` for the cotangents ``gz`` (x's dtype, ``[T, ...]``) and
    ``gv``, ``gi`` (the state dtype) of ``(z_seq, v_T, i_T)``. One
    launch of ``csrc/temporal_cell.cu``'s backward kernel; its plain
    version is autograd through :func:`temporal_cell_seq_reference`.
    LIF at T >= 2 runs under ``plan`` (default :func:`cell_bwd_plan`;
    ``chip_smoke.py`` and the card tests run others), with its
    checkpoint rows allocated here when they are global."""
    _check_cell_args(x_seq, v0, i0, cell)
    if x_seq.device.type != "cuda":
        raise ValueError("the backward kernel takes CUDA tensors, not "
                         f"{x_seq.device}")
    if (gz.shape, gz.dtype) != (x_seq.shape, x_seq.dtype) or any(
            (g.shape, g.dtype) != (v0.shape, v0.dtype) for g in (gv, gi)):
        raise ValueError("cotangents must match (z_seq, v_T, i_T) in shape "
                         "and dtype")
    _require_contiguous(x_seq=x_seq, v0=v0, i0=i0)
    gz, gv, gi = gz.contiguous(), gv.contiguous(), gi.contiguous()
    T, m = x_seq.shape[0], v0.numel()
    gx = torch.empty_like(x_seq)
    gv0 = torch.empty_like(v0)
    gi0 = torch.empty_like(i0)
    vec = _bwd_vec(x_seq, v0, (x_seq, gz, gx), (v0, i0, gv, gi, gv0, gi0))
    ckpt = None
    chunk, threads, smem = 0, 256, 0
    if cell == "lif" and T >= 2:
        if plan is None:
            plan = cell_bwd_plan(T, m, x_seq.dtype, v0.dtype, vec)
        if plan.vec and not vec:
            raise ValueError("the plan takes 16-byte loads that these "
                             "tensors do not allow")
        if not plan.shared:
            ckpt = torch.empty((2, plan.rows, m), dtype=v0.dtype,
                               device=v0.device)
        chunk, threads, smem, vec = (plan.chunk, plan.threads, plan.smem,
                                     plan.vec)
    c_mem, c_syn = _euler(cell)
    with torch.cuda.device(x_seq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _temporal_lib("temporal_cell_seq_bwd_launch")(
            x_seq.data_ptr(), v0.data_ptr(), i0.data_ptr(), gz.data_ptr(),
            gv.data_ptr(), gi.data_ptr(), gx.data_ptr(), gv0.data_ptr(),
            gi0.data_ptr(), None if ckpt is None else ckpt.data_ptr(), T,
            m, int(start), _CELLS[cell], _CODES[x_seq.dtype],
            _CODES[v0.dtype], c_mem, c_syn, neurons.LIFParams().alpha,
            chunk, threads, int(vec), smem, stream,
        )
    if rc != 0:
        raise RuntimeError(f"temporal_cell_seq_bwd launch failed (code {rc})")
    LAUNCHES["temporal_cell_seq_bwd"] += 1
    return gx, gv0, gi0


# ---- the cell kernels as registered operators ----
#
# ``torch.export`` cannot trace a ctypes call on ``data_ptr()``: the
# CUDA forms of the cell kernels are ``torch.library`` operators, so a
# traced program holds ``soda_torch::temporal_cell_seq`` and
# ``soda_torch::plif_cell_seq`` as nodes (shapes from their fake forms)
# and runs the kernels when it runs on the card. Each takes CUDA tensors
# only: there is no CPU implementation to fall back to.


def _through_operator(*tensors: torch.Tensor) -> bool:
    """Whether a CUDA cell call goes through its registered operator:
    while traced (``torch.export``, ``torch.compile``) and where autograd
    records it (training). An eager call with no gradient to record
    (predict, the engine, eval) launches its kernel itself: the
    operator's Python dispatch more than doubles the host's cost of a
    call, and those paths are bound by the host (``chip_smoke.py`` [19]
    prints both)."""
    return (torch.compiler.is_exporting() or torch.compiler.is_compiling()
            or (torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors)))


@torch.library.custom_op("soda_torch::temporal_cell_seq", mutates_args=(),
                         device_types="cuda")
def _temporal_cell_seq_op(x_seq: torch.Tensor, v0: torch.Tensor,
                          i0: torch.Tensor, cell: str, start: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``csrc/temporal_cell.cu``'s forward: one launch, or raises."""
    _check_cell_args(x_seq, v0, i0, cell)
    return _launch_forward(x_seq, v0, i0, cell, start)


@_temporal_cell_seq_op.register_fake
def _(x_seq, v0, i0, cell, start):
    _check_cell_args(x_seq, v0, i0, cell)
    return torch.empty_like(x_seq), torch.empty_like(v0), \
        torch.empty_like(i0)


def _temporal_setup(ctx, inputs, output):
    # only (x_seq, v0, i0) and the start, as the JAX custom VJP: the
    # backward recomputes the states
    x_seq, v0, i0, cell, start = inputs
    ctx.cell, ctx.start = cell, start
    ctx.save_for_backward(x_seq, v0, i0)


def _temporal_backward(ctx, gz, gv, gi):
    x_seq, v0, i0 = ctx.saved_tensors
    gx, gv0, gi0 = temporal_cell_seq_bwd(
        x_seq, v0, i0, gz, gv, gi, ctx.cell, ctx.start)
    return gx, gv0, gi0, None, None


_temporal_cell_seq_op.register_autograd(_temporal_backward,
                                        setup_context=_temporal_setup)


def temporal_cell_seq(
    x_seq: torch.Tensor, v0: torch.Tensor, i0: torch.Tensor,
    cell: str = "lif", start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-layer LIF/LI over T steps: ``(z_seq, v_T, i_T)``.

    :param x_seq: ``[T, ...]`` cell input, fp32 or bf16.
    :param v0: ``[...]`` initial membrane, fp32, bf16 or fp8 (e5m2,
        e4m3fn).
    :param i0: ``[...]`` initial current, same dtype as ``v0``.
    :param start: truncation start r: the state is frozen for steps
        ``t < r`` while their outputs are still emitted. It gets no
        gradient.
    :return: ``z_seq`` in ``x_seq``'s dtype (spikes for LIF, the fp32
        membrane before quantization for LI); ``v_T``, ``i_T`` in the
        state dtype.

    On a CPU tensor this is :func:`temporal_cell_seq_reference`, and
    autograd runs through it. On a CUDA tensor it launches
    ``csrc/temporal_cell.cu`` on the current stream or raises: through
    the registered operator ``soda_torch::temporal_cell_seq`` while
    traced or where autograd records the call, its gradient one launch
    of the backward kernel (:func:`temporal_cell_seq_bwd`), else
    directly (:func:`_through_operator`). Inputs must be contiguous (a
    sequence is never copied here).
    """
    _check_cell_args(x_seq, v0, i0, cell)
    if x_seq.device.type == "cpu":
        return temporal_cell_seq_reference(x_seq, v0, i0, cell, start)
    if x_seq.device.type != "cuda":
        raise ValueError(f"unsupported device {x_seq.device}")
    if _through_operator(x_seq, v0, i0):
        return torch.ops.soda_torch.temporal_cell_seq(x_seq, v0, i0, cell,
                                                      int(start))
    return _launch_forward(x_seq, v0, i0, cell, int(start))


# ---- PLIF: the LIF kernels with per-channel factors ----


def _check_plif_args(x_seq, v0, i0, c_mem, c_syn):
    _check_cell_args(x_seq, v0, i0, "lif")
    ch = v0.shape[-1] if v0.dim() else 0
    for name, c in (("c_mem", c_mem), ("c_syn", c_syn)):
        if c.dtype != torch.float32 or tuple(c.shape) != (ch,):
            raise ValueError(f"{name} must be fp32 [{ch}] (the state's "
                             f"trailing axis), not {c.dtype} "
                             f"{tuple(c.shape)}")
        if c.device != x_seq.device:
            raise ValueError(f"{name} on {c.device}, x_seq on "
                             f"{x_seq.device}")


def plif_cell_seq_reference(
    x_seq: torch.Tensor, v0: torch.Tensor, i0: torch.Tensor,
    c_mem: torch.Tensor, c_syn: torch.Tensor, start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`plif_cell_seq`: a loop over T of
    ``neurons.plif_step_factors`` in fp32 with the state stored in its
    dtype and frozen for ``t < start``, exactly as
    :func:`temporal_cell_seq_reference` runs LIF. Autograd through it is
    the plain version of the backward kernel, the factors' gradients
    included (each step's summed over the batch by ``neurons.fma``'s
    backward, then across steps)."""
    _check_plif_args(x_seq, v0, i0, c_mem, c_syn)
    return _cell_loop(
        lambda x, st: neurons.plif_step_factors(x, st, c_mem, c_syn),
        x_seq, v0, i0, start)


def _launch_plif_forward(x_seq, v0, i0, c_mem, c_syn, start):
    _require_contiguous(x_seq=x_seq, v0=v0, i0=i0, c_mem=c_mem, c_syn=c_syn)
    z = torch.empty_like(x_seq)
    v_t = torch.empty_like(v0)
    i_t = torch.empty_like(i0)
    with torch.cuda.device(x_seq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _temporal_lib("plif_cell_seq_launch")(
            x_seq.data_ptr(), v0.data_ptr(), i0.data_ptr(),
            z.data_ptr(), v_t.data_ptr(), i_t.data_ptr(),
            c_mem.data_ptr(), c_syn.data_ptr(), x_seq.shape[0], v0.numel(),
            v0.shape[-1], int(start), _CODES[x_seq.dtype], _CODES[v0.dtype],
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"plif_cell_seq launch failed (code {rc})")
    LAUNCHES["plif_cell_seq"] += 1
    return z, v_t, i_t


# the chunk plif_cell.cu builds for PLIF's chunked backward, by elements a
# thread (its plif_chunk): a thread keeps each step's entering (v, i),
# twice LIF's s values, so the chunks are shorter than LIF's
PLIF_BWD_CHUNK = {1: 8, 4: 4, 8: 2}
# registers a thread of PLIF's chunked kernels take, by elements a thread
# (fp32 x: 1 or 4, bf16 x: 1 or 8): what the H100 reported
# (``plif_cell_bwd_regs``, chip_smoke.py [14], CUDA 12.8), the most over
# the state types
_PLIF_BWD_REGS_SEEN = {1: 78, 4: 150, 8: 185}


def plif_bwd_regs_on_card(x_dtype: torch.dtype, state_dtype: torch.dtype,
                          vec: bool) -> int:
    """Registers a thread of PLIF's chunked backward takes, as the card's
    ``cudaFuncGetAttributes`` reports them (builds the source)."""
    regs = _temporal_lib("plif_cell_bwd_regs")(
        _CODES[x_dtype], _CODES[state_dtype], int(vec))
    if regs < 0:
        raise RuntimeError("plif_cell_bwd_regs failed")
    return regs


@functools.lru_cache(maxsize=256)
def plif_bwd_plan(T: int, m: int, x_dtype: torch.dtype,
                  state_dtype: torch.dtype, vec: bool = True) -> CellBwdPlan:
    """The launch plan of PLIF's backward over ``T >= 2`` steps of ``m``
    elements: the chunk its width is built with (``PLIF_BWD_CHUNK``),
    and of 256 or 128 threads with the checkpoints in shared or global
    memory the one of least :func:`_cell_bwd_cost` (LIF's model, with
    PLIF's registers). The plan never changes results."""
    if T < 2:
        raise ValueError(f"T = {T}: the chunked backward runs T >= 2")
    width = 16 // x_dtype.itemsize if vec and m % (16 // x_dtype.itemsize) \
        == 0 else 1
    chunk = PLIF_BWD_CHUNK[width]
    plans = []
    for threads, shared in itertools.product(CELL_BWD_THREADS, (True, False)):
        plan = cell_bwd_plan_of(T, m, x_dtype, state_dtype, chunk, threads,
                                shared, vec)
        if plan.smem <= CELL_BWD_MAX_SMEM and plan not in plans:
            plans.append(plan)
    return min(plans, key=lambda p: _cell_bwd_cost(
        p, T, m, x_dtype.itemsize, _PLIF_BWD_REGS_SEEN[width]))


def plif_cell_seq_bwd(
    x_seq: torch.Tensor, v0: torch.Tensor, i0: torch.Tensor,
    c_mem: torch.Tensor, c_syn: torch.Tensor, gz: torch.Tensor,
    gv: torch.Tensor, gi: torch.Tensor, start: int = 0,
    plan: Optional[CellBwdPlan] = None,
) -> Tuple[torch.Tensor, ...]:
    """The VJP of :func:`plif_cell_seq` on the card: ``(gx, gv0, gi0,
    gcm, gcs)``, the last two each element's fp32 sum over t of the
    cotangents of its channel's ``c_mem`` and of ``-c_syn`` (``[*state]``;
    :func:`plif_factor_grads` sums them to ``[C]``). One launch of
    ``csrc/plif_cell.cu``'s backward: the chunked kernel at T >= 2
    under ``plan`` (default :func:`plif_bwd_plan`), the single pass at
    T <= 1."""
    _check_plif_args(x_seq, v0, i0, c_mem, c_syn)
    if x_seq.device.type != "cuda":
        raise ValueError("the backward kernel takes CUDA tensors, not "
                         f"{x_seq.device}")
    if (gz.shape, gz.dtype) != (x_seq.shape, x_seq.dtype) or any(
            (g.shape, g.dtype) != (v0.shape, v0.dtype) for g in (gv, gi)):
        raise ValueError("cotangents must match (z_seq, v_T, i_T) in shape "
                         "and dtype")
    _require_contiguous(x_seq=x_seq, v0=v0, i0=i0, c_mem=c_mem, c_syn=c_syn)
    gz, gv, gi = gz.contiguous(), gv.contiguous(), gi.contiguous()
    T, m = x_seq.shape[0], v0.numel()
    gx = torch.empty_like(x_seq)
    gv0 = torch.empty_like(v0)
    gi0 = torch.empty_like(i0)
    gcm = torch.empty(v0.shape, dtype=torch.float32, device=v0.device)
    gcs = torch.empty_like(gcm)
    vec = _bwd_vec(x_seq, v0, (x_seq, gz, gx),
                   (v0, i0, gv, gi, gv0, gi0)) and all(
        g.data_ptr() % (4 * 16 // x_seq.element_size()) == 0
        for g in (gcm, gcs))
    ckpt = None
    chunk, threads, smem = 0, 256, 0
    if T >= 2:
        if plan is None:
            plan = plif_bwd_plan(T, m, x_seq.dtype, v0.dtype, vec)
        if plan.vec and not vec:
            raise ValueError("the plan takes 16-byte loads that these "
                             "tensors do not allow")
        if not plan.shared:
            ckpt = torch.empty((2, plan.rows, m), dtype=v0.dtype,
                               device=v0.device)
        chunk, threads, smem, vec = (plan.chunk, plan.threads, plan.smem,
                                     plan.vec)
    with torch.cuda.device(x_seq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _temporal_lib("plif_cell_seq_bwd_launch")(
            x_seq.data_ptr(), v0.data_ptr(), i0.data_ptr(), gz.data_ptr(),
            gv.data_ptr(), gi.data_ptr(), gx.data_ptr(), gv0.data_ptr(),
            gi0.data_ptr(), None if ckpt is None else ckpt.data_ptr(),
            c_mem.data_ptr(), c_syn.data_ptr(), gcm.data_ptr(),
            gcs.data_ptr(), T, m, v0.shape[-1], int(start),
            _CODES[x_seq.dtype], _CODES[v0.dtype], neurons.LIFParams().alpha,
            chunk, threads, int(vec), smem, stream,
        )
    if rc != 0:
        raise RuntimeError(f"plif_cell_seq_bwd launch failed (code {rc})")
    LAUNCHES["plif_cell_seq_bwd"] += 1
    return gx, gv0, gi0, gcm, gcs


def plif_factor_grads(gcm: torch.Tensor, gcs: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``[C]`` gradients of ``(c_mem, c_syn)`` from the backward
    kernel's per-element sums: one ``torch.sum`` over the rows (a fixed
    order), ``c_syn``'s negated (the kernel sums the cotangent of
    ``-c_syn``)."""
    ch = gcm.shape[-1]
    return gcm.reshape(-1, ch).sum(0), -gcs.reshape(-1, ch).sum(0)


@torch.library.custom_op("soda_torch::plif_cell_seq", mutates_args=(),
                         device_types="cuda")
def _plif_cell_seq_op(x_seq: torch.Tensor, v0: torch.Tensor,
                      i0: torch.Tensor, c_mem: torch.Tensor,
                      c_syn: torch.Tensor, start: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``csrc/plif_cell.cu``'s forward: one launch, or raises."""
    _check_plif_args(x_seq, v0, i0, c_mem, c_syn)
    return _launch_plif_forward(x_seq, v0, i0, c_mem, c_syn, start)


@_plif_cell_seq_op.register_fake
def _(x_seq, v0, i0, c_mem, c_syn, start):
    _check_plif_args(x_seq, v0, i0, c_mem, c_syn)
    return torch.empty_like(x_seq), torch.empty_like(v0), \
        torch.empty_like(i0)


def _plif_setup(ctx, inputs, output):
    # the backward recomputes the states
    *tensors, start = inputs
    ctx.start = start
    ctx.save_for_backward(*tensors)


def _plif_backward(ctx, gz, gv, gi):
    x_seq, v0, i0, c_mem, c_syn = ctx.saved_tensors
    gx, gv0, gi0, gcm, gcs = plif_cell_seq_bwd(
        x_seq, v0, i0, c_mem, c_syn, gz, gv, gi, ctx.start)
    return (gx, gv0, gi0, *plif_factor_grads(gcm, gcs), None)


_plif_cell_seq_op.register_autograd(_plif_backward,
                                    setup_context=_plif_setup)


def plif_cell_seq(
    x_seq: torch.Tensor, v0: torch.Tensor, i0: torch.Tensor,
    c_mem: torch.Tensor, c_syn: torch.Tensor, start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-layer PLIF over T steps: ``(z_seq, v_T, i_T)``, LIF with the
    per-channel Euler factors ``c_mem`` and ``c_syn`` (fp32 ``[C]``,
    ``dt * softplus(raw)`` of the layer's learnable time constants, for
    the trailing axis of the state).

    Arguments and outputs as :func:`temporal_cell_seq`. On a CPU tensor
    this is :func:`plif_cell_seq_reference`, and autograd runs through
    it. On a CUDA tensor it launches ``csrc/plif_cell.cu`` (the PLIF
    form of the cell kernels) on the current stream or raises: through
    the registered operator ``soda_torch::plif_cell_seq`` while traced
    or where autograd records the call, its gradient, the factors'
    included, one launch of the backward kernel
    (:func:`plif_cell_seq_bwd`) and a sum over rows, else directly
    (:func:`_through_operator`).
    """
    _check_plif_args(x_seq, v0, i0, c_mem, c_syn)
    if x_seq.device.type == "cpu":
        return plif_cell_seq_reference(x_seq, v0, i0, c_mem, c_syn, start)
    if x_seq.device.type != "cuda":
        raise ValueError(f"unsupported device {x_seq.device}")
    c_mem, c_syn = c_mem.contiguous(), c_syn.contiguous()
    if _through_operator(x_seq, v0, i0, c_mem, c_syn):
        return torch.ops.soda_torch.plif_cell_seq(x_seq, v0, i0, c_mem,
                                                  c_syn, int(start))
    return _launch_plif_forward(x_seq, v0, i0, c_mem, c_syn, int(start))


@contextlib.contextmanager
def full_fp32_conv():
    """cuDNN runs fp32 convs in TF32 unless told not to; the plain
    versions sum in full fp32, as the kernels and XLA do."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _check_conv_args(x, w, a, b, v0, i0, cell, stride, pad_h=None):
    """Shared checks of the spiking conv; returns ``(k, Ho, Wo, pad_h)``:
    Ho from the rows given and ``pad_h`` (``None``: ``k // 2``), which
    the state's rows must match."""
    if cell not in _CELLS:
        raise ValueError(f"unsupported cell {cell!r}")
    if stride not in (1, 2):
        raise ValueError(f"unsupported stride {stride}")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"x_seq dtype {x.dtype} not in {X_DTYPES}")
    _check_state_dtypes(v0, i0)
    if x.dim() != 5 or w.dim() != 4:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}: want x = "
            "[T, N, H, W, Cin] and w = [k, k, Cin, Cout]"
        )
    _, n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    if k not in (1, 3) or tuple(w.shape[1:3]) != (k, cin):
        raise ValueError(f"w {tuple(w.shape)}: want [k, k, {cin}, Cout], "
                         "k in (1, 3)")
    pad_h = k // 2 if pad_h is None else pad_h
    if pad_h not in (0, k // 2) or h + 2 * pad_h < k:
        raise ValueError(f"pad_h {pad_h} with k={k} and {h} rows: want "
                         f"{k // 2}, or 0 for fetched rows (at least {k})")
    ho = (h + 2 * pad_h - k) // stride + 1
    wo = (wd + 2 * (k // 2) - k) // stride + 1
    if tuple(v0.shape) != (n, ho, wo, cout) or v0.shape != i0.shape \
            or tuple(a.shape) != (cout,) or tuple(b.shape) != (cout,):
        raise ValueError(
            f"shapes v0 {tuple(v0.shape)}, i0 {tuple(i0.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}: want state "
            f"{(n, ho, wo, cout)} and a, b ({cout},)"
        )
    if len({t.device for t in (x, w, a, b, v0, i0)}) != 1:
        raise ValueError("all inputs must be on one device")
    return k, ho, wo, pad_h


# ---- the launch plan of csrc/spiking_conv.cu ----

SC_TB = 4  # steps a block: a thread's rows of the product (kTB)
SC_THREADS = (256, 128)  # threads a CTA the plans take (at most kMaxThreads)
SC_MAX_SMEM = 232448  # kMaxSmem: 227 KB, the most a CTA can have
SC_SM_SMEM = 233472  # 228 KB an SM, of which the card keeps
SC_CTA_RESERVED = 1024  # per CTA
SC_REGS = 128  # registers a thread at most: 2 CTAs of 256 (launch bounds)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How ``csrc/spiking_conv.cu`` runs one layer: the CTA's weights
    staged once (``resident``) or with each chunk of input channels,
    CTAs of ``co`` output channels x a ``th`` x ``tw`` tile of output
    pixels (the 4 steps of a block each), ``threads`` threads, input
    channels staged ``kc`` at a time, ``smem`` bytes of shared memory,
    ``grid`` CTAs."""

    resident: bool
    co: int
    th: int
    tw: int
    threads: int
    kc: int
    smem: int
    grid: int


def spiking_conv_smem(resident: bool, k: int, stride: int, cin: int,
                      co: int, th: int, tw: int, kc: int,
                      x_bytes: int) -> int:
    """Shared memory bytes of one CTA (the source's ``conv_smem``): fp32
    weights ``[Cin][k*k][co]`` if resident, else two buffers of a
    chunk's ``[kc][k*k][co]``; the raw rows of a chunk (a halo pixel's
    step, ``kc`` channels of x's type, padded by 16 bytes); the chunk as
    fp32 planes ``[kc][pixel][step]``, each padded to 4 mod 32 words."""
    hin = (th - 1) * stride + 3 if k == 3 else th
    win = (tw - 1) * stride + 3 if k == 3 else tw
    plane = hin * win * SC_TB
    plane += (36 - plane % 32) % 32
    row = -(-kc * x_bytes // 16) * 16 + 16
    return (4 * (cin if resident else 2 * kc) * k * k * co
            + hin * win * SC_TB * row + 4 * kc * plane)


def spiking_conv_grid(n: int, ho: int, wo: int, cout: int, co: int, th: int,
                      tw: int) -> int:
    """CTAs of one layer (``grid_of`` in the source, which checks the
    plan's grid against it)."""
    return n * -(-ho // th) * -(-wo // tw) * -(-cout // co)


def spiking_conv_ctas_per_sm(plan: ConvPlan) -> int:
    """CTAs of ``plan`` that fit one SM: by shared memory, by threads
    (2048), by registers (at most ``SC_REGS`` a thread)."""
    return max(1, min(SC_SM_SMEM // (plan.smem + SC_CTA_RESERVED),
                      2048 // plan.threads,
                      65536 // (SC_REGS * plan.threads)))


def spiking_conv_plans(k: int, stride: int, n: int, ho: int, wo: int,
                       cin: int, cout: int,
                       x_dtype: torch.dtype) -> List[ConvPlan]:
    """Every plan the kernel takes for a layer: a channel tile of 64, 32,
    16 or 8 (no wider than Cout needs), 256 or 128 threads, pixel tiles
    16 or 8 columns wide, weights resident or streamed with the chunks,
    and the widest chunk of 32, 16 or 8 input channels (all of them if
    fewer) that fits one CTA an SM, and the widest that fits two. Every
    plan sums each output in the same order, so all give the same
    bits."""
    x_bytes = x_dtype.itemsize
    plans = []
    widest = max(8, -(-cout // 8) * 8)
    for co in (c for c in (64, 32, 16, 8) if c <= widest):
        for threads in SC_THREADS:
            tp = threads // (co // 8)
            for tw, resident in itertools.product((16, 8), (True, False)):
                if tp % tw:
                    continue
                for most in (SC_MAX_SMEM, SC_SM_SMEM // 2 - SC_CTA_RESERVED):
                    for kc in sorted({min(cin, c) for c in (32, 16, 8)},
                                     reverse=True):
                        smem = spiking_conv_smem(resident, k, stride, cin, co,
                                                 tp // tw, tw, kc, x_bytes)
                        plan = ConvPlan(
                            resident, co, tp // tw, tw, threads, kc, smem,
                            spiking_conv_grid(n, ho, wo, cout, co, tp // tw,
                                              tw))
                        if smem <= most:
                            if plan not in plans:
                                plans.append(plan)
                            break
    return plans


def _plan_cost(plan: ConvPlan, k: int, stride: int, cin: int,
               sms: int) -> float:
    """Relative time of a plan, fitted to every plan's time on the GEN1
    layers on the H100 (``scripts/spiking_conv_ab.py plans``; PERF.md,
    PR 9). The CTAs an SM (``ceil(grid / sms)``) run in rounds of as
    many as fit; a round costs the work of the CTAs it runs, slowed by
    the square root of the share of 16 warps an SM they leave idle. A
    part-filled last round costs less than a full one, since CTAs do not
    finish in step: the slots are 3/4 whole rounds, 1/4 the even spread
    ``grid / sms``. A CTA's work, a step: its multiply-adds over its
    whole tile (ragged edges included; 5% more at 64 channels, whose
    weight loads cross 256 bytes and meet in the banks), ten more per
    staged halo element and per streamed weight, and a chunk's barriers
    and pipeline bubble (512 a thread)."""
    per_sm = spiking_conv_ctas_per_sm(plan)
    a_sm = -(-plan.grid // sms)
    conc = min(per_sm, a_sm)
    rounds = -(-a_sm // per_sm)
    slots = 0.75 * rounds * conc + 0.25 * plan.grid / sms
    work = plan.th * plan.tw * plan.co * cin * k * k
    if plan.co == 64:
        work *= 1.05
    hin = (plan.th - 1) * stride + 3 if k == 3 else plan.th
    win = (plan.tw - 1) * stride + 3 if k == 3 else plan.tw
    work += 10 * hin * win * cin
    if not plan.resident:
        work += 10 * k * k * plan.co * cin / SC_TB
    work += 512 * plan.threads * -(-cin // plan.kc) / SC_TB
    warps = conc * plan.threads // 32
    return slots * work / min(1.0, warps / 16) ** 0.5


@functools.lru_cache(maxsize=256)
def spiking_conv_plan(k: int, stride: int, n: int, ho: int, wo: int,
                      cin: int, cout: int, x_dtype: torch.dtype,
                      sms: int, pad_h: Optional[int] = None) -> ConvPlan:
    """The launch plan of one ``spiking_conv_seq`` layer on a card of
    ``sms`` SMs: of :func:`spiking_conv_plans`, the one of least
    :func:`_plan_cost` (the first of equals). The plan never changes
    results (``chip_smoke.py`` [3] holds every plan bit-equal and times
    it). ``pad_h`` (``k // 2``, or 0 for fetched rows) moves where a
    CTA's halo tile starts, not its size: a block of rows takes the plan
    of its own output size. Cached: a layer's plan is computed once."""
    if pad_h not in (None, 0, k // 2):
        raise ValueError(f"spiking_conv_seq: pad_h {pad_h} with k={k}")
    plans = spiking_conv_plans(k, stride, n, ho, wo, cin, cout, x_dtype)
    if not plans:
        raise ValueError(f"spiking_conv_seq: no launch plan for k={k}, "
                         f"Cin={cin}, Cout={cout}")
    return min(plans, key=lambda p: _plan_cost(p, k, stride, cin, sms))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``: one wave of the launch plan."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def spiking_conv_seq_reference(
    x_seq: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    v0: torch.Tensor, i0: torch.Tensor, cell: str = "lif", stride: int = 1,
    exact_sums: bool = False, pad_h: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`spiking_conv_seq` (``pad_h`` as
    there), a loop over T:
    the conv on fp32-upcast x and w (bf16 products are exact in fp32, so
    this is the fp32-accumulated conv), rounded to x's dtype; ``y * a +
    b`` in fp32 rounded once (``neurons.fma``: XLA contracts it inside
    the TPU kernel) and rounded to x's dtype again; then ``lif_step`` /
    ``li_step`` with the state rounded to its storage dtype every step.

    ``exact_sums`` runs the conv in float64 and rounds it once to fp32;
    everything after it rounds as before, so the run differs from the
    default only in the conv sums (the reference of the witness,
    ``megakernel.run_distance``)."""
    k, _, _, pad_h = _check_conv_args(x_seq, w, a, b, v0, i0, cell, stride,
                                      pad_h)
    xd, sd = x_seq.dtype, v0.dtype
    cdt = torch.float64 if exact_sums else torch.float32
    w_oihw = w.to(xd).to(cdt).permute(3, 2, 0, 1)
    a32, b32 = a.float(), b.float()
    step = neurons.lif_step if cell == "lif" else neurons.li_step
    v, i = v0.float(), i0.float()
    z = torch.empty(x_seq.shape[:2] + v0.shape[1:], dtype=xd,
                    device=x_seq.device)
    with full_fp32_conv():
        for t in range(x_seq.shape[0]):
            y = F.conv2d(x_seq[t].to(cdt).permute(0, 3, 1, 2), w_oihw,
                         stride=stride, padding=(pad_h, k // 2)
                         ).permute(0, 2, 3, 1).float()
            y = neurons.fma(y.to(xd).float(), a32, b32).to(xd).float()
            out, (v, i) = step(y, (v, i))
            z[t] = out.to(xd)
            v = neurons.to_state(v, sd).float()
            i = neurons.to_state(i, sd).float()
    return z, neurons.to_state(v, sd), neurons.to_state(i, sd)


_KERNEL_WEIGHTS: "collections.OrderedDict" = collections.OrderedDict()
_KERNEL_WEIGHTS_MAX = 64  # weight tensors kept: a GEN1 net has 22 convs


def spiking_conv_weights(w: torch.Tensor,
                         x_dtype: torch.dtype) -> torch.Tensor:
    """``w [k, k, Cin, Cout]`` rounded to ``x_dtype``, as the fp32
    ``[Cin][k][k][Cout]`` that ``csrc/spiking_conv.cu`` reads (a chunk's
    weights in one run). Eval weights do not change between steps, so
    the copy is kept, keyed on w's storage, view and version (an
    in-place update makes a new key); the entry holds w, so no other
    tensor takes its storage while it is kept. Inference tensors have no
    version and are copied every call."""
    key = None
    if not w.is_inference():
        key = (w.device, w.untyped_storage().data_ptr(), w.storage_offset(),
               tuple(w.shape), w.stride(), w.dtype, w._version, x_dtype)
        hit = _KERNEL_WEIGHTS.get(key)
        if hit is not None:
            _KERNEL_WEIGHTS.move_to_end(key)
            return hit[1]
    with torch.no_grad():
        out = w.to(x_dtype).float().permute(2, 0, 1, 3).contiguous()
    if key is not None:
        _KERNEL_WEIGHTS[key] = (w, out)
        if len(_KERNEL_WEIGHTS) > _KERNEL_WEIGHTS_MAX:
            _KERNEL_WEIGHTS.popitem(last=False)
    return out


def spiking_conv_seq(
    x_seq: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    v0: torch.Tensor, i0: torch.Tensor, cell: str = "lif", stride: int = 1,
    pad_h: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused [k x k conv (stride 1 or 2, zero padding k // 2) -> eval
    BatchNorm affine -> LIF / LI] over a whole sequence: ``(z_seq, v_T,
    i_T)``. Inference only: no truncation.

    ``pad_h``: the zero rows above and below the map, ``k // 2`` (the
    default) or 0: the fetched-rows form, for a block of a map split
    along H (``parallel/halo.py``), whose rows ``x_seq`` holds with the
    halo and the zero rows beyond the map's edge already in place (W
    keeps its padding). The output rows are ``(H + 2 pad_h - k) //
    stride + 1``; ``v0`` must have as many. Each output sums as in the
    whole map's launch, so a block's rows are the whole map's bit for
    bit.

    :param x_seq: ``[T, N, H, W, Cin]``, fp32 or bf16.
    :param w: ``[k, k, Cin, Cout]`` (the JAX layout), k in (1, 3); cast
        to x's dtype.
    :param a: ``[Cout]`` folded BatchNorm scale, cast to fp32.
    :param b: ``[Cout]`` folded BatchNorm offset, cast to fp32.
    :param v0: ``[N, Ho, Wo, Cout]`` initial membrane, fp32, bf16 or fp8
        (e5m2, e4m3fn).
    :param i0: initial current, same shape and dtype as ``v0``.
    :return: ``z_seq [T, N, Ho, Wo, Cout]`` in x's dtype (spikes for LIF,
        the fp32 membrane before quantization for LI); ``v_T``, ``i_T``
        in the state dtype.

    On a CPU tensor this is :func:`spiking_conv_seq_reference`. On a
    CUDA tensor it launches ``csrc/spiking_conv.cu`` on the current
    stream or raises; ``x_seq``, ``v0`` and ``i0`` must be contiguous.
    """
    _, ho, wo, pad = _check_conv_args(x_seq, w, a, b, v0, i0, cell, stride,
                                      pad_h)
    if x_seq.device.type == "cpu":
        return spiking_conv_seq_reference(
            x_seq, w, a, b, v0, i0, cell, stride,
            **({} if pad_h is None else {"pad_h": pad_h}))
    if x_seq.device.type != "cuda":
        raise ValueError(f"unsupported device {x_seq.device}")
    _require_contiguous(x_seq=x_seq, v0=v0, i0=i0)
    plan = spiking_conv_plan(w.shape[0], stride, x_seq.shape[1], ho, wo,
                             x_seq.shape[4], w.shape[3], x_seq.dtype,
                             sm_count(x_seq.device.index), pad)
    return spiking_conv_seq_launch(x_seq, w, a, b, v0, i0, cell, stride,
                                   plan, pad)


def spiking_conv_seq_launch(
    x_seq: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    v0: torch.Tensor, i0: torch.Tensor, cell: str, stride: int,
    plan: ConvPlan, pad_h: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/spiking_conv.cu`` under ``plan``, for
    arguments :func:`spiking_conv_seq` has checked (``chip_smoke.py``
    runs every other plan of the layer through it); the entry point
    refuses a plan that is not its geometry's, and output rows that are
    not those of the rows given and ``pad_h`` (``None``: ``k // 2``).
    The weights go as :func:`spiking_conv_weights` keeps them."""
    T, n, h, wd, cin = x_seq.shape
    k, cout = w.shape[0], w.shape[3]
    pad_h = k // 2 if pad_h is None else pad_h
    ho, wo = v0.shape[1:3]
    w = spiking_conv_weights(w, x_seq.dtype)
    a, b = a.float().contiguous(), b.float().contiguous()
    z = torch.empty((T, n, ho, wo, cout), dtype=x_seq.dtype,
                    device=x_seq.device)
    v_t = torch.empty_like(v0)
    i_t = torch.empty_like(i0)
    c_mem, c_syn = _euler(cell)
    with torch.cuda.device(x_seq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _spiking_conv_lib()(
            x_seq.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            v0.data_ptr(), i0.data_ptr(), z.data_ptr(), v_t.data_ptr(),
            i_t.data_ptr(), T, n, h, wd, cin, ho, wo, cout, k, stride,
            pad_h, int(plan.resident), plan.co, plan.th, plan.tw,
            plan.threads, plan.kc, plan.smem, plan.grid,
            _CELLS[cell], _CODES[x_seq.dtype], _CODES[v0.dtype], c_mem,
            c_syn, stream,
        )
    if rc != 0:
        raise RuntimeError(f"spiking_conv_seq launch failed (code {rc})")
    LAUNCHES["spiking_conv_seq"] += 1
    return z, v_t, i_t


def _check_pointwise_args(x, w, a, b, v, i):
    if x.dtype not in X_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w dtypes ({x.dtype}, {w.dtype}) must match "
                        f"and be one of {X_DTYPES}")
    _check_state_dtypes(v, i)
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] \
            or tuple(v.shape) != (x.shape[0], w.shape[1]) \
            or v.shape != i.shape or tuple(a.shape) != (w.shape[1],) \
            or tuple(b.shape) != (w.shape[1],):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, v {tuple(v.shape)}, i "
            f"{tuple(i.shape)}: want x [N, Cin], w [Cin, Cout], a, b "
            "[Cout], v, i [N, Cout]"
        )
    if len({t.device for t in (x, w, a, b, v, i)}) != 1:
        raise ValueError("all inputs must be on one device")


def fused_pointwise_conv_bn_lif_reference(
    x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    v: torch.Tensor, i: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_pointwise_conv_bn_lif`
    (the JAX package's ``xla_pointwise_conv_bn_lif``): ``x @ w`` summed
    in fp32, ``y * a + b`` in fp32 rounded once and not rounded to x's
    dtype, then one LIF step with the reset ``(1 - z) * v_dec``."""
    _check_pointwise_args(x, w, a, b, v, i)
    c_mem, c_syn = _euler("lif")
    y = neurons.fma(x.float() @ w.float(), a.float(), b.float())
    vf, if_ = v.float(), i.float()
    v_dec = neurons.fma(if_ - vf, c_mem, vf)
    i_dec = neurons.fma(if_, -c_syn, if_)
    z = (v_dec > neurons.LIFParams().v_th).float()
    return ((z.to(x.dtype), neurons.to_state((1.0 - z) * v_dec, v.dtype),
             neurons.to_state(i_dec + y, i.dtype)))


# ---- the launch plan of csrc/pointwise.cu ----

PW_THREADS = {2: 256, 4: 128}  # a CTA, by x's size: mma, FFMA
PW_MAX_SMEM = 232448  # 227 KB: the most a CTA can have on the H100
PW_SM_SMEM = 233472  # 228 KB an SM, of which the card keeps
PW_CTA_RESERVED = 1024  # per CTA
PW_SLAB_MAX = 135168  # 132 KB: the largest resident weight slab
PW_STAGES = 2  # the ring's depth (the source's kStages)
PW_CTAS_PER_SM = {2: 2, 4: 4}  # the most a plan asks for: mma, FFMA


@dataclasses.dataclass(frozen=True)
class PointwisePlan:
    """How ``csrc/pointwise.cu`` runs one call: row tiles of ``rows``
    rows, ``splits`` CTAs of ``cout_tile`` output channels each per row
    tile, ``smem`` bytes of shared memory a CTA (the weight slab and a
    ring of ``PW_STAGES`` row tiles), ``grid`` persistent CTAs
    (``ctas_per_sm`` an SM) of ``threads`` threads."""

    rows: int
    cout_tile: int
    splits: int
    smem: int
    grid: int
    ctas_per_sm: int
    threads: int


def _pw_sizes(x_dtype, state_dtype) -> Tuple[int, int]:
    return (torch.empty((), dtype=x_dtype).element_size(),
            torch.empty((), dtype=state_dtype).element_size())


def pointwise_smem(cin: int, cout_tile: int, rows: int, sx: int,
                   ss: int) -> Tuple[int, int]:
    """``(weight slab bytes, shared memory bytes)`` of one CTA: the
    source's ``geometry``. Every shared row is padded by 16 bytes; the
    product's k step is 16 (bf16, mma) or 4 (fp32, FFMA), a state row
    holds whole 16-byte items, and z takes x's slot after the product."""
    mma, ch, xw = sx == 2, 16 // ss, 16 // sx
    kstep, nstep = (16, 8) if mma else (4, 4)
    kpad = -(-cin // kstep) * kstep
    wc = -(-cout_tile // nstep) * nstep
    vc = -(-cout_tile // ch) * ch
    zs = -(-vc // xw) * xw + xw
    w_bytes = kpad * (wc + xw) * sx
    ab_bytes = -(-2 * wc * 4 // 16) * 16
    stage = rows * max(kpad + xw, zs) * sx + 2 * rows * (vc + ch) * ss
    return w_bytes, w_bytes + ab_bytes + PW_STAGES * stage


def pointwise_rows(cout_tile: int, sx: int) -> List[int]:
    """Row-tile heights the kernel takes for ``cout_tile`` channels,
    largest first: with mma (256 threads), 16 rows a warp (at most 8 n8
    tiles a warp); with FFMA (128 threads), 4, 2 or 1 rows a thread of 8
    channels, channel groups a power of two from 1 to 16 (so at most 128
    channels)."""
    threads = PW_THREADS[sx]
    if sx == 2:
        n8 = -(-cout_tile // 8)
        warps = threads // 32
        return [r for r in (128, 64, 32, 16)
                if -(-n8 // (warps // (r // 16))) <= 8]
    cgp = 1
    while cgp * 8 < cout_tile:
        cgp *= 2
    if cgp > 16:
        return []
    return [threads // cgp * rm for rm in (4, 2, 1)]


def pointwise_grid(n: int, rows: int, splits: int, sms: int,
                   ctas_per_sm: int) -> int:
    """Persistent CTAs: one a work item (row tile x Cout split) up to
    ``sms * ctas_per_sm``, a multiple of the splits so that each CTA
    keeps one slab; the splits of a row tile are neighbours."""
    items = -(-n // rows) * splits
    most = max(splits, sms * ctas_per_sm // splits * splits)
    return min(items, most)


def pointwise_plan(n: int, cin: int, cout: int, x_dtype: torch.dtype,
                   state_dtype: torch.dtype, sms: int,
                   ctas_per_sm: Optional[int] = None) -> PointwisePlan:
    """The launch plan of one ``fused_pointwise_conv_bn_lif`` call on a
    card of ``sms`` SMs.

    ``cout_tile`` is Cout wherever its weight slab fits in
    ``PW_SLAB_MAX`` (and, in fp32, Cout <= 128), so x is read once; else
    Cout is split into the fewest tiles that fit. Then, of the row tiles
    and CTAs an SM (up to 2 of 256 threads for bf16, mma; up to 4 of 128
    for fp32, FFMA) whose slab and ring fit, the most rows in flight an
    SM (rows x CTAs), then more CTAs, taking the first that gives every
    CTA of the grid a row tile (else the one with the most row tiles):
    on the H100 an SM's throughput grows with the rows it works on at
    once (PERF.md, Findings).
    ``ctas_per_sm`` is what the card reports for the instance
    (``pointwise_occupancy``); without it the plan's own count is used.
    """
    sx, ss = _pw_sizes(x_dtype, state_dtype)
    unit = math.lcm(8 if sx == 2 else 4, 16 // ss)
    splits = 1
    while True:
        tile = -(-cout // splits)
        tile = min(cout, -(-tile // unit) * unit)
        if pointwise_smem(cin, tile, 0, sx, ss)[0] <= PW_SLAB_MAX \
                and pointwise_rows(tile, sx):
            break
        if tile <= unit:
            raise ValueError(f"Cin = {cin}: no weight slab fits")
        splits += 1
    splits = -(-cout // tile)

    fits = []  # (rows, ctas, smem)
    for ctas in range(PW_CTAS_PER_SM[sx], 0, -1):
        for rows in pointwise_rows(tile, sx):
            smem = pointwise_smem(cin, tile, rows, sx, ss)[1]
            if smem <= PW_MAX_SMEM and ctas * (
                    smem + PW_CTA_RESERVED) <= PW_SM_SMEM:
                fits.append((rows, ctas, smem))
    if not fits:
        raise ValueError(f"no launch plan for Cin = {cin}, Cout = {cout}")
    # most rows in flight an SM, then more CTAs
    fits.sort(key=lambda f: (f[0] * f[1], f[1]), reverse=True)
    full = [f for f in fits if -(-n // f[0]) * splits >= sms * f[1]]
    rows, ctas, smem = full[0] if full else min(fits)
    per_sm = ctas if ctas_per_sm is None else ctas_per_sm
    return PointwisePlan(rows, tile, splits, smem,
                         pointwise_grid(n, rows, splits, sms, per_sm), per_sm,
                         PW_THREADS[sx])


@functools.lru_cache(maxsize=None)
def pointwise_occupancy(index: int, x_dtype: torch.dtype,
                        state_dtype: torch.dtype, cin: int, rows: int,
                        cout_tile: int, threads: int, smem: int) -> int:
    """CTAs of the ``csrc/pointwise.cu`` instance that a plan of ``rows``
    x ``cout_tile`` and ``threads`` threads runs for these dtypes that
    fit one SM of CUDA device ``index`` at ``smem`` bytes of shared
    memory (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = _pointwise_lib("pointwise_occupancy")(
            _CODES[x_dtype], _CODES[state_dtype], cin, rows, cout_tile,
            threads, smem, ctypes.addressof(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"pointwise occupancy query failed (code {rc}, "
                           f"{blocks.value} CTAs an SM)")
    return blocks.value


@functools.lru_cache(maxsize=256)
def pointwise_plan_on(index: int, n: int, cin: int, cout: int,
                      x_dtype: torch.dtype,
                      state_dtype: torch.dtype) -> PointwisePlan:
    """The plan :func:`fused_pointwise_conv_bn_lif` launches on CUDA
    device ``index``: :func:`pointwise_plan` with the card's SMs and the
    CTAs an SM it reports for the plan's shared memory."""
    sms = sm_count(index)
    plan = pointwise_plan(n, cin, cout, x_dtype, state_dtype, sms)
    return pointwise_plan(n, cin, cout, x_dtype, state_dtype, sms,
                          pointwise_occupancy(index, x_dtype, state_dtype,
                                              cin, plan.rows, plan.cout_tile,
                                              plan.threads, plan.smem))


def fused_pointwise_conv_bn_lif(
    x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    v: torch.Tensor, i: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused pass of ``[N, Cin] @ [Cin, Cout]`` -> BatchNorm affine
    -> one LIF step: ``(z, v', i')``, all ``[N, Cout]``.

    :param x: ``[N, Cin]`` fp32 or bf16, any N; ``w`` ``[Cin, Cout]`` of
        the same dtype.
    :param a: ``[Cout]`` folded BatchNorm scale, cast to fp32; ``b`` the
        offset.
    :param v: ``[N, Cout]`` membrane, fp32, bf16 or fp8 (e5m2,
        e4m3fn); ``i`` the
        current, same dtype.
    :return: ``z`` in x's dtype, ``v'`` and ``i'`` in the state dtype.

    On a CPU tensor this is :func:`fused_pointwise_conv_bn_lif_reference`.
    On a CUDA tensor it launches ``csrc/pointwise.cu`` once, under
    :func:`pointwise_plan` with the card's occupancy, on the current
    stream, or raises; ``x``, ``v`` and ``i`` must be contiguous.
    """
    _check_pointwise_args(x, w, a, b, v, i)
    if x.device.type == "cpu":
        return fused_pointwise_conv_bn_lif_reference(x, w, a, b, v, i)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _require_contiguous(x=x, v=v, i=i)
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    plan = pointwise_plan_on(index, x.shape[0], x.shape[1], w.shape[1],
                             x.dtype, v.dtype)
    return fused_pointwise_launch(x, w, a, b, v, i, plan)


def fused_pointwise_launch(
    x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    v: torch.Tensor, i: torch.Tensor, plan: PointwisePlan,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/pointwise.cu`` under ``plan``, for arguments
    :func:`fused_pointwise_conv_bn_lif` has checked (``chip_smoke.py``
    and the card tests run other plans through it); the entry point
    refuses a plan whose shared memory or grid does not match."""
    w = w.contiguous()
    a, b = a.float().contiguous(), b.float().contiguous()
    z = torch.empty(v.shape, dtype=x.dtype, device=x.device)
    v_out = torch.empty_like(v)
    i_out = torch.empty_like(i)
    c_mem, c_syn = _euler("lif")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _pointwise_lib("fused_pointwise_launch")(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            v.data_ptr(), i.data_ptr(), z.data_ptr(), v_out.data_ptr(),
            i_out.data_ptr(), x.shape[0], x.shape[1], w.shape[1], plan.rows,
            plan.cout_tile, plan.threads, plan.smem, plan.grid,
            _CODES[x.dtype], _CODES[v.dtype], c_mem, c_syn, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_pointwise_conv_bn_lif launch failed (code {rc})"
        )
    LAUNCHES["fused_pointwise_conv_bn_lif"] += 1
    return z, v_out, i_out


# ---- the streaming megakernel (csrc/megakernel.cu) ----

# op table of csrc/megakernel.cu: one row of int32 fields per op. An
# activation is read or written at ``off + pixel * c + ch_off +
# channel``: the root buffer's offset and channels, and where the op's
# slice starts in it (``src_*`` input, ``res_*`` Residual input, ``dst``
# output).
MK_FIELDS = (
    "kind", "src_space", "src_off", "src_c", "src_ch_off", "res_space",
    "res_off", "res_c", "res_ch_off", "dst_space", "dst_off", "dst_c",
    "ch_off", "h", "w", "cin", "ho", "wo", "cout", "k", "stride", "w_off",
    "nk_off", "nb_off", "cell", "slot_v", "slot_i", "act", "pool", "tiles",
    "tile0", "bn", "split", "scratch_off", "counter_off", "vec_a", "vec_b",
)
_MK_ROW = 40
_MK_KINDS = {"conv": 0, "ew": 1, "pool": 2, "up": 3, "add": 4, "copy": 5}
_MK_SPACES = {"ws": 0, "frame": 1, "preds": 2}
_MK_ACTS = {None: 0, "relu": 1, "silu": 2, "tanh": 3}
_MK_POOLS = {"M": 0, "A": 1, "S": 2}
_MK_EW_TILE = 1024  # elements of an elementwise tile: 256 threads x 4
_MK_BK = 16  # K-chunk of a conv tile
_MK_MAX_SPLIT = 16
_MK_MAX_SLOTS = 128
_MK_BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__ minimum
_FRAME_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 3}


def _megakernel_lib(name: str):
    fn = getattr(cuda_build.load("megakernel.cu"), name)
    if fn.argtypes is None:
        if name == "megakernel_occupancy":
            fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        else:
            fn.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_int]     # ops, phases, n
                + [ctypes.c_void_p] * 3 + [ctypes.c_int]   # w, ws, frame, dt
                + [ctypes.c_void_p] * 6 + [ctypes.c_int]   # preds, scratch,
                # tile counters, barrier, state in / out pointers, slots
                + [ctypes.c_int] * 2 + [ctypes.c_float] * 4
                + [ctypes.c_int] + [ctypes.c_void_p] * 2   # grid, timeline,
                # stream
            )
        fn.restype = ctypes.c_int
    return fn


def _conv_tile(cout: int) -> Tuple[int, int]:
    """(BM, BN) of a conv tile: 64 x 64, or 128 x 32 for narrow convs."""
    return (128, 32) if cout <= 32 else (64, 64)


def _conv_split(tiles: int, k: int, grid: Optional[int]) -> int:
    """Slices of K a conv with ``tiles`` output tiles and reduction depth
    ``k`` is split into, so that a phase of it fills about ``grid``
    blocks: 1 (no split) without a grid or when its tiles fill half of
    it; each slice keeps at least 4 chunks of 16."""
    if grid is None or 2 * tiles > grid:
        return 1
    return max(1, min(grid // tiles, k // (4 * _MK_BK), _MK_MAX_SPLIT))


@dataclasses.dataclass
class OpTable:
    """A megakernel plan as the kernel reads it: the int32 op table
    ``rows [ops, 40]`` (sorted by phase), the phase table ``phases
    [phases, 3]`` (first op, end op, tiles), and the fp32 split-K
    scratch and int32 tile counters the launch needs."""

    rows: torch.Tensor
    phases: torch.Tensor
    scratch: int
    counters: int


def megakernel_op_table(plan, grid: Optional[int] = None) -> OpTable:
    """The op table of a megakernel plan, on the CPU.

    Every op runs in its plan phase (``megakernel.op_phases``). With
    ``grid`` (the blocks of the launch), a conv whose tiles fill less
    than half the grid is split along K: each slice of an output tile
    writes its fp32 partial sums to scratch and arrives on the tile's
    counter, and the slice that arrives last sums the slices in order
    and runs the epilogue, in the same phase. Split convs of one phase
    take disjoint scratch and counters; the next phase reuses them."""
    x_bytes = torch.empty((), dtype=plan.compute_dtype).element_size()
    vec = 16 // x_bytes  # elements of a 16-byte copy
    n_phases = max(plan.phases) + 1
    scratch_at = [0] * n_phases
    counter_at = [0] * n_phases
    entries = []  # (phase, fields)

    def where(buf):
        b = plan.buffers[buf]
        root, ch_off = plan.locate(buf)
        rb = plan.buffers[root]
        return _MK_SPACES[b.space], rb.offset, rb.shape[2], ch_off

    for op, phase in zip(plan.ops, plan.phases):
        src, dst = plan.buffers[op.src], plan.buffers[op.dst]
        h, w, cin = src.shape
        ho, wo, cout = dst.shape
        f = dict(kind=_MK_KINDS[op.kind], h=h, w=w, cin=cin, ho=ho, wo=wo,
                 cout=cout, k=op.k, stride=op.stride, w_off=op.w,
                 nk_off=op.norm[0] if op.norm else -1,
                 nb_off=op.norm[1] if op.norm else -1,
                 cell={None: -1, "lif": 0, "li": 1}[op.cell],
                 slot_v=op.slots[0], slot_i=op.slots[1],
                 act=_MK_ACTS[op.act], pool=_MK_POOLS[op.pool], bn=0,
                 split=1, scratch_off=-1, counter_off=-1, vec_a=0, vec_b=0)
        (f["src_space"], f["src_off"], f["src_c"],
         f["src_ch_off"]) = where(op.src)
        (f["res_space"], f["res_off"], f["res_c"], f["res_ch_off"]) = (
            where(op.res) if op.res >= 0 else (-1, -1, 0, 0))
        (f["dst_space"], f["dst_off"], f["dst_c"], f["ch_off"]) = where(op.dst)
        if op.kind == "conv":
            bm, f["bn"] = _conv_tile(cout)
            tiles = -(-(ho * wo) // bm) * -(-cout // f["bn"])
            split = _conv_split(tiles, op.k * op.k * cin, grid)
            f["tiles"] = tiles * split
            # 16 channels of one tap are one 16-byte-aligned run in NHWC
            f["vec_a"] = int(f["src_space"] == _MK_SPACES["ws"]
                             and cin % _MK_BK == 0 and f["src_c"] % vec == 0
                             and f["src_ch_off"] % vec == 0)
            f["vec_b"] = int(cout % vec == 0 and op.w % vec == 0)
            if split > 1:
                f.update(split=split, scratch_off=scratch_at[phase],
                         counter_off=counter_at[phase])
                # 16-byte rows of partial sums: offsets in whole lines
                scratch_at[phase] += -(-split * ho * wo * cout // 64) * 64
                counter_at[phase] += tiles
        else:
            numel = ho * wo * cin if op.kind in ("pool", "up") else h * w * cin
            f["tiles"] = -(-numel // _MK_EW_TILE)
        entries.append((phase, f))
    entries.sort(key=lambda e: e[0])  # stable: emission order in a phase
    rows = torch.full((len(entries), _MK_ROW), -1, dtype=torch.int32)
    phases = torch.zeros((n_phases, 3), dtype=torch.int32)
    phases[:, 0] = len(entries)
    for n, (phase, f) in enumerate(entries):
        f["tile0"] = int(phases[phase, 2])
        rows[n, :len(MK_FIELDS)] = torch.tensor(
            [f[k] for k in MK_FIELDS], dtype=torch.int32)
        phases[phase, 0] = min(int(phases[phase, 0]), n)
        phases[phase, 1] = n + 1
        phases[phase, 2] += f["tiles"]
    return OpTable(rows, phases, max(scratch_at), max(counter_at))


def prepare_megakernel(plan) -> None:
    """Size the launch to the card (two co-resident blocks an SM, as the
    kernel's launch bounds ask), then upload the plan's op and phase
    tables and allocate its workspace, split-K scratch, tile counters and
    barrier counter there (once, before the first launch)."""
    if len(plan.slots) > _MK_MAX_SLOTS:
        raise ValueError(f"{len(plan.slots)} state slots; the megakernel "
                         f"takes at most {_MK_MAX_SLOTS}")
    big = max(plan.ws_numel, plan.weight_numel, plan.preds_numel)
    if big >= 2 ** 31:
        raise ValueError("plan too large for 32-bit offsets")
    dev = plan.device
    with torch.cuda.device(dev):
        blocks, sms = ctypes.c_int(0), ctypes.c_int(0)
        rc = _megakernel_lib("megakernel_occupancy")(
            _CODES[plan.compute_dtype], _CODES[plan.state_dtype],
            ctypes.addressof(blocks), ctypes.addressof(sms))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"streaming_megakernel: occupancy query failed "
                           f"(code {rc}, {blocks.value} blocks per SM)")
    blocks_per_sm = min(blocks.value, _MK_BLOCKS_PER_SM)
    grid = blocks_per_sm * sms.value
    table = megakernel_op_table(plan, grid)
    if table.scratch >= 2 ** 31:
        raise ValueError("plan too large for 32-bit offsets")
    plan.cuda = dict(
        ops=table.rows.to(dev), phases=table.phases.to(dev),
        workspace=torch.empty(max(plan.ws_numel, 1),
                              dtype=plan.compute_dtype, device=dev),
        scratch=torch.empty(max(table.scratch, 1), dtype=torch.float32,
                            device=dev),
        # every split conv's last slice sets its counters back to zero
        counters=torch.zeros(max(table.counters, 1), dtype=torch.int32,
                             device=dev),
        barrier=torch.zeros(2, dtype=torch.int32, device=dev),
        blocks_per_sm=blocks_per_sm, sms=sms.value, grid=grid,
    )


def _check_megakernel_args(plan, x, state_vals) -> None:
    if x.dtype not in _FRAME_CODES:
        raise TypeError(f"frame dtype {x.dtype} not in {tuple(_FRAME_CODES)}")
    want = plan.buffers[0].shape
    if tuple(x.shape) != want:
        raise ValueError(f"frame shape {tuple(x.shape)}, want {want}")
    if len(state_vals) != len(plan.slots):
        raise ValueError(f"{len(state_vals)} state slots, want "
                         f"{len(plan.slots)}")
    for n, (t, slot) in enumerate(zip(state_vals, plan.slots)):
        if t.dtype != slot.dtype or tuple(t.shape) != slot.shape:
            raise ValueError(
                f"state slot {n} ({'/'.join(slot.path)}[{slot.field}]): "
                f"{t.dtype} {tuple(t.shape)}, want {slot.dtype} {slot.shape}")
        if t.device != x.device:
            raise ValueError(f"state slot {n} on {t.device}, frame on "
                             f"{x.device}")


def streaming_megakernel(
    plan, x: torch.Tensor, state_vals: List[torch.Tensor],
    timeline: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """One B=1 frame through a whole detector: ``(cls [1, A, C+1], box
    [1, A, 4], new state slots)``, predictions in fp32.

    :param plan: a ``megakernel.Plan`` (``megakernel.build_plan``).
    :param x: the frame ``[H, W, Cin]``, uint8, fp32 or bf16; the kernel
        reads its dtype, so a frame costs no cast.
    :param state_vals: the plan's state slots, ``[H, W, C]`` each in the
        state dtype. They are read, never written: the new state comes
        out in new tensors.
    :param timeline: optional int64 ``[phases + 1]`` tensor on the card
        that receives the device's global timer (ns) at the start and at
        the end of every phase (costs one more grid barrier).

    On a CPU frame this is ``megakernel.streaming_megakernel_reference``.
    On a CUDA frame it launches ``csrc/megakernel.cu`` once, as one
    cooperative grid on the current stream, or raises; the state slots
    must be contiguous and on the frame's card, and the plan prepared
    there (``prepare_megakernel``). The plan's workspace holds one
    frame's activations, so one plan runs one frame at a time.
    """
    _check_megakernel_args(plan, x, state_vals)
    if x.device.type == "cpu":
        from snn_for_object_detection_tpu_torch.ops.megakernel import (
            streaming_megakernel_reference,
        )

        return streaming_megakernel_reference(plan, x, state_vals)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    cu = getattr(plan, "cuda", None)
    if cu is None or cu["ops"].device != x.device:
        raise ValueError("the plan is not prepared on the frame's card "
                         "(prepare_megakernel)")
    _require_contiguous(x=x)
    _require_contiguous(**{f"state slot {n}": t
                           for n, t in enumerate(state_vals)})
    if timeline is not None and (
            timeline.dtype != torch.int64 or timeline.device != x.device
            or timeline.numel() != cu["phases"].shape[0] + 1):
        raise ValueError("timeline: want an int64 [phases + 1] tensor on "
                         "the frame's card")
    n = len(state_vals)
    new_vals = [torch.empty_like(t) for t in state_vals]
    preds = torch.empty(plan.preds_numel, dtype=torch.float32,
                        device=x.device)
    s_in = (ctypes.c_void_p * max(n, 1))(*[t.data_ptr() for t in state_vals])
    s_out = (ctypes.c_void_p * max(n, 1))(*[t.data_ptr() for t in new_vals])
    lif, li = _euler("lif"), _euler("li")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _megakernel_lib("streaming_megakernel_launch")(
            cu["ops"].data_ptr(), cu["phases"].data_ptr(),
            cu["phases"].shape[0], plan.weight_buf.data_ptr(),
            cu["workspace"].data_ptr(), x.data_ptr(), _FRAME_CODES[x.dtype],
            preds.data_ptr(), cu["scratch"].data_ptr(),
            cu["counters"].data_ptr(), cu["barrier"].data_ptr(),
            ctypes.addressof(s_in), ctypes.addressof(s_out), n,
            _CODES[plan.compute_dtype], _CODES[plan.state_dtype],
            lif[0], lif[1], li[0], li[1], cu["grid"],
            None if timeline is None else timeline.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"streaming_megakernel launch failed (code {rc})")
    LAUNCHES["streaming_megakernel"] += 1
    a, c1 = plan.num_anchors, plan.num_classes + 1
    return (preds[:a * c1].view(1, a, c1), preds[a * c1:].view(1, a, 4),
            new_vals)
