"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Counterpart of ``snn_for_object_detection_tpu/ops/pallas_kernels.py``.
Each wrapper runs its kernel on a CUDA tensor and the plain PyTorch
version, kept in this module, on a CPU tensor; there is no fallback
from one to the other. Each wrapper counts its launches in
``LAUNCHES`` so that a run can show its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from snn_for_object_detection_tpu_torch.ops import cuda_build, neurons

# launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"temporal_cell_seq": 0}

# type codes of the C entry points
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e5m2: 2}
X_DTYPES = (torch.float32, torch.bfloat16)
STATE_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e5m2)
_CELLS = {"lif": 0, "li": 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _temporal_lib():
    lib = cuda_build.load("temporal_cell.cu")
    fn = lib.temporal_cell_seq_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 4
            + [ctypes.c_float] * 2
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check_cell_args(x_seq, v0, i0, cell):
    if cell not in _CELLS:
        raise ValueError(f"unsupported cell {cell!r}")
    if x_seq.dtype not in X_DTYPES:
        raise TypeError(f"x_seq dtype {x_seq.dtype} not in {X_DTYPES}")
    if v0.dtype not in STATE_DTYPES or i0.dtype != v0.dtype:
        raise TypeError(
            f"state dtypes ({v0.dtype}, {i0.dtype}) must match and be one "
            f"of {STATE_DTYPES}"
        )
    if x_seq.dim() < 1 or x_seq.shape[1:] != v0.shape \
            or v0.shape != i0.shape:
        raise ValueError(
            f"shapes x {tuple(x_seq.shape)}, v0 {tuple(v0.shape)}, "
            f"i0 {tuple(i0.shape)}: want x = [T, *state]"
        )
    if not (x_seq.device == v0.device == i0.device):
        raise ValueError("x_seq, v0 and i0 must be on one device")


def temporal_cell_seq_reference(
    x_seq: torch.Tensor, v0: torch.Tensor, i0: torch.Tensor,
    cell: str = "lif", start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`temporal_cell_seq`: a loop over T
    of ``neurons.lif_step`` / ``li_step`` in fp32, the state cast to its
    storage dtype every step and frozen for ``t < start`` (the output is
    still emitted from the frozen state)."""
    _check_cell_args(x_seq, v0, i0, cell)
    step = neurons.lif_step if cell == "lif" else neurons.li_step
    sd = v0.dtype
    v, i = v0.float(), i0.float()
    z = torch.empty_like(x_seq)
    for t in range(x_seq.shape[0]):
        out, (v_new, i_new) = step(x_seq[t].float(), (v, i))
        z[t] = out.to(x_seq.dtype)
        if t >= start:
            v, i = v_new.to(sd).float(), i_new.to(sd).float()
    return z, v.to(sd), i.to(sd)


def temporal_cell_seq(
    x_seq: torch.Tensor, v0: torch.Tensor, i0: torch.Tensor,
    cell: str = "lif", start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-layer LIF/LI over T steps: ``(z_seq, v_T, i_T)``.

    :param x_seq: ``[T, ...]`` cell input, fp32 or bf16.
    :param v0: ``[...]`` initial membrane, fp32, bf16 or fp8 e5m2.
    :param i0: ``[...]`` initial current, same dtype as ``v0``.
    :param start: truncation start r: the state is frozen for steps
        ``t < r`` while their outputs are still emitted.
    :return: ``z_seq`` in ``x_seq``'s dtype (spikes for LIF, the fp32
        membrane before quantization for LI); ``v_T``, ``i_T`` in the
        state dtype.

    On a CPU tensor this is :func:`temporal_cell_seq_reference`. On a
    CUDA tensor it launches ``csrc/temporal_cell.cu`` on the current
    stream or raises; inputs must be contiguous (a sequence is never
    copied here).
    """
    _check_cell_args(x_seq, v0, i0, cell)
    if x_seq.device.type == "cpu":
        return temporal_cell_seq_reference(x_seq, v0, i0, cell, start)
    if x_seq.device.type != "cuda":
        raise ValueError(f"unsupported device {x_seq.device}")
    for name, t in (("x_seq", x_seq), ("v0", v0), ("i0", i0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    z = torch.empty_like(x_seq)
    v_t = torch.empty_like(v0)
    i_t = torch.empty_like(i0)
    c_mem, c_syn = neurons.euler_factors(
        neurons.LIFParams() if cell == "lif" else neurons.LIParams()
    )
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
