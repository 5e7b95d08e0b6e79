"""The port's temporal LIF/LI cell against the JAX package.

On the CPU, ``temporal_cell_seq`` of the port runs its plain PyTorch
version. It must equal, bit for bit, both the JAX Pallas kernel (in
interpret mode) and the JAX scan of ``neurons.lif_step`` / ``li_step``,
for both cells, with and without truncation, at the three dtype pairs
the detector uses. The CUDA kernel itself is held against the same
plain version on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.ops import pallas_kernels as jpk
from snn_for_object_detection_tpu_torch.ops import cuda_kernels, neurons

torch.set_num_threads(1)

DTYPE_PAIRS = [
    ("float32", "float32"),
    ("bfloat16", "bfloat16"),
    ("bfloat16", "float8_e5m2"),
]


def _to_torch(a, dtype: str) -> torch.Tensor:
    # through fp32: every value of these dtypes is exact in fp32
    t = torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    return t.to(getattr(torch, dtype))


def _assert_same(j, t):
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(j, jnp.float32)), t.float().numpy()
    )


def _inputs(seed, x_dtype, state_dtype, shape=(6, 2, 4, 5, 8)):
    """Seeded cell inputs (rows = 2*4*5 = 40, a multiple of 8 as the
    Pallas kernel needs), large enough that LIF spikes and the state
    quantization matters; a few x values overflow e5m2 (max 57344)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    x.reshape(-1)[::97] *= 3e4
    v0 = rng.standard_normal(shape[1:]).astype(np.float32)
    i0 = rng.standard_normal(shape[1:]).astype(np.float32) * 2.0
    return (jnp.asarray(x).astype(x_dtype), jnp.asarray(v0).astype(state_dtype),
            jnp.asarray(i0).astype(state_dtype))


@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("cell", ["lif", "li"])
def test_cell_matches_jax_exactly(cell, start, x_dtype, state_dtype):
    jx, jv, ji = _inputs(7, x_dtype, state_dtype)
    kernel = jpk.temporal_cell_seq(jx, jv, ji, cell=cell, interpret=True,
                                   start=start)
    scan = jpk._temporal_scan_reference(jx, jv, ji, start, cell)
    z, v_t, i_t = cuda_kernels.temporal_cell_seq(
        _to_torch(jx, x_dtype), _to_torch(jv, state_dtype),
        _to_torch(ji, state_dtype), cell=cell, start=start,
    )
    assert z.dtype == getattr(torch, x_dtype)
    assert v_t.dtype == i_t.dtype == getattr(torch, state_dtype)
    for ref in (kernel, scan):
        for j, t in zip(ref, (z, v_t, i_t)):
            _assert_same(j, t)
    if cell == "lif":
        assert 0 < float(z.float().mean()) < 1  # the test really spikes


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4, 1e-30])
def test_fma_rounds_once_like_xla(scale):
    """``neurons.fma`` against XLA's own contracted ``a * c + b`` (one
    hardware fused multiply-add on the CPU). XLA's CPU backend flushes
    subnormal results to zero where PyTorch and the CUDA kernel keep
    them, so the scales stay in the normal range."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal(100_000) * scale).astype(np.float32)
    b = (rng.standard_normal(100_000) * scale).astype(np.float32)
    c = np.float32(0.1)
    want = jax.jit(lambda a, b: a * c + b)(a, b)
    got = neurons.fma(torch.from_numpy(a), float(c), torch.from_numpy(b))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_step_functions_match_jax_neurons():
    """One plain ``lif_step`` / ``li_step`` against the JAX cells."""
    from snn_for_object_detection_tpu.ops import neurons as jn

    rng = np.random.default_rng(11)
    x, v, i = (rng.standard_normal((3, 64, 32)) * 2).astype(np.float32)
    for jstep, tstep in ((jn.lif_step, neurons.lif_step),
                         (jn.li_step, neurons.li_step)):
        jz, (jv, ji) = jax.jit(jstep)(x, jn.LIFState(v, i))
        tz, (tv, ti) = tstep(torch.from_numpy(x), (torch.from_numpy(v),
                                                  torch.from_numpy(i)))
        for j, t in ((jz, tz), (jv, tv), (ji, ti)):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(4, 2, 8)
    v = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="cell"):
        cuda_kernels.temporal_cell_seq(x, v, v, cell="alif")
    with pytest.raises(ValueError, match="shapes"):
        cuda_kernels.temporal_cell_seq(x, torch.zeros(2, 4), v)
    with pytest.raises(TypeError, match="state dtypes"):
        cuda_kernels.temporal_cell_seq(x, v, v.bfloat16())
    with pytest.raises(TypeError, match="state dtypes"):
        # e4m3 states are taken (tests/test_torch_e4m3.py), fp16 are not
        cuda_kernels.temporal_cell_seq(x, v.half(), v.half())
    e4m3 = v.to(torch.float8_e4m3fn)
    assert cuda_kernels.temporal_cell_seq(x, e4m3, e4m3)[1].dtype == \
        torch.float8_e4m3fn
    with pytest.raises(TypeError, match="x_seq dtype"):
        cuda_kernels.temporal_cell_seq(x.half(), v, v)


def test_cpu_call_counts_no_launch():
    """The launch counts move only where a kernel launches: the plain
    versions on CPU tensors leave them alone."""
    cuda_kernels.reset_launches()
    x = torch.ones(3, 2, 8)
    cuda_kernels.temporal_cell_seq(x, torch.zeros(2, 8), torch.zeros(2, 8))
    ones, zeros = torch.ones(8), torch.zeros(8)
    state = torch.zeros(1, 4, 4, 8)
    cuda_kernels.spiking_conv_seq(torch.ones(3, 1, 4, 4, 2),
                                  torch.ones(3, 3, 2, 8), ones, zeros,
                                  state, state)
    cuda_kernels.fused_pointwise_conv_bn_lif(
        torch.ones(5, 2), torch.ones(2, 8), ones, zeros, torch.zeros(5, 8),
        torch.zeros(5, 8),
    )
    cuda_kernels.plif_cell_seq(x, torch.zeros(2, 8), torch.zeros(2, 8),
                               ones * 0.1, ones * 0.2)
    assert cuda_kernels.LAUNCHES == {
        "temporal_cell_seq": 0, "temporal_cell_seq_bwd": 0,
        "plif_cell_seq": 0, "plif_cell_seq_bwd": 0,
        "spiking_conv_seq": 0, "fused_pointwise_conv_bn_lif": 0,
        "streaming_megakernel": 0,
    }
