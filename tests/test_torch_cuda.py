"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere every test here skips.
"""

import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu_torch.ops import cuda_kernels

DTYPE_PAIRS = [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float8_e5m2),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _inputs(shape, x_dtype, state_dtype, seed=5):
    """Seeded inputs on the card; a few x values overflow e5m2."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    x.reshape(-1)[::97] *= 3e4
    v0 = rng.standard_normal(shape[1:]).astype(np.float32)
    i0 = rng.standard_normal(shape[1:]).astype(np.float32) * 2.0
    return (torch.from_numpy(x).cuda().to(x_dtype),
            torch.from_numpy(v0).cuda().to(state_dtype),
            torch.from_numpy(i0).cuda().to(state_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("cell", ["lif", "li"])
def test_temporal_cell_matches_plain_version(card, cell, x_dtype,
                                             state_dtype):
    """Bit-equal: a flat size that takes the 16-byte vector path and an
    odd one that takes the scalar path, with and without truncation."""
    for shape in ((9, 3, 7, 5, 24), (5, 1, 3, 5, 7)):
        args = _inputs(shape, x_dtype, state_dtype)
        for start in (0, 4):
            cuda_kernels.reset_launches()
            got = cuda_kernels.temporal_cell_seq(*args, cell=cell,
                                                 start=start)
            torch.cuda.synchronize()
            assert cuda_kernels.LAUNCHES["temporal_cell_seq"] == 1
            want = cuda_kernels.temporal_cell_seq_reference(
                *args, cell=cell, start=start
            )
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                           atol=0, equal_nan=True)


@pytest.mark.cuda
def test_temporal_cell_rejects_strided_input(card):
    x, v, i = _inputs((4, 2, 6, 8), torch.float32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.temporal_cell_seq(x.transpose(2, 3), v.transpose(1, 2),
                                       i.transpose(1, 2))
