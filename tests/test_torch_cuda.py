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


def _plif_factors(ch, seed=3):
    """Per-channel factors of raw time constants spread around their
    init, on the card."""
    from snn_for_object_detection_tpu_torch.ops import neurons

    rng = np.random.default_rng(seed)
    init = neurons.plif_params_init(ch)
    raw = neurons.PLIFParams(*(
        (p + torch.from_numpy(rng.normal(0, sd, ch).astype(np.float32)))
        .cuda() for p, sd in zip(init, (40.0, 20.0))))
    return neurons.plif_factors(raw)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
def test_plif_cell_matches_plain_version(card, x_dtype, state_dtype):
    """PLIF's forward bit-equal to ``plif_cell_seq_reference`` (the
    vector path and the scalar one, with and without truncation); its
    backward under every plan the source builds for the width (threads,
    checkpoints shared or global) and at T = 1: gx, gv0, gi0 bit-equal
    to autograd through the plain version, the [C] factor gradients
    within 1e-4 of the largest (another order of sums)."""
    for shape in ((9, 3, 7, 5, 24), (5, 1, 3, 5, 7)):
        x, v0, i0 = _inputs(shape, x_dtype, state_dtype)
        c_mem, c_syn = _plif_factors(shape[-1])
        for start in (0, 4):
            cuda_kernels.reset_launches()
            got = cuda_kernels.plif_cell_seq(x, v0, i0, c_mem, c_syn, start)
            torch.cuda.synchronize()
            assert cuda_kernels.LAUNCHES["plif_cell_seq"] == 1
            want = cuda_kernels.plif_cell_seq_reference(x, v0, i0, c_mem,
                                                        c_syn, start)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                           atol=0, equal_nan=True)
        rng = np.random.default_rng(7)
        gz = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().to(x_dtype)
        gv, gi = (torch.from_numpy(rng.standard_normal(shape[1:]).astype(
            np.float32)).cuda().to(state_dtype) for _ in range(2))
        T, m = shape[0], v0.numel()
        vec = m % (16 // x.element_size()) == 0
        width = 16 // x.element_size() if vec else 1
        plans = [cuda_kernels.cell_bwd_plan_of(
            T, m, x_dtype, state_dtype, cuda_kernels.PLIF_BWD_CHUNK[width],
            threads, shared, vec)
            for threads in (256, 128) for shared in (True, False)]
        # finite states: no input past what e5m2 holds
        x = x.float().clamp(-30, 30).to(x_dtype)
        cases = [(x, gz, 3, p) for p in plans] + [
            (x[:1].contiguous(), gz[:1].contiguous(), 0, None)]
        for bx, bgz, start, plan in cases:
            leaves = [a.detach().requires_grad_()
                      for a in (bx, v0, i0, c_mem, c_syn)]
            outs = cuda_kernels.plif_cell_seq_reference(*leaves, start)
            want = torch.autograd.grad(outs, leaves, (bgz, gv, gi))
            got = cuda_kernels.plif_cell_seq_bwd(bx, v0, i0, c_mem, c_syn,
                                                 bgz, gv, gi, start, plan)
            for g, w in zip(got[:3], want[:3]):
                assert g.dtype == w.dtype
                torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                           atol=0, equal_nan=True)
            for g, w in zip(cuda_kernels.plif_factor_grads(*got[3:]),
                            want[3:]):
                torch.testing.assert_close(
                    g, w, rtol=0, atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
def test_temporal_cell_rejects_strided_input(card):
    x, v, i = _inputs((4, 2, 6, 8), torch.float32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.temporal_cell_seq(x.transpose(2, 3), v.transpose(1, 2),
                                       i.transpose(1, 2))


CONV_CASES = [  # (k, stride, cell) of tests/test_pallas.py
    (3, 1, "lif"), (3, 2, "lif"), (1, 1, "lif"),
    (3, 2, "li"), (1, 1, "li"), (1, 2, "lif"),
]


def _conv_inputs(k, stride, x_dtype, state_dtype, shape, cout, seed=7):
    """Seeded spiking conv inputs on the card: binary events, normal
    weights, a BN affine away from identity, non-zero state."""
    rng = np.random.default_rng(seed)
    _, n, h, w, cin = shape
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, \
        (w + 2 * (k // 2) - k) // stride + 1
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    return (f32(rng.random(shape) < 0.3).to(x_dtype),
            f32(rng.normal(size=(k, k, cin, cout)) * 1.5 / (k * cin ** 0.5)),
            f32(rng.uniform(0.5, 1.5, cout)), f32(rng.normal(size=cout) * 0.1),
            f32(rng.normal(size=(n, ho, wo, cout)) * 0.3).to(state_dtype),
            f32(rng.normal(size=(n, ho, wo, cout)) * 0.3).to(state_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("k,stride,cell", CONV_CASES)
def test_spiking_conv_matches_plain_version(card, k, stride, cell, x_dtype,
                                            state_dtype):
    """The gates of chip_smoke.py [3]: spike agreement >= 0.999 and at
    most 0.1% (fp32; 1% in bf16) of final state elements outside rtol
    1e-4, atol 1e-5 (fp32) or two ulps of the storage dtype. Odd sizes,
    Cin off the chunk size, Cout off the channel tile and one Cout that
    is no multiple of 8 (the scalar store path); Cin = 32, a whole
    chunk."""
    for shape, cout in (((5, 2, 13, 19, 6), 40), ((3, 1, 9, 7, 10), 18),
                        ((6, 2, 11, 17, 32), 40)):
        _check_conv_gates(k, stride, cell, x_dtype, state_dtype, shape, cout)


def _check_conv_gates(k, stride, cell, x_dtype, state_dtype, shape, cout):
    """One launch, then the gates of chip_smoke.py [3] against the plain
    version; every plan of the layer gives the plan's bits."""
    from chip_smoke import outside_share, spike_agreement

    limit = 0.001 if x_dtype == torch.float32 else 0.01
    args = _conv_inputs(k, stride, x_dtype, state_dtype, shape, cout)
    cuda_kernels.reset_launches()
    got = cuda_kernels.spiking_conv_seq(*args, cell=cell, stride=stride)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["spiking_conv_seq"] == 1
    ho, wo = args[4].shape[1:3]
    want = cuda_kernels.spiking_conv_seq_reference(*args, cell=cell,
                                                   stride=stride)
    for plan in cuda_kernels.spiking_conv_plans(k, stride, shape[1], ho, wo,
                                                shape[4], cout, x_dtype):
        other = cuda_kernels.spiking_conv_seq_launch(*args, cell, stride,
                                                     plan)
        for g, o in zip(got, other):
            torch.testing.assert_close(o.float(), g.float(), rtol=0, atol=0,
                                       equal_nan=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    if cell == "lif":
        assert 0 < float(want[0].float().mean()) < 1
        assert spike_agreement(got[0], want[0]) >= 0.999
    else:
        assert outside_share(got[0], want[0], x_dtype) <= limit
    for g, w in zip(got[1:], want[1:]):
        assert outside_share(g, w, state_dtype) <= limit


PLAN_CASES = {  # (k, stride, cell, [T, N, H, W, Cin], Cout)
    "stem_cin2_s2_odd": (3, 2, "lif", (4, 2, 23, 31, 2), 64),
    "out_8x10": (3, 1, "lif", (6, 4, 8, 10, 128), 128),
    "out_15x19_s2_cout48": (3, 2, "lif", (5, 4, 30, 38, 64), 48),
    "head_8x10_li": (1, 1, "li", (5, 4, 8, 10, 256), 256),
    "n1_s2_odd_8x10": (3, 2, "lif", (4, 1, 15, 19, 32), 40),
    "n1_15x19_cout24": (3, 1, "lif", (4, 1, 15, 19, 128), 24),
}


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_spiking_conv_plan_variants(card, case, x_dtype, state_dtype):
    """The launch plan and every other plan against the plain version on
    the shapes where the tiles are ragged: Cin = 2, 8 x 10 and 15 x 19
    outputs, stride 2 on odd inputs, N = 1, Cout off a multiple of 32 (a
    ragged channel tile)."""
    k, stride, cell, shape, cout = PLAN_CASES[case]
    _check_conv_gates(k, stride, cell, x_dtype, state_dtype, shape, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("k,stride,cell", CONV_CASES)
def test_spiking_conv_fetched_rows_are_the_whole_maps(card, k, stride, cell,
                                                      x_dtype, state_dtype):
    """The fetched-rows form (``pad_h=0``): each row block of 2, 3 and 4
    ranks, launched on its rows sliced from the zero-padded map, gives
    the whole map's launch's rows of z, v and i bit for bit; the entry
    point refuses output rows that are not the rows given's."""
    import torch.nn.functional as F

    from snn_for_object_detection_tpu_torch.parallel import row_blocks

    for shape, cout in (((5, 2, 13, 19, 6), 40), ((4, 1, 16, 9, 32), 24)):
        x, w, a, b, v0, i0 = _conv_inputs(k, stride, x_dtype, state_dtype,
                                          shape, cout)
        whole = cuda_kernels.spiking_conv_seq(x, w, a, b, v0, i0, cell,
                                              stride)
        p, ho = k // 2, v0.shape[1]
        padded = F.pad(x, (0, 0, 0, 0, p, p + stride))
        for ranks in (2, 3, 4):
            for o0, o1 in row_blocks(ho, ranks):
                rows = padded[:, :, o0 * stride:(o1 - 1) * stride + k]
                got = cuda_kernels.spiking_conv_seq(
                    rows.contiguous(), w, a, b, v0[:, o0:o1].contiguous(),
                    i0[:, o0:o1].contiguous(), cell, stride, pad_h=0)
                for g, full in zip(got, (whole[0][:, :, o0:o1],
                                         whole[1][:, o0:o1],
                                         whole[2][:, o0:o1])):
                    torch.testing.assert_close(g.float(), full.float(),
                                               rtol=0, atol=0,
                                               equal_nan=True)
    if k == 3:  # the whole map's rows unpadded give fewer output rows
        plan = cuda_kernels.spiking_conv_plan(
            k, stride, shape[1], ho, v0.shape[2], shape[4], cout, x_dtype,
            cuda_kernels.sm_count(0))
        with pytest.raises(RuntimeError, match="code -1"):
            cuda_kernels.spiking_conv_seq_launch(x, w, a, b, v0, i0, cell,
                                                 stride, plan, pad_h=0)


@pytest.mark.cuda
def test_spiking_conv_rejects_a_wrong_grid(card):
    """The entry point checks the plan's grid and shared memory against
    its geometry."""
    import dataclasses

    for x_dtype in (torch.float32, torch.bfloat16):
        args = _conv_inputs(3, 1, x_dtype, torch.float32,
                            (2, 1, 8, 10, 16), 32)
        plan = cuda_kernels.spiking_conv_plan(3, 1, 1, 8, 10, 16, 32,
                                              x_dtype, 132)
        for bad in (dataclasses.replace(plan, grid=plan.grid + 1),
                    dataclasses.replace(plan, smem=plan.smem + 16)):
            with pytest.raises(RuntimeError, match="code -1"):
                cuda_kernels.spiking_conv_seq_launch(*args, "lif", 1, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("cell", ["lif", "li"])
def test_spiking_conv_identity_weights_bit_equal(card, cell, x_dtype,
                                                 state_dtype):
    """1 x 1 identity weights make the conv exact: kernel and plain
    version agree bit for bit."""
    c = 16
    x, _, a, b, v0, i0 = _conv_inputs(1, 1, x_dtype, state_dtype,
                                      (6, 2, 5, 7, c), c)
    x = (torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
         * 2.0).cuda().to(x_dtype)
    w = torch.eye(c, device="cuda")[None, None]
    got = cuda_kernels.spiking_conv_seq(x, w, a, b, v0, i0, cell=cell)
    want = cuda_kernels.spiking_conv_seq_reference(x, w, a, b, v0, i0,
                                                   cell=cell)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g.float(), w_.float(), rtol=0, atol=0,
                                   equal_nan=True)


POINTWISE_CASES = {  # name: (N, Cin, Cout, x[1:] of an [N + 1, Cin] x)
    "full_cout": (700, 64, 32, False),
    "cout_split": (300, 256, 256, False),  # fp32: two Cout tiles
    "ragged_n": (1001, 128, 64, False),
    "general": (333, 40, 32, False),  # Cin off 16, e5m2 rows of 32 B
    "unaligned_x": (200, 10, 24, True),  # 40-byte fp32 rows, odd base
}


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("case", sorted(POINTWISE_CASES))
def test_pointwise_matches_plain_version(card, case, x_dtype, state_dtype):
    """One launch a call over the plan's branches: the whole Cout in one
    tile, fp32 256 -> 256 split in two, N ragged against the row tile,
    Cin and Cout off the vector widths, and a contiguous x whose base
    and rows are not 16-byte aligned. z and v' do not depend on the
    product, so they are equal. With fp32 x, i' is bit-equal to the
    plain version's formula with the product summed as the FFMA kernel
    sums it, k ascending, one fused multiply-add at a time: the plain
    version's own cuBLAS product sums in another order, and at 300 x
    256 -> 256 that puts 9 of 76,800 elements past rtol 1e-5 where
    i_dec + y cancels. With bf16 x, i' is within two ulps of the storage
    dtype of the plain version plus what two fp32 sums of the products
    in different orders may differ by (the tensor cores' order;
    ``chip_smoke.pointwise_i_outside``)."""
    from chip_smoke import pointwise_i_outside

    n, cin, cout, shifted = POINTWISE_CASES[case]
    rng = np.random.default_rng(4)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    x = f32(rng.normal(size=(n + shifted, cin))).to(x_dtype)[int(shifted):]
    args = (x, f32(rng.normal(size=(cin, cout)) * 0.1).to(x_dtype),
            f32(rng.uniform(0.5, 1.5, cout)), f32(rng.normal(size=cout) * 0.1),
            f32(rng.normal(size=(n, cout)) * 0.4).to(state_dtype),
            f32(rng.normal(size=(n, cout)) * 0.4).to(state_dtype))
    plan = cuda_kernels.pointwise_plan_on(0, n, cin, cout, x_dtype,
                                          state_dtype)
    if case == "cout_split":
        assert plan.splits == (2 if x_dtype == torch.float32 else 1)
    if case == "unaligned_x":
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    cuda_kernels.reset_launches()
    z, v, i = cuda_kernels.fused_pointwise_conv_bn_lif(*args)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["fused_pointwise_conv_bn_lif"] == 1
    wz, wv, wi = cuda_kernels.fused_pointwise_conv_bn_lif_reference(*args)
    assert 0 < float(wz.float().mean()) < 1
    for g, w in ((z, wz), (v, wv)):
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=0)
    if x_dtype == torch.float32:
        assert torch.equal(i, _pointwise_i_summed_k_ascending(*args))
    else:
        assert pointwise_i_outside(i, wi, *args[:3])[1] == 0.0


def _pointwise_i_summed_k_ascending(x, w, a, b, v, i):
    """i' of ``fused_pointwise_conv_bn_lif_reference`` with ``x @ w``
    summed k ascending from zero by fused multiply-adds (``neurons.fma``
    is one on the card)."""
    from snn_for_object_detection_tpu_torch.ops import neurons

    xf, wf = x.float(), w.float()
    y = torch.zeros(v.shape, device=x.device)
    for k in range(x.shape[1]):
        y = neurons.fma(xf[:, k:k + 1], wf[k:k + 1], y)
    _, c_syn = cuda_kernels._euler("lif")
    i32 = i.float()
    i_dec = neurons.fma(i32, -c_syn, i32)
    return (i_dec + neurons.fma(y, a.float(), b.float())).to(i.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
def test_pointwise_every_plan_agrees(card, x_dtype, state_dtype):
    """Every row tile and grid the kernel takes at 777 x
    128 -> 64 gives the plan's bits (each output sums its products in
    the same order under every plan), and the plan's launch is within
    the gate of the plain version; a plan whose shared memory does not
    match the kernel's is refused."""
    import dataclasses

    from chip_smoke import pointwise_i_outside

    n, cin, cout = 777, 128, 64
    rng = np.random.default_rng(5)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    args = (f32(rng.normal(size=(n, cin))).to(x_dtype),
            f32(rng.normal(size=(cin, cout)) * 0.1).to(x_dtype),
            f32(rng.uniform(0.5, 1.5, cout)), f32(rng.normal(size=cout) * 0.1),
            f32(rng.normal(size=(n, cout)) * 0.4).to(state_dtype),
            f32(rng.normal(size=(n, cout)) * 0.4).to(state_dtype))
    wz, wv, wi = cuda_kernels.fused_pointwise_conv_bn_lif_reference(*args)
    base = cuda_kernels.pointwise_plan_on(0, n, cin, cout, x_dtype,
                                          state_dtype)
    got = cuda_kernels.fused_pointwise_launch(*args, base)
    torch.cuda.synchronize()
    assert torch.equal(got[0], wz) and torch.equal(got[1].float(),
                                                   wv.float())
    assert pointwise_i_outside(got[2], wi, *args[:3])[1] == 0.0
    sx, ss = cuda_kernels._pw_sizes(x_dtype, state_dtype)
    for rows in cuda_kernels.pointwise_rows(base.cout_tile, sx):
        smem = cuda_kernels.pointwise_smem(cin, base.cout_tile, rows, sx,
                                           ss)[1]
        if smem > cuda_kernels.PW_MAX_SMEM:
            continue
        for grid in (1, 7):
            plan = dataclasses.replace(base, rows=rows, smem=smem, grid=grid)
            other = cuda_kernels.fused_pointwise_launch(*args, plan)
            torch.cuda.synchronize()
            for g, o in zip(got, other):
                assert torch.equal(g.float(), o.float()), plan
    bad = dataclasses.replace(base, smem=base.smem + 16)
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_kernels.fused_pointwise_launch(*args, bad)


@pytest.mark.cuda
def test_spiking_conv_rejects_strided_input(card):
    x, w, a, b, v, i = _conv_inputs(3, 1, torch.float32, torch.float32,
                                    (2, 1, 6, 6, 4), 8)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.spiking_conv_seq(x.transpose(2, 3), w, a, b, v, i)


def _cuda_models():
    """Port-only models for the megakernel on the card (no JAX here): the
    ``StructYolo`` layer menu of tests/test_megakernel.py and a narrow
    TinyYolo."""
    from snn_for_object_detection_tpu_torch.models import spec as S
    from snn_for_object_detection_tpu_torch.models.detector import SODa
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo

    class StructYolo(SODa):
        def backbone_cfgs(self):
            return [
                S.Conv(8, 3, 2), S.Norm(), S.LIF(),
                S.Dense([
                    [S.Conv(4, 1), S.Norm(), S.LIF(),
                     S.Residual([[S.Conv(4, 3), S.Norm(), S.LIF()], []])],
                    [S.Conv(4, 1)],
                ]),
                S.Pool("S"),
            ]

        def neck_cfgs(self):
            return [
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Up(2), S.Pool("M"),
                S.Return(),
            ]

        def head_cfgs(self, box_out, cls_out):
            return [
                [S.Conv(kernel_size=1), S.Norm(), S.LI(), S.Tanh()],
                [S.Conv(box_out, 1)],
                [S.Conv(cls_out, 1)],
            ]

    class Narrow(TinyYolo):
        backbone_plan = ((8, 1), (16, 1))
        neck_plan = ((16, 1), (16, 1), (16, 1))

    class Wide(TinyYolo):  # every Cin past stage 1 a multiple of 16
        backbone_plan = ((32, 1), (64, 2))
        neck_plan = ((64, 1), (128, 1), (64, 1))

    class Fallbacks(StructYolo):  # add, copy and ew ops in the plan
        def backbone_cfgs(self):
            return [
                S.Conv(8, 3, 2), S.Norm(), S.LIF(),
                S.Residual([[S.Conv(8, 1), S.Norm(), S.LIF()],
                            [S.Conv(8, 1)], []]),
                S.Dense([[], [], [S.Conv(8, 1), S.Norm(), S.LIF()]]),
                S.Pool("M"), S.Norm(), S.LIF(),
            ]

        def neck_cfgs(self):
            return [
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
            ]

    return {"struct": (StructYolo, (32, 40), 4.0),
            "narrow_tiny_yolo": (Narrow, (64, 80), 8.0),
            "wide_tiny_yolo": (Wide, (64, 80), 8.0),
            "fallbacks": (Fallbacks, (64, 80), 4.0)}


def _megakernel_model(name, x_dtype, state_dtype):
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        StreamingMegakernel,
    )

    cls, hw, gain = _cuda_models()[name]
    model = cls(num_classes=2, in_hw=hw, time_window=0,
                compute_dtype=x_dtype, state_dtype=state_dtype,
                device="cuda", seed=1)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith(".scale"):
                p.fill_(gain)
    return StreamingMegakernel(model), hw


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("name", ["struct", "narrow_tiny_yolo",
                                  "wide_tiny_yolo", "fallbacks"])
def test_megakernel_matches_plain_version(card, name, x_dtype, state_dtype):
    """One launch per frame; after 6 frames the final spikes (v == 0) of
    every LIF cell agree on >= 99% with the plain version run on the
    card, LI states lie within a relative L2 error of 10% and predictions
    close by (the kernel sums the convs in another order, split along K
    where the grid would idle, and uses CUDA's tanhf)."""
    from chip_smoke import relative_l2, spike_agreement
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        streaming_megakernel_reference,
    )

    mk, hw = _megakernel_model(name, x_dtype, state_dtype)
    rng = np.random.default_rng(8)
    frames = torch.from_numpy(
        (rng.random((6, *hw, 2)) < 0.3).astype(np.uint8)).cuda()
    got, want = mk._flat_state(None), mk._flat_state(None)
    cuda_kernels.reset_launches()
    for x in frames:
        gc, gb, got = cuda_kernels.streaming_megakernel(mk.plan, x, got)
        wc, wb, want = streaming_megakernel_reference(mk.plan, x, want)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["streaming_megakernel"] == len(frames)
    assert sum(cuda_kernels.LAUNCHES.values()) == len(frames)
    for n, slot in enumerate(mk.plan.slots):
        g, w = got[n], want[n]
        assert g.dtype == w.dtype == state_dtype
        if "head" in slot.path[0]:  # LI
            assert relative_l2(g, w) <= 0.1, slot.path
        elif slot.field == 0:  # LIF v
            assert spike_agreement(g == 0, w == 0) >= 0.99, slot.path
    for g, w in ((gc, wc), (gb, wb)):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) < 0.1


def _mk_frames(hw, n, seed=8):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.random((n, *hw, 2)) < 0.3).astype(np.uint8)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("name", ["struct", "narrow_tiny_yolo",
                                  "wide_tiny_yolo", "fallbacks"])
def test_megakernel_bit_equal_with_selection_weights(card, name, x_dtype,
                                                     state_dtype):
    """Every conv weight selects one input value per output (output
    channel co reads channel co % Cin at tap co % k^2), so every conv
    sum is exact in any order, padding and stride included: every state
    of the kernel equals the plain version's bit for bit, through the
    in-place concatenations, the Residual epilogues, split K and both
    ways of staging. The predictions pass through CUDA's tanhf, so they
    agree within a few ulps."""
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        StreamingMegakernel,
        streaming_megakernel_reference,
    )

    mk, hw = _megakernel_model(name, x_dtype, state_dtype)
    with torch.no_grad():
        for pname, p in mk.model.named_parameters():
            if pname.endswith(".w"):
                cout, cin, k, _ = p.shape
                p.zero_()
                for co in range(cout):
                    t = co % (k * k)
                    p[co, co % cin, t // k, t % k] = 1.0
    mk = StreamingMegakernel(mk.model)
    if "tiny_yolo" in name:  # the others' convs are too shallow to split
        split = cuda_kernels.MK_FIELDS.index("split")
        assert int((mk.plan.cuda["ops"][:, split] > 1).sum()) > 0
    got, want = mk._flat_state(None), mk._flat_state(None)
    for x in _mk_frames(hw, 6):
        gc, gb, got = cuda_kernels.streaming_megakernel(mk.plan, x, got)
        wc, wb, want = streaming_megakernel_reference(mk.plan, x, want)
    torch.cuda.synchronize()
    spiked = 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=0)
        spiked += int((w == 0).sum())
    assert spiked > 0
    tol = (dict(rtol=1e-5, atol=1e-6) if x_dtype == torch.float32
           else dict(rtol=2e-2, atol=1e-3))
    torch.testing.assert_close(gc, wc, **tol)
    torch.testing.assert_close(gb, wb, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", [DTYPE_PAIRS[0],
                                                 DTYPE_PAIRS[2]])
def test_megakernel_is_deterministic(card, x_dtype, state_dtype):
    """Two launches on the same frame and state give the same bits (the
    last slice of a split conv sums the slices in order; no atomics
    touch the values), and every tile counter is back at zero after a
    frame."""
    mk, hw = _megakernel_model("wide_tiny_yolo", x_dtype, state_dtype)
    frames = _mk_frames(hw, 3)
    state = mk._flat_state(None)
    for x in frames[:2]:
        _, _, state = cuda_kernels.streaming_megakernel(mk.plan, x, state)
    runs = [cuda_kernels.streaming_megakernel(mk.plan, frames[2], state)
            for _ in range(2)]
    torch.cuda.synchronize()
    (c1, b1, s1), (c2, b2, s2) = runs
    for a, b in zip([c1, b1] + s1, [c2, b2] + s2):
        assert torch.equal(a, b)
    counters = mk.plan.cuda["counters"]
    assert counters.numel() > 1 and int(counters.abs().sum()) == 0


@pytest.mark.cuda
def test_megakernel_rejects_bad_state(card):
    mk, hw = _megakernel_model("struct", torch.float32, torch.float32)
    x = torch.zeros((*hw, 2), device="cuda")
    state = mk._flat_state(None)
    bad = list(state)
    h, w, c = bad[0].shape
    bad[0] = torch.zeros((h, c, w), device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.streaming_megakernel(mk.plan, x, bad)
    bad[0] = state[0].cpu()
    with pytest.raises(ValueError, match="state slot 0 on cpu"):
        cuda_kernels.streaming_megakernel(mk.plan, x, bad)


TRAIN_PAIRS = DTYPE_PAIRS + [(torch.float32, torch.bfloat16)]


def _bwd_inputs(shape, x_dtype, state_dtype, seed=9):
    """Seeded cell inputs and cotangents on the card, in range."""
    rng = np.random.default_rng(seed)

    def draw(s, scale, dtype):
        a = rng.standard_normal(s).astype(np.float32) * scale
        return torch.from_numpy(a).cuda().to(dtype)

    return (draw(shape, 2.0, x_dtype), draw(shape[1:], 1.0, state_dtype),
            draw(shape[1:], 1.0, state_dtype), draw(shape, 1.0, x_dtype),
            draw(shape[1:], 1.0, state_dtype),
            draw(shape[1:], 1.0, state_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", TRAIN_PAIRS)
@pytest.mark.parametrize("cell", ["lif", "li"])
def test_temporal_cell_backward_matches_plain_version(card, cell, x_dtype,
                                                      state_dtype):
    """The backward kernel bit-equal to autograd through the plain
    version (it sums in autograd's order): the vector path, the scalar
    path and T = 1 (the per-step schedule), with and without truncation;
    one launch a call, and autograd through ``temporal_cell_seq`` on the
    card runs it. LIF also under every plan of the chunked kernel, T
    around each chunk length (``_chunked_backward_matches_plain_version``)."""
    for shape in ((9, 3, 7, 5, 24), (5, 1, 3, 5, 7), (1, 2, 4, 16)):
        x, v0, i0, gz, gv, gi = _bwd_inputs(shape, x_dtype, state_dtype)
        for start in (0, 4):
            cuda_kernels.reset_launches()
            got = cuda_kernels.temporal_cell_seq_bwd(x, v0, i0, gz, gv, gi,
                                                     cell, start)
            torch.cuda.synchronize()
            assert cuda_kernels.LAUNCHES["temporal_cell_seq_bwd"] == 1
            leaves = [a.detach().requires_grad_() for a in (x, v0, i0)]
            # LIF at T = 1 frozen: x reaches nothing, its cotangent is 0
            want = torch.autograd.grad(
                cuda_kernels.temporal_cell_seq_reference(*leaves, cell,
                                                         start),
                leaves, (gz, gv, gi), allow_unused=True,
                materialize_grads=True)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                           atol=0, equal_nan=True)
            leaves = [a.detach().requires_grad_() for a in (x, v0, i0)]
            via = torch.autograd.grad(
                cuda_kernels.temporal_cell_seq(*leaves, cell, start),
                leaves, (gz, gv, gi))
            assert cuda_kernels.LAUNCHES["temporal_cell_seq_bwd"] == 2
            for g, w in zip(via, got):
                assert torch.equal(g, w)
    if cell == "lif":
        _chunked_backward_matches_plain_version(x_dtype, state_dtype)


# T around each chunk length C (C - 1, C, C + 1, 2C + 3) and the GEN1
# sequence; starts 0, on the boundary of chunks of 2 and 4, and past the
# first chunk of up to 8
CHUNK_STEPS = sorted({t for c in cuda_kernels.CELL_BWD_CHUNKS
                      for t in (c - 1, c, c + 1, 2 * c + 3)} | {42})
CHUNK_STARTS = (0, 4, 9)


def _chunked_backward_matches_plain_version(x_dtype, state_dtype):
    """LIF under every chunk length the source builds, checkpoints in
    shared and in global memory, 256 and 128 threads, on the vector and
    the scalar path:
    every element bit-equal to autograd through the plain version."""
    for shape in ((3, 7, 5, 24), (1, 3, 5, 7)):
        for T in CHUNK_STEPS:
            if T < 2:
                continue
            x, v0, i0, gz, gv, gi = _bwd_inputs((T, *shape), x_dtype,
                                                state_dtype, seed=T)
            m = v0.numel()
            for start in CHUNK_STARTS:
                leaves = [a.detach().requires_grad_() for a in (x, v0, i0)]
                want = torch.autograd.grad(
                    cuda_kernels.temporal_cell_seq_reference(*leaves, "lif",
                                                             start),
                    leaves, (gz, gv, gi), allow_unused=True,
                    materialize_grads=True)
                width = 16 // x.element_size() if m % (
                    16 // x.element_size()) == 0 else 1
                for chunk in cuda_kernels.CELL_BWD_CHUNKS:
                    if not cuda_kernels.cell_bwd_built(chunk, width):
                        continue
                    threads = 128 if chunk in (4, 12) else 256
                    for shared in (True, False):
                        plan = cuda_kernels.cell_bwd_plan_of(
                            T, m, x_dtype, state_dtype, chunk, threads,
                            shared)
                        assert plan.vec == (m % (16 // x.element_size())
                                            == 0)
                        got = cuda_kernels.temporal_cell_seq_bwd(
                            x, v0, i0, gz, gv, gi, "lif", start, plan)
                        for g, w in zip(got, want):
                            assert g.dtype == w.dtype
                            torch.testing.assert_close(
                                g.float(), w.float(), rtol=0, atol=0,
                                equal_nan=True,
                                msg=lambda msg: f"T={T} start={start} "
                                f"{plan}: {msg}")


@pytest.mark.cuda
def test_temporal_cell_backward_rejects_bad_cotangents(card):
    x, v0, i0, gz, gv, gi = _bwd_inputs((3, 2, 8), torch.float32,
                                        torch.float32)
    with pytest.raises(ValueError, match="cotangents"):
        cuda_kernels.temporal_cell_seq_bwd(x, v0, i0, gz.bfloat16(), gv, gi)
    with pytest.raises(ValueError, match="cotangents"):
        cuda_kernels.temporal_cell_seq_bwd(x, v0, i0, gz, gv[:1], gi)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.temporal_cell_seq_bwd(x.cpu(), v0.cpu(), i0.cpu(),
                                           gz.cpu(), gv.cpu(), gi.cpu())


@pytest.mark.cuda
def test_narrow_training_on_the_card(card):
    """A narrow TinyYolo train step on each schedule on the card: one
    backward launch per cell and active step (13 cells), no fused
    launch, finite gradients; with cuDNN off the two schedules'
    gradients agree within rtol 2e-3 and match the same model's on the
    CPU (the plain versions) within rtol 2e-3."""
    cls, hw, _ = _cuda_models()["narrow_tiny_yolo"]
    rng = np.random.default_rng(3)
    T, B, r = 8, 2, 2
    X = (rng.random((T, B, *hw, 2)) < 0.4).astype(np.float32)
    lab = np.full((B, 4, 5), -1.0, np.float32)
    lab[:, 0] = [1, 0.2, 0.2, 0.6, 0.7]
    grads = {}
    torch.backends.cudnn.enabled = False
    try:
        for dev in ("cuda", "cpu"):
            model = cls(num_classes=2, in_hw=hw, device=dev, seed=1)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name.endswith(".scale"):
                        p.fill_(4.0)
            for schedule in (False, True):
                cuda_kernels.reset_launches()
                model.zero_grad()
                preds, _ = model.forward_fn(schedule)(
                    torch.from_numpy(X).to(dev), start_step=r, train=True)
                model.loss(preds, torch.from_numpy(lab).to(dev)).backward()
                if dev == "cuda":
                    n = cuda_kernels.LAUNCHES
                    assert n["temporal_cell_seq_bwd"] == \
                        13 * (1 if schedule else T - r)
                    assert n["spiking_conv_seq"] == 0
                grads[dev, schedule] = {
                    k: (torch.zeros_like(p) if p.grad is None
                        else p.grad).cpu()
                    for k, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.enabled = True
    for key in (("cuda", True), ("cpu", False)):
        for name, g in grads["cuda", False].items():
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g, grads[key][name], rtol=2e-3,
                                       atol=1e-7, msg=name)


@pytest.mark.cuda
def test_conv_layer_is_full_fp32_whatever_the_tf32_flag(card):
    """The Conv layer's fp32 forward and gradients are the same bits with
    the process's ``cudnn.allow_tf32`` on as with it off, where a plain
    ``F.conv2d`` under the flag on is not. cuDNN runs deterministic
    algorithms here (its backward of the input may otherwise differ from
    run to run in the last bits)."""
    import torch.nn.functional as F

    from snn_for_object_detection_tpu_torch.models import compile as C

    layer = C.Conv(64, 128, 3, 1, (30, 38)).cuda()
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x0 = torch.randn(4, 30, 38, 64,
                     generator=torch.Generator().manual_seed(1)).cuda()

    def run(flag, plain=False):
        torch.backends.cudnn.allow_tf32 = flag
        x = x0.clone().requires_grad_(True)
        layer.w.grad = None
        if plain:
            y = F.conv2d(x.permute(0, 3, 1, 2), layer.w, padding=1)
            y = y.permute(0, 2, 3, 1)
        else:
            y, _ = layer.step(x, None, C.Ctx())
        y.square().sum().backward()
        return y.detach(), x.grad, layer.w.grad

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.deterministic = True
    try:
        off, on, plain_on = run(False), run(True), run(True, plain=True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert not torch.equal(off[2], plain_on[2])


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
def test_registered_operators_match_plain_versions(card, x_dtype,
                                                   state_dtype):
    """``soda_torch::temporal_cell_seq`` and ``soda_torch::plif_cell_seq``
    called as operators: one forward launch each, bit-equal to the plain
    versions; their autograd is one launch of the backward kernel, whose
    gradients equal the backward's own called directly."""
    ops = torch.ops.soda_torch
    x, v0, i0 = _inputs((6, 2, 3, 5, 8), x_dtype, state_dtype)
    cm, cs = _plif_factors(8)
    for name, op, plain, bwd in (
        ("temporal_cell_seq",
         lambda x, v, i: ops.temporal_cell_seq(x, v, i, "lif", 2),
         lambda x, v, i: cuda_kernels.temporal_cell_seq_reference(
             x, v, i, "lif", 2),
         lambda x, v, i, g: cuda_kernels.temporal_cell_seq_bwd(
             x, v, i, *g, "lif", 2)),
        ("plif_cell_seq",
         lambda x, v, i: ops.plif_cell_seq(x, v, i, cm, cs, 2),
         lambda x, v, i: cuda_kernels.plif_cell_seq_reference(
             x, v, i, cm, cs, 2),
         lambda x, v, i, g: cuda_kernels.plif_cell_seq_bwd(
             x, v, i, cm, cs, *g, 2)[:3]),
    ):
        cuda_kernels.reset_launches()
        got = op(x, v0, i0)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES[name] == 1
        for g, w in zip(got, plain(x, v0, i0)):
            assert g.dtype == w.dtype
            torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=0,
                                       equal_nan=True)
        leaves = [x.clone().requires_grad_(True), v0, i0]
        cots = [torch.ones_like(t) for t in got]
        z, v, i = op(*leaves)
        (gx,) = torch.autograd.grad((z, v, i), leaves[:1], cots)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES[name + "_bwd"] == 1
        torch.testing.assert_close(gx, bwd(x, v0, i0, cots)[0], rtol=0,
                                   atol=0, equal_nan=True)


def _export_micro(dev, hw=(32, 40), **kw):
    """tests/test_detector.py's ``MicroSODa`` on ``dev`` (JAX-free, from
    tests/torch_rank_worker.py), BatchNorm gains at 4 so that it spikes."""
    from torch_rank_worker import micro_soda

    model = micro_soda()(num_classes=2, in_hw=hw, time_window=0, device=dev,
                         seed=2, **kw)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.fill_(4.0)
    return model


def _frames(n, b, hw=(32, 40), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, b, *hw, 2)) < 0.25).astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
def test_exported_cuda_program_is_predict(card, tmp_path, x_dtype,
                                          state_dtype):
    """A CUDA program exported and loaded on the narrow net: detections
    bit-equal to ``predict`` on the card over 4 frames at B=2, every cell
    a launch of its kernel a frame, and B=3 from the same file."""
    from snn_for_object_detection_tpu_torch import export
    from snn_for_object_detection_tpu_torch.models import compile as C

    model = _export_micro("cuda", compute_dtype=x_dtype,
                          state_dtype=state_dtype)
    cells = sum(isinstance(m, C.Cell) for m in model.modules())
    path = str(tmp_path / "predict.pt2")
    export.export_predict(model, path, platforms=("cuda",))
    runner = export.load_predict(path)
    for b in (2, 3):
        runner.reset()
        state = None
        cuda_kernels.reset_launches()
        for x in _frames(4, b):
            got = runner(x)
            assert got.is_cuda
            want, state = model.predict(torch.from_numpy(x).cuda(), state)
            assert torch.equal(got, want)
        # the runner's and predict's: a launch a cell and frame each
        assert cuda_kernels.LAUNCHES["temporal_cell_seq"] == 2 * 4 * cells
    with pytest.raises(ValueError, match="batch changed"):
        runner(_frames(1, 2)[0])


@pytest.mark.cuda
def test_one_file_holds_both_platforms(card, tmp_path):
    """``platforms=("cpu", "cuda")``: one file, each program traced on its
    own device; the CPU program is the CPU model's predict (the plain
    versions) and the CUDA one the card's (the kernels), bit for bit."""
    from snn_for_object_detection_tpu_torch import export
    from snn_for_object_detection_tpu_torch.models import compile as C

    model = _export_micro("cuda")
    cells = sum(isinstance(m, C.Cell) for m in model.modules())
    path = str(tmp_path / "predict.pt2")
    export.export_predict(model, path)
    cpu_model = _export_micro("cpu")
    cpu_model.load_state_dict(model.state_dict())
    for dev, m in (("cpu", cpu_model), ("cuda", model)):
        runner = export.load_predict(path, device=dev)
        state = None
        cuda_kernels.reset_launches()
        for x in _frames(3, 2, seed=1):
            want, state = m.predict(torch.from_numpy(x).to(dev), state)
            got = runner(x)
            assert got.device.type == dev and torch.equal(got, want)
        assert cuda_kernels.LAUNCHES["temporal_cell_seq"] == \
            (2 * 3 * cells if dev == "cuda" else 0)
