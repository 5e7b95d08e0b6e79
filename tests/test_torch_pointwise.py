"""The launch plan of the port's pointwise kernel (``csrc/pointwise.cu``)
and the gate its card checks hold it to, on the CPU.

``cuda_kernels.pointwise_plan`` is pure Python: it is walked here as the
kernel walks it (CTAs over row tiles and Cout splits, and, inside a tile,
the warps of the mma branch or the threads of the FFMA branch over rows
and channels, mirrored from the source), so that every output is owned
exactly once, the shared memory fits, and x is read once wherever the
weight slab fits. ``chip_smoke.pointwise_i_outside`` is held to tell a
sum taken in another order (which it must pass) from a dropped product
(which it must refuse).
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import POINTWISE_CASES, pointwise_i_outside
from snn_for_object_detection_tpu_torch.ops import cuda_kernels as K

torch.set_num_threads(1)

DTYPE_PAIRS = [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float8_e5m2),
]
EDGE_SHAPES = [(1, 2, 32), (777, 40, 32), (5, 40, 40), (300, 256, 256),
               (1001, 128, 64), (33, 200, 136), (64, 2, 64)]


def _owned(plan, n, cout, sx):
    """How many times the kernel computes and stores each output under
    ``plan``: CTA b takes the Cout split b % splits and the row tiles
    b // splits + k * (grid // splits); inside a tile, each (row,
    channel) below (rows, wc) belongs to one accumulator (the source's
    warp_tile / thread_tile), and the store pass keeps rows < N and
    channels < Cout."""
    owned = np.zeros((n, cout), np.int32)
    tile_own = np.zeros((plan.rows, plan.cout_tile), np.int32)
    threads = plan.threads
    if sx == 2:
        wc = -(-plan.cout_tile // 8) * 8
        wm = plan.rows // 16
        wn = threads // 32 // wm
        npw = -(-(wc // 8) // wn)
        for warp in range(threads // 32):
            m, nn = warp % wm, warp // wm
            for j in range(max(0, min(npw, wc // 8 - nn * npw))):
                c0 = nn * npw * 8 + j * 8
                r = slice(m * 16, m * 16 + 16)
                c = slice(c0, min(c0 + 8, plan.cout_tile))
                tile_own[r, c] += 1
    else:
        wc = -(-plan.cout_tile // 4) * 4
        cgp = 1
        while cgp * 8 < wc:
            cgp *= 2
        rm = plan.rows // (threads // cgp)
        assert rm in (1, 2, 4) and rm * (threads // cgp) == plan.rows
        for tid in range(threads):
            cg, rb = tid % cgp, (tid // cgp) * rm
            for c0 in (cg * 4, cgp * 4 + cg * 4):
                if c0 < wc:
                    tile_own[rb:rb + rm, c0:min(c0 + 4, plan.cout_tile)] += 1
    assert (tile_own == 1).all()
    row_tiles = -(-n // plan.rows)
    assert plan.grid % plan.splits == 0 and plan.grid >= 1
    for b in range(plan.grid):
        split = b % plan.splits
        c0 = split * plan.cout_tile
        c1 = min(cout, c0 + plan.cout_tile)
        for t in range(b // plan.splits, row_tiles,
                       plan.grid // plan.splits):
            r0, r1 = t * plan.rows, min(n, (t + 1) * plan.rows)
            owned[r0:r1, c0:c1] += tile_own[:r1 - r0, :c1 - c0]
    return owned


@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("shape", POINTWISE_CASES + tuple(EDGE_SHAPES))
def test_plan_owns_every_output_once(shape, x_dtype, state_dtype):
    """The plan's CTAs, row tiles, Cout splits and accumulators cover
    every output exactly once, on a card of 132 SMs (at the plan's CTAs
    an SM and at 1) and of 3, and so does every other row tile the
    kernel takes."""
    n, cin, cout = shape
    sx, _ = K._pw_sizes(x_dtype, state_dtype)
    for sms, per_sm in ((132, None), (132, 1), (3, 2)):
        plan = K.pointwise_plan(n, cin, cout, x_dtype, state_dtype, sms,
                                per_sm)
        assert (_owned(plan, n, cout, sx) == 1).all()
    if n * cout <= 300 * 256:
        for rows in K.pointwise_rows(plan.cout_tile, sx):
            other = dataclasses.replace(
                plan, rows=rows, grid=K.pointwise_grid(n, rows, plan.splits,
                                                       7, 1))
            assert (_owned(other, n, cout, sx) == 1).all()


@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("shape", POINTWISE_CASES + tuple(EDGE_SHAPES))
def test_plan_fits_and_reads_x_once(shape, x_dtype, state_dtype):
    """Shared memory stays within the 227 KB of a CTA (and the plan's
    CTAs an SM within the SM's 228 KB), and Cout is split only where the
    whole slab does not fit: x is read once whenever it does. At fp32
    256 -> 256 the slab is split in two."""
    n, cin, cout = shape
    sx, ss = K._pw_sizes(x_dtype, state_dtype)
    plan = K.pointwise_plan(n, cin, cout, x_dtype, state_dtype, 132)
    assert plan.smem == K.pointwise_smem(cin, plan.cout_tile, plan.rows,
                                         sx, ss)[1]
    assert plan.smem <= K.PW_MAX_SMEM
    assert plan.ctas_per_sm * (plan.smem + K.PW_CTA_RESERVED) \
        <= K.PW_SM_SMEM
    whole = K.pointwise_smem(cin, cout, 0, sx, ss)[0]
    fits = whole <= K.PW_SLAB_MAX and bool(K.pointwise_rows(cout, sx))
    assert (plan.splits == 1) == fits
    assert plan.splits == -(-cout // plan.cout_tile)
    if (cin, cout, sx) == (256, 256, 4):
        assert plan.splits == 2
    if plan.splits == 1:
        assert plan.cout_tile == cout


def test_plan_fills_the_card_where_it_can():
    """With enough row tiles every CTA of the grid gets one; with few,
    the plan takes its smallest row tile, for the most CTAs."""
    big = K.pointwise_plan(72960, 64, 64, torch.float32, torch.float32, 132)
    assert big.grid == 132 * big.ctas_per_sm
    small = K.pointwise_plan(1000, 256, 128, torch.float32, torch.float32,
                             132)
    assert small.rows == min(K.pointwise_rows(small.cout_tile, 4))
    assert small.grid == -(-1000 // small.rows)


def _ordered_i(args, order, drop=None):
    """i' of the plain version with the product summed in ``order`` of
    k, one fused multiply-add at a time (``drop``: leave product k out)."""
    x, w = args[0].float(), args[1].float()
    y = torch.zeros(x.shape[0], w.shape[1])
    for k in order:
        if k != drop:
            y = torch.addcmul(y, x[:, k:k + 1], w[k:k + 1])
    c_mem, c_syn = K._euler("lif")
    i = args[5].float()
    i_dec = K.neurons.fma(i, -c_syn, i)
    return (i_dec + K.neurons.fma(y, args[2], args[3])).to(args[5].dtype)


@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
def test_i_gate_tells_reorderings_from_faults(x_dtype, state_dtype):
    """At 4000 x 256 -> 32, with one product dropped (k = 5, or the
    last) i' falls outside ``pointwise_i_outside``'s gate. With bf16 x,
    i' summed k last to first, or in 16-wide blocks taken from the last
    (as the tensor cores may), passes it. With fp32 x the gate is the
    strict tolerance (rtol 1e-5, atol 1e-6), which such reordered sums
    already miss on some elements: the fp32 kernel must sum as the plain
    version does closely enough to meet it."""
    rng = np.random.default_rng(0)
    n, cin, cout = 4000, 256, 32
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    args = (f(rng.normal(size=(n, cin))).to(x_dtype),
            f(rng.normal(size=(cin, cout)) * 0.1).to(x_dtype),
            f(rng.uniform(0.5, 1.5, cout)), f(rng.normal(size=cout) * 0.1),
            f(rng.normal(size=(n, cout)) * 0.4).to(state_dtype),
            f(rng.normal(size=(n, cout)) * 0.4).to(state_dtype))
    want = K.fused_pointwise_conv_bn_lif_reference(*args)[2]
    blocks = [k for b in reversed(range(0, cin, 16)) for k in range(b, b + 16)]
    for order in (list(reversed(range(cin))), blocks):
        strict, gate = pointwise_i_outside(_ordered_i(args, order), want,
                                           *args[:3])
        if x_dtype == torch.float32:
            assert gate == strict > 0.0
        else:
            assert gate == 0.0
    for drop in (5, cin - 1):
        _, gate = pointwise_i_outside(_ordered_i(args, range(cin), drop),
                                      want, *args[:3])
        assert gate > 0.01
