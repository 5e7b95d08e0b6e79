"""The port's fused spiking conv against the JAX package, on the CPU.

On the CPU, ``spiking_conv_seq`` and ``fused_pointwise_conv_bn_lif`` of
the port run their plain PyTorch versions. They are held against the
JAX Pallas kernels in interpret mode (as ``tests/test_pallas.py`` runs
them), and the fused schedule of a narrow TinyYolo against JAX's
``forward_seq(fuse_seq=True)`` on the same converted weights. The CUDA
kernel is held against the same plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py`` [3]). The kernel's
launch plan (``cuda_kernels.spiking_conv_plan``) is walked here as the
kernel walks it, for every GEN1 triple: each output is owned once.

Tolerances. With random weights the conv sums its products in another
order than XLA, so at fp32 z, v and i agree within rtol 1e-4, atol 1e-5;
in bf16, where the conv output is rounded to bf16 before and after the
affine, spikes agree on at least 99.9% of elements and v, i lie within
two ulps of the storage dtype on at least 99% (the gates of
``chip_smoke.py``). With 1 x 1 identity weights the conv is exact and
the port equals JAX bit for bit: that pins where the affine and the
cell round.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import outside_share, pointwise_i_outside, spike_agreement
from snn_for_object_detection_tpu.ops import pallas_kernels as jpk
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.ops import cuda_kernels
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from test_torch_detector import (
    HW,
    PRED_TOL,
    STATE_TOL,
    T,
    JNarrow,
    PNarrow,
    _frames,
    _jax_weights,
    _labels,
    _state_leaves,
)

torch.set_num_threads(1)

DTYPE_PAIRS = [
    ("float32", "float32"),
    ("bfloat16", "bfloat16"),
    ("bfloat16", "float8_e5m2"),
]
CASES = [  # (k, stride, cell) of tests/test_pallas.py
    (3, 1, "lif"), (3, 2, "lif"), (1, 1, "lif"),
    (3, 2, "li"), (1, 1, "li"), (1, 2, "lif"),
]


def _to_torch(a, dtype: str) -> torch.Tensor:
    # through fp32: every value of these dtypes is exact in fp32
    t = torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    return t.to(getattr(torch, dtype))


def _conv_inputs(seed, k, stride, x_dtype, state_dtype,
                 shape=(4, 2, 12, 19, 8), cout=16, w=None):
    """Seeded inputs as numpy-drawn JAX arrays (those of
    tests/test_pallas.py, with 1 x 1 weights three times as large so
    that they spike too): binary event input, normal weights, a BN
    affine away from identity, non-zero initial state."""
    rng = np.random.default_rng(seed)
    T_, n, h, wd, cin = shape
    ho, wo = -(-h // stride), -(-wd // stride)
    x = (rng.random(shape) < 0.3).astype(np.float32)
    if w is None:
        w = rng.normal(size=(k, k, cin, cout)) * 0.6 / k
    a = rng.uniform(0.5, 1.5, cout)
    b = rng.normal(size=cout) * 0.1
    v0 = rng.normal(size=(n, ho, wo, cout)) * 0.3
    i0 = rng.normal(size=(n, ho, wo, cout)) * 0.3
    f32 = lambda v: jnp.asarray(np.asarray(v, np.float32))
    return (f32(x).astype(x_dtype), f32(w), f32(a), f32(b),
            f32(v0).astype(state_dtype), f32(i0).astype(state_dtype))


def _run_both(args, cell, stride, x_dtype, state_dtype):
    want = jpk.spiking_conv_seq(*args, cell=cell, stride=stride,
                                interpret=True)
    dtypes = (x_dtype, "float32", "float32", "float32", state_dtype,
              state_dtype)
    got = cuda_kernels.spiking_conv_seq(
        *(_to_torch(a, d) for a, d in zip(args, dtypes)), cell=cell,
        stride=stride,
    )
    return got, [_to_torch(w, d) for w, d in
                 zip(want, (x_dtype, state_dtype, state_dtype))]


@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("k,stride,cell", CASES)
def test_plain_spiking_conv_matches_jax(k, stride, cell, x_dtype,
                                        state_dtype):
    args = _conv_inputs(3, k, stride, x_dtype, state_dtype)
    (z, v_t, i_t), (jz, jv, ji) = _run_both(args, cell, stride, x_dtype,
                                            state_dtype)
    assert z.dtype == getattr(torch, x_dtype)
    assert v_t.dtype == i_t.dtype == getattr(torch, state_dtype)
    assert z.shape == jz.shape and v_t.shape == jv.shape
    if cell == "lif":
        assert 0 < float(z.float().mean()) < 1  # the test really spikes
    if x_dtype == "float32":
        for g, w in ((z, jz), (v_t, jv), (i_t, ji)):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        return
    sd = getattr(torch, state_dtype)
    if cell == "lif":
        assert spike_agreement(z, jz) >= 0.999
    else:  # LI emits the membrane in x's dtype
        assert outside_share(z, jz, torch.bfloat16) <= 0.01
    for g, w in ((v_t, jv), (i_t, ji)):
        assert outside_share(g, w, sd) <= 0.01


@pytest.mark.parametrize("cell", ["lif", "li"])
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
def test_identity_weights_bit_equal_to_jax(x_dtype, state_dtype, cell):
    """1 x 1 identity weights make the conv exact, so what is left is
    the rounding of the affine (one fused multiply-add) and of the cell:
    bit for bit with JAX. Inputs are normal, not binary, so the bf16
    rounding of the conv output and of the affine both matter."""
    c = 16
    args = list(_conv_inputs(5, 1, 1, x_dtype, state_dtype,
                             shape=(6, 2, 5, 7, c), cout=c,
                             w=np.eye(c)[None, None]))
    rng = np.random.default_rng(6)
    args[0] = jnp.asarray(
        rng.normal(size=(6, 2, 5, 7, c)).astype(np.float32) * 2.0
    ).astype(x_dtype)
    got, want = _run_both(args, cell, 1, x_dtype, state_dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("cell", ["lif", "li"])
@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
def test_exact_sums_change_only_the_conv_sums(x_dtype, state_dtype, cell):
    """``exact_sums`` (the conv in float64, rounded once to fp32) is the
    witness's reference. With 1 x 1 identity weights the fp32 conv is
    exact too, so every output is bit-equal to the default: the option
    changes the conv sums and nothing else. With random 3 x 3 weights
    at fp32 the sums, and so the states, do differ."""
    c = 16
    args = list(_conv_inputs(5, 1, 1, x_dtype, state_dtype,
                             shape=(6, 2, 5, 7, c), cout=c,
                             w=np.eye(c)[None, None]))
    args[0] = jnp.asarray(np.random.default_rng(6).normal(
        size=(6, 2, 5, 7, c)).astype(np.float32) * 2.0).astype(x_dtype)
    dtypes = (x_dtype, "float32", "float32", "float32", state_dtype,
              state_dtype)
    t = [_to_torch(a, d) for a, d in zip(args, dtypes)]
    ref = cuda_kernels.spiking_conv_seq_reference
    for g, w in zip(ref(*t, cell=cell, exact_sums=True), ref(*t, cell=cell)):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=0,
                                   equal_nan=True)
    if x_dtype == "float32":
        t = [_to_torch(a, d) for a, d in zip(
            _conv_inputs(3, 3, 1, x_dtype, state_dtype), dtypes)]
        got, want = ref(*t, cell=cell, exact_sums=True), ref(*t, cell=cell)
        assert not torch.equal(got[2], want[2])


def _pointwise_inputs(rng, n, cin=64, cout=32):
    """The inputs of tests/test_pallas.py::make_inputs (fp32)."""
    x = rng.normal(size=(n, cin))
    w = rng.normal(size=(cin, cout)) * 0.1
    a = rng.uniform(0.5, 1.5, (cout,))
    b = rng.normal(size=(cout,)) * 0.1
    v = rng.normal(size=(n, cout)) * 0.4
    i = rng.normal(size=(n, cout)) * 0.4
    return [np.asarray(t, np.float32) for t in (x, w, a, b, v, i)]


def _check_pointwise_against_jax(args, x_dtype, state_dtype):
    """The port's pointwise op (its plain version on the CPU) against the
    Pallas kernel in interpret mode and its XLA oracle, on the same
    inputs cast to the same dtypes: z bit-equal; v' bit-equal to the
    Pallas kernel's in low precision, rtol 1e-5, atol 1e-6 at fp32 and
    against the XLA oracle (which, outside a kernel, rounds the decay's
    multiply-add on its own: a v_dec that nearly cancels moves by 1e-9
    there); i' within rtol 1e-5, atol 1e-6 at fp32; in bf16 within two
    ulps of the storage dtype plus what two fp32 sums of the Cin
    products in different orders may differ by
    (``chip_smoke.pointwise_i_outside``: at 1000 x 256 -> 128 in bf16
    one element of 128,000 cancels past two ulps between XLA's and
    PyTorch's CPU dot products)."""
    dtypes = (x_dtype, x_dtype, "float32", "float32", state_dtype,
              state_dtype)
    t = [_to_torch(a, d) for a, d in zip(args, dtypes)]
    z, v, i = cuda_kernels.fused_pointwise_conv_bn_lif(*t)
    jargs = [jnp.asarray(a).astype(d) for a, d in zip(args, dtypes)]
    for oracle, (jz, jv, ji) in (
        ("pallas", jpk.fused_pointwise_conv_bn_lif(*jargs, interpret=True)),
        ("xla", jpk.xla_pointwise_conv_bn_lif(*jargs)),
    ):
        np.testing.assert_array_equal(z.float().numpy(),
                                      np.asarray(jz.astype(jnp.float32)))
        jv32 = np.asarray(jv.astype(jnp.float32))
        if state_dtype == "float32" or oracle == "xla":
            np.testing.assert_allclose(v.float().numpy(), jv32, rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(v.float().numpy(), jv32)
        ji_t = _to_torch(np.asarray(ji.astype(jnp.float32)), state_dtype)
        assert pointwise_i_outside(i, ji_t, *t[:3])[1] == 0.0
    assert 0 < float(z.float().mean()) < 1


@pytest.mark.parametrize("n", [256, 700])
def test_plain_pointwise_matches_jax(n):
    """Against the Pallas kernel (interpret mode) and its XLA oracle at
    64 -> 32, in fp32, bf16 and bf16 with e5m2 states; N = 700 is the
    ragged case of tests/test_pallas.py."""
    for x_dtype, state_dtype in DTYPE_PAIRS:
        args = _pointwise_inputs(np.random.default_rng(42), n)
        _check_pointwise_against_jax(args, x_dtype, state_dtype)


@pytest.mark.parametrize("x_dtype,state_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("n,cin,cout", [(1000, 256, 128), (700, 128, 64)])
def test_plain_pointwise_matches_jax_on_bench_shapes(n, cin, cout, x_dtype,
                                                     state_dtype):
    """Ragged, narrow versions of benchmarks/bench_pallas.py's C2f
    shapes (256 -> 128 and 128 -> 64), every dtype pair."""
    args = _pointwise_inputs(np.random.default_rng(42), n, cin, cout)
    _check_pointwise_against_jax(args, x_dtype, state_dtype)


def _count_calls(monkeypatch):
    """Record ``(k, stride, cell, Cin, Cout)`` of every fused call: the
    port's plain spiking conv and JAX's (traced) Pallas one."""
    calls = {"port": [], "jax": []}
    port_ref = cuda_kernels.spiking_conv_seq_reference
    jax_fn = jpk.spiking_conv_seq

    def port(x, w, a, b, v0, i0, cell="lif", stride=1):
        calls["port"].append((w.shape[0], stride, cell, *w.shape[2:]))
        return port_ref(x, w, a, b, v0, i0, cell, stride)

    def jax_call(x, w, a, b, v0, i0, cell="lif", stride=1, **kw):
        calls["jax"].append((w.shape[0], stride, cell, *w.shape[2:]))
        return jax_fn(x, w, a, b, v0, i0, cell=cell, stride=stride, **kw)

    monkeypatch.setattr(cuda_kernels, "spiking_conv_seq_reference", port)
    monkeypatch.setattr(jpk, "spiking_conv_seq", jax_call)
    return calls


@pytest.fixture(scope="module")
def fused_pair():
    jm = JNarrow(num_classes=2, in_hw=HW, fuse_seq=True)
    params, stats = _jax_weights(jm, 0, 8.0)
    return jm, params, stats


def _port_model(params, stats, **kw):
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu", **kw)
    load_jax_params(pm, params, stats)
    return pm


def test_fused_narrow_tiny_yolo_matches_jax(fused_pair, monkeypatch):
    """The fused schedule against JAX's, on weights converted from JAX:
    predictions and final states within the detector tolerances, and the
    same 13 triples fused (10 LIF, 3 LI)."""
    jm, params, stats = fused_pair
    calls = _count_calls(monkeypatch)
    X = _frames(1)
    (j_cls, j_box), _, j_state = jax.jit(
        lambda x: jm.forward_seq(params, stats, x)
    )(jnp.asarray(X))
    pm = _port_model(params, stats, fuse_seq=True)
    (cls, box), state = pm.forward_seq(torch.from_numpy(X))
    assert len(calls["port"]) == 13
    assert sorted(calls["port"]) == sorted(calls["jax"])
    assert sum(c[2] == "li" for c in calls["port"]) == 3
    assert float(cls.abs().max()) > 0.1  # the net is not silent
    np.testing.assert_allclose(cls.numpy(), np.asarray(j_cls), **PRED_TOL)
    np.testing.assert_allclose(box.numpy(), np.asarray(j_box), **PRED_TOL)
    jl, pl = jax.tree.leaves(j_state), _state_leaves(state)
    assert len(jl) == len(pl) == 2 * 13
    for j, p in zip(jl, pl):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **STATE_TOL)


def test_truncated_forward_seq_does_not_fuse(fused_pair, monkeypatch):
    """A truncation start keeps the fused model on the unfused schedule
    (JAX fuses only at the Python int start 0), with the same results;
    asking for the fused kernel with a start raises."""
    _, params, stats = fused_pair
    calls = _count_calls(monkeypatch)
    X = torch.from_numpy(_frames(2))
    fused = _port_model(params, stats, fuse_seq=True)
    plain = _port_model(params, stats)
    (c1, b1), s1 = fused.forward_seq(X, start_step=3)
    (c2, b2), s2 = plain.forward_seq(X, start_step=3)
    assert calls["port"] == []
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)
    torch.testing.assert_close(b1, b2, rtol=0, atol=0)
    for p1, p2 in zip(_state_leaves(s1), _state_leaves(s2)):
        torch.testing.assert_close(p1, p2, rtol=0, atol=0)
    with pytest.raises(ValueError, match="truncation gate"):
        fused.forward_seq(X, start_step=3, fuse=True)


@pytest.mark.parametrize("time_window", [0, T - 1])
def test_trainer_fuses_only_without_time_window(fused_pair, monkeypatch,
                                               time_window):
    """``Trainer(time_batched=True)`` reaches the fused kernel only at
    ``time_window == 0``, as the JAX eval step does (it passes a traced
    start otherwise, even for a draw of 0). With a window the fused
    model gives the unfused model's metrics exactly."""
    _, params, stats = fused_pair
    calls = _count_calls(monkeypatch)
    batches = [(_frames(10 + k), _labels(20 + k)) for k in range(2)]
    got = {}
    for fuse in (True, False):
        pm = _port_model(params, stats, fuse_seq=fuse,
                         time_window=time_window)
        trainer = Trainer(limit_test_batches=5, seed=3, time_batched=True)
        got[fuse] = trainer.test(pm, iter(batches))
    if time_window:
        assert calls["port"] == []
        assert got[True] == got[False]
    else:
        assert len(calls["port"]) == 13 * len(batches)
        for k in got[False]:
            np.testing.assert_allclose(got[True][k], got[False][k],
                                       rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def gen1_triples():
    """``(k, stride, Cin, Cout, out_hw)`` of the 22 fused triples of
    TinyYolo at GEN1 width (240 x 304), in launch order."""
    from chip_smoke import fused_convs
    from snn_for_object_detection_tpu_torch.models.compile import Block
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo

    m = TinyYolo(num_classes=2, in_hw=(240, 304), fuse_seq=True,
                 device="cpu")
    return [(c.w.shape[-1], c.stride, c.w.shape[1], c.w.shape[0], c.out_hw)
            for top in (m.backbone, m.neck, *(h["base"] for h in m.heads()))
            for c in fused_convs(Block, top)]


def _check_plan_covers(plan, k, stride, n, ho, wo, cin, cout, x_bytes):
    """Walk the plan as ``csrc/spiking_conv.cu`` does: every CTA's
    (image, pixel tile, channel tile) from its block index (channel
    tiles fastest), every thread's pixel and 8 channels from its thread
    index (channel group tid % (co / 8), pixel tid / (co / 8) of the
    tile). The CTAs tile the output map and
    the threads their tile, each exactly once, so each output pixel and
    channel is owned exactly once (for every step: a thread owns its
    pixel's 4 steps of each block; outputs past the map's edge are
    masked). Shared memory is the source's and at most 227 KB; the grid
    is the source's."""
    assert plan.smem == cuda_kernels.spiking_conv_smem(
        plan.resident, k, stride, cin, plan.co, plan.th, plan.tw, plan.kc,
        x_bytes)
    assert plan.smem <= cuda_kernels.SC_MAX_SMEM == 232448
    assert plan.grid == cuda_kernels.spiking_conv_grid(
        n, ho, wo, cout, plan.co, plan.th, plan.tw)
    assert plan.threads in cuda_kernels.SC_THREADS
    # the CTAs: each (image, pixel tile, channel tile) once, channel
    # tiles fastest
    co_tiles = -(-cout // plan.co)
    tiles_w = -(-wo // plan.tw)
    tiles = -(-ho // plan.th) * tiles_w
    bid = np.arange(plan.grid)
    cot, rest = bid % co_tiles, bid // co_tiles
    tile, img = rest % tiles, rest // tiles
    origin = ((img * -(-ho // plan.th) + tile // tiles_w) * tiles_w
              + tile % tiles_w) * co_tiles + cot
    assert img.max() == n - 1 and (np.bincount(origin) == 1).all()
    # a CTA's threads: each of its th x tw pixels x co channels once
    tid = np.arange(plan.threads)[:, None]
    q = np.arange(8)[None, :]
    groups = plan.co // 8
    assert plan.threads == groups * plan.th * plan.tw
    cg, pg = tid % groups, tid // groups
    oy, ox, co = pg // plan.tw, pg % plan.tw, cg * 8 + q
    owned = np.bincount(((oy * plan.tw + ox) * plan.co + co).ravel(),
                        minlength=plan.th * plan.tw * plan.co)
    assert owned.size == plan.th * plan.tw * plan.co and (owned == 1).all()


# the plans take x's dtype only (bf16 with bf16 or e5m2 states alike)
PLAN_DTYPES = sorted({getattr(torch, x) for x, _ in DTYPE_PAIRS}, key=str)


_COVERED = set()  # plans already walked by _check_plan_covers


def _check_layer_plans(k, stride, n, ho, wo, cin, cout, x_dtype, sms):
    """Every plan of a layer covers it (``_check_plan_covers``, once per
    plan and layer); the plan is one of them."""
    plans = cuda_kernels.spiking_conv_plans(k, stride, n, ho, wo, cin, cout,
                                            x_dtype)
    assert plans
    for plan in plans:
        key = (plan, k, stride, n, ho, wo, cin, cout, x_dtype)
        if key not in _COVERED:
            _check_plan_covers(plan, k, stride, n, ho, wo, cin, cout,
                               x_dtype.itemsize)
            _COVERED.add(key)
    plan = cuda_kernels.spiking_conv_plan(k, stride, n, ho, wo, cin, cout,
                                          x_dtype, sms)
    assert plan in plans
    return plans, plan


@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("triple", range(22))
def test_launch_plan_covers_gen1_triple(gen1_triples, triple, batch):
    """Every launch plan of each GEN1 triple at B = 4 and B = 1, for each
    x dtype of the three dtype pairs, covers every output pixel and
    channel exactly once within 227 KB of shared memory; the plan on a
    card of 132 SMs is one of them. Where fp32 weights of Cin = 256 are
    resident (the 3 x 3 downsamples of stages 4 and 5) the channel tile
    is at most 16."""
    assert len(gen1_triples) == 22
    k, stride, cin, cout, (ho, wo) = gen1_triples[triple]
    for x_dtype in PLAN_DTYPES:
        plans, _ = _check_layer_plans(k, stride, batch, ho, wo, cin,
                                      cout, x_dtype, 132)
        if k == 3 and cin == 256:
            assert all(p.co <= 16 for p in plans if p.resident)


@pytest.mark.parametrize("shape", [  # (k, stride, N, Cin, Cout, Ho, Wo)
    (3, 1, 2, 16, 40, 13, 19), (3, 2, 1, 2, 18, 5, 4),
    (3, 1, 1, 128, 24, 8, 10), (1, 1, 1, 256, 32, 1, 700),
    (1, 2, 3, 24, 24, 3, 3),
])
def test_launch_plan_covers_odd_shapes(shape):
    """Shapes of the card tests: Cout off the channel tile and off a
    multiple of 8, an 8 x 10 and a 1 x 700 map, N = 1, Cin off 16; every
    plan for each x dtype, and the plan on a card of 132 SMs and of
    one SM."""
    k, stride, n, cin, cout, ho, wo = shape
    for x_dtype in PLAN_DTYPES:
        for sms in (132, 1):
            _check_layer_plans(k, stride, n, ho, wo, cin, cout, x_dtype, sms)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_kernel_weights_kept_until_the_weights_change(x_dtype):
    """The weights the kernel reads (w rounded to x's dtype, as fp32
    [Cin][k][k][Cout]) are copied once per weight tensor: the same view
    of the same parameter, as the fused schedule hands it every step,
    gets the kept copy; an in-place update makes a new one."""
    xd = getattr(torch, x_dtype)
    p = torch.nn.Parameter(torch.randn(16, 8, 3, 3,
                                       generator=torch.Generator()
                                       .manual_seed(0)))
    got = cuda_kernels.spiking_conv_weights(p.permute(2, 3, 1, 0), xd)
    assert got.dtype == torch.float32 and got.is_contiguous()
    torch.testing.assert_close(
        got, p.detach().to(xd).float().permute(1, 2, 3, 0), rtol=0, atol=0)
    assert cuda_kernels.spiking_conv_weights(p.permute(2, 3, 1, 0),
                                             xd) is got
    with torch.no_grad():
        p.mul_(2.0)
    new = cuda_kernels.spiking_conv_weights(p.permute(2, 3, 1, 0), xd)
    assert new is not got
    torch.testing.assert_close(new, 2.0 * got, rtol=0, atol=0)


@pytest.mark.parametrize("cin,want_co", [(2, 64), (128, 32), (256, 16)])
def test_ffma_weights_resident_for_the_whole_time_loop(cin, want_co):
    """Where they fit, the kernel keeps all of a CTA's fp32 weights
    (every tap and input channel of its channel tile) in shared memory
    for the whole time loop, beside the ring: at Cin = 128 at most a
    32-channel tile (147,456 bytes of weights), at Cin = 256 at most a
    16-channel one; elsewhere the plans stream them with each chunk of
    input channels, once a block of 4 steps. The stem stages its 2
    input channels, not a chunk of 16."""
    for stride, ho, wo in ((2, 30, 38), (1, 60, 76)):
        plans = cuda_kernels.spiking_conv_plans(3, stride, 4, ho, wo, cin,
                                                256, torch.float32)
        resident = [p for p in plans if p.resident]
        assert all(p.co <= want_co for p in resident)
        assert all(p.smem >= 4 * 9 * cin * p.co for p in resident)
        assert any(not p.resident for p in plans)
        if cin == 2:
            assert all(p.kc == 2 for p in plans)
            assert max(p.co for p in resident) == want_co
    assert max(p.co for p in cuda_kernels.spiking_conv_plans(
        3, 1, 4, 60, 76, cin, 256, torch.float32) if p.resident) == want_co


def test_wrappers_reject_bad_arguments():
    x = torch.zeros(2, 1, 6, 6, 4)
    w = torch.zeros(3, 3, 4, 8)
    a = torch.ones(8)
    v = torch.zeros(1, 6, 6, 8)
    conv = cuda_kernels.spiking_conv_seq
    with pytest.raises(ValueError, match="cell"):
        conv(x, w, a, a, v, v, cell="alif")
    with pytest.raises(ValueError, match="stride"):
        conv(x, w, a, a, v, v, stride=3)
    with pytest.raises(ValueError, match="k in"):
        conv(x, torch.zeros(5, 5, 4, 8), a, a, v, v)
    with pytest.raises(ValueError, match="want state"):
        conv(x, w, a, a, v, v, stride=2)
    with pytest.raises(TypeError, match="state dtypes"):
        conv(x, w, a, a, v, v.bfloat16())
    with pytest.raises(TypeError, match="x_seq dtype"):
        conv(x.half(), w, a, a, v, v)
    pw = cuda_kernels.fused_pointwise_conv_bn_lif
    xs, ws, vs = torch.zeros(5, 4), torch.zeros(4, 8), torch.zeros(5, 8)
    with pytest.raises(TypeError, match="x and w dtypes"):
        pw(xs, ws.bfloat16(), a, a, vs, vs)
    with pytest.raises(ValueError, match="want x"):
        pw(xs, ws, a, a, vs[:4], vs[:4])


# ---- the TPU kernel's tap-major sum order, mirrored on the CPU ----
# (the order of a bf16 mma.sync route for csrc/spiking_conv.cu, measured
# on the card and left out: it missed chip_smoke.py [7]'s 0.99 gate)


def tap_major_takes(x_dtype, cin, cout) -> bool:
    """The layers such a route takes: bf16 x, Cin in whole k16 steps,
    Cout in whole n8 tiles."""
    return x_dtype == torch.bfloat16 and cin % 16 == 0 and cout % 8 == 0

def tap_major_reference(x_seq, w, a, b, v0, i0, cell="lif", stride=1,
                        drop_tap=None):
    """``spiking_conv_seq`` with the conv summed in the TPU kernel's order:
    per tap, the dot over Cin in k16 chunks, each chunk's fp32 sum added
    in order to the tap's fp32 sum; the taps added to an fp32
    accumulator in (dy, dx) order. Layers it does not take
    (``tap_major_takes``) keep the plain version's sums. ``drop_tap`` leaves one tap of every 3 x 3
    layer out (a fault, for the witness). Everything after the conv
    rounds as the plain version does."""
    from snn_for_object_detection_tpu_torch.ops import neurons

    k, cin, cout = w.shape[0], w.shape[2], w.shape[3]
    if not tap_major_takes(x_seq.dtype, cin, cout):
        return cuda_kernels.spiking_conv_seq_reference(
            x_seq, w, a, b, v0, i0, cell, stride)
    xd, sd = x_seq.dtype, v0.dtype
    ho, wo = v0.shape[1:3]
    wf = w.to(xd).float()
    step = neurons.lif_step if cell == "lif" else neurons.li_step
    v, i = v0.float(), i0.float()
    z = torch.empty(x_seq.shape[:2] + v0.shape[1:], dtype=xd)
    pad = k // 2
    for t in range(x_seq.shape[0]):
        xp = torch.nn.functional.pad(x_seq[t].float(),
                                     (0, 0, pad, pad, pad, pad))
        acc = torch.zeros(v0.shape)
        for tap in range(k * k):
            dy, dx = divmod(tap, k)
            if k == 3 and tap == drop_tap:
                continue
            patch = xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                       dx:dx + (wo - 1) * stride + 1:stride, :]
            m = torch.zeros(v0.shape)
            for c0 in range(0, cin, 16):
                m = m + patch[..., c0:c0 + 16] @ wf[dy, dx, c0:c0 + 16]
            acc = acc + m
        y = neurons.fma(acc.to(xd).float(), a.float(), b.float()).to(xd)
        out, (v, i) = step(y.float(), (v, i))
        z[t] = out.to(xd)
        v, i = v.to(sd).float(), i.to(sd).float()
    return z, v.to(sd), i.to(sd)


def test_tap_major_reference_is_the_sum_in_another_order():
    """On one bf16 layer the mirror agrees with the plain version as two
    fp32 sums of the same exact products do (1 x 1 identity weights:
    bit for bit), and dropping a tap moves it far."""
    c = 32
    args = list(_conv_inputs(5, 1, 1, "bfloat16", "bfloat16",
                             shape=(4, 2, 5, 7, c), cout=c,
                             w=np.eye(c)[None, None]))
    t = [_to_torch(a_, d) for a_, d in zip(args, (
        "bfloat16", "float32", "float32", "float32", "bfloat16",
        "bfloat16"))]
    for g, w_ in zip(tap_major_reference(*t),
                     cuda_kernels.spiking_conv_seq_reference(*t)):
        torch.testing.assert_close(g.float(), w_.float(), rtol=0, atol=0)
    t = [_to_torch(a_, d) for a_, d in zip(
        _conv_inputs(3, 3, 1, "bfloat16", "bfloat16",
                     shape=(6, 2, 12, 19, 32), cout=16),
        ("bfloat16", "float32", "float32", "float32", "bfloat16",
         "bfloat16"))]
    got = tap_major_reference(*t)
    want = cuda_kernels.spiking_conv_seq_reference(*t)
    assert spike_agreement(got[0], want[0]) >= 0.999
    for g, w_ in zip(got[1:], want[1:]):
        assert outside_share(g, w_, torch.bfloat16) <= 0.01
    bad = tap_major_reference(*t, drop_tap=8)
    assert outside_share(bad[2], want[2], torch.bfloat16) > 0.1


def _port_tree(like, leaves):
    """JAX state leaves (pytree order) in the port's state tree ``like``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(node[key]) for key in sorted(node)}
        return [torch.tensor(np.asarray(next(it).astype(jnp.float32)))
                .to(x.dtype) for x in node]

    return walk(like)


@pytest.fixture(scope="module")
def fused_bf16_runs():
    """The narrow fused TinyYolo in bf16 with e5m2 states on converted
    weights: JAX's run (its Pallas ``spiking_conv_seq`` in interpret
    mode) and the port's run with exact conv sums (float64, rounded
    once), as ``(preds, cells)``, with the port model and input."""
    from snn_for_object_detection_tpu_torch.models import compile as PC
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        model_cells,
    )

    dt = dict(compute_dtype="bfloat16", state_dtype="float8_e5m2")
    jm = JNarrow(num_classes=2, in_hw=HW, fuse_seq=True, **dt)
    params, stats = _jax_weights(jm, 0, 8.0)
    X = _frames(1)
    (j_cls, j_box), _, j_state = jax.jit(
        lambda x: jm.forward_seq(params, stats, x))(jnp.asarray(X))
    pm = _port_model(params, stats, fuse_seq=True, **dt)
    Xt = torch.from_numpy(X)
    _, like = pm.forward_seq(Xt)
    jax_run = ([torch.tensor(np.asarray(j_cls, np.float32)),
                torch.tensor(np.asarray(j_box, np.float32))],
               model_cells(pm, _port_tree(like, jax.tree.leaves(j_state))))
    saved = PC.spiking_conv_seq
    PC.spiking_conv_seq = functools.partial(
        cuda_kernels.spiking_conv_seq_reference, exact_sums=True)
    try:
        (cls, box), state = pm.forward_seq(Xt)
    finally:
        PC.spiking_conv_seq = saved
    return pm, Xt, jax_run, ([cls, box], model_cells(pm, state))


@pytest.mark.parametrize("fault", [False, True])
def test_tap_major_order_passes_the_witness(fused_bf16_runs, monkeypatch,
                                            fault):
    """The witness (``megakernel.witness_passes``) on the narrow fused
    TinyYolo in bf16 with e5m2 states: the tap-major sum order (its CPU
    mirror, ``tap_major_reference``) is no further from the exact-sum
    run than JAX's ``spiking_conv_seq`` in interpret mode, within the
    witness's slack; the same order with one tap dropped is refused."""
    from snn_for_object_detection_tpu_torch.models import compile as PC
    from snn_for_object_detection_tpu_torch.ops.megakernel import (
        model_cells,
        run_distance,
        witness_passes,
    )

    pm, Xt, jax_run, exact = fused_bf16_runs
    calls = []

    def mirror(*args, **kw):
        calls.append(tap_major_takes(args[0].dtype, args[1].shape[2],
                                     args[1].shape[3]))
        return tap_major_reference(*args, **kw,
                                   drop_tap=8 if fault else None)

    monkeypatch.setattr(PC, "spiking_conv_seq", mirror)
    (cls, box), state = pm.forward_seq(Xt)
    assert len(calls) == 13 and any(calls) and not all(calls)
    got = run_distance([cls, box], model_cells(pm, state), *exact)
    plain = run_distance(*jax_run, *exact)
    assert witness_passes(got, plain) is not fault, (got, plain)
