"""The port's training pieces against the JAX package, on the CPU.

Seeded numpy inputs go through the JAX function and its counterpart in
the port:

- ``superspike``, ``lif_step`` and ``li_step`` gradients;
- the ``temporal_cell_seq`` VJP: autograd through the port's plain
  version against JAX's custom VJP of ``temporal_cell_seq`` (the Pallas
  kernel forward in interpret mode, the scan backward), LIF and LI,
  truncation start 0 and 3, fp32, bf16 and e5m2 states; and the order
  of the card's backward kernel (mirrored in numpy) bit-equal to that
  autograd;
- train-mode Norm, step and sequence form: outputs, gradients and the
  new running statistics, with truncation;
- global-norm clipping, the three learning-rate schedules, the four
  optimizers and ``MultiSteps`` against optax on small trees; the EMA
  against its closed form under accumulation;
- the checkpoint manager's save / prune / restore and ``fit`` resuming
  from ``ckpt_path="auto"``; every mode left out raising.

The whole narrow TinyYolo (gradients, running statistics, the 8-step
Adamax trajectory) is in ``tests/test_torch_train_model.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snn_for_object_detection_tpu.models import compile as JC
from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.ops import neurons as jn
from snn_for_object_detection_tpu.ops import pallas_kernels as jpk
from snn_for_object_detection_tpu_torch.models import compile as PC
from snn_for_object_detection_tpu_torch.models import spec as PS
from snn_for_object_detection_tpu_torch.ops import cuda_kernels, neurons
from snn_for_object_detection_tpu_torch.train import loop
from snn_for_object_detection_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_single,
    save_single,
)
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from test_torch_detector import PNarrow

torch.set_num_threads(1)

STATE_DTYPES = ["float32", "bfloat16", "float8_e5m2"]
# storage ulp at 1 of each state dtype: the cotangent carried between
# steps is rounded to it
ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7, "float8_e5m2": 2.0 ** -2}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


# ---- cells ----


def test_superspike_gradient_matches_jax():
    """Forward strict ``x > 0``; backward ``g / (100|x| + 1)^2`` bit for
    bit (both are four separately rounded fp32 ops)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(1000) * 0.05, [0.0, -0.0]]
                       ).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jn.superspike(a, 100.0), jnp.asarray(x))
    tx = _t(x).requires_grad_()
    tz = neurons.superspike(tx)
    (tg,) = torch.autograd.grad(tz, tx, _t(g))
    np.testing.assert_array_equal(tz.detach().numpy(), _np(out))
    np.testing.assert_array_equal(tg.numpy(), _np(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("cell", ["lif", "li"])
def test_step_gradients_match_jax(cell):
    """One ``lif_step`` / ``li_step``: the cotangents of (x, v, i) for
    those of (out, v', i'), against jitted JAX within rtol 1e-6 (XLA
    contracts some of the backward's multiply-adds; the port rounds each
    op). The reset gate is detached in both."""
    rng = np.random.default_rng(1)
    x, v, i = (rng.standard_normal((3, 64, 32)) * 2).astype(np.float32)
    gz, gv, gi = rng.standard_normal((3, 64, 32)).astype(np.float32)
    jstep = jn.lif_step if cell == "lif" else jn.li_step
    tstep = neurons.lif_step if cell == "lif" else neurons.li_step

    def jf(a, b, c):
        out, (nv, ni) = jstep(a, jn.LIFState(b, c))
        return out, nv, ni

    _, vjp = jax.vjp(jax.jit(jf), *map(jnp.asarray, (x, v, i)))
    want = jax.jit(vjp)(tuple(map(jnp.asarray, (gz, gv, gi))))
    tx, tv, ti = (_t(a).requires_grad_() for a in (x, v, i))
    out, (nv, ni) = tstep(tx, (tv, ti))
    got = torch.autograd.grad((out, nv, ni), (tx, tv, ti),
                              tuple(map(_t, (gz, gv, gi))))
    if cell == "lif":
        assert 0 < float(out.detach().mean()) < 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-6, atol=1e-6)


def _cell_inputs(seed, state_dtype, x_dtype="float32", shape=(7, 2, 4, 5, 8)):
    """Seeded x, states and cotangents, each exact in its dtype."""
    rng = np.random.default_rng(seed)

    def draw(s, scale, dtype):
        a = (rng.standard_normal(s) * scale).astype(np.float32)
        return _t(a, dtype).float().numpy()

    return (draw(shape, 2.0, x_dtype), draw(shape[1:], 1.0, state_dtype),
            draw(shape[1:], 1.0, state_dtype), draw(shape, 1.0, x_dtype),
            draw(shape[1:], 1.0, state_dtype),
            draw(shape[1:], 1.0, state_dtype))


def _port_vjp(inputs, cell, start, state_dtype, x_dtype="float32"):
    x, v0, i0, gz, gv, gi = inputs
    tx = _t(x, x_dtype).requires_grad_()
    tv = _t(v0, state_dtype).requires_grad_()
    ti = _t(i0, state_dtype).requires_grad_()
    out = cuda_kernels.temporal_cell_seq(tx, tv, ti, cell, start)
    # LIF at T = 1 frozen: x reaches nothing, its cotangent is 0
    grads = torch.autograd.grad(
        out, (tx, tv, ti),
        (_t(gz, x_dtype), _t(gv, state_dtype), _t(gi, state_dtype)),
        allow_unused=True, materialize_grads=True)
    return out, grads


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("cell", ["lif", "li"])
def test_cell_vjp_matches_jax(cell, start, state_dtype):
    """The port's VJP of ``temporal_cell_seq`` (autograd through its
    plain version) against JAX's custom VJP over T = 7 steps. Tolerance:
    rtol 1e-6 relative to each cotangent's largest value at fp32 (XLA
    contracts some multiply-adds of the scan backward, the port rounds
    each op), one storage ulp in bf16 and e5m2, where the carried
    cotangent is rounded to the state dtype at every step."""
    inputs = _cell_inputs(3, state_dtype)
    x, v0, i0, gz, gv, gi = inputs
    jsd = jnp.dtype(state_dtype)
    _, vjp = jax.vjp(
        lambda a, b, c: jpk.temporal_cell_seq(a, b, c, cell=cell,
                                              interpret=True, start=start),
        jnp.asarray(x), jnp.asarray(v0).astype(jsd),
        jnp.asarray(i0).astype(jsd))
    want = vjp((jnp.asarray(gz), jnp.asarray(gv).astype(jsd),
                jnp.asarray(gi).astype(jsd)))
    (z, _, _), got = _port_vjp(inputs, cell, start, state_dtype)
    if cell == "lif":
        assert 0 < float(z.detach().mean()) < 1
    rtol = 1e-6 if state_dtype == "float32" else ULP[state_dtype]
    for g, w, dt in zip(got, want, ("float32", state_dtype, state_dtype)):
        assert g.dtype == getattr(torch, dt)
        w = _np(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=rtol * np.abs(w).max())


def _kernel_order_vjp(inputs, cell, start, state_dtype, x_dtype, chunk=None):
    """The backward kernel's arithmetic (csrc/temporal_cell.cu,
    ``cell_step_vjp`` and the carry), in numpy fp32, op for op, with
    LIF's states recomputed in chunks of ``chunk`` steps (default: one
    chunk of T) as the chunked kernel does: pass 1 runs the forward over
    every chunk but the last and keeps the state entering each, pass 2
    re-runs each chunk from its checkpoint, last chunk first, for the
    s = v_dec - v_th of every step, then walks it backward."""
    x, v0, i0, gz, gv_t, gi_t = inputs
    f32 = np.float32
    sd = getattr(torch, state_dtype)
    T = x.shape[0]

    def rnd(a, dtype=sd):
        return torch.from_numpy(np.asarray(a, f32)).to(dtype).float().numpy()

    c_mem, c_syn = (f32(c) for c in neurons.euler_factors(
        neurons.LIFParams()))
    step = neurons.lif_step if cell == "lif" else neurons.li_step

    def advance(v, i, t):
        if t < start:
            return v, i
        with torch.no_grad():
            _, (vn, i_n) = step(_t(x[t]), (_t(v), _t(i)))
        return rnd(vn.numpy()), rnd(i_n.numpy())

    def lif_s(v, i):
        d = (f32(0) - v) + i
        return neurons.fma(_t(d), float(c_mem), _t(v)).numpy() - f32(1)

    C = chunk or max(T, 1)
    K = -(-T // C)
    checkpoints, v, i = {}, rnd(v0), rnd(i0)
    for k in range(K - 1):  # pass 1
        if k > 0:
            checkpoints[k] = (v, i)
        for t in range(k * C, (k + 1) * C):
            v, i = advance(v, i, t)
    Gv, Gi = gv_t.astype(f32), gi_t.astype(f32)
    gx = np.zeros_like(x)
    for k in reversed(range(K)):  # pass 2
        if k == 0 and K > 1:
            v, i = rnd(v0), rnd(i0)
        elif k < K - 1:
            v, i = checkpoints[k]
        t0, L = k * C, min(C, T - k * C)
        s = []
        for j in range(L):
            s.append(lif_s(v, i))
            if j + 1 < L:
                v, i = advance(v, i, t0 + j)
        for j in reversed(range(L)):
            t = t0 + j
            gvr, gir = rnd(Gv), rnd(Gi)
            active = t >= start
            gvn = gvr if active else np.zeros_like(gvr)
            gin = gir if active else np.zeros_like(gir)
            g = gz[t].astype(f32)
            if cell == "lif":
                q = f32(100) * np.abs(s[j]) + f32(1)
                g_vdec = np.where(s[j] > 0, f32(0), f32(1)) * gvn + g / (q * q)
            else:
                g_vdec = gvn + g
            g_d = g_vdec * c_mem
            gv = rnd(g_vdec + (-g_d))
            gi_f = (gin * (-c_syn) + gin) + g_d
            gx[t] = gin if cell == "lif" else gi_f
            gi = rnd(gi_f)
            Gv, Gi = (gv, gi) if active else (gv + gvr, gi + gir)
    return rnd(gx, getattr(torch, x_dtype)), rnd(Gv), rnd(Gi)


TRAIN_DTYPE_PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
                     ("bfloat16", "float8_e5m2"), ("float32", "bfloat16")]


@pytest.mark.parametrize("x_dtype,state_dtype", TRAIN_DTYPE_PAIRS)
@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("cell", ["lif", "li"])
def test_cell_vjp_in_the_kernels_order(cell, start, x_dtype, state_dtype):
    """The order in which the card's backward kernel sums (the current's
    three uses: the decay's product and addend, then the membrane
    update's) is the order autograd sums the plain version's gradients:
    bit-equal, so the kernel can be held bit-equal to it on the card."""
    inputs = _cell_inputs(4, state_dtype, x_dtype)
    _, want = _port_vjp(inputs, cell, start, state_dtype, x_dtype)
    got = _kernel_order_vjp(inputs, cell, start, state_dtype, x_dtype)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.float().numpy())


@pytest.mark.parametrize("x_dtype,state_dtype", TRAIN_DTYPE_PAIRS)
@pytest.mark.parametrize("start", [0, 3, 8])
@pytest.mark.parametrize("T", [1, 7, 8, 9, 17])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_cell_vjp_in_the_chunked_order(chunk, T, start, x_dtype,
                                       state_dtype):
    """LIF's states recomputed from a checkpoint every ``chunk`` steps
    (the chunked kernel's order; starts on a chunk boundary, inside one
    and past a whole chunk; T shorter than a chunk, equal, one longer
    and several): bit-equal to autograd through the plain version,
    which keeps every state."""
    inputs = _cell_inputs(T, state_dtype, x_dtype, shape=(T, 2, 4, 5, 8))
    _, want = _port_vjp(inputs, "lif", start, state_dtype, x_dtype)
    got = _kernel_order_vjp(inputs, "lif", start, state_dtype, x_dtype,
                            chunk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.float().numpy())


@pytest.mark.parametrize("x_dtype,state_dtype", TRAIN_DTYPE_PAIRS)
def test_cell_bwd_plan_fits_the_card(x_dtype, state_dtype):
    """Every plan of the chunked backward, and the one picked, fits an
    H100: shared memory within a CTA's 227 KB and equal to the source's
    count (threads x rows x both states x a thread's elements), the
    register budget (C x V s values a thread at most 48 on the vector
    paths) and the registers ptxas gives it below 255 a thread, C <= T, ceil(T / C) - 2
    checkpoint rows a state, global rows only where there are any; a
    long sequence whose checkpoints fit no CTA takes global rows."""
    xt, st = getattr(torch, x_dtype), getattr(torch, state_dtype)
    xb, ss = xt.itemsize, st.itemsize
    for T in (2, 3, 7, 8, 9, 17, 42, 300, 1000):
        for m in (105, 2520, 4 * 30 * 38 * 256, 4 * 120 * 152 * 64):
            vec = m % (16 // xb) == 0
            width = 16 // xb if vec else 1
            plans = cuda_kernels.cell_bwd_plans(T, m, xt, st, vec)
            pick = cuda_kernels.cell_bwd_plan(T, m, xt, st, vec)
            assert pick in plans
            for p in plans:
                assert p.chunk <= T and cuda_kernels.cell_bwd_built(
                    p.chunk, width)
                assert p.chunk * width <= 48 or width == 1
                assert cuda_kernels.cell_bwd_regs(p.chunk, width) \
                    < cuda_kernels.CELL_BWD_REGS == 255
                assert p.rows == max(0, -(-T // p.chunk) - 2)
                assert p.vec == vec
                assert p.ckpt_bytes == 2 * p.rows * m * ss
                if p.shared:
                    assert p.smem == p.threads * p.rows * 2 * width * ss
                    assert p.smem <= 232448
                else:
                    assert p.smem == 0 and p.rows > 0
            if not any(p.shared for p in plans):
                assert pick.rows > 0 and not pick.shared
    if (x_dtype, state_dtype) == ("float32", "float32"):
        # 61 checkpoints a state at C = 16 take 244 KB at 128 threads
        assert not cuda_kernels.cell_bwd_plan(
            1000, 4 * 120 * 152 * 64, xt, st).shared
    with pytest.raises(ValueError, match="T >= 2"):
        cuda_kernels.cell_bwd_plans(1, 2520, xt, st)


# ---- train-mode Norm ----


def _norm_pair(ch, hw):
    jb = JC.compile_block([JS.Norm(bias=True)], ch, hw)
    pb = PC.compile_block([PS.Norm(bias=True)], ch, hw)
    rng = np.random.default_rng(5)
    scale = rng.uniform(0.5, 2.0, ch).astype(np.float32)
    bias = rng.normal(0, 0.3, ch).astype(np.float32)
    mean = rng.normal(0, 0.2, ch).astype(np.float32)
    var = rng.uniform(0.5, 1.5, ch).astype(np.float32)
    params = {"b0": {"l0": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)}}}
    stats = {"b0": {"l0": {"mean": jnp.asarray(mean),
                           "var": jnp.asarray(var)}}}
    norm = pb.b0.l0
    with torch.no_grad():
        for name, value in (("scale", scale), ("bias", bias),
                            ("mean", mean), ("var", var)):
            getattr(norm, name).copy_(_t(value))
    return jb, params, stats, pb


@pytest.mark.parametrize("form", ["step", "seq"])
def test_train_norm_matches_jax(form):
    """Batch statistics over (B, H, W) (per step in the sequence form),
    y rounded once, the unbiased variance folded into the running stats
    with momentum 0.1, once per step t >= 3 in the sequence form. Output
    and new stats within rtol 1e-5, atol 1e-5 (XLA's rsqrt and sums round
    differently); gradients of (x, scale, bias) for a random cotangent
    within rtol 1e-4, atol 1e-5."""
    ch, hw, start = 6, (5, 7), 3
    shape = (3, *hw, ch) if form == "step" else (6, 3, *hw, ch)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(shape) * 1.5 + 0.4).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jb, params, stats, pb = _norm_pair(ch, hw)

    if form == "step":
        def jf(p, a):
            y, s, _ = jb.apply(p, stats, jb.init_state(3), a,
                               JC.Ctx(train=True))
            return y, s
    else:
        mask = jnp.arange(shape[0]) >= start

        def jf(p, a):
            y, s, _ = jb.apply_seq(p, stats, jb.init_state(3), a,
                                   JC.Ctx(train=True, step_mask=mask,
                                          start_step=jnp.int32(start)))
            return y, s

    (jy, jstats), vjp = jax.vjp(jax.jit(jf), params, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, jstats)))

    tx = _t(x).requires_grad_()
    ctx = PC.Ctx(train=True, start_step=start)
    state = pb.init_state(3, "cpu")
    fn = pb.step if form == "step" else pb.seq
    y, new_state = fn(tx, state, ctx)
    norm = pb.b0.l0
    gx, gscale, gbias = torch.autograd.grad(y, (tx, norm.scale, norm.bias),
                                            _t(g))
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), rtol=1e-5,
                               atol=1e-5)
    new_mean, new_var = new_state["b0"]["l0"]
    for got, want in ((new_mean, jstats["b0"]["l0"]["mean"]),
                      (new_var, jstats["b0"]["l0"]["var"])):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)
    assert not np.allclose(new_mean.numpy(), norm.mean.numpy())
    for got, want in ((gx, jgx), (gscale, jgp["b0"]["l0"]["scale"]),
                      (gbias, jgp["b0"]["l0"]["bias"])):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4,
                                   atol=1e-5)


def test_train_norm_frozen_before_start_and_committed_once():
    """In the sequence form steps t < start leave the running stats as
    they were; ``commit_norm_stats`` writes the carried stats into the
    buffers and hands the state back as in eval."""
    _, _, _, pb = _norm_pair(4, (3, 3))
    norm = pb.b0.l0
    x = torch.randn(4, 2, 3, 3, 4, generator=torch.Generator().manual_seed(0))
    before = (norm.mean.clone(), norm.var.clone())
    _, st = pb.seq(x, pb.init_state(2, "cpu"), PC.Ctx(train=True,
                                                      start_step=4))
    assert st["b0"]["l0"] == ()  # every step frozen: nothing folded
    _, st = pb.seq(x, pb.init_state(2, "cpu"), PC.Ctx(train=True,
                                                      start_step=3))
    assert torch.equal(norm.mean, before[0])  # nothing written yet
    folded = st["b0"]["l0"]
    st = PC.commit_norm_stats(pb, st)
    assert st == {"b0": {"l0": ()}}
    assert torch.equal(norm.mean, folded[0])
    assert torch.equal(norm.var, folded[1])


# ---- optimizer chain against optax ----


def _tree(seed, shapes=((3, 4), (5,), (2, 3, 2))):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    grads = _tree(0)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = loop.clip_by_global_norm([_t(g) for g in grads], max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-6)


@pytest.mark.parametrize("cfg,optax_fn", [
    ({"name": "warmup_cosine", "init_value": 1e-5, "warmup_steps": 4,
      "decay_steps": 20, "end_value": 1e-5},
     lambda lr: optax.warmup_cosine_decay_schedule(1e-5, lr, 4, 20, 1e-5)),
    ({"name": "cosine", "decay_steps": 12, "alpha": 0.1},
     lambda lr: optax.cosine_decay_schedule(lr, 12, alpha=0.1)),
    ({"name": "exponential", "transition_steps": 3, "decay_rate": 0.5,
      "transition_begin": 2, "staircase": True, "end_value": 2e-4},
     lambda lr: optax.exponential_decay(lr, 3, 0.5, 2, True, 2e-4)),
])
def test_lr_schedules_match_optax(cfg, optax_fn):
    """Within rtol 1e-5 and a millionth of the peak: optax evaluates the
    schedule in fp32, the port in float64."""
    lr = 1e-3
    got = loop.make_schedule(lr, cfg)
    want = optax_fn(lr)
    for count in range(25):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-5, atol=1e-6 * lr)


def _run_chain(name_or_cfg, optax_opt, clip=None, every_k=1, steps=6,
               schedule=None):
    """``steps`` micro-batches of seeded gradients through the port's
    ``Optimizer`` and through the optax chain; the parameters after
    every call."""
    params = _tree(10)
    tx = optax_opt
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    if every_k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=every_k)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p)) for p in params]
    opt = loop.Optimizer(tp, name_or_cfg,
                         schedule or (lambda count: 1e-2), clip, every_k)
    out = []
    for s in range(steps):
        grads = _tree(100 + s)
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        did = opt.step([_t(g) for g in grads])
        assert did == ((s + 1) % every_k == 0)
        out.append(([_np(p) for p in jp],
                    [p.detach().numpy().copy() for p in tp]))
    return out


@pytest.mark.parametrize("name,optax_opt", [
    ("adamax", optax.adamax(1e-2)),
    ("adam", optax.adam(1e-2)),
    ("adamw", optax.adamw(1e-2)),
    ({"name": "sgd", "momentum": 0.9}, optax.sgd(1e-2, momentum=0.9)),
])
def test_optimizers_match_optax(name, optax_opt):
    """Six updates of each named optimizer within rtol 1e-5 (torch and
    optax order the update's arithmetic differently)."""
    for jp, tp in _run_chain(name, optax_opt):
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_multisteps_clip_and_schedule_match_optax():
    """``MultiSteps(chain(clip, adamax(schedule)), 3)``: no update on the
    first two micro-batches of three, then the mean gradient, clipped,
    at the schedule's value for the update count."""
    sched = optax.cosine_decay_schedule(1e-2, 4)
    mine = loop.make_schedule(1e-2, {"name": "cosine", "decay_steps": 4})
    out = _run_chain("adamax", optax.adamax(sched), clip=0.5, every_k=3,
                     steps=9, schedule=mine)
    p0 = _tree(10)
    for s, (jp, tp) in enumerate(out):
        for a, b, start in zip(tp, jp, p0):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
            if s in (0, 1):
                np.testing.assert_array_equal(a, start)


# ---- EMA, checkpoints, fit ----


def _tiny_model(**kw):
    model = PNarrow(num_classes=2, in_hw=(32, 40), device="cpu",
                    time_window=2, **kw)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.fill_(4.0)
    return model


def _batch(seed, t=6, b=1):
    rng = np.random.default_rng(seed)
    X = (rng.random((t, b, 32, 40, 2)) < 0.4).astype(np.float32)
    lab = np.full((b, 4, 5), -1.0, np.float32)
    lab[:, 0] = [1, 0.2, 0.2, 0.6, 0.7]
    return X, lab


def test_ema_blends_only_on_a_real_update():
    """Under accumulation (k = 2) the average and the weights stay put on
    the first micro-batch; on the second both move and the average is
    ``0.5 * old + 0.5 * new`` (decay 0.5), as the JAX step's gate."""
    model = _tiny_model()
    trainer = Trainer(ema_decay=0.5, accumulate_grad_batches=2, seed=0)
    trainer.configure(model)
    p0 = [p.detach().clone() for p in model.parameters()]
    X, lab = map(torch.from_numpy, _batch(0))
    trainer.train_step(model, X, lab, 0)
    for p, q, e in zip(model.parameters(), p0, trainer.ema):
        assert torch.equal(p, q) and torch.equal(e, q)
    trainer.train_step(model, X, lab, 1)
    assert any(not torch.equal(p, q) for p, q in zip(model.parameters(), p0))
    for p, q, e in zip(model.parameters(), p0, trainer.ema):
        torch.testing.assert_close(e, 0.5 * q + 0.5 * p.detach(),
                                   rtol=1e-6, atol=0)


def test_checkpoint_manager_keeps_top_k_and_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), save_top_k=2)
    for step, metric in zip((1, 2, 3, 4), (0.1, 0.5, 0.3, 0.2)):
        mgr.save(step, {"step": step, "w": torch.full((3,), float(step))},
                 metric=metric, meta={"m": metric})
    names = sorted(n for n in os.listdir(mgr.directory)
                   if n.startswith("step_") and not n.endswith(".json"))
    # top 2 by metric, and the newest (4) while it is the newest
    assert names == ["step_000000002", "step_000000003", "step_000000004"]
    with open(os.path.join(mgr.directory, "index.json")) as f:
        assert set(json.load(f)) == {"step_000000002", "step_000000003"}
    assert mgr.best_path().endswith("step_000000002")
    assert mgr.restore()["step"] == 4
    assert set(mgr.restore()) == {"step", "w"}
    mgr.save(5, {"step": 5}, metric=0.05)
    assert not os.path.exists(os.path.join(mgr.directory, "step_000000004"))
    assert mgr.restore()["step"] == 5
    # a new manager reads the index back
    assert CheckpointManager(mgr.directory, save_top_k=2).best_path() \
        == mgr.best_path()
    save_single(str(tmp_path / "one"), {"a": torch.ones(2)})
    assert torch.equal(load_single(str(tmp_path / "one"))["a"],
                       torch.ones(2))


class _Data:
    def train_loader(self):
        return (_batch(s) for s in range(1000))

    def val_loader(self):
        return (_batch(1000 + s) for s in range(1000))


def test_fit_logs_checkpoints_and_resumes(tmp_path):
    """Two epochs of two steps with validation and a checkpoint after
    each; a fresh trainer with ``ckpt_path="auto"`` restores the weights,
    stats, optimizer and EMA of ``last`` and goes on from its step and
    epoch."""
    out = str(tmp_path / "run")
    kw = dict(limit_train_batches=2, limit_val_batches=1,
              check_val_every_n_epoch=1, out_dir=out, seed=0,
              ema_decay=0.9, log_every_n_steps=1)
    model = _tiny_model()
    result = Trainer(max_epochs=2, **kw).fit(model, _Data())
    assert (result["step"], result["epoch"]) == (4, 2)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert sum("train_loss" in r for r in records) == 4
    assert sum("val_loss" in r for r in records) == 2
    assert all(np.isfinite(r["train_loss"]) for r in records
               if "train_loss" in r)
    saved = CheckpointManager(os.path.join(out, "checkpoints")).restore()
    assert saved["step"] == 4 and saved["epoch"] == 2
    assert set(saved) >= {"params", "stats", "opt_state", "ema_params",
                          "best_metric", "checks_since_best"}
    for name, p in model.named_parameters():
        assert torch.equal(saved["params"][name], p.detach())

    # nothing left to train: the resumed model holds the checkpoint
    fresh = _tiny_model()
    trainer = Trainer(max_epochs=2, **kw)
    assert trainer.fit(fresh, _Data(), ckpt_path="auto")["step"] == 4
    for name, p in fresh.named_parameters():
        assert torch.equal(saved["params"][name], p.detach())
    for name, b in fresh.named_buffers():
        if name.endswith((".mean", ".var")):
            assert torch.equal(saved["stats"][name], b)
    assert trainer.opt.count == 4
    for e, (name, _) in zip(trainer.ema, fresh.named_parameters()):
        assert torch.equal(e, saved["ema_params"][name])

    result = Trainer(max_epochs=3, **kw).fit(fresh, _Data(),
                                             ckpt_path="auto")
    assert (result["step"], result["epoch"]) == (6, 3)


def test_fast_dev_run_and_early_stopping(tmp_path):
    trainer = Trainer(fast_dev_run=True, out_dir=str(tmp_path / "f"))
    assert trainer.fit(_tiny_model(), _Data())["step"] == 1
    # patience 1: the run stops at the first validation that does not
    # beat the best mAP so far (an untrained net this small stays at 0)
    trainer = Trainer(max_epochs=5, limit_train_batches=1, limit_val_batches=1,
                      check_val_every_n_epoch=1, early_stopping_patience=1,
                      out_dir=str(tmp_path / "e"), seed=0)
    assert trainer.fit(_tiny_model(), _Data())["epoch"] < 5


@pytest.mark.parametrize("schedule", ["hybrid", "auto"])
def test_other_schedules_accepted(schedule):
    """The hybrid and "auto" schedules are ported: the trainer takes
    them as they are (an unknown one is refused)."""
    assert Trainer(time_batched=schedule).time_batched == schedule
    with pytest.raises(ValueError, match="time_batched"):
        Trainer(time_batched="fused")


@pytest.mark.parametrize("kwargs", [
    {"spatial_devices": 2},
], ids=["kwargs1"])
def test_modes_left_out_raise(kwargs):
    """``spatial_devices=2`` builds a trainer (it raised before spatial
    sharding was ported); in one process of one device its mesh raises
    JAX's ``ValueError`` (tests/test_torch_spatial_layers.py holds the
    grids of several ranks)."""
    trainer = Trainer(**kwargs)
    assert trainer.spatial_devices == 2
    with pytest.raises(ValueError, match="1 devices not divisible by "
                                         "spatial_devices=2"):
        trainer.mesh_for(torch.device("cpu"))


@pytest.mark.parametrize("kwargs", [
    {"debug_nans": True}, {"profile_dir": "trace"},
    {"logger": {"class_path":
                "snn_for_object_detection_tpu.train.CSVLogger"}},
], ids=["debug_nans", "profile_dir", "logger"])
def test_training_extras_are_taken(kwargs):
    """``debug_nans``, the profiler and logger back ends (raised before
    they were ported; tests/test_torch_extras.py holds them against
    JAX's)."""
    trainer = Trainer(**kwargs)
    assert trainer.debug_nans == kwargs.get("debug_nans", False)
    assert trainer.profile_dir == kwargs.get("profile_dir")
    assert [type(b).__name__ for b in trainer.loggers] == (
        ["CSVLogger"] if "logger" in kwargs else [])


@pytest.mark.parametrize("kwargs", [
    {"mesh": "cpu"}, {"prefetch_batches": 2},
])
def test_mesh_and_prefetch_are_taken(tmp_path, kwargs):
    """A one-device mesh and prefetch threads (both raised before data
    parallel was ported): ``fit`` runs as without them, to the same
    weights (tests/test_torch_parallel.py holds the mesh of several
    ranks against JAX, tests/test_torch_prefetch.py the prefetch)."""
    from snn_for_object_detection_tpu_torch.parallel import make_mesh

    if kwargs.get("mesh") == "cpu":
        kwargs = {"mesh": make_mesh(devices=["cpu"])}
    runs = []
    for kw in ({"prefetch_batches": 0}, kwargs):
        model = _tiny_model()
        Trainer(max_epochs=1, limit_train_batches=2, limit_val_batches=1,
                check_val_every_n_epoch=1, out_dir=str(tmp_path / str(kw)),
                seed=0, **kw).fit(model, _Data())
        runs.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_optimizer_options_left_out_raise():
    """No optax factory or option is left out any more (``fromage`` and
    ``mu_dtype`` run); what raises is what fails under JAX's trainer
    too: a factory whose update needs the loss value, at its first step,
    and an unknown factory."""
    params = [torch.nn.Parameter(torch.zeros(2))]
    loop.Optimizer(params, "fromage", lambda c: 1e-3).step([torch.ones(2)])
    loop.Optimizer(params, {"name": "adam", "mu_dtype": "bfloat16"},
                   lambda c: 1e-3).step([torch.ones(2)])
    with pytest.raises(TypeError, match="value"):
        loop.Optimizer(params, "lbfgs", lambda c: 1e-3).step([torch.ones(2)])
    with pytest.raises(ValueError, match="unknown optimizer"):
        loop.Optimizer(params, "adamz", lambda c: 1e-3)
    # a live reshape in one process of one device: one device or none
    # (tests/test_torch_spatial_layers.py holds the rest)
    with pytest.raises(ValueError, match=r"in \[1, 1\], got 2"):
        Trainer().request_mesh_reshape(num_devices=2)
    with pytest.raises(ValueError, match="fused"):
        _tiny_model(fuse_seq=True).forward_seq(
            torch.zeros(2, 1, 32, 40, 2), fuse=True, train=True)


def test_conv_runs_without_tf32_in_forward_and_backward(monkeypatch):
    """The Conv layer turns cuDNN's TF32 off for its forward and for its
    backward (which autograd runs outside the forward's call), and gives
    the process's flag back; the values are those of ``F.conv2d``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (aten.convolution.default,
                        aten.convolution_backward.default):
                seen.append((func.__name__,
                             torch.backends.cudnn.allow_tf32))
            return func(*args, **(kwargs or {}))

    layer = PC.Conv(3, 4, 3, 2, (7, 9))
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 7, 9, 3, generator=torch.Generator().manual_seed(1))
    x.requires_grad_(True)
    want_y = torch.nn.functional.conv2d(
        x.detach().permute(0, 3, 1, 2), layer.w.detach(), stride=2,
        padding=1).permute(0, 2, 3, 1)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with Spy():
        y, _ = layer.step(x, None, PC.Ctx())
        assert torch.backends.cudnn.allow_tf32
        y.square().sum().backward()
    assert seen == [("convolution.default", False),
                    ("convolution_backward.default", False)]
    assert torch.backends.cudnn.allow_tf32
    assert torch.equal(y, want_y)
    assert x.grad is not None and layer.w.grad is not None
