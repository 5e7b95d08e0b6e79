"""The port's model zoo against the JAX package, on the CPU.

Seeded numpy inputs and weights (drawn in the JAX pytree layout, carried
into the port by ``load_jax_params``) go through both packages:

- every leaf the zoo adds (PLIF, ALIF, SLI, Synapse with and without
  inhibition, the conv LSTM at k = 1 and 3, Pool A/M/S at k = 3 s = 2,
  the four interpolating Up modes) inside a narrow net: the port's
  ``step`` against JAX's jitted ``step`` and its ``forward_seq`` against
  JAX's ``forward`` (from start 0 and 2), fp32 and bf16 states, within
  the detector tolerances (``PRED_TOL``, ``STATE_TOL``);
- the interpolation weights of ``Up`` against ``jax.image.resize`` of
  unit impulses, borders included, within 4 ulps;
- ``plif_cell_seq``'s plain version: its VJP, the raw time constants'
  gradients included, against ``jax.grad`` of the JAX cell's scan
  (rtol 2e-3), and the backward kernel's order (mirrored in numpy):
  the state and input cotangents bit-equal to autograd, the per-channel
  factor gradients summed as the kernel does within rtol 1e-5;
- a narrow ``VggSNN`` (widths 8/12/16, 64x80) for each neuron: eval
  predictions on the three schedules against JAX's; for PLIF the
  gradients on the three schedules (rtol 2e-3) and eight Adamax steps on
  all four (rtol 1e-3; "auto" with its clock stubbed to pick each);
- ``YoloSNN``'s stage tables and parameter counts at every scale against
  JAX's, and a narrow ``scale="s"`` eval against JAX's;
- a detector whose box tail holds a Norm and an LI (state and statistics
  at every step) against JAX on every schedule, eval and train;
- the CLI's ``fit`` and ``test`` on ``config/vgg.yaml`` at narrow width,
  ``test`` against JAX's ``Trainer.test``.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.data import (
    PropheseeDataModule as JDataModule,
)
from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.models.detector import SODa as JSODa
from snn_for_object_detection_tpu.models.vgg import VggSNN as JVgg
from snn_for_object_detection_tpu.models.yolo import YoloSNN as JYolo
from snn_for_object_detection_tpu.ops import neurons as jn
from snn_for_object_detection_tpu.parallel import shard_batch
from snn_for_object_detection_tpu.train import Trainer as JTrainer
from snn_for_object_detection_tpu_torch import cli
from snn_for_object_detection_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
)
from snn_for_object_detection_tpu_torch.models import VggSNN, YoloSNN
from snn_for_object_detection_tpu_torch.models import compile as PC
from snn_for_object_detection_tpu_torch.models import spec as PS
from snn_for_object_detection_tpu_torch.models.convert import (
    _flatten,
    load_jax_params,
)
from snn_for_object_detection_tpu_torch.models.detector import SODa as PSODa
from snn_for_object_detection_tpu_torch.ops import cuda_kernels, neurons
from snn_for_object_detection_tpu_torch.train import loop
from snn_for_object_detection_tpu_torch.train.checkpoint import save_single
from snn_for_object_detection_tpu_torch.train.loop import Trainer
from test_torch_detector import PRED_TOL, STATE_TOL, _labels, _state_leaves
from test_torch_train_model import GRAD_TOL

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAF_HW, LEAF_T, LEAF_B = (32, 40), 4, 2
VGG_HW, VGG_WIDTHS, VGG_T, B = (64, 80), (8, 12, 16), 6, 2
GAIN = 4.0
# raw time constants drawn around their init (inverse softplus of 200
# and 100): every PLIF channel has factors of its own
RAW_SPREAD = {"raw_tau_syn": (200.0, 40.0), "raw_tau_mem": (100.0, 20.0)}


def _inv_softplus(y):
    return math.log(math.expm1(y))


def zoo_weights(jm, seed, gain):
    """``(params, stats)`` in the JAX model's layout, drawn with numpy:
    conv and LSTM kernels as the Kaiming fan_out init draws them, BN
    gains raised so the narrow nets spike, non-trivial running stats,
    and PLIF's raw time constants spread around their init."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = getattr(path[-1], "key", None)
        if key == "w":  # HWIO
            kh, kw, _, out = leaf.shape
            value = rng.standard_normal(leaf.shape) * (
                2.0 / (kh * kw * out)) ** 0.5
        elif key == "scale":
            value = np.full(leaf.shape, gain)
        elif key in ("bias", "mean"):
            value = rng.normal(0, 0.05, leaf.shape)
        elif key == "var":
            value = rng.uniform(0.8, 1.25, leaf.shape)
        elif key in RAW_SPREAD:
            centre, sd = RAW_SPREAD[key]
            value = _inv_softplus(centre) + rng.normal(0, sd, leaf.shape)
        else:
            raise KeyError(f"unexpected JAX leaf {jax.tree_util.keystr(path)}")
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def frames(seed, hw, t, b=B):
    rng = np.random.default_rng(seed)
    return (rng.random((t, b, *hw, 2)) < 0.4).astype(np.float32)


def pair(jcls, pcls, hw, seed=0, gain=GAIN, **kw):
    jm = jcls(num_classes=2, in_hw=hw, **kw)
    params, stats = zoo_weights(jm, seed, gain)
    pm = pcls(num_classes=2, in_hw=hw, device="cpu", **kw)
    load_jax_params(pm, params, stats)
    return jm, params, stats, pm


def assert_preds(got, want, tol=PRED_TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


# bf16 states: the share of a state's elements allowed one storage ulp
# away (a conv summed in another order moves the fp32 value by ~1e-7 and
# can cross a bf16 rounding boundary), the rest within STATE_TOL
ULP_SHARE = 0.005
BF16_ULP = 2.0 ** -7


def assert_states(got, want):
    """Final states within ``STATE_TOL``; in bf16, up to ``ULP_SHARE`` of
    a state's elements one bf16 ulp away instead."""
    jl, pl = jax.tree.leaves(want), _state_leaves(got)
    assert len(jl) == len(pl)
    for j, p in zip(jl, pl):
        g, w = p.float().numpy(), np.asarray(j, np.float32)
        if p.dtype == torch.float32:
            np.testing.assert_allclose(g, w, **STATE_TOL)
            continue
        outside = ~np.isclose(g, w, **STATE_TOL)
        assert outside.mean() <= ULP_SHARE, outside.mean()
        np.testing.assert_allclose(g[outside], w[outside], rtol=BF16_ULP,
                                   atol=STATE_TOL["atol"])


# ---- each leaf in a narrow net ----


def leaf_net(S, base, leaf):
    """A two-scale net with ``leaf`` (a list of specs) after the stride-2
    spiking stem, at 32x40."""

    class LeafNet(base):
        def backbone_cfgs(self):
            return [S.Conv(8, 3, 2), S.Norm(), S.LIF(), *leaf]

        def neck_cfgs(self):
            return [S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
                    S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return()]

        def head_cfgs(self, box_out, cls_out):
            return [[S.Conv(kernel_size=1), S.Norm(), S.LI(), S.Tanh()],
                    [S.Conv(box_out, 1)], [S.Conv(cls_out, 1)]]

    return LeafNet


def _leaves(S):
    return {
        "plif": [S.Conv(8, 3, 1), S.Norm(), S.PLIF()],
        "alif": [S.Conv(8, 3, 1), S.Norm(),
                 S.ALIF(beta=0.3, tau_adapt_inv=20.0)],
        "sli": [S.Conv(8, 3, 1), S.Norm(), S.SLI()],
        "synapse": [S.Conv(8, 3, 1), S.Norm(), S.Synapse()],
        "synapse_inhibition": [S.Conv(8, 3, 1), S.Norm(),
                               S.Synapse(sigma_inhibition=0.7)],
        "lstm_k1": [S.LSTM(hidden_size=6)],
        "lstm_k3": [S.LSTM(hidden_size=6, kernel_size=3)],
        "pool_avg_k3s2": [S.Pool("A", 3, 2)],
        "pool_max_k3s2": [S.Pool("M", 3, 2)],
        "pool_sum_k3s2": [S.Pool("S", 3, 2)],
        **{f"up_{mode}": [S.Up(2, mode), S.Pool("A")]
           for mode in ("linear", "bilinear", "trilinear", "bicubic")},
    }


LEAVES = sorted(_leaves(PS))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("leaf", LEAVES)
def test_leaf_matches_jax(leaf, state_dtype):
    """Per step (the port's ``SODa.step`` against JAX's jitted
    ``step``, every step's predictions and the final state) and
    time-batched (``forward_seq`` against JAX's scanned ``forward``,
    from start 0 and 2)."""
    jm, params, stats, pm = pair(
        leaf_net(JS, JSODa, _leaves(JS)[leaf]),
        leaf_net(PS, PSODa, _leaves(PS)[leaf]), LEAF_HW,
        state_dtype=state_dtype)
    X = frames(3, LEAF_HW, LEAF_T, LEAF_B)
    step = jax.jit(lambda st, x: jm.step(params, stats, st, x)[::2])
    j_state, state = jm.init_state(LEAF_B), None
    for x in X:
        j_preds, j_state = step(j_state, jnp.asarray(x))
        preds, state = pm.step(torch.from_numpy(x), state)
        assert_preds(preds, j_preds)
    assert float(preds[0].abs().max()) > 0.05  # the net is not silent
    assert_states(state, j_state)
    fwd = jax.jit(lambda x, r: jm.forward(params, stats, x, start_step=r))
    for r in (0, 2):
        j_preds, _, j_state = fwd(jnp.asarray(X), jnp.int32(r))
        preds, state = pm.forward_seq(torch.from_numpy(X), start_step=r)
        assert_preds(preds, j_preds)
        assert_states(state, j_state)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size", [1, 2, 5])
def test_resize_weights_are_jax_image_resize(mode, size):
    """``Up``'s weight matrix of one axis is ``jax.image.resize`` of unit
    impulses at every input position, borders included (the edge weights
    renormalised): within 4 fp32 ulps (XLA's division at the
    renormalised edges of a 2-pixel map is 1-2 ulps off the correctly
    rounded one; every other weight is bit-equal); torch's own bicubic
    (a = -0.75) is not."""
    scale = 3
    kernel = PC._keys_cubic if mode == "bicubic" else PC._triangle
    got = PC.resize_weights(size, size * scale, kernel).numpy()
    eye = jnp.eye(size, dtype=jnp.float32)[:, :, None]  # [in, in, 1]
    want = np.asarray(jax.image.resize(
        eye, (size, size * scale, 1), "cubic" if mode == "bicubic"
        else "linear"))[:, :, 0]
    np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=0)
    if mode == "bicubic" and size == 5:
        x = torch.from_numpy(np.arange(5, dtype=np.float32))[None, None, None]
        theirs = torch.nn.functional.interpolate(
            x, size=(1, 15), mode="bicubic", align_corners=False)[0, 0, 0]
        assert not np.allclose(theirs.numpy(), np.arange(5) @ got)


# ---- the PLIF cell's VJP ----


def _jax_plif_scan(x, v0, i0, raw_syn, raw_mem, start, sd):
    """JAX's time-batched PLIF (``_cell_apply_seq``): a scan of
    ``plif_step`` in fp32, the state stored in ``sd`` and frozen for
    ``t < start``."""
    learn = jn.PLIFParams(raw_syn, raw_mem)
    keep = jnp.arange(x.shape[0]) >= start

    def body(st, inp):
        x_t, k = inp
        st32 = jax.tree.map(lambda a: a.astype(jnp.float32), st)
        out, upd = jn.plif_step(x_t.astype(jnp.float32), st32, learn)
        upd = jax.tree.map(lambda a: a.astype(sd), upd)
        upd = jax.tree.map(lambda n, o: jnp.where(k, n, o), upd, st)
        return upd, out.astype(x.dtype)

    st, z = jax.lax.scan(body, jn.LIFState(v0, i0), (x, keep))
    return z, st.v, st.i


def _plif_inputs(seed, state_dtype, shape=(7, 2, 4, 5, 8)):
    rng = np.random.default_rng(seed)
    sdt = getattr(torch, state_dtype)

    def draw(s, scale, exact_in=torch.float32):
        a = (rng.standard_normal(s) * scale).astype(np.float32)
        return torch.from_numpy(a).to(exact_in).float().numpy()

    ch = shape[-1]
    raw_syn = (_inv_softplus(200.0) + rng.normal(0, 40, ch)).astype(
        np.float32)
    raw_mem = (_inv_softplus(100.0) + rng.normal(0, 20, ch)).astype(
        np.float32)
    return (draw(shape, 2.0), draw(shape[1:], 1.0, sdt),
            draw(shape[1:], 1.0, sdt), raw_syn, raw_mem, draw(shape, 1.0),
            draw(shape[1:], 1.0, sdt), draw(shape[1:], 1.0, sdt))


def _port_plif_vjp(inputs, start, state_dtype):
    x, v0, i0, raw_syn, raw_mem, gz, gv, gi = inputs
    sd = getattr(torch, state_dtype)
    tx = torch.from_numpy(x).requires_grad_()
    tv = torch.from_numpy(v0).to(sd).requires_grad_()
    ti = torch.from_numpy(i0).to(sd).requires_grad_()
    rs = torch.from_numpy(raw_syn).requires_grad_()
    rm = torch.from_numpy(raw_mem).requires_grad_()
    c_mem, c_syn = neurons.plif_factors(neurons.PLIFParams(rs, rm))
    out = cuda_kernels.plif_cell_seq(tx, tv, ti, c_mem, c_syn, start)
    # every step frozen: x and c_syn reach nothing, their cotangents are 0
    grads = torch.autograd.grad(
        out, (tx, tv, ti, rs, rm),
        (torch.from_numpy(gz), torch.from_numpy(gv).to(sd),
         torch.from_numpy(gi).to(sd)), allow_unused=True,
        materialize_grads=True)
    return out, grads


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16",
                                         "float8_e5m2"])
@pytest.mark.parametrize("start", [0, 3])
def test_plif_vjp_matches_jax(start, state_dtype):
    """The VJP of ``plif_cell_seq``'s plain version (x, the states and the
    raw time constants through ``dt * softplus``) against ``jax.vjp`` of
    the JAX cell's scan, T = 7: within rtol 2e-3 of each cotangent's
    largest value, the carried state cotangent rounded to the state
    dtype every step in both."""
    inputs = _plif_inputs(5, state_dtype)
    x, v0, i0, raw_syn, raw_mem, gz, gv, gi = inputs
    jsd = jnp.dtype(state_dtype)
    _, vjp = jax.vjp(
        lambda a, b, c, d, e: _jax_plif_scan(a, b, c, d, e, start, jsd),
        jnp.asarray(x), jnp.asarray(v0).astype(jsd),
        jnp.asarray(i0).astype(jsd), jnp.asarray(raw_syn),
        jnp.asarray(raw_mem))
    want = vjp((jnp.asarray(gz), jnp.asarray(gv).astype(jsd),
                jnp.asarray(gi).astype(jsd)))
    (z, _, _), got = _port_plif_vjp(inputs, start, state_dtype)
    assert 0 < float(z.detach().mean()) < 1
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2e-3 * np.abs(w).max())


def _plif_kernel_order(inputs, start, state_dtype, chunk):
    """PLIF's backward as ``csrc/temporal_cell.cu`` runs it, in numpy
    fp32: the states recomputed in chunks of ``chunk`` steps from the
    checkpoints of pass 1, each chunk walked backward with ``plif_bwd_
    step``'s ops, every element's factor products summed over t from
    the last step, then over the rows (``cuda_kernels.plif_factor_
    grads``). Returns (gx, gv0, gi0) and the [C] factor gradients."""
    x, v0, i0, raw_syn, raw_mem, gz, gv_t, gi_t = inputs
    f32 = np.float32
    sd = getattr(torch, state_dtype)
    T = x.shape[0]

    def rnd(a):
        return torch.from_numpy(np.asarray(a, f32)).to(sd).float().numpy()

    c_mem, c_syn = (c.numpy() for c in neurons.plif_factors(
        neurons.PLIFParams(torch.from_numpy(raw_syn),
                           torch.from_numpy(raw_mem))))

    def t_(a):
        return torch.from_numpy(np.asarray(a, f32))

    def advance(v, i, t):
        if t < start:
            return v, i
        _, (vn, i_n) = neurons.plif_step_factors(
            t_(x[t]), (t_(v), t_(i)), t_(c_mem), t_(c_syn))
        return rnd(vn.numpy()), rnd(i_n.numpy())

    K = -(-T // chunk)
    checkpoints, v, i = {}, rnd(v0), rnd(i0)
    for k in range(K - 1):  # pass 1
        if k > 0:
            checkpoints[k] = (v, i)
        for t in range(k * chunk, (k + 1) * chunk):
            v, i = advance(v, i, t)
    Gv, Gi = gv_t.astype(f32), gi_t.astype(f32)
    Gm, Gs = np.zeros_like(v0), np.zeros_like(v0)
    gx = np.zeros_like(x)
    for k in reversed(range(K)):  # pass 2
        if k == 0 and K > 1:
            v, i = rnd(v0), rnd(i0)
        elif k < K - 1:
            v, i = checkpoints[k]
        t0, L = k * chunk, min(chunk, T - k * chunk)
        entering = []
        for j in range(L):
            entering.append((v, i))
            if j + 1 < L:
                v, i = advance(v, i, t0 + j)
        for j in reversed(range(L)):
            t = t0 + j
            ve, ie = entering[j]
            gvr, gir = rnd(Gv), rnd(Gi)
            active = t >= start
            gvn = gvr if active else np.zeros_like(gvr)
            gin = gir if active else np.zeros_like(gir)
            d = (f32(0) - ve) + ie
            s = neurons.fma(t_(d), t_(c_mem), t_(ve)).numpy() - f32(1)
            q = f32(100) * np.abs(s) + f32(1)
            g_vdec = np.where(s > 0, f32(0), f32(1)) * gvn + gz[t] / (q * q)
            g_d = g_vdec * c_mem
            Gm = Gm + g_vdec * d
            Gs = Gs + gin * ie
            gx[t] = gin
            gv = rnd(g_vdec + (-g_d))
            gi = rnd((gin * (-c_syn) + gin) + g_d)
            Gv, Gi = (gv, gi) if active else (gv + gvr, gi + gir)
    gcm, gcs = cuda_kernels.plif_factor_grads(t_(Gm), t_(Gs))
    return (gx, rnd(Gv), rnd(Gi)), (gcm.numpy(), gcs.numpy())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", [0, 3, 8])
@pytest.mark.parametrize("T,chunk", [(1, 8), (7, 2), (9, 4), (17, 8)])
def test_plif_vjp_in_the_kernels_order(T, chunk, start, state_dtype):
    """The backward kernel's order (the chunks its widths are built
    with, starts on a chunk boundary, inside one and past the end): gx,
    gv0 and gi0 bit-equal to autograd through the plain version; the
    factor gradients (each element summed over t, then the rows, where
    autograd sums each step over the rows, then the steps) within rtol
    1e-5 of the largest."""
    inputs = _plif_inputs(6, state_dtype, shape=(T, 2, 4, 5, 8))
    _, want = _port_plif_vjp(inputs, start, state_dtype)
    got, factors = _plif_kernel_order(inputs, start, state_dtype, chunk)
    for g, w in zip(got, want[:3]):
        np.testing.assert_array_equal(g, w.float().numpy())
    # the chain through softplus: dc/draw = dt * sigmoid(raw)
    c_grads = []
    rs, rm = (torch.from_numpy(a).requires_grad_() for a in inputs[3:5])
    c_mem, c_syn = neurons.plif_factors(neurons.PLIFParams(rs, rm))
    for c, g, r in ((c_mem, factors[0], rm), (c_syn, factors[1], rs)):
        (gr,) = torch.autograd.grad(c, r, torch.from_numpy(g))
        c_grads.append(gr.numpy())
    for g, w in zip(c_grads[::-1], want[3:]):
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))


def test_plif_bwd_plan_takes_the_built_chunk():
    """Every plan of PLIF's backward has the chunk its width is built
    with, fits a CTA's shared memory where it is shared, and keeps its
    checkpoints in global rows only where there are any."""
    for xd in (torch.float32, torch.bfloat16):
        for sd in (torch.float32, torch.bfloat16, torch.float8_e5m2):
            for T in (2, 3, 9, 42, 300):
                for m in (105, 4 * 240 * 304 * 32, 4 * 15 * 19 * 256):
                    vec = m % (16 // xd.itemsize) == 0
                    width = 16 // xd.itemsize if vec else 1
                    p = cuda_kernels.plif_bwd_plan(T, m, xd, sd, vec)
                    assert p.chunk == cuda_kernels.PLIF_BWD_CHUNK[width]
                    assert p.vec == vec
                    assert p.rows == max(0, -(-T // p.chunk) - 2)
                    if p.shared:
                        assert p.smem == p.threads * p.rows * 2 * width \
                            * sd.itemsize <= cuda_kernels.CELL_BWD_MAX_SMEM
                    else:
                        assert p.smem == 0 and p.rows > 0
    with pytest.raises(ValueError, match="T >= 2"):
        cuda_kernels.plif_bwd_plan(1, 2520, torch.float32, torch.float32)


# ---- VggSNN ----


@pytest.fixture(scope="module")
def vgg_frames():
    return frames(1, VGG_HW, VGG_T)


@pytest.mark.parametrize("neuron", ["lif", "plif", "alif", "sli"])
def test_vgg_eval_matches_jax(neuron, vgg_frames):
    """Eval predictions and final states of the three schedules against
    JAX's, from start 0 and 3."""
    jm, params, stats, pm = pair(JVgg, VggSNN, VGG_HW, neuron=neuron,
                                 widths=VGG_WIDTHS)
    X = jnp.asarray(vgg_frames)
    for schedule in (False, True, "hybrid"):
        fwd = jax.jit(lambda x, r, f=jm.forward_fn(schedule): f(
            params, stats, x, start_step=r))
        for r in (0, 3):
            j_preds, _, j_state = fwd(X, jnp.int32(r))
            preds, state = pm.forward_fn(schedule)(
                torch.from_numpy(vgg_frames), start_step=r)
            assert float(preds[0].abs().max()) > 0.05
            assert_preds(preds, j_preds)
            assert_states(state, j_state)


def test_vgg_refuses_unknown_neurons():
    with pytest.raises(ValueError, match="neuron must be one of"):
        VggSNN(num_classes=2, in_hw=VGG_HW, neuron="izhikevich",
               device="cpu")


def _vgg_models(time_window=16):
    jm, params, stats, pm = pair(JVgg, VggSNN, VGG_HW, neuron="plif",
                                 widths=VGG_WIDTHS, time_window=time_window)
    return jm, params, stats, pm


def _grads(pm, schedule, X, lab, r):
    pm.zero_grad()
    preds, _ = pm.forward_fn(schedule)(torch.from_numpy(X), start_step=r,
                                       train=True)
    loss = pm.loss(preds, torch.from_numpy(lab))
    loss.backward()
    # zeros where no path reaches a parameter, as JAX has them
    grads = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
             else p.grad.numpy().copy() for n, p in pm.named_parameters()}
    stats = {n: b.numpy().copy() for n, b in pm.named_buffers()
             if n.endswith((".mean", ".var"))}
    return float(loss), grads, stats


@pytest.mark.parametrize("r", [0, 2])
@pytest.mark.parametrize("schedule", [False, True, "hybrid"])
def test_vgg_plif_gradients_match_jax(schedule, r):
    """One train forward and backward of the PLIF VggSNN on each
    schedule: the loss within rtol 1e-5, every gradient within rtol
    2e-3, atol 1e-7 and the new running statistics within rtol 1e-5,
    atol 1e-6 of JAX's ``value_and_grad``. The raw time constants'
    gradients are small (``dt * sigmoid(raw)`` = 1e-3 times the factor's,
    1e-12 to 1e-5 here), so theirs are held within rtol 2e-3 and an atol
    of 1e-4 of their own largest; from start 0 most layers' reach the
    loss (in 6 steps the spikes do not reach the last stage; from start
    2, with 4 steps, none does, in JAX too)."""
    X, lab = frames(0, VGG_HW, VGG_T), _labels(1)
    jm, params, stats, pm = _vgg_models()
    fwd = jm.forward_fn(schedule)

    def loss_fn(p):
        preds, new_stats, _ = fwd(p, stats, jnp.asarray(X), start_step=r,
                                  train=True)
        return jm.loss(preds, jnp.asarray(lab)), new_stats

    (j_loss, j_stats), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    j_grads, j_stats = _flatten(jax.device_get(j_grads)), _flatten(
        jax.device_get(j_stats))
    loss, grads, new_stats = _grads(pm, schedule, X, lab, r)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    assert set(grads) == set(j_grads)
    taus = 0
    for name, g in grads.items():
        want = j_grads[name]
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(g, want, err_msg=name, **GRAD_TOL)
        if name.endswith(("raw_tau_syn", "raw_tau_mem")):
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(g, want, rtol=2e-3, atol=1e-4 * scale,
                                       err_msg=name)
            taus += scale > 0
    # of 6 PLIF layers' 12 time constants
    assert taus >= 8 if r == 0 else taus == 0
    for name, s in new_stats.items():
        np.testing.assert_allclose(s, j_stats[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _stub_auto(monkeypatch, winner):
    """``loop.time_call`` that makes ``winner`` the fastest schedule."""
    def fake(fn, device, reps=2):
        fn()
        fake.calls += 1
        return 1.0 if loop.SCHEDULES[(fake.calls - 1) % 3] == winner else 2.0

    fake.calls = 0
    monkeypatch.setattr(loop, "time_call", fake)


@pytest.mark.parametrize("schedule", [False, True, "hybrid", "auto"])
def test_vgg_plif_adamax_trajectory_matches_jax(tmp_path, monkeypatch,
                                                schedule):
    """Eight Adamax steps of JAX's and the port's Trainer on the PLIF
    VggSNN, time window 3, the start r of each JAX step given to the
    port: losses within rtol 1e-3 a step, the weights after them (the
    raw time constants too) within rtol 1e-3, atol 1e-5. "auto" has its
    clock stubbed to pick the time-batched schedule, held against JAX's
    time-batched trainer."""
    window, steps = 3, 8
    j_schedule = True if schedule == "auto" else schedule
    if schedule == "auto":
        _stub_auto(monkeypatch, True)
    jm, params, stats, pm = _vgg_models(time_window=window)
    jt = JTrainer(out_dir=str(tmp_path / "jax"), seed=0, prefetch_batches=0,
                  time_batched=j_schedule)
    jt.mesh_for_batch(B)
    opt, jit_train, _ = jt._build_steps(jm, j_schedule)
    opt_state = opt.init(params)
    keys, starts, k = [], [], 0
    while len(keys) < steps:
        want = len(keys) % window
        key = jax.random.PRNGKey(k)
        k += 1
        if int(jax.random.randint(key, (), 0, window)) == want:
            keys.append(key)
            starts.append(want)
    trainer = Trainer(seed=0, time_batched=schedule)
    trainer.configure(pm)
    raw0 = pm.backbone.b0.l2.raw_tau_mem.detach().clone()
    j_losses, losses = [], []
    for s in range(steps):
        X, lab = frames(10 + s, VGG_HW, VGG_T), _labels(20 + s)
        Xd, labd = shard_batch(jt.mesh, jnp.asarray(X), jnp.asarray(lab))
        params, opt_state, stats, _, loss = jit_train(
            params, opt_state, stats, None, Xd, labd, keys[s])
        j_losses.append(float(loss))
        losses.append(float(trainer.train_step(
            pm, torch.from_numpy(X), torch.from_numpy(lab), starts[s])))
    if schedule == "auto":
        assert trainer._schedule_for(pm, None, None, train=True) is True
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    assert len(set(np.round(j_losses, 4))) == steps
    assert not torch.equal(pm.backbone.b0.l2.raw_tau_mem, raw0)  # taus move
    flat = _flatten(jax.device_get(params))
    for name, p in pm.named_parameters():
        want = flat[name]
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-3,
                                   atol=1e-5, err_msg=name)


# ---- YoloSNN ----


@pytest.mark.parametrize("scale", ["tiny", "s", "m", "l"])
def test_yolo_tables_and_sizes_match_jax(scale):
    """Stage plans and parameter counts at GEN1 against JAX's."""
    jm = JYolo(num_classes=2, in_hw=(240, 304), scale=scale)
    pm = YoloSNN(num_classes=2, in_hw=(240, 304), scale=scale, device="cpu")
    assert pm.backbone_plan == jm.backbone_plan
    assert pm.neck_plan == jm.neck_plan
    params, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    j_count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in pm.parameters()) == j_count
    if scale == "tiny":
        assert j_count == 4_228_544  # TinyYolo's
    with pytest.raises(ValueError, match="scale must be one of"):
        YoloSNN(num_classes=2, scale="xl", device="cpu")


def test_yolo_s_eval_matches_jax():
    """``scale="s"`` with its widths cut to a sixteenth (the stage plan's
    depths kept): eval on the per-step and time-batched schedules
    against JAX's."""

    def narrow(base):
        class Narrow(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, scale="s", **kw)

            def backbone_cfgs(self):
                self.backbone_plan = tuple(
                    (max(4, c // 16), d) for c, d in self.backbone_plan)
                return super().backbone_cfgs()

            def neck_cfgs(self):
                self.neck_plan = tuple(
                    (max(4, c // 16), d) for c, d in self.neck_plan)
                return super().neck_cfgs()

        return Narrow

    jm, params, stats, pm = pair(narrow(JYolo), narrow(YoloSNN), VGG_HW)
    assert pm.neck_plan == jm.neck_plan == ((24, 5), (24, 4), (24, 3))
    # the scaled plan is the instance's: TinyYolo's own table is intact
    assert YoloSNN.neck_plan == ((256, 4), (256, 3), (256, 2))
    X = frames(2, VGG_HW, 4)
    for schedule in (False, True):
        fwd = jax.jit(lambda x, f=jm.forward_fn(schedule): f(
            params, stats, x))
        j_preds, _, j_state = fwd(jnp.asarray(X))
        preds, state = pm.forward_fn(schedule)(torch.from_numpy(X))
        assert_preds(preds, j_preds)
        assert_states(state, j_state)


# ---- a stateful head tail ----


def heavy_tail_net(S, base):
    """Two scales whose box tail holds a Norm and an LI: it runs every
    step, with state and running statistics."""

    class HeavyTail(base):
        def backbone_cfgs(self):
            return [S.Conv(8, 3, 2), S.Norm(), S.LIF()]

        def neck_cfgs(self):
            return [S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
                    S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return()]

        def head_cfgs(self, box_out, cls_out):
            return [[S.Conv(kernel_size=1), S.Norm(), S.LI(), S.Tanh()],
                    [S.Conv(8, 1), S.Norm(bias=True), S.LI(),
                     S.Conv(box_out, 1)],
                    [S.Conv(cls_out, 1)]]

    return HeavyTail


def test_heavy_tail_matches_jax():
    """Eval on the three schedules (from start 0 and 2) and one train
    forward and backward a schedule: predictions, states, the tails'
    running statistics and the gradients against JAX's."""
    jm, params, stats, pm = pair(heavy_tail_net(JS, JSODa),
                                 heavy_tail_net(PS, PSODa), LEAF_HW)
    assert not pm.head_tails_light
    X, lab = frames(4, LEAF_HW, LEAF_T, LEAF_B), _labels(2, b=LEAF_B)
    for schedule in (False, True, "hybrid"):
        fwd = jax.jit(lambda x, r, f=jm.forward_fn(schedule): f(
            params, stats, x, start_step=r))
        for r in (0, 2):
            j_preds, _, j_state = fwd(jnp.asarray(X), jnp.int32(r))
            preds, state = pm.forward_fn(schedule)(torch.from_numpy(X),
                                                   start_step=r)
            assert_preds(preds, j_preds)
            assert_states(state, j_state)
        one = pm.forward_fn(schedule)
        _, _, _, pm_t = pair(heavy_tail_net(JS, JSODa),
                             heavy_tail_net(PS, PSODa), LEAF_HW)
        f = jm.forward_fn(schedule)

        def loss_fn(p):
            preds, new_stats, _ = f(p, stats, jnp.asarray(X), start_step=1,
                                    train=True)
            return jm.loss(preds, jnp.asarray(lab)), new_stats

        (j_loss, j_stats), j_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        loss, grads, new_stats = _grads(pm_t, schedule, X, lab, 1)
        del one
        np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
        j_grads = _flatten(jax.device_get(j_grads))
        for name, g in grads.items():
            want = j_grads[name]
            if want.ndim == 4:
                want = want.transpose(3, 2, 0, 1)
            np.testing.assert_allclose(g, want, err_msg=name, **GRAD_TOL)
        j_stats = _flatten(jax.device_get(j_stats))
        assert any(".box." in n for n in new_stats)
        for name, s in new_stats.items():
            np.testing.assert_allclose(s, j_stats[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)


# ---- the CLI on config/vgg.yaml ----


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zoodata"))
    return make_synthetic_dataset(root, records_per_split=1, duration_ms=1200)


def vgg_args(synth_root, out_dir, extra=()):
    return [
        "--config", os.path.join(REPO, "config", "config.yaml"),
        "--config", os.path.join(REPO, "config", "vgg.yaml"),
        "--model.init_args.widths=[8, 12, 16]",
        f"--data.init_args.data_dir={synth_root}",
        "--data.init_args.batch_size=2",
        "--data.init_args.num_steps=4",
        "--data.init_args.num_workers=1",
        "--data.init_args.num_load_file=1",
        "--data.init_args.time_shift=2",
        "--model.init_args.time_window=2",
        "--trainer.max_epochs=1",
        "--trainer.limit_train_batches=2",
        "--trainer.limit_val_batches=1",
        "--trainer.limit_test_batches=2",
        "--trainer.check_val_every_n_epoch=1",
        "--trainer.min_epochs=0",
        "--trainer.log_every_n_steps=1",
        f"--trainer.out_dir={out_dir}",
        "--device", "cpu",
        *extra,
    ]


def test_cli_fit_and_test_on_vgg_yaml(synth_root, tmp_path):
    """``fit`` then ``test`` from its checkpoint: a PLIF VggSNN, finite
    losses and metrics, every parameter (the raw time constants too)
    restored by ``test`` bit for bit. (Two steps from the init leave the
    time constants where they were: their gradients, ~1e-12 here, are
    far below Adamax's eps of 1e-8.)"""
    args = vgg_args(synth_root, tmp_path / "run")
    fit = cli.main(["fit", *args])
    assert type(fit.model) is VggSNN and fit.model.neuron == "plif"
    assert fit.result["step"] == 2
    ckpt = tmp_path / "run" / "checkpoints" / "last"
    test = cli.main(["test", *args, f"--ckpt_path={ckpt}"])
    names = [n for n, _ in test.model.named_parameters()]
    assert sum(n.endswith("raw_tau_mem") for n in names) == 6
    for (name, p), q in zip(fit.model.named_parameters(),
                            test.model.parameters()):
        assert torch.equal(p.detach(), q.detach()), name
    assert all(math.isfinite(v) for v in test.result.values())
    assert set(test.result) >= {"test_loss", "map"}


def test_cli_test_on_vgg_yaml_matches_jax(synth_root, tmp_path):
    """``test`` on a checkpoint of JAX weights against JAX's
    ``Trainer.test`` on the same weights and loader settings (time
    window 0): every metric within rtol 1e-5, atol 1e-6."""
    jm, params, stats, pm = pair(JVgg, VggSNN, (240, 304), neuron="plif",
                                 widths=VGG_WIDTHS, time_window=0)
    ckpt = str(tmp_path / "jax_weights")
    save_single(ckpt, {
        "params": {n: p.detach() for n, p in pm.named_parameters()},
        "stats": {n: b for n, b in pm.named_buffers()
                  if n.endswith((".mean", ".var"))},
    })
    run = cli.main(["test", *vgg_args(synth_root, tmp_path / "port"),
                    "--model.init_args.time_window=0",
                    f"--ckpt_path={ckpt}"])
    data = JDataModule(**run.cfg["data"]["init_args"])
    jt = JTrainer(out_dir=str(tmp_path / "jax"), seed=0,
                  limit_test_batches=run.trainer.limit_test_batches)
    want = jt.test(jm, data, params, stats)
    assert run.result.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(run.result[k], want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
