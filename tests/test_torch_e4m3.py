"""e4m3 neuron states (``float8_e4m3fn``) in the port against the JAX
package, on the CPU.

JAX stores an e4m3 state with ``astype``: round to nearest even, and NaN
with the value's sign (bits 0x7f / 0xff) for every |x| > 464, inf and
NaN; PyTorch's own cast saturates to 448. The port stores every state
through ``neurons.to_state`` (and the kernels through
``cell_math::from_f32<E4M3>``), so:

- ``to_state`` is bit-equal to JAX's ``astype`` on every fp32 value from
  440 to 500 in both signs, the subnormal range, inf, NaN and a wide
  random draw;
- the plain versions of every kernel with e4m3 states are bit-equal to
  JAX's kernels (Pallas in interpret mode, and the scan) on inputs that
  overflow, NaNs included: states as uint8 views, fp32 and bf16 outputs
  equal where finite and NaN at the same places. Where every NaN comes
  from a store (one step from finite states) the NaN's sign bits are
  equal too. A NaN that arithmetic makes from a NaN state has a sign IEEE
  754 leaves open: XLA's CPU code turns ``0 - v`` into a negation that
  flips it, x86's subtraction keeps it, the card returns a positive
  canonical NaN; so over several steps only the NaN positions are
  compared (the payload of a widened e4m3 NaN differs too);
- the cell's VJP with e4m3 states: NaN where JAX's is, the finite values
  within one storage ulp (2^-3) of the largest cotangent, the bar the
  bf16 and e5m2 cases of ``test_torch_train.py`` set;
- a narrow TinyYolo with e4m3 states on every schedule within the
  detector's tolerances of JAX's, and eight Adamax steps within rtol 1e-3
  a step; PLIF with e4m3 states; the config's ``state_dtype:
  float8_e4m3fn``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.ops import pallas_kernels as jpk
from snn_for_object_detection_tpu_torch.ops import cuda_kernels, neurons
from test_torch_detector import (
    HW,
    PRED_TOL,
    STATE_TOL,
    JNarrow,
    PNarrow,
    _frames,
    _jax_weights,
    _state_leaves,
)
from test_torch_train_model import adamax_trajectory
from test_torch_zoo import LEAF_B, LEAF_HW, LEAF_T, _leaves, frames, leaf_net
from test_torch_zoo import pair as zoo_pair

torch.set_num_threads(1)

E4 = torch.float8_e4m3fn
JE4 = jnp.float8_e4m3fn


def _bits(a) -> np.ndarray:
    """JAX e4m3 array or port e4m3 tensor -> uint8 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _to_port(a, dtype):
    """A JAX array as a port tensor of the same values and bits."""
    if dtype == "float8_e4m3fn":
        return torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(E4)
    return torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32))).to(
        getattr(torch, dtype))


def assert_same(got, want, nan_signs=True):
    """e4m3 states bit-equal as uint8, wider outputs equal where finite;
    NaN at the same places, with the same sign bit if ``nan_signs``."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    if nan_signs:
        np.testing.assert_array_equal(np.signbit(g[np.isnan(g)]),
                                      np.signbit(w[np.isnan(w)]))
    if got.dtype == E4:
        fin = ~np.isnan(w)
        np.testing.assert_array_equal(_bits(got)[fin], _bits(want)[fin])
    else:
        np.testing.assert_array_equal(g[~np.isnan(g)], w[~np.isnan(w)])


def _sweep():
    lo, hi = np.array([440.0, 500.0], np.float32).view(np.uint32)
    near = np.arange(lo, hi + 1, dtype=np.uint32).view(np.float32)
    # every 97th fp32 pattern from 0 to 2**-5: the subnormals of e4m3
    # (step 2**-9) and its smallest normals
    small = np.arange(0, 0x3D000000, 97, dtype=np.uint32).view(np.float32)
    edge = np.array([np.inf, np.nan, 448.0, 464.0, 2.0 ** -9, 2.0 ** -10,
                     3 * 2.0 ** -11, 0.0], np.float32)
    nans = np.array([0x7FC00001, 0x7F800001], np.uint32).view(np.float32)
    rng = np.random.default_rng(0)
    wide = (rng.standard_normal(1 << 18)
            * np.exp(rng.uniform(-25, 10, 1 << 18))).astype(np.float32)
    half = np.concatenate([near, small, edge, nans])
    return np.concatenate([half, -half, wide])


def test_to_state_is_jax_astype():
    x = _sweep()
    want = np.asarray(jnp.asarray(x).astype(JE4)).view(np.uint8)
    got = neurons.to_state(torch.from_numpy(x), E4)
    assert got.dtype == E4
    np.testing.assert_array_equal(_bits(got), want)
    # both NaN encodings, and torch's own cast differs past 464
    assert {0x7F, 0xFF} <= set(want.tolist())
    assert (torch.from_numpy(x).to(E4).view(torch.uint8).numpy()
            != want).any()
    # a stored value stores again as itself
    np.testing.assert_array_equal(_bits(neurons.to_state(got.float(), E4)),
                                  want)


def test_to_state_other_dtypes_are_casts():
    x = torch.from_numpy(_sweep())
    for dt in (torch.float32, torch.bfloat16, torch.float8_e5m2):
        assert torch.equal(neurons.to_state(x, dt).view(torch.uint8),
                           x.to(dt).view(torch.uint8))


def test_to_state_gradient_is_a_cast():
    """The store's gradient is JAX's astype VJP: the cotangent widened;
    ``from_state``'s stores the cotangent as the state is stored."""
    x = torch.tensor([1.0, 500.0, -3.3], requires_grad=True)
    g = torch.tensor([0.5, 600.0, -1000.0]).to(E4)
    (gx,) = torch.autograd.grad(neurons.to_state(x, E4), x, g)
    assert torch.equal(gx, g.float())
    s = torch.tensor([1.0, 2.0, 3.0]).to(E4).requires_grad_()
    (gs,) = torch.autograd.grad(neurons.from_state(s), s,
                                torch.tensor([0.3, 470.0, -480.0]))
    assert _bits(gs).tolist() == _bits(neurons.to_state(
        torch.tensor([0.3, 470.0, -480.0]), E4)).tolist()


def _overflow_inputs(seed, x_dtype, shape=(6, 2, 4, 5, 8), finite=False):
    """Cell inputs whose states overflow 464 (x of spread 150, states of
    spread 250, clipped to +-440 if ``finite``): JAX arrays in x's and
    e4m3."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 150).astype(np.float32)
    lim = 440.0 if finite else np.inf
    v0 = np.clip(rng.standard_normal(shape[1:]) * 250, -lim, lim).astype(
        np.float32)
    i0 = np.clip(rng.standard_normal(shape[1:]) * 250, -lim, lim).astype(
        np.float32)
    return (jnp.asarray(x).astype(x_dtype), jnp.asarray(v0).astype(JE4),
            jnp.asarray(i0).astype(JE4))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,start", [(6, 0), (6, 3), (1, 0)])
@pytest.mark.parametrize("cell", ["lif", "li"])
def test_cell_matches_jax_with_e4m3_states(cell, T, start, x_dtype):
    """Over six steps from states that hold NaNs, and one step from
    finite states (every NaN a store's: its sign too)."""
    one = T == 1
    jx, jv, ji = _overflow_inputs(7, x_dtype, (T, 2, 4, 5, 8), finite=one)
    kernel = jpk.temporal_cell_seq(jx, jv, ji, cell=cell, interpret=True,
                                   start=start)
    scan = jpk._temporal_scan_reference(jx, jv, ji, start, cell)
    got = cuda_kernels.temporal_cell_seq(
        _to_port(jx, x_dtype), _to_port(jv, "float8_e4m3fn"),
        _to_port(ji, "float8_e4m3fn"), cell=cell, start=start)
    assert got[1].dtype == got[2].dtype == E4
    for ref in (kernel, scan):
        for g, w in zip(got, ref):
            assert_same(g, w, nan_signs=one)
    if one:
        np.testing.assert_array_equal(_bits(got[2]), _bits(scan[2]))
    nan = np.isnan(np.asarray(scan[2].astype(jnp.float32)))
    assert 0.01 < nan.mean() < 0.95  # the NaN path really runs


@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("cell", ["lif", "li"])
def test_cell_vjp_matches_jax_with_e4m3_states(cell, start):
    """The port's VJP (autograd through the plain version) against JAX's
    custom VJP, T = 6, on inputs whose states and carried cotangents
    overflow."""
    jx, jv, ji = _overflow_inputs(3, "float32")
    rng = np.random.default_rng(4)
    gz = rng.standard_normal(jx.shape).astype(np.float32)
    gv, gi = ((rng.standard_normal(jv.shape) * 300).astype(np.float32)
              for _ in range(2))
    _, vjp = jax.vjp(lambda a, b, c: jpk.temporal_cell_seq(
        a, b, c, cell=cell, interpret=True, start=start), jx, jv, ji)
    want = vjp((jnp.asarray(gz), jnp.asarray(gv).astype(JE4),
                jnp.asarray(gi).astype(JE4)))
    tx = _to_port(jx, "float32").requires_grad_()
    tv = _to_port(jv, "float8_e4m3fn").requires_grad_()
    ti = _to_port(ji, "float8_e4m3fn").requires_grad_()
    out = cuda_kernels.temporal_cell_seq(tx, tv, ti, cell, start)
    got = torch.autograd.grad(
        out, (tx, tv, ti), (torch.from_numpy(gz),
                            _to_port(jnp.asarray(gv).astype(JE4),
                                     "float8_e4m3fn"),
                            _to_port(jnp.asarray(gi).astype(JE4),
                                     "float8_e4m3fn")),
        allow_unused=True, materialize_grads=True)
    nans = 0
    for g, w in zip(got, want):
        g = g.float().numpy()
        w = np.asarray(jnp.asarray(w, jnp.float32))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        nans += int((~fin).sum())
        np.testing.assert_allclose(g[fin], w[fin], rtol=0,
                                   atol=2.0 ** -3 * np.abs(w[fin]).max())
    assert nans > 0


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,cell", [(3, 2, "lif"), (1, 1, "li")])
def test_spiking_conv_matches_jax_with_e4m3_states(k, stride, cell,
                                                   x_dtype):
    """``spiking_conv_seq``'s plain version against JAX's kernel in
    interpret mode: integer weights on binary events make every conv sum
    exact in either order, so the two are bit-equal."""
    rng = np.random.default_rng(5)
    T, n, h, w, cin, cout = 4, 2, 12, 14, 8, 16
    ho, wo = -(-h // stride), -(-w // stride)
    x = (rng.random((T, n, h, w, cin)) < 0.4).astype(np.float32)
    wt = rng.integers(-2, 3, (k, k, cin, cout)).astype(np.float32)
    a = rng.uniform(20, 60, cout).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    v0, i0 = ((rng.standard_normal((n, ho, wo, cout)) * 250).astype(
        np.float32) for _ in range(2))
    args = (jnp.asarray(x).astype(x_dtype), jnp.asarray(wt), jnp.asarray(a),
            jnp.asarray(b), jnp.asarray(v0).astype(JE4),
            jnp.asarray(i0).astype(JE4))
    want = jpk.spiking_conv_seq(*args, cell=cell, stride=stride,
                                interpret=True)
    dtypes = (x_dtype, "float32", "float32", "float32", "float8_e4m3fn",
              "float8_e4m3fn")
    got = cuda_kernels.spiking_conv_seq(
        *(_to_port(t, d) for t, d in zip(args, dtypes)), cell=cell,
        stride=stride)
    for g, wt_ in zip(got, want):
        assert_same(g, wt_, nan_signs=False)
    assert np.isnan(np.asarray(want[2].astype(jnp.float32))).mean() > 0.01


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_pointwise_matches_jax_with_e4m3_states(x_dtype):
    """``fused_pointwise_conv_bn_lif``'s plain version against JAX's
    kernel in interpret mode, integer x and w (exact sums). Not against
    the XLA oracle: it rounds the decay's multiply-add on its own, which
    with |v| and |i| in the hundreds moves a v_dec near the threshold and
    flips its spike (test_torch_spiking_conv.py holds the oracle at
    smaller states)."""
    rng = np.random.default_rng(6)
    n, cin, cout = 256, 32, 16
    x = rng.integers(-2, 3, (n, cin)).astype(np.float32)
    w = rng.integers(-2, 3, (cin, cout)).astype(np.float32)
    a = rng.uniform(10, 30, cout).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    # one step from finite states: every NaN a store's, signs compared
    v, i = (np.clip(rng.standard_normal((n, cout)) * 250, -440, 440).astype(
        np.float32) for _ in range(2))
    args = (jnp.asarray(x).astype(x_dtype), jnp.asarray(w).astype(x_dtype),
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(v).astype(JE4),
            jnp.asarray(i).astype(JE4))
    dtypes = (x_dtype, x_dtype, "float32", "float32", "float8_e4m3fn",
              "float8_e4m3fn")
    got = cuda_kernels.fused_pointwise_conv_bn_lif(
        *(_to_port(t, d) for t, d in zip(args, dtypes)))
    want = jpk.fused_pointwise_conv_bn_lif(*args, interpret=True)
    for g, wt in zip(got, want):
        assert_same(g, wt)
    assert np.isnan(got[2].float().numpy()).mean() > 0.01


def _narrow_pair(**kw):
    jm = JNarrow(num_classes=2, in_hw=HW, state_dtype="float8_e4m3fn", **kw)
    params, stats = _jax_weights(jm, 0, 8.0)
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu",
                 state_dtype="float8_e4m3fn", **kw)
    from snn_for_object_detection_tpu_torch.models.convert import (
        load_jax_params,
    )

    load_jax_params(pm, params, stats)
    return jm, params, stats, pm


@pytest.mark.parametrize("schedule", [False, True, "hybrid"])
def test_narrow_tiny_yolo_with_e4m3_states_matches_jax(schedule):
    """Predictions within the detector's tolerance of JAX's and the final
    states (e4m3) bit-equal, from start 0 and 3; fused too."""
    jm, params, stats, pm = _narrow_pair()
    X = _frames(1)
    fwd = jax.jit(lambda x, r, f=jm.forward_fn(schedule): f(
        params, stats, x, start_step=r))
    for r in (0, 3):
        (jc, jb), _, j_state = fwd(jnp.asarray(X), jnp.int32(r))
        (c, b), state = pm.forward_fn(schedule)(torch.from_numpy(X),
                                                start_step=r)
        assert float(c.abs().max()) > 0.1
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **PRED_TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), **PRED_TOL)
        for j, p in zip(jax.tree.leaves(j_state), _state_leaves(state)):
            assert p.dtype == E4
            np.testing.assert_allclose(p.float().numpy(),
                                       np.asarray(j, np.float32),
                                       **STATE_TOL)


def test_fused_narrow_tiny_yolo_with_e4m3_states_matches_jax():
    jm, params, stats, pm = _narrow_pair(fuse_seq=True, time_window=0)
    X = _frames(2)
    (jc, jb), _, j_state = jax.jit(lambda x: jm.forward_seq(
        params, stats, x))(jnp.asarray(X))
    cuda_kernels.reset_launches()
    (c, b), state = pm.forward_seq(torch.from_numpy(X))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **PRED_TOL)
    for j, p in zip(jax.tree.leaves(j_state), _state_leaves(state)):
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(j, np.float32), **STATE_TOL)


def test_adamax_trajectory_with_e4m3_states(tmp_path):
    """Eight Adamax steps with e4m3 states, per-step schedule: losses
    within rtol 1e-3 a step and the weights after them, as at fp32."""
    adamax_trajectory(tmp_path, False, state_dtype="float8_e4m3fn")


def test_plif_with_e4m3_states_matches_jax():
    """PLIF after a spiking stem, e4m3 states: per step and time-batched
    (from start 0 and 2) against JAX, as the zoo's leaf test."""
    from snn_for_object_detection_tpu.models import spec as JS
    from snn_for_object_detection_tpu.models.detector import SODa as JSODa
    from snn_for_object_detection_tpu_torch.models import spec as PS
    from snn_for_object_detection_tpu_torch.models.detector import (
        SODa as PSODa,
    )

    jm, params, stats, pm = zoo_pair(
        leaf_net(JS, JSODa, _leaves(JS)["plif"]),
        leaf_net(PS, PSODa, _leaves(PS)["plif"]), LEAF_HW,
        state_dtype="float8_e4m3fn")
    X = frames(3, LEAF_HW, LEAF_T, LEAF_B)
    step = jax.jit(lambda st, x: jm.step(params, stats, st, x)[::2])
    j_state, state = jm.init_state(LEAF_B), None
    for x in X:
        (jc, jb), j_state = step(j_state, jnp.asarray(x))
        (c, b), state = pm.step(torch.from_numpy(x), state)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **PRED_TOL)
    assert float(c.abs().max()) > 0.05
    fwd = jax.jit(lambda x, r: jm.forward(params, stats, x, start_step=r))
    for r in (0, 2):
        (jc, _), _, j_state = fwd(jnp.asarray(X), jnp.int32(r))
        (c, _), state = pm.forward_seq(torch.from_numpy(X), start_step=r)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **PRED_TOL)
        for j, p in zip(jax.tree.leaves(j_state), _state_leaves(state)):
            assert p.dtype == E4
            np.testing.assert_allclose(p.float().numpy(),
                                       np.asarray(j, np.float32),
                                       **STATE_TOL)


def test_config_state_dtype_e4m3(tmp_path):
    """``state_dtype: float8_e4m3fn`` in a YAML config builds the model
    with e4m3 states."""
    from snn_for_object_detection_tpu_torch.utils.config import (
        instantiate,
        load_config,
    )

    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    extra = tmp_path / "e4m3.yaml"
    extra.write_text("model:\n  init_args:\n    state_dtype: float8_e4m3fn\n")
    cfg = load_config([os.path.join(repo, "config", "config.yaml"),
                       str(extra)])
    model = instantiate(cfg["model"], device="cpu")
    assert model.state_dtype == E4
    leaves = _state_leaves(model.init_state(1))
    assert {x.dtype for x in leaves} == {E4}
