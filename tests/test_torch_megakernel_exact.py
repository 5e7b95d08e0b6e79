"""The megakernel's exact-sum gate (``megakernel.make_exact``) on the CPU.

``make_exact`` gives a built plan integer conv weights and power-of-two
Norm gains, with the biases that make every LIF op spike at 5-95% over
the frames. Every conv that reads the frame or spikes (or sums of them)
then sums integers below 2^24, exact in fp32 in any order, so on the
card the kernel must equal its plain version bit for bit in every state
slot after every frame (``chip_smoke.py`` [8], [15] (b)). Here, at full
GEN1 width (240x304; 3 frames, cut from the card's 16 to keep the file
near a minute, never the width), the plain version with its conv sums
reordered (``megakernel.witness_variants``: taps last to first, K in 4
slices) gives every state slot bit for bit after every frame, and with
each of the two faults (the /8 downsample's first K-chunk dropped, a /16
bottleneck's bottom padding row read from above) some slot differs, on
inputs that are nonzero where each fault breaks; fp32, bf16 / e5m2 and
bf16 / e4m3. At narrow width the exact weights carried into the model
make the port's ``SODa.step`` equal JAX's ``step`` bit for bit, and the
plan's plain version equal both.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu_torch.models.convert import (
    model_params,
    model_stats,
)
from snn_for_object_detection_tpu_torch.models.tiny_yolo import (
    TinyYolo as PTiny,
)
from snn_for_object_detection_tpu_torch.ops import (
    megakernel as megakernel_module,
)
from snn_for_object_detection_tpu_torch.ops.megakernel import (
    EXACT_LIMIT,
    EXACT_RATE,
    EXACT_WEIGHT,
    StreamingMegakernel,
    build_plan,
    conv_weight,
    make_exact,
    streaming_megakernel_reference,
    witness_variants,
)
from test_torch_detector import JNarrow, PNarrow, _state_leaves
from test_torch_leaves import roll_jax

torch.set_num_threads(1)

GEN1_HW = (240, 304)
NARROW_HW = (64, 80)
FRAMES = 3
DTYPES = [("float32", "float32"), ("bfloat16", "float8_e5m2"),
          ("bfloat16", "float8_e4m3fn")]


def _events(hw, n, seed, density):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.random((n, *hw, 2)) < density).astype(np.uint8))


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _run(plan, frames):
    """The plain version from the zero state: every frame's state slots."""
    state = [torch.zeros(s.shape, dtype=s.dtype) for s in plan.slots]
    states = []
    for x in frames:
        _, _, state = streaming_megakernel_reference(plan, x, state)
        states.append(state)
    return states


def _differ(a, b):
    """State slots x frames where two runs differ in any bit."""
    return sum(not torch.equal(_bits(x), _bits(y))
               for sa, sb in zip(a, b) for x, y in zip(sa, sb))


@functools.lru_cache(maxsize=None)
def _exact_base(dtypes):
    """The full-width GEN1 plan made exact on seeded event frames, what
    ``make_exact`` measured, and the plain version's states."""
    pm = PTiny(num_classes=2, in_hw=GEN1_HW, time_window=0, device="cpu",
               compute_dtype=dtypes[0], state_dtype=dtypes[1])
    plan = build_plan(pm)
    frames = _events(GEN1_HW, FRAMES, 200, 0.05)
    report = make_exact(plan, frames, seed=0)
    return plan, frames, report, _run(plan, frames)


@pytest.mark.parametrize("dtypes", DTYPES)
def test_make_exact_at_gen1_width(dtypes):
    """Integer weights in [-2, 2], power-of-two Norm gains, every LIF op
    spiking inside EXACT_RATE over the frames, every conv that reads
    integers bounded below 2^24, and only the heads' box / cls convs
    reading non-integers (tanh outputs)."""
    plan, _, report, _ = _exact_base(dtypes)
    heads = tuple(n for n, op in enumerate(plan.ops)
                  if plan.buffers[op.dst].space == "preds")
    assert report.inexact == heads and len(heads) == 6
    assert 0 < report.largest_sum < EXACT_LIMIT
    rates = dict(report.rates)
    lif = [n for n, op in enumerate(plan.ops) if op.cell == "lif"]
    assert sorted(rates) == lif and len(lif) == 19
    assert all(EXACT_RATE[0] <= r <= EXACT_RATE[1] for r in rates.values())
    for op in plan.ops:
        if op.kind == "conv":
            w = conv_weight(plan, op).float()
            assert torch.equal(w, w.round())
            assert int(w.abs().max()) <= EXACT_WEIGHT
        if op.norm is not None:
            c = plan.buffers[op.dst].shape[2]
            k = plan.weight(op.norm[0], c).float()
            assert bool((torch.frexp(k).mantissa == 0.5).all())


@pytest.mark.parametrize("dtypes", DTYPES)
@pytest.mark.parametrize("variant", ["reverse_taps", "k_in_4_slices",
                                     "chunk_dropped",
                                     "bottom_pad_from_above"])
def test_exact_gate_tells_reorderings_from_faults(dtypes, variant,
                                                  monkeypatch):
    """Under exact sums a reordering is bit-equal to the plain version in
    every state slot after every frame, and a fault is not; each fault
    sees nonzero inputs where it breaks (else it could change nothing)."""
    plan, frames, _, base = _exact_base(dtypes)
    conv_sum = witness_variants(plan)[variant]
    monkeypatch.setattr(megakernel_module, "_conv_taps", conv_sum.conv_taps)
    differ = _differ(_run(plan, frames), base)
    if conv_sum.reordering:
        assert differ == 0
    else:
        assert differ > 0
        assert len(conv_sum.seen) == FRAMES and sum(conv_sum.seen) > 0


def _into_model(plan, model):
    """Carry an exact plan's weights into the model it was built from:
    each conv's taps back to OIHW, each Norm (the layer after its conv)
    to ``scale = k``, ``mean = -b / k`` (no bias) and a variance with
    ``var + eps == 1`` in fp32, so both packages fold exactly ``(k, b)``."""
    with torch.no_grad():
        for op in plan.ops:
            if op.kind != "conv":
                continue
            conv = model.get_submodule(".".join(op.path))
            k = op.k
            conv.w.copy_(conv_weight(plan, op).float().reshape(
                k, k, *conv_weight(plan, op).shape[1:]).permute(3, 2, 0, 1))
            if op.norm is None:
                continue
            li = int(op.path[-1][1:]) + 1
            norm = model.get_submodule(".".join(op.path[:-1] + (f"l{li}",)))
            c = plan.buffers[op.dst].shape[2]
            kv = plan.weight(op.norm[0], c).float()
            bv = plan.weight(op.norm[1], c).float()
            var = torch.tensor(1.0) - torch.tensor(norm.eps)
            assert float(var + norm.eps) == 1.0
            norm.scale.copy_(kv)
            norm.var.fill_(float(var))
            if norm.bias is None:
                norm.mean.copy_(-bv / kv)
            else:
                norm.mean.zero_()
                norm.bias.copy_(bv)


def _jax_layout(tree, shapes):
    """The port's ``model_params`` / ``model_stats`` tree in the layout
    of JAX's ``init`` (which keeps an empty node for a layer without
    weights)."""

    def leaf(path, _):
        node = tree
        for key in path:
            node = node[key.key]
        return node

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16")])
def test_exact_weights_step_bit_equal_to_jax(dtypes):
    """At narrow width, the exact plan's weights in the port's model:
    ``SODa.step`` equals JAX's jitted ``step`` bit for bit in every state
    leaf after every frame (as ``test_identity_weights_bit_equal_to_jax``
    holds the identity case), and the plan's plain version equals it;
    the predictions (sums of tanh outputs) within the prediction
    tolerance."""
    kw = dict(num_classes=2, in_hw=NARROW_HW, time_window=0,
              compute_dtype=dtypes[0], state_dtype=dtypes[1])
    pm = PNarrow(device="cpu", **kw)
    plan = build_plan(pm)
    frames = _events(NARROW_HW, 4, 7, 0.3)
    report = make_exact(plan, frames, seed=1)
    assert all(EXACT_RATE[0] <= r <= EXACT_RATE[1] for _, r in report.rates)
    _into_model(plan, pm)

    jm = JNarrow(**kw)
    params, stats = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    j_preds, j_state = roll_jax(jm, _jax_layout(model_params(pm), params),
                                _jax_layout(model_stats(pm), stats),
                                frames.float().numpy())
    state, mk_state, mk = None, None, StreamingMegakernel(pm)
    for x in frames:
        preds, state = pm.step(x[None], state)
        _, mk_state = mk.step(x, mk_state)
    p_state = _state_leaves(state)
    assert len(p_state) == len(j_state)
    for p, j in zip(p_state, j_state):
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(j, np.float32))
    for p, m in zip(p_state, _state_leaves(mk_state)):
        assert torch.equal(p, m)
    flat = torch.cat([p.float().flatten() for p in p_state])
    assert 0 < int((flat == 0).sum()) < flat.numel()
    tol = (dict(rtol=1e-4, atol=1e-5) if dtypes[0] == "float32"
           else dict(rtol=2e-2, atol=1e-3))
    for g, w in zip(preds, j_preds[-1]):
        np.testing.assert_allclose(g.float().numpy(), w, **tol)
    assert jax.devices()[0].platform == "cpu"
