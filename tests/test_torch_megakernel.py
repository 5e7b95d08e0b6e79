"""The port's streaming megakernel against the JAX package, on the CPU.

On the CPU, ``StreamingMegakernel`` runs its plain version, which walks
the same plan (op table, weight packing, state slots) that
``csrc/megakernel.cu`` runs on the card. It is held against JAX's
``StreamingMegakernel``: in Pallas interpret mode (as
``tests/test_megakernel.py`` runs it) for ``MicroSODa`` and
``StructYolo`` at 32x40, and through its XLA body for a narrow TinyYolo
at 64x80, on the same seeded frames and weights (drawn with numpy,
carried into the port by ``load_jax_params``). Tolerances are the JAX
tests' own: predictions and carried state within rtol 1e-4, atol 1e-5 at
fp32, rtol 2e-2, atol 1e-3 with bf16 activations or states. With 1 x 1
identity weights every conv is exact and the states are bit-equal to
JAX at fp32 and in bf16, which pins where the affine rounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.models.detector import SODa as JSODa
from snn_for_object_detection_tpu.ops.megakernel import (
    StreamingMegakernel as JMegakernel,
)
from snn_for_object_detection_tpu_torch.models import spec as PS
from snn_for_object_detection_tpu_torch.models.detector import SODa as PSODa
from snn_for_object_detection_tpu_torch.models.tiny_yolo import (
    TinyYolo as PTiny,
)
from snn_for_object_detection_tpu_torch.ops import cuda_kernels
from snn_for_object_detection_tpu_torch.ops import (
    megakernel as megakernel_module,
)
from snn_for_object_detection_tpu_torch.ops.megakernel import (
    StreamingMegakernel,
    UnsupportedLayer,
    build_plan,
    model_cells,
    plan_cells,
    run_distance,
    streaming_megakernel_reference,
    witness_passes,
)
from test_torch_detector import JNarrow, PNarrow, _jax_weights, _state_leaves
from test_torch_leaves import identity_weights, identity_yolo, struct_yolo

torch.set_num_threads(1)

HW = (32, 40)
NARROW_HW = (64, 80)
TOL = {
    ("float32", "float32"): dict(rtol=1e-4, atol=1e-5),
    ("bfloat16", "bfloat16"): dict(rtol=2e-2, atol=1e-3),
    ("bfloat16", "float8_e5m2"): dict(rtol=2e-2, atol=1e-3),
}


def micro_soda(S, base):
    """The ``MicroSODa`` of tests/test_detector.py over either spec."""

    class MicroSODa(base):
        def backbone_cfgs(self):
            return [S.Conv(8, 3, 2), S.Norm(), S.LIF()]

        def neck_cfgs(self):
            return [
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
                S.Conv(8, 3, 2), S.Norm(), S.LIF(), S.Return(),
            ]

        def head_cfgs(self, box_out, cls_out):
            return [
                [S.Conv(kernel_size=1), S.Norm(), S.LI(), S.Tanh()],
                [S.Conv(box_out, 1)],
                [S.Conv(cls_out, 1)],
            ]

    return MicroSODa


def fallback_soda(S, base):
    """A net whose Residual has three branches (two ``add`` ops), whose
    Dense holds one value twice (one ``copy`` op) and with a Norm and
    LIF after a Pool (an ``ew`` op): the plan's paths that TinyYolo no
    longer takes."""

    class FallbackSODa(base):
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

        def head_cfgs(self, box_out, cls_out):
            return [
                [S.Conv(kernel_size=1), S.Norm(), S.LI(), S.Tanh()],
                [S.Conv(box_out, 1)],
                [S.Conv(cls_out, 1)],
            ]

    return FallbackSODa


MODELS = {  # name: (JAX class, port class, frame geometry, BN gain, pallas)
    "micro": (micro_soda(JS, JSODa), micro_soda(PS, PSODa), HW, 4.0, True),
    "struct": (struct_yolo(JS, JSODa), struct_yolo(PS, PSODa), HW, 4.0,
               True),
    "narrow_tiny_yolo": (JNarrow, PNarrow, NARROW_HW, 8.0, False),
    "fallbacks": (fallback_soda(JS, JSODa), fallback_soda(PS, PSODa),
                  (64, 80), 4.0, True),
}


def _pair(name, compute_dtype="float32", state_dtype="float32",
          weights=None, hw=None):
    jcls, pcls, model_hw, gain, pallas = MODELS[name]
    hw = hw or model_hw
    kw = dict(num_classes=2, in_hw=hw, time_window=0,
              compute_dtype=compute_dtype, state_dtype=state_dtype)
    jm = jcls(**kw)
    params, stats = (weights or (lambda m: _jax_weights(m, 0, gain)))(jm)
    pm = pcls(device="cpu", **kw)
    from snn_for_object_detection_tpu_torch.models.convert import (
        load_jax_params,
    )

    load_jax_params(pm, params, stats)
    return JMegakernel(jm, params, stats, use_pallas=pallas), pm


def _frames(hw, n=4, seed=3, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((n, *hw, 2)) < density).astype(np.float32)


def _roll(jmk, mk, frames):
    """Both megakernels over the frames; per-frame predictions and the
    final state leaves (JAX pytree order)."""
    js, ps, preds = None, None, []
    for x in frames:
        (jc, jb), js = jmk.step(jnp.asarray(x), js)
        (pc, pb), ps = mk.step(torch.from_numpy(x), ps)
        preds.append(((pc, pb), (np.asarray(jc, np.float32),
                                 np.asarray(jb, np.float32))))
    return preds, _state_leaves(ps), jax.tree.leaves(js)


@pytest.mark.parametrize("dtypes", sorted(TOL))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_megakernel_matches_jax(name, dtypes):
    jmk, pm = _pair(name, *dtypes)
    mk = StreamingMegakernel(pm)
    hw = MODELS[name][2]
    preds, p_state, j_state = _roll(jmk, mk, _frames(hw))
    tol = TOL[dtypes]
    for (pc, pb), (jc, jb) in preds:
        assert pc.dtype == pb.dtype == torch.float32
        np.testing.assert_allclose(pc.numpy(), jc, **tol)
        np.testing.assert_allclose(pb.numpy(), jb, **tol)
    assert float(preds[-1][0][0].abs().max()) > 0.05  # not silent
    assert len(p_state) == len(j_state) == len(mk.plan.slots)
    spiked = 0
    for p, j in zip(p_state, j_state):
        assert p.dtype == getattr(torch, dtypes[1])
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(j, np.float32), **tol)
        spiked += int((p.float() == 0).sum())
    assert spiked > 0


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16")])
def test_identity_weights_bit_equal_to_jax(dtypes):
    """1 x 1 identity convs are exact, so every carried state equals
    JAX's Pallas megakernel bit for bit: the affine is one fused
    multiply-add at fp32; in bf16 its product is rounded and its sum
    reaches the cell in fp32."""
    kw = dict(num_classes=2, in_hw=HW, time_window=0,
              compute_dtype=dtypes[0], state_dtype=dtypes[1])
    jm = identity_yolo(JS, JSODa)(**kw)
    params, stats = identity_weights(jm)
    pm = identity_yolo(PS, PSODa)(device="cpu", **kw)
    from snn_for_object_detection_tpu_torch.models.convert import (
        load_jax_params,
    )

    load_jax_params(pm, params, stats)
    frames = np.random.default_rng(4).normal(
        size=(4, *HW, 2)).astype(np.float32) * 0.5
    preds, p_state, j_state = _roll(
        JMegakernel(jm, params, stats, use_pallas=True),
        StreamingMegakernel(pm), frames)
    for p, j in zip(p_state, j_state):
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(j, np.float32))
    assert 0 < int((p_state[0] == 0).sum()) < p_state[0].numel()
    for (pc, pb), (jc, jb) in preds:
        np.testing.assert_allclose(pc.numpy(), jc, **TOL[dtypes])
        np.testing.assert_allclose(pb.numpy(), jb, **TOL[dtypes])


def test_predict_matches_jax():
    jmk, pm = _pair("micro")
    mk = StreamingMegakernel(pm)
    js, ps = None, None
    for x in _frames(HW, n=3, seed=5):
        j_dets, js = jmk.predict(jnp.asarray(x), js)
        p_dets, ps = mk.predict(torch.from_numpy(x), ps)
        assert p_dets.shape == (300, 6) and isinstance(ps, list)
        j_dets = np.asarray(j_dets)
        np.testing.assert_array_equal(p_dets[:, 0].numpy(), j_dets[:, 0])
        np.testing.assert_allclose(p_dets[:, 1:].numpy(), j_dets[:, 1:],
                                   rtol=1e-4, atol=1e-5)
    assert float(p_dets[:, 2:].min()) >= 0 and float(p_dets[:, 2:].max()) <= 1
    # the flat state converts back to the step's state tree
    (c1, b1), _ = mk.step(torch.from_numpy(x), mk.to_model_state(ps))
    (c2, b2), _ = mk.step(torch.from_numpy(x), ps)
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)


def test_megakernel_matches_port_step():
    """The plain megakernel against the port's own per-step ``SODa.step``
    (conv order aside, the same function at fp32)."""
    _, pm = _pair("struct")
    mk = StreamingMegakernel(pm)
    sm, ss = None, None
    for x in _frames(HW, seed=6):
        (mc, mb), sm = mk.step(torch.from_numpy(x), sm)
        (sc, sb), ss = pm.step(torch.from_numpy(x)[None], ss)
        torch.testing.assert_close(mc, sc, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(mb, sb, rtol=1e-4, atol=1e-5)
    for a, b in zip(_state_leaves(sm), _state_leaves(ss)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_uint8_frames_equal_float_frames():
    _, pm = _pair("micro", "bfloat16", "bfloat16")
    mk = StreamingMegakernel(pm)
    x = _frames(HW, n=1)[0]
    (c8, b8), s8 = mk.step(torch.from_numpy(x.astype(np.uint8)))
    for dt in (torch.float32, torch.bfloat16):
        (c, b), s = mk.step(torch.from_numpy(x).to(dt))
        torch.testing.assert_close(c8, c, rtol=0, atol=0)
        torch.testing.assert_close(b8, b, rtol=0, atol=0)


def test_step_leaves_the_callers_state_alone():
    """Functional, as in JAX: the same state fed twice gives the same
    result, and the state passed in is not written."""
    _, pm = _pair("struct")
    mk = StreamingMegakernel(pm)
    frames = _frames(HW, n=2)
    cuda_kernels.reset_launches()
    _, state = mk.step(torch.from_numpy(frames[0]))
    assert cuda_kernels.LAUNCHES["streaming_megakernel"] == 0  # CPU: plain
    before = [t.clone() for t in _state_leaves(state)]
    (c1, _), s1 = mk.step(torch.from_numpy(frames[1]), state)
    (c2, _), s2 = mk.step(torch.from_numpy(frames[1]), state)
    for a, b in zip(before, _state_leaves(state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)
    for a, b in zip(_state_leaves(s1), _state_leaves(s2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, _state_leaves(s1)))


def test_unsupported_layers_raise():
    class OddPool(micro_soda(PS, PSODa)):
        def backbone_cfgs(self):
            return [PS.Conv(8, 3, 2), PS.Norm(), PS.LIF(), PS.Pool("M", 3)]

    pm = OddPool(num_classes=2, in_hw=HW, device="cpu")  # 16x20: not / 3
    with pytest.raises(UnsupportedLayer, match="Pool"):
        StreamingMegakernel(pm)

    class WideConv(micro_soda(PS, PSODa)):
        def backbone_cfgs(self):
            return [PS.Conv(8, 5, 2), PS.Norm(), PS.LIF()]

    with pytest.raises(UnsupportedLayer, match="Conv k=5"):
        StreamingMegakernel(WideConv(num_classes=2, in_hw=HW, device="cpu"))


def test_bad_frames_and_states_raise():
    _, pm = _pair("micro")
    mk = StreamingMegakernel(pm)
    x = torch.from_numpy(_frames(HW, n=1)[0])
    with pytest.raises(ValueError, match="batch-1"):
        mk.step(torch.zeros(2, *HW, 2))
    with pytest.raises(TypeError, match="frame dtype"):
        mk.step(x.half())
    with pytest.raises(ValueError, match="frame shape"):
        mk.step(torch.zeros(8, 8, 2))
    state = mk._flat_state(None)
    with pytest.raises(ValueError, match="state slots"):
        cuda_kernels.streaming_megakernel(mk.plan, x, state[:-1])
    bad = list(state)
    bad[3] = bad[3].to(torch.bfloat16)
    with pytest.raises(ValueError, match="state slot 3"):
        cuda_kernels.streaming_megakernel(mk.plan, x, bad)


def _overlap(plan, a, b):
    """Whether buffers ``a`` and ``b`` share an element."""
    (ra, oa), (rb, ob) = plan.locate(a), plan.locate(b)
    ca, cb = plan.buffers[a].shape[2], plan.buffers[b].shape[2]
    return ra == rb and oa < ob + cb and ob < oa + ca


def _schedule_ok(plan, table):
    """The plan's phases and the op table read as the kernel reads them:
    every op runs after every op that wrote into its inputs; every
    phase's tiles are the sum of its ops' (each op's first tile the sum
    before it); no op is an add, copy or reduce of a split conv; a split
    conv's slices cover its K range with at least 4 chunks each, and the
    split convs of one phase take disjoint scratch and counters."""
    for n, op in enumerate(plan.ops):
        for m, other in enumerate(plan.ops):
            if any(_overlap(plan, other.dst, b) for b in op.inputs):
                assert plan.phases[m] < plan.phases[n], (m, n)
    f = {name: i for i, name in enumerate(cuda_kernels.MK_FIELDS)}
    rows, phases = table.rows, table.phases
    assert rows.shape == (len(plan.ops), 40)
    assert int(phases[-1, 1]) == rows.shape[0]
    assert phases.shape[0] == max(plan.phases) + 1
    for p, (o0, o1, tiles) in enumerate(phases.tolist()):
        assert o0 < o1
        assert sum(int(rows[n, f["tiles"]]) for n in range(o0, o1)) == tiles
        scratch, counters = [], []
        for n in range(o0, o1):
            r = rows[n].tolist()
            assert r[f["tile0"]] == sum(int(rows[m, f["tiles"]])
                                        for m in range(o0, n))
            if r[f["kind"]] == 0 and r[f["split"]] > 1:
                split, k = r[f["split"]], r[f["k"]] ** 2 * r[f["cin"]]
                assert 4 * 16 * split <= k
                mn = r[f["tiles"]] // split
                plane = r[f["ho"]] * r[f["wo"]] * r[f["cout"]]
                scratch.append((r[f["scratch_off"]],
                                r[f["scratch_off"]] + split * plane))
                counters.append((r[f["counter_off"]],
                                 r[f["counter_off"]] + mn))
        for spans, total in ((scratch, table.scratch),
                             (counters, table.counters)):
            spans.sort()
            assert all(e <= o for (_, e), (o, _) in zip(spans, spans[1:]))
            assert all(0 <= o and e <= total for o, e in spans)
        assert all(o % 64 == 0 for o, _ in scratch)  # 16-byte rows


@pytest.mark.parametrize("grid", [None, 264])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_op_table_schedule(name, grid):
    _, pm = _pair(name)
    plan = build_plan(pm)
    table = cuda_kernels.megakernel_op_table(plan, grid)
    n_split = int((table.rows[:, cuda_kernels.MK_FIELDS.index("split")]
                   > 1).sum())
    assert (table.scratch > 0) == (table.counters > 0) == (n_split > 0)
    if grid is None:
        assert n_split == 0
    _schedule_ok(plan, table)


def _gen1_plan():
    return build_plan(PTiny(num_classes=2, in_hw=(240, 304), device="cpu"))


@pytest.mark.parametrize("name", sorted(MODELS) + ["gen1_tiny_yolo"])
def test_workspace_by_liveness(name):
    """No two workspace buffers whose live phases (first write to last
    read) overlap share an element, and each lies inside the workspace;
    buffers that live apart do share memory."""
    plan = _gen1_plan() if name == "gen1_tiny_yolo" else build_plan(
        _pair(name)[1])
    live = {}
    for op, p in zip(plan.ops, plan.phases):
        for b in op.inputs + [op.dst]:
            root, _ = plan.locate(b)
            if plan.buffers[root].space == "ws":
                lo, hi = live.get(root, (p, p))
                live[root] = (min(lo, p), max(hi, p))
    spans = {r: (plan.buffers[r].offset,
                 plan.buffers[r].offset + plan.buffers[r].numel)
             for r in live}
    for r, (o, e) in spans.items():
        assert o % 64 == 0 and 0 <= o and e <= plan.ws_numel
    shared = 0
    for a in live:
        for b in live:
            (oa, ea), (ob, eb) = spans[a], spans[b]
            if a < b and oa < eb and ob < ea:
                shared += 1
                assert live[a][1] < live[b][0] or live[b][1] < live[a][0]
    assert plan.ws_numel < sum(e - o for o, e in spans.values())
    assert shared > 0


def test_gen1_tiny_yolo_plan():
    """The full-width GEN1 plan, built on the CPU: 48 convs, 22 cells
    (44 state slots), every weight packed once, the heads written
    straight into the prediction buffer; every Residual sum in a conv
    epilogue and every Dense concatenation written in place, so no add
    or copy op; 36 phases (the convs' dependency depth), none more at
    the H100's grid, where the under-filled convs are split along K and
    summed by their last slice; a workspace reused by liveness."""
    pm = PTiny(num_classes=2, in_hw=(240, 304), device="cpu")
    plan = build_plan(pm)
    kinds = [op.kind for op in plan.ops]
    assert kinds.count("conv") == 48
    assert kinds.count("add") == 0 and kinds.count("copy") == 0
    assert sum(op.res >= 0 for op in plan.ops) == 14  # the bottlenecks
    assert len(plan.slots) == 44
    assert sum(np.prod(s.shape) for s in plan.slots) == 2 * 5_278_080
    convs = sum(op.k * op.k * plan.buffers[op.src].shape[2]
                * plan.buffers[op.dst].shape[2]
                for op in plan.ops if op.kind == "conv")
    assert convs == sum(p.numel() for n, p in pm.named_parameters()
                        if n.endswith(".w"))
    assert sum(plan.buffers[op.dst].space == "preds"
               for op in plan.ops) == 6  # 3 box + 3 cls convs, no copy
    # one buffer a frame before: 27,398,656 elements
    assert plan.ws_numel == 3_502_080
    table = cuda_kernels.megakernel_op_table(plan)
    assert table.phases.shape[0] == 36 < table.rows.shape[0]
    # at the H100's grid (2 blocks of 256 threads on each of 132 SMs)
    table = cuda_kernels.megakernel_op_table(plan, 264)
    _schedule_ok(plan, table)
    assert table.phases.shape[0] == 36 and table.rows.shape[0] == 48
    splits = table.rows[:, cuda_kernels.MK_FIELDS.index("split")]
    assert int((splits > 1).sum()) == 38


def test_exact_sums_change_only_the_conv_sums():
    """With 1 x 1 identity weights every conv up to the head stems sums
    exactly in fp32, so every state of the exact-sum run equals the
    plain version's bit for bit: the option changes the conv sums and
    nothing else. (The random box and cls tails do not sum exactly: the
    predictions agree to their dtype's tolerance.)"""
    for dtypes in (("float32", "float32"), ("bfloat16", "float8_e5m2")):
        kw = dict(num_classes=2, in_hw=HW, time_window=0,
                  compute_dtype=dtypes[0], state_dtype=dtypes[1])
        jm = identity_yolo(JS, JSODa)(**kw)
        pm = identity_yolo(PS, PSODa)(device="cpu", **kw)
        from snn_for_object_detection_tpu_torch.models.convert import (
            load_jax_params,
        )

        load_jax_params(pm, *identity_weights(jm))
        plan = build_plan(pm)
        frames = np.random.default_rng(4).normal(
            size=(4, *HW, 2)).astype(np.float32) * 0.5
        runs = []
        for exact in (False, True):
            state = StreamingMegakernel(pm)._flat_state(None)
            for x in frames:
                cls, box, state = streaming_megakernel_reference(
                    plan, torch.from_numpy(x), state, exact_sums=exact)
            runs.append((cls, box, state))
        (c0, b0, s0), (c1, b1, s1) = runs
        for a, b in zip(s0, s1):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert 0 < int((s0[0] == 0).sum()) < s0[0].numel()
        tol = TOL[("float32", "float32") if dtypes[0] == "float32"
                  else ("bfloat16", "bfloat16")]
        torch.testing.assert_close(c0, c1, **tol)
        torch.testing.assert_close(b0, b1, **tol)


def test_model_cells_follow_the_plan_slots():
    """``model_cells`` reads a model's state tree in the order of the
    plan's slots, so the witness compares like with like."""
    _, pm = _pair("narrow_tiny_yolo")
    mk = StreamingMegakernel(pm)
    x = torch.from_numpy(_frames(NARROW_HW, n=1)[0])
    _, state = mk.step(x)
    from_tree = model_cells(pm, state)
    from_slots = plan_cells(mk.plan, mk._flat_state(state))
    assert len(from_tree) == len(from_slots) == len(mk.plan.slots) // 2
    for (ka, va, ia), (kb, vb, ib) in zip(from_tree, from_slots):
        assert ka == kb
        assert torch.equal(va[0], vb) and torch.equal(ia[0], ib)
    assert [k for k, _, _ in from_tree].count("li") == 3


# ---- the witness: tells a reordered conv sum from a fault ----

WITNESS_HW = (128, 160)
WITNESS_SEEDS = (1, 2, 3)
WITNESS_FRAMES = 16
DROP_CONV = (3, 2, 16, 16, (16, 20))  # the first neck downsample
PAD_CONV = (3, 1, 8, 8, (8, 10))      # the second neck bottleneck


def _padded_taps(x, k, stride, out_hw, fill_bottom=False):
    ho, wo = out_hw
    pad = k // 2
    x = torch.nn.functional.pad(x.float(), (0, 0, pad, pad, pad, pad))
    if fill_bottom:  # the bottom padding row read from the row above
        x[-1] = x[-2]
    return [x[dy:dy + (ho - 1) * stride + 1:stride,
              dx:dx + (wo - 1) * stride + 1:stride].reshape(ho * wo, -1)
            for dy in range(k) for dx in range(k)]


def _is(conv, x, w, k, stride, out_hw):
    return (k, stride, x.shape[-1], w.shape[-1], tuple(out_hw)) == conv


def _reverse_taps(x, w, k, stride, out_hw, exact=False):
    """Reordering: the taps summed last to first."""
    patches = _padded_taps(x, k, stride, out_hw)
    acc = None
    for t in reversed(range(k * k)):
        m = patches[t] @ w[t].float()
        acc = m if acc is None else acc + m
    return acc.reshape(*out_hw, -1)


def _k_slices(x, w, k, stride, out_hw, exact=False):
    """Reordering: K (tap by tap, channel by channel) cut into 4 in-order
    slices, each summed alone, then the slices summed in order."""
    a = torch.cat(_padded_taps(x, k, stride, out_hw), dim=1)
    b = w.float().reshape(-1, w.shape[-1])
    acc = torch.zeros(a.shape[0], b.shape[1])
    for s in range(4):
        lo, hi = s * a.shape[1] // 4, (s + 1) * a.shape[1] // 4
        acc = acc + a[:, lo:hi] @ b[lo:hi]
    return acc.reshape(*out_hw, -1)


def _drop_chunk(x, w, k, stride, out_hw, exact=False):
    """Fault: one mid-network conv loses its first 16-channel K-chunk."""
    if _is(DROP_CONV, x, w, k, stride, out_hw):
        w = w.clone()
        w[0, :16] = 0
    return _PLAIN_TAPS(x, w, k, stride, out_hw, exact)


def _bottom_pad_from_above(x, w, k, stride, out_hw, exact=False):
    """Fault: one 3 x 3 conv reads its bottom padding row from the row
    above."""
    if not _is(PAD_CONV, x, w, k, stride, out_hw):
        return _PLAIN_TAPS(x, w, k, stride, out_hw, exact)
    patches = _padded_taps(x, k, stride, out_hw, fill_bottom=True)
    acc = None
    for t in range(k * k):
        m = patches[t] @ w[t].float()
        acc = m if acc is None else acc + m
    return acc.reshape(*out_hw, -1)


_PLAIN_TAPS = megakernel_module._conv_taps
WITNESS_VARIANTS = {  # name: (conv sum, a legitimate reordering)
    "reverse_taps": (_reverse_taps, True),
    "k_in_4_slices": (_k_slices, True),
    "chunk_dropped": (_drop_chunk, False),
    "bottom_pad_from_above": (_bottom_pad_from_above, False),
}


def _witness_run(plan, frames, exact=False):
    state = [torch.zeros(s.shape, dtype=s.dtype) for s in plan.slots]
    preds = []
    for x in frames:
        cls, box, state = streaming_megakernel_reference(
            plan, torch.from_numpy(x), state, exact_sums=exact)
        preds += [cls, box]
    return preds, plan_cells(plan, state)


@functools.lru_cache(maxsize=None)
def _witness_base(dtypes):
    """The narrow net's plan and, per seed, its frames and the plain
    version's distance from the exact-sum run."""
    _, pm = _pair("narrow_tiny_yolo", *dtypes, hw=WITNESS_HW)
    plan = build_plan(pm)
    seeds = []
    for seed in WITNESS_SEEDS:
        frames = _frames(WITNESS_HW, n=WITNESS_FRAMES, seed=seed)
        exact = _witness_run(plan, frames, exact=True)
        plain = run_distance(*_witness_run(plan, frames), *exact)
        seeds.append((frames, exact, plain))
    return plan, seeds


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "float8_e5m2")])
@pytest.mark.parametrize("variant", sorted(WITNESS_VARIANTS))
def test_witness_tells_reorderings_from_faults(variant, dtypes, monkeypatch):
    """On an untrained narrow net at BatchNorm gain 8, over 16 frames of
    3 seeds: a conv summed in another order is no further from the
    exact-sum run than the plain version (within the witness's slack)
    on every seed, and a fault is further on every seed. Seed 1 at fp32
    is where a 4-slice K order flips one spike of the deepest cell,
    which the slack must and does absorb (PERF.md, the witness)."""
    plan, seeds = _witness_base(dtypes)
    fn, legit = WITNESS_VARIANTS[variant]
    monkeypatch.setattr(megakernel_module, "_conv_taps", fn)
    verdicts = []
    for frames, exact, plain in seeds:
        got = run_distance(*_witness_run(plan, frames), *exact)
        verdicts.append(witness_passes(got, plain))
        if not legit:  # a fault moves the run, not just a rounding
            assert min(got.agreement) < 0.995 and max(got.li_rel_l2) > 0.05
    assert verdicts == [legit] * len(seeds), verdicts
