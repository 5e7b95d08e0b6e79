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
from snn_for_object_detection_tpu_torch.ops.megakernel import (
    StreamingMegakernel,
    UnsupportedLayer,
    build_plan,
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


MODELS = {  # name: (JAX class, port class, frame geometry, BN gain, pallas)
    "micro": (micro_soda(JS, JSODa), micro_soda(PS, PSODa), HW, 4.0, True),
    "struct": (struct_yolo(JS, JSODa), struct_yolo(PS, PSODa), HW, 4.0,
               True),
    "narrow_tiny_yolo": (JNarrow, PNarrow, NARROW_HW, 8.0, False),
}


def _pair(name, compute_dtype="float32", state_dtype="float32",
          weights=None):
    jcls, pcls, hw, gain, pallas = MODELS[name]
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


def _schedule_ok(rows, phases):
    """The op table read as the kernel reads it: every phase's tiles are
    the sum of its ops' (each op's first tile the sum before it), every
    workspace or scratch input was written in an earlier phase, and a
    split conv's slices cover its K range once."""
    f = {name: i for i, name in enumerate(cuda_kernels.MK_FIELDS)}
    written = {}  # (space, offset) -> phase
    for p, (o0, o1, tiles) in enumerate(phases.tolist()):
        assert o0 < o1
        assert sum(int(rows[n, f["tiles"]]) for n in range(o0, o1)) == tiles
        for n in range(o0, o1):
            r = rows[n].tolist()
            assert r[f["tile0"]] == sum(int(rows[m, f["tiles"]])
                                        for m in range(o0, n))
            for space, off in ((r[f["src_space"]], r[f["src_off"]]),
                               (r[f["res_space"]], r[f["res_off"]])):
                if space in (0, 3):  # workspace, scratch
                    assert written[(space, off)] < p
            if r[f["kind"]] == 0 and r[f["split"]] > 1:
                k = r[f["k"]] ** 2 * r[f["cin"]]
                assert 4 * 16 * r[f["split"]] <= k
                written[(3, r[f["scratch_off"]])] = p
            else:
                key = (r[f["dst_space"]], r[f["dst_off"]])
                written[key] = max(written.get(key, -1), p)


@pytest.mark.parametrize("grid", [None, 264])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_op_table_schedule(name, grid):
    _, pm = _pair(name)
    plan = build_plan(pm)
    rows, phases, scratch = cuda_kernels.megakernel_op_table(plan, grid)
    n_split = int((rows[:, 0] == 6).sum())
    assert rows.shape == (len(plan.ops) + n_split, 32)
    assert int(phases[-1, 1]) == rows.shape[0]
    assert (scratch > 0) == (n_split > 0)
    if grid is None:
        assert n_split == 0
    _schedule_ok(rows, phases)


def test_gen1_tiny_yolo_plan():
    """The full-width GEN1 plan, built on the CPU: 48 convs, 22 cells
    (44 state slots), every weight packed once, the heads written
    straight into the prediction buffer."""
    pm = PTiny(num_classes=2, in_hw=(240, 304), device="cpu")
    plan = build_plan(pm)
    kinds = [op.kind for op in plan.ops]
    assert kinds.count("conv") == 48
    assert len(plan.slots) == 44
    assert sum(np.prod(s.shape) for s in plan.slots) == 2 * 5_278_080
    convs = sum(op.k * op.k * plan.buffers[op.src].shape[2]
                * plan.buffers[op.dst].shape[2]
                for op in plan.ops if op.kind == "conv")
    assert convs == sum(p.numel() for n, p in pm.named_parameters()
                        if n.endswith(".w"))
    assert sum(plan.buffers[op.dst].space == "preds"
               for op in plan.ops) == 6  # 3 box + 3 cls convs, no copy
    rows, phases, _ = cuda_kernels.megakernel_op_table(plan)
    assert phases.shape[0] < rows.shape[0]  # independent ops share phases
    # at the H100's grid (2 blocks of 256 threads on each of 132 SMs) the
    # under-filled convs are split along K
    rows, phases, _ = cuda_kernels.megakernel_op_table(plan, 264)
    _schedule_ok(rows, phases)
    splits = rows[rows[:, 0] == 0, cuda_kernels.MK_FIELDS.index("split")]
    assert int((splits > 1).sum()) > 10
