"""The port's ``StreamingEngine`` (multi-camera serving), on the CPU.

The counterparts of ``tests/test_serve.py`` that need no mesh and no
int8 weights, on a ``MicroSODa`` whose weights come from JAX through
``load_jax_params``, and one differential test: per-stream detections
equal to the JAX engine's within rtol 1e-4, atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.models.detector import SODa as JSODa
from snn_for_object_detection_tpu.models import spec as JS
from snn_for_object_detection_tpu.serve import StreamingEngine as JEngine
from snn_for_object_detection_tpu_torch.models import spec as PS
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.models.detector import SODa as PSODa
from snn_for_object_detection_tpu_torch.parallel import make_mesh
from snn_for_object_detection_tpu_torch.serve import StreamingEngine
from test_torch_detector import _jax_weights
from test_torch_megakernel import micro_soda

torch.set_num_threads(1)

H, W = 32, 40


def _port_model(params, stats, **kw):
    pm = micro_soda(PS, PSODa)(num_classes=2, in_hw=(H, W), time_window=2,
                               device="cpu", **kw)
    load_jax_params(pm, params, stats)
    return pm


@pytest.fixture(scope="module")
def setup():
    jm = micro_soda(JS, JSODa)(num_classes=2, in_hw=(H, W), time_window=2)
    params, stats = _jax_weights(jm, 0, 4.0)
    return jm, params, stats, _port_model(params, stats)


def frame(seed):
    return (np.random.default_rng(seed).random((H, W, 2)) < 0.2).astype(
        np.float32)


def test_lifecycle_and_outputs(setup):
    model = setup[3]
    eng = StreamingEngine(model, capacity=4)
    eng.add_stream("a")
    eng.add_stream("b")
    assert sorted(eng.streams) == ["a", "b"]
    for t in range(5):
        out = eng.step({"a": frame(t), "b": frame(100 + t)})
        assert sorted(out) == ["a", "b"]
        for d in out.values():
            assert d.ndim == 2 and d.shape[1] == 6
            if t < model.time_window:  # warm-up suppression
                assert d.shape[0] == 0
    assert out["a"].shape[0] > 0
    eng.remove_stream("a")
    assert eng.streams == ["b"]
    assert sorted(eng.step({"b": frame(9)})) == ["b"]


def test_stream_state_isolation(setup):
    """A stream's detections are bit-identical whether or not other
    cameras share the batch."""
    model = setup[3]
    frames_a = [frame(t) for t in range(6)]
    eng1 = StreamingEngine(model, capacity=4)
    eng1.add_stream("a")
    solo = [eng1.step({"a": f})["a"] for f in frames_a]
    eng2 = StreamingEngine(model, capacity=4)
    eng2.add_stream("x")
    eng2.step({"x": frame(500)})  # x is mid-stream when a joins
    eng2.add_stream("a")
    shared = [eng2.step({"a": f, "x": frame(600 + t)})["a"]
              for t, f in enumerate(frames_a)]
    for s, m in zip(solo, shared):
        np.testing.assert_array_equal(s, m)


def test_slot_reuse_resets_state(setup):
    model = setup[3]
    frames_c = [frame(t) for t in range(5)]
    eng = StreamingEngine(model, capacity=1)
    eng.add_stream("old")
    for t in range(4):
        eng.step({"old": frame(50 + t)})
    eng.remove_stream("old")
    eng.add_stream("c")  # reuses the only slot
    reused = [eng.step({"c": f})["c"] for f in frames_c]
    fresh_eng = StreamingEngine(model, capacity=1)
    fresh_eng.add_stream("c")
    fresh = [fresh_eng.step({"c": f})["c"] for f in frames_c]
    for r, f in zip(reused, fresh):
        np.testing.assert_array_equal(r, f)


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "float8_e5m2")])
def test_reset_stream(setup, dtypes):
    _, params, stats, _ = setup
    model = _port_model(params, stats, compute_dtype=dtypes[0],
                        state_dtype=dtypes[1])
    eng = StreamingEngine(model, capacity=2)
    eng.add_stream("a")
    seq = [frame(t) for t in range(4)]
    first = [eng.step({"a": f})["a"] for f in seq]
    eng.reset_stream("a")
    second = [eng.step({"a": f})["a"] for f in seq]
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_idle_stream_advances_with_zero_frame(setup):
    eng = StreamingEngine(setup[3], capacity=2)
    eng.add_stream("a")
    eng.add_stream("b")
    assert sorted(eng.step({"a": frame(1)})) == ["a", "b"]


def test_errors(setup):
    eng = StreamingEngine(setup[3], capacity=1)
    eng.add_stream("a")
    with pytest.raises(KeyError):
        eng.add_stream("a")
    with pytest.raises(RuntimeError, match="capacity"):
        eng.add_stream("b")
    with pytest.raises(KeyError, match="unattached"):
        eng.step({"nope": frame(0)})
    with pytest.raises(ValueError, match="shape"):
        eng.step({"a": np.zeros((4, 4, 2), np.float32)})
    with pytest.raises(KeyError):
        eng.remove_stream("nope")


def test_not_ported_options_raise(setup):
    """Mesh serving is ported (``test_mesh_engine_matches_one_device``);
    a capacity the mesh does not divide raises, as JAX's engine."""
    jm, params, stats, model = setup
    with pytest.raises(ValueError, match="divide"):
        StreamingEngine(model, capacity=6, mesh=make_mesh(["cpu"] * 4))


@pytest.mark.parametrize("pipelined", [False, True])
def test_mesh_engine_matches_one_device(setup, pipelined):
    """The counterpart of JAX's ``test_sharded_engine_matches_single_
    device``: the same streams on an engine over a mesh of four CPU
    replicas (conftest's virtual devices' analogue) give the mesh-less
    engine's detections bit for bit, through a stream added to and one
    removed from another block part way, in sync and pipelined mode."""
    model = setup[3]
    mesh = make_mesh(["cpu"] * 4)
    assert mesh.shape == {"data": 4}
    one = StreamingEngine(model, capacity=8, pipelined=pipelined)
    four = StreamingEngine(model, capacity=8, mesh=mesh, pipelined=pipelined)
    assert [m is model for m, _ in four._replicas] == [True] + [False] * 3
    for eng in (one, four):
        for sid in ("a", "b", "c"):
            eng.add_stream(sid)
    outs = ([], [])
    for t in range(model.time_window + 4):
        if t == 2:
            for eng in (one, four):
                eng.remove_stream("b")
                eng.add_stream("d")
        fr = {sid: frame(10 * t + i) for i, sid in enumerate(one.streams)}
        for eng, out in zip((one, four), outs):
            out.append(eng.step(fr))
    for eng, out in zip((one, four), outs):
        out.append(eng.flush())
    for a, b in zip(*outs):
        assert a.keys() == b.keys()
        for sid in a:
            np.testing.assert_array_equal(a[sid], b[sid])
    assert sum(len(d) for out in outs[0] for d in out.values()) > 0


def test_mesh_engine_updates_every_replica(setup):
    """``update_weights`` reaches every replica of a mesh engine."""
    _, params, stats, _ = setup
    model = _port_model(params, stats)
    eng = StreamingEngine(model, capacity=4, mesh=make_mesh(["cpu"] * 2))
    doubled = jax.tree.map(lambda a: a * 2.0, params)
    eng.update_weights(doubled, stats)
    want = doubled["head0"]["box"]["b0"]["l0"]["w"].transpose(3, 2, 0, 1)
    for replica, _ in eng._replicas:
        np.testing.assert_array_equal(
            replica.head0.box.b0.l0.w.detach().numpy(), want)


def test_update_weights_takes_int8_leaves(setup):
    """JAX's int8 conv leaves (ops/quantize.py) turn the engine's conv
    int8, and ``w`` leaves turn it back (tests/test_torch_quantize.py
    holds the int8 forward against JAX's)."""
    _, params, stats, _ = setup
    model = _port_model(params, stats)
    eng = StreamingEngine(model, capacity=2)
    eng.add_stream("a")
    qparams = jax.tree.map(lambda a: a, params)
    w = qparams["head0"]["box"]["b0"]["l0"]["w"]
    qparams["head0"]["box"]["b0"]["l0"] = {
        "w_q": np.round(w * 100).clip(-127, 127).astype(np.int8),
        "w_scale": np.full(w.shape[-1], 0.01, np.float32),
        "x_scale": np.float32(0.02),
    }
    eng.update_weights(qparams, stats)
    conv = model.head0.box.b0.l0
    assert conv.quantized and "w" not in dict(conv.named_parameters())
    np.testing.assert_array_equal(
        conv.w_q.numpy(), qparams["head0"]["box"]["b0"]["l0"]["w_q"]
        .transpose(3, 2, 0, 1))
    out = eng.step({"a": frame(0)})
    assert out["a"].shape[1] == 6
    eng.update_weights(params, stats)
    assert not conv.quantized
    np.testing.assert_array_equal(conv.w.detach().numpy(),
                                  w.transpose(3, 2, 0, 1))


def test_update_weights_keeps_states(setup):
    _, params, stats, _ = setup
    model = _port_model(params, stats)
    eng = StreamingEngine(model, capacity=2)
    eng.add_stream("a")
    seq = [frame(t) for t in range(5)]
    for f in seq[:2]:
        eng.step({"a": f})
    eng.update_weights(params, stats)  # same weights: same trajectory
    cont = [eng.step({"a": f})["a"] for f in seq[2:4]]
    eng.update_weights(params)  # stats=None keeps the statistics
    cont.append(eng.step({"a": seq[4]})["a"])
    ref_eng = StreamingEngine(_port_model(params, stats), capacity=2)
    ref_eng.add_stream("a")
    ref = [ref_eng.step({"a": f})["a"] for f in seq]
    for a, b in zip(cont, ref[2:]):
        np.testing.assert_array_equal(a, b)
    # new weights change the detections, and the states carry on
    doubled = jax.tree.map(lambda a: a * 2.0, params)
    eng.update_weights(doubled, stats)
    assert not np.array_equal(eng.step({"a": seq[0]})["a"],
                              ref_eng.step({"a": seq[0]})["a"])


def test_threshold_filters(setup):
    model = setup[3]
    eng = StreamingEngine(model, capacity=1, threshold=2.0)
    eng.add_stream("a")
    for t in range(model.time_window + 2):
        out = eng.step({"a": frame(t)})
    assert out["a"].shape[0] == 0  # conf is a probability < 2.0


def test_pipelined_mode_shifts_results_one_step(setup):
    model = setup[3]
    seq = [frame(t) for t in range(6)]
    sync_eng = StreamingEngine(model, capacity=2)
    sync_eng.add_stream("a")
    expected = [sync_eng.step({"a": f})["a"] for f in seq]
    pipe_eng = StreamingEngine(model, capacity=2, pipelined=True)
    pipe_eng.add_stream("a")
    assert pipe_eng.step({"a": seq[0]}) == {}  # nothing in flight yet
    got = [pipe_eng.step({"a": f})["a"] for f in seq[1:]]
    got.append(pipe_eng.flush()["a"])
    assert pipe_eng.flush() == {}  # drained
    for e, g in zip(expected, got):
        np.testing.assert_array_equal(e, g)


def test_pipelined_remove_stream_keeps_pending(setup):
    model = setup[3]
    eng = StreamingEngine(model, capacity=2, pipelined=True)
    eng.add_stream("a")
    for t in range(model.time_window + 1):
        eng.step({"a": frame(t)})
    eng.remove_stream("a")
    out = eng.flush()
    assert "a" in out and out["a"].shape[1] == 6


def test_frame_staging_dtypes_match(setup):
    model = setup[3]
    eng8 = StreamingEngine(model, capacity=2)
    eng32 = StreamingEngine(model, capacity=2, frame_dtype="float32")
    for eng in (eng8, eng32):
        eng.add_stream("a")
    for t in range(model.time_window + 3):
        f = frame(t)
        np.testing.assert_array_equal(eng8.step({"a": f})["a"],
                                      eng32.step({"a": f})["a"])


def test_integer_staging_rejects_fractional_frames(setup):
    eng = StreamingEngine(setup[3], capacity=2)
    eng.add_stream("a")
    with pytest.raises(ValueError, match="frame_dtype='float32'"):
        eng.step({"a": np.full((H, W, 2), 0.5, np.float32)})
    eng.step({"a": frame(0)})  # integral floats are fine


def test_integer_staging_saturates_large_counts(setup):
    eng = StreamingEngine(setup[3], capacity=2)
    eng.add_stream("a")
    big = np.zeros((H, W, 2), np.float32)
    big[0, 0, 0] = 300.0
    big[0, 1, 0] = -1.0  # integral: passes the rint check
    eng.step({"a": big})
    staged = eng._bufs[0].numpy()
    assert staged.max() == 255  # saturated, not 300 % 256 == 44
    assert staged[0, 0, 1, 0] == 0  # -1 clips to 0, not 255


def test_pipelined_bad_frame_does_not_desync_buffers(setup):
    model = setup[3]
    seq = [frame(t) for t in range(6)]
    clean = StreamingEngine(model, capacity=2, pipelined=True)
    hit = StreamingEngine(model, capacity=2, pipelined=True)
    for eng in (clean, hit):
        eng.add_stream("a")
    outs = {id(clean): [], id(hit): []}
    for t, f in enumerate(seq):
        if t == 3:
            flip_before = hit._flip
            with pytest.raises(ValueError, match="shape"):
                hit.step({"a": np.zeros((4, 4, 2), np.float32)})
            assert hit._flip == flip_before  # no flip on rejection
        for eng in (clean, hit):
            out = eng.step({"a": f})
            if out:
                outs[id(eng)].append(out["a"])
    for eng in (clean, hit):
        outs[id(eng)].append(eng.flush()["a"])
    for c, h in zip(outs[id(clean)], outs[id(hit)]):
        np.testing.assert_array_equal(c, h)


def test_engine_matches_jax_engine(setup):
    """Two streams, one joining late, over 5 steps: the port engine's
    per-stream detections against the JAX engine's."""
    jm, params, stats, model = setup
    engines = (JEngine(jm, params, stats, capacity=4),
               StreamingEngine(model, capacity=4))
    for eng in engines:
        eng.add_stream("a")
    n_dets = 0
    for t in range(5):
        if t == 1:
            for eng in engines:
                eng.add_stream("b")
        frames = {"a": frame(t)}
        if t >= 1:
            frames["b"] = frame(200 + t)
        want, got = (eng.step(frames) for eng in engines)
        assert sorted(got) == sorted(want)
        for sid in want:
            assert got[sid].shape == want[sid].shape
            np.testing.assert_allclose(got[sid], want[sid], rtol=1e-4,
                                       atol=1e-5)
            n_dets += got[sid].shape[0]
    assert n_dets > 0
