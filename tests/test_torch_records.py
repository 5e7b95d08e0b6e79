"""State recording (``state_storage=True``, ``forward_with_records``) and
``utils/analysis.py`` in the port against the JAX package, on the CPU.

- ``forward_with_records`` of a narrow TinyYolo and of VggSNN with PLIF
  cells: the same record names as JAX's (``backbone/b0/l2``), each
  ``(state [T, ...], out [T, ...])``; LIF and PLIF spike trains equal,
  states and LI outputs within the detector's STATE_TOL, the last step's
  state the returned one;
- the time-batched form (a block's ``seq`` with ``Ctx(record=True)``)
  against JAX's ``apply_seq`` with ``record``, from start 0 and 2: the
  held states of frozen steps recorded as JAX's scan records them;
- the fused plan takes a recorded cell's triple off as JAX's
  ``_make_apply`` does: with ``record`` no ``spiking_conv_seq`` call in
  either package, without it the same calls in both;
- ``spike_stats`` and ``print_spike_report`` equal to JAX's on the same
  records, number for number and character for character.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.models import compile as JC
from snn_for_object_detection_tpu.models.vgg import VggSNN as JVgg
from snn_for_object_detection_tpu.ops import pallas_kernels as jpk
from snn_for_object_detection_tpu.utils import analysis as janalysis
from snn_for_object_detection_tpu_torch.models import VggSNN
from snn_for_object_detection_tpu_torch.models import compile as PC
from snn_for_object_detection_tpu_torch.models.convert import load_jax_params
from snn_for_object_detection_tpu_torch.ops import cuda_kernels
from snn_for_object_detection_tpu_torch.utils import analysis
from test_torch_detector import (
    HW,
    PRED_TOL,
    STATE_TOL,
    JNarrow,
    PNarrow,
    _frames,
    _pair,
)
from test_torch_zoo import VGG_HW, VGG_WIDTHS, frames
from test_torch_zoo import pair as zoo_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def narrow():
    jm, params, stats, _ = _pair(JNarrow, PNarrow, 8.0, state_storage=True)
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu", state_storage=True)
    load_jax_params(pm, params, stats)
    return jm, params, stats, pm, _frames(1)


def _check_records(got, want, spiking):
    """Port records against JAX's: names, shapes, dtypes; spikes equal,
    the rest within STATE_TOL."""
    assert sorted(got) == sorted(want)
    for name, (st, out) in got.items():
        j_st, j_out = want[name]
        assert out.dtype == torch.float32 and out.shape == j_out.shape
        if spiking(name):
            np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
        else:
            np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                       **STATE_TOL)
        assert type(st).__name__ == type(j_st).__name__
        for p, j in zip(st, j_st):
            assert p.shape == j.shape
            np.testing.assert_allclose(p.float().numpy(),
                                       np.asarray(j, np.float32),
                                       **STATE_TOL)


def test_forward_with_records_matches_jax(narrow):
    jm, params, stats, pm, X = narrow
    (jc, jb), _, j_state, j_rec = jax.jit(
        lambda x: jm.forward_with_records(params, stats, x))(jnp.asarray(X))
    (c, b), state, records = pm.forward_with_records(torch.from_numpy(X))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **PRED_TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), **PRED_TOL)
    assert len(records) == 13 and "backbone/b0/l2" in records
    _check_records(records, j_rec, lambda n: not n.startswith("head"))
    spikes = sum(int(out.sum()) for n, (_, out) in records.items()
                 if not n.startswith("head"))
    assert spikes > 1000
    for name, (st, _) in records.items():
        node = state
        for key in name.split("/"):
            node = node[key]
        for rec, last in zip(st, node):
            assert torch.equal(rec[-1], last)


def test_vgg_plif_records_match_jax():
    jm, params, stats, pm = zoo_pair(JVgg, VggSNN, VGG_HW, neuron="plif",
                                     widths=VGG_WIDTHS, state_storage=True)
    X = frames(2, VGG_HW, 4)
    _, _, _, j_rec = jax.jit(
        lambda x: jm.forward_with_records(params, stats, x))(jnp.asarray(X))
    _, _, records = pm.forward_with_records(torch.from_numpy(X))
    layers = {type(m).__name__ for m in pm.modules()
              if getattr(m, "record", False)}
    assert layers == {"PLIF", "Cell"} and len(records) == len(j_rec)
    _check_records(records, j_rec,
                   lambda n: not n.startswith("head"))
    assert sum(int(out.sum()) for n, (_, out) in records.items()
               if not n.startswith("head")) > 100


@pytest.mark.parametrize("start", [0, 2])
def test_sequence_records_match_jax(narrow, start):
    """The backbone's sequence form with ``record`` against JAX's
    ``apply_seq``: every recorded cell runs a step at a time (the port's
    kernel at T = 1, JAX's scan), its held state recorded at frozen
    steps."""
    jm, params, stats, pm, X = narrow
    T = X.shape[0]
    keep = jnp.arange(T) >= start

    def jrun(x):
        ctx = JC.Ctx(record=True, step_mask=keep, start_step=jnp.int32(start))
        y, _, st = jm.backbone.apply_seq(params["backbone"],
                                         stats["backbone"],
                                         jm.init_state(X.shape[1])["backbone"],
                                         x, ctx)
        return y, st, ctx.records

    jy, _, j_rec = jax.jit(jrun)(jnp.asarray(X))
    ctx = PC.Ctx(record=True, start_step=start)
    calls = []
    kernel = PC.temporal_cell_seq

    def counted(x, *args, **kw):
        calls.append(x.shape[0])
        return kernel(x, *args, **kw)

    PC.temporal_cell_seq = counted
    try:
        with torch.no_grad():
            y, _ = pm.backbone.seq(torch.from_numpy(X),
                                   pm.init_state(X.shape[1])["backbone"], ctx)
    finally:
        PC.temporal_cell_seq = kernel
    assert calls == [1] * (4 * T)  # 4 backbone cells, a step at a time
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **STATE_TOL)
    assert len(ctx.records) == 4
    _check_records(ctx.records, j_rec, lambda n: True)


@pytest.mark.parametrize("record", [True, False])
def test_fused_plan_and_recording_as_jax(narrow, monkeypatch, record):
    """JAX's fused plan runs a triple whose cell records layer by layer
    when recording (``not (grp[2] and ctx.record)``): neither package
    calls ``spiking_conv_seq`` then; without ``record`` both fuse the
    backbone's 4 triples."""
    jm, params, stats, pm, X = narrow
    calls = {"port": 0, "jax": 0}
    port_ref = cuda_kernels.spiking_conv_seq_reference
    jax_fn = jpk.spiking_conv_seq

    def port(*args, **kw):
        calls["port"] += 1
        return port_ref(*args, **kw)

    def jax_call(*args, **kw):
        calls["jax"] += 1
        return jax_fn(*args, **kw)

    monkeypatch.setattr(cuda_kernels, "spiking_conv_seq_reference", port)
    monkeypatch.setattr(jpk, "spiking_conv_seq", jax_call)
    jctx = JC.Ctx(record=record, fuse=True)
    jy, _, _ = jm.backbone.apply_seq(
        params["backbone"], stats["backbone"],
        jm.init_state(X.shape[1])["backbone"], jnp.asarray(X), jctx)
    ctx = PC.Ctx(record=record, fuse=True)
    with torch.no_grad():
        y, _ = pm.backbone.seq(torch.from_numpy(X),
                               pm.init_state(X.shape[1])["backbone"], ctx)
    assert calls["port"] == calls["jax"] == (0 if record else 4)
    assert len(ctx.records) == len(jctx.records) == (4 if record else 0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **STATE_TOL)


@pytest.fixture(scope="module")
def jax_records(narrow):
    jm, params, stats, _, X = narrow
    _, _, _, j_rec = jax.jit(
        lambda x: jm.forward_with_records(params, stats, x))(jnp.asarray(X))
    return j_rec


def _as_port(j_rec):
    """JAX records as the port holds them: tensors in the same
    containers."""
    return {name: (type(st)(*(torch.from_numpy(np.asarray(a, np.float32))
                              for a in st)),
                   torch.from_numpy(np.asarray(out)))
            for name, (st, out) in j_rec.items()}


def test_spike_stats_equal_jax(jax_records):
    want = janalysis.spike_stats(jax_records)
    got = analysis.spike_stats(_as_port(jax_records))
    assert got == want
    assert {"firing_rate", "dead_fraction", "always_on_fraction", "v_mean",
            "v_std"} == set(next(iter(got.values())))


def test_spike_stats_reads_low_precision_states(jax_records):
    """bf16 and e4m3 states widen to fp32 first (numpy has neither)."""
    rec = _as_port(jax_records)
    for dt in (torch.bfloat16, torch.float8_e4m3fn):
        low = {n: (type(st)(*(a.to(dt) for a in st)), out)
               for n, (st, out) in rec.items()}
        want = analysis.spike_stats({
            n: (type(st)(*(a.float() for a in st)), out)
            for n, (st, out) in low.items()})
        assert analysis.spike_stats(low) == want


def test_print_spike_report_equals_jax(jax_records, capsys):
    janalysis.print_spike_report(jax_records)
    want = capsys.readouterr().out
    analysis.print_spike_report(_as_port(jax_records))
    got = capsys.readouterr().out
    assert got == want and got.count("\n") == 13


def test_records_of_a_model_without_state_storage_are_empty():
    pm = PNarrow(num_classes=2, in_hw=HW, device="cpu")
    _, _, records = pm.forward_with_records(torch.from_numpy(_frames(3, t=2)))
    assert records == {}
    assert not dataclasses.replace(PC.Ctx(), record=True).records
