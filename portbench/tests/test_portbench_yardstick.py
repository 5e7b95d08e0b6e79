"""The yardstick: operations and bytes from shapes, and the readers of a
trace, on hand-counted cases."""

from __future__ import annotations

import pytest

from portbench.lib import kineto, readers, roofline
from portbench.lib.kineto import Event, Trace
from portbench.lib.spans import Spans
from portbench.reference import tiny_yolo as R


@pytest.mark.parametrize("classes,hw,flops,params,anchors", [
    (2, (240, 304), 7_615_577_600, 4_228_544, 13_545),
    (7, (720, 1280), 96_410_255_360, 4_263_104, 170_280),
])
def test_conv_walk(classes, hw, flops, params, anchors):
    net = R.Net(classes, hw)
    assert net.conv_flops_per_frame() == flops
    assert net.num_params() == params
    assert net.num_anchors == anchors
    assert len(net.convs) == 48 and len(net.cells) == 22


@pytest.mark.parametrize("classes,hw", [(2, (240, 304)), (7, (720, 1280))])
def test_conv_walk_matches_the_programs_summary(classes, hw):
    """The frozen walk over the frozen spec gives what the program's own
    ``utils/summary.py`` gives today (and what its model holds)."""
    from snn_for_object_detection_tpu_torch.models.tiny_yolo import TinyYolo
    from snn_for_object_detection_tpu_torch.utils.summary import summarize

    model = TinyYolo(num_classes=classes, in_hw=hw, device="cpu")
    got = summarize(model)
    net = R.Net(classes, hw)
    assert got["conv_flops_per_frame"] == net.conv_flops_per_frame()
    assert got["params"] == net.num_params()
    cells = [m for m in model.modules() if type(m).__name__ == "Cell"]
    assert [(c.kind, (c.out_channels, *c.out_hw)) for c in cells] == \
        net.cells


def test_cell_bounds_by_hand():
    """GEN1 stage 1, B = 4, T = 42, fp32: m = 4 * 120 * 152 * 64."""
    m = 4 * 120 * 152 * 64
    # forward from start 5: x read on 37 steps, z written on 42, (v, i)
    # read and written once, 4 bytes each
    fwd = (37 + 42) * m * 4 + 4 * m * 4
    assert roofline.cell_fwd_bound_s(37, 42, m) == pytest.approx(
        fwd / 3.35e12, rel=1e-12)
    # backward, LIF, 37 steps: gz read, gx written, x read (3 a step),
    # the final state's cotangents read, the initial state's written and
    # the initial state read (6 a neuron)
    bwd = 3 * 37 * m * 4 + 6 * m * 4
    assert roofline.cell_bwd_bound_s("lif", 37, m) == pytest.approx(
        bwd / 3.35e12, rel=1e-12)
    # LI: gz, gx a step; 4 state values a neuron
    assert roofline.cell_bwd_bound_s("li", 37, m) == pytest.approx(
        (2 * 37 * m * 4 + 4 * m * 4) / 3.35e12, rel=1e-12)
    # a train step's cells: two forwards (the recompute) and a backward
    one = [("lif", (64, 120, 152))]
    assert roofline.cells_bound_s(one, 4, 42, 5, 2, True) == pytest.approx(
        2 * fwd / 3.35e12 + bwd / 3.35e12, rel=1e-12)
    # bytes bound every GEN1 cell; operations never do
    ops = 37 * m * roofline.CELL_BWD_OPS["lif"] / roofline.FP32_FLOPS
    assert ops < bwd / 3.35e12


def _trace():
    # host: a step span 0-100 us holding a loss span 40-60; two conv ops
    # on thread 1, one backward conv op on thread 2
    spans = [Event("profiled", 0, 100), Event("train_step", 0, 95, 0, 1),
             Event("loss", 40, 60, 0, 1)]
    convs = [Event("aten::convolution", 5, 10, 0, 1),
             Event("aten::cudnn_convolution", 6, 9, 0, 1),
             Event("aten::convolution_backward", 70, 80, 0, 2)]
    launches = [Event("cudaLaunchKernel", 7, 7.5, 1, 1),
                Event("cudaLaunchKernel", 20, 20.5, 2, 1),
                Event("cudaLaunchKernel", 75, 75.5, 3, 2),
                Event("cudaLaunchKernel", 75, 75.5, 4, 1)]
    device = [Event("conv_fprop", 10, 30, 1),
              Event("temporal_cell_kernel", 30, 40, 2),
              Event("conv_dgrad", 80, 90, 3),
              Event("elementwise", 85, 95, 4)]
    return Trace(device, launches, convs, spans)


def test_trace_readers_by_hand():
    trace = _trace()
    assert kineto.union_us([(e.start, e.end) for e in trace.device]) == 45
    assert [e.corr for e in kineto.conv_kernels(trace)] == [1, 3]
    gaps = dict(kineto.idle_gaps(trace, 0, 100))
    # idle 0-10 (train_step), 40-80 (loss opened at 40), 95-100
    assert gaps == pytest.approx({"train_step": 10e-6, "loss": 40e-6,
                                  "profiled": 5e-6})
    spans = Spans()
    spans.add("loss", 0.002)
    spans.add("loss", 0.004)
    rec = {"path": "train", "trace": trace, "window": (0, 100),
           "spans": spans, "conv_flops_fwd": 67e12 * 20e-6,
           "conv_flops_bwd": 67e12 * 5e-6, "cell_bound_s": 8e-6}
    assert readers.device_idle(rec, "train") == pytest.approx(55.0)
    assert readers.mfu(rec, "train") == pytest.approx(25.0)
    # conv kernels busy 30 us; their least time 25 us
    assert readers.conv_roofline(rec, "train") == pytest.approx(100 * 25 / 30)
    assert readers.cell_roofline(rec, "train") == pytest.approx(80.0)
    assert readers.span_ms(rec, "train", "loss") == pytest.approx(3.0)
    # another path's record, or no device event: nothing to read
    assert readers.mfu(rec, "serve") is None
    empty = dict(rec, trace=Trace([], [], [], spans=[]))
    for fn in (readers.mfu, readers.device_idle, readers.conv_roofline,
               readers.cell_roofline):
        assert fn(empty, "train") is None
