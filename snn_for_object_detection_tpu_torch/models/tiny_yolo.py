"""TinyYolo: the flagship ~3M-param YOLOv8-like SNN detector config.

The port's counterpart of ``snn_for_object_detection_tpu/models/
tiny_yolo.py``, with the same stage plan. Architecture parity target:
the reference's ``TinyYolo`` (models/tiny_yolo.py:10-89) — a stride-2
spiking-conv + C2f backbone, a 3-stage neck emitting a stride-8/16/32 pyramid, and a
shared-stem 1x1-conv head with an LI (analog leaky-integrator) readout
squashed by Tanh. The spec tree produced here is structurally identical
(4,228,544 params on GEN1 geometry — pinned by
``tests/test_detector.py::test_tiny_yolo_structure``), but it is
expressed as a declarative *stage plan* — ``(channels, depth)`` rows
consumed by free-function builders — rather than the reference's
recursive private-method decomposition.
"""

from __future__ import annotations

from snn_for_object_detection_tpu_torch.models.detector import SODa
from snn_for_object_detection_tpu_torch.models.spec import (
    Conv,
    Dense,
    LI,
    LIF,
    ListGen,
    Norm,
    Pass,
    Residual,
    Return,
    Tanh,
)


def spiking_conv(
    channels: int | None = None,
    kernel_size: int = 3,
    stride: int = 1,
    record: bool = False,
) -> ListGen:
    """Conv → BatchNorm → LIF: the basic spiking unit of the family."""
    return [
        Conv(channels, kernel_size=kernel_size, stride=stride),
        Norm(),
        LIF(state_storage=record),
    ]


def csp_block(
    channels: int, depth: int, record: bool = False, shortcut: bool = True
) -> ListGen:
    """YOLOv8 C2f cross-stage-partial block.

    One half of a 1x1 split passes straight through; the other half runs
    ``depth`` bottleneck units whose outputs all feed the final 1x1 fuse
    conv (the "f" in C2f). The per-unit output taps are expressed as a
    nested ``Dense`` chain built iteratively from the innermost unit out;
    each bottleneck is a spiking conv with an identity ``Residual`` skip
    (or a bare spiking conv when ``shortcut`` is off).
    """
    half = channels // 2
    chain: ListGen = []
    for _ in range(depth):
        unit = spiking_conv(record=record)
        branch = [Residual([unit, [Pass()]])] if shortcut else unit
        chain = [Dense([branch + chain, [Pass()]])]
    return [
        Conv(channels, 1),
        Dense([[Conv(half, 1), *chain], [Conv(half, 1)]]),
        Conv(channels, 1),
    ]


def stage(
    channels: int, depth: int, record: bool = False, tap: bool = False
) -> ListGen:
    """One downsampling stage: stride-2 spiking conv + C2f block,
    optionally tapping its output into the detection pyramid."""
    cfg = [
        *spiking_conv(channels, kernel_size=3, stride=2, record=record),
        *csp_block(channels, depth, record=record),
    ]
    if tap:
        cfg.append(Return())
    return cfg


class TinyYolo(SODa):
    """YOLOv8-like SNN detector (reference tiny_yolo.py:10-14).

    The net is five stride-2 stages described by ``(channels, depth)``
    plan rows: the first two form the backbone, the last three the neck,
    each neck stage tapping the pyramid (strides 8/16/32 at the taps).
    """

    backbone_plan: tuple = ((64, 2), (128, 3))
    neck_plan: tuple = ((256, 4), (256, 3), (256, 2))

    def backbone_cfgs(self) -> ListGen:
        return [
            spec
            for channels, depth in self.backbone_plan
            for spec in stage(channels, depth, record=self.state_storage)
        ]

    def neck_cfgs(self) -> ListGen:
        return [
            spec
            for channels, depth in self.neck_plan
            for spec in stage(channels, depth, record=self.state_storage, tap=True)
        ]

    def head_cfgs(self, box_out: int, cls_out: int) -> ListGen:
        stem = [
            Conv(kernel_size=1),
            Norm(),
            LI(state_storage=self.state_storage),
            Tanh(),
        ]
        return [stem, [Conv(box_out, 1)], [Conv(cls_out, 1)]]
