"""Declarative model-generation DSL: layer specs as frozen dataclasses.

The port's own copy of ``snn_for_object_detection_tpu/models/spec.py``
(pure dataclasses; kept identical so that one spec tree builds both
packages). It re-designs the reference's ``LayerGen`` DSL
(models/modules/layer_gen.py:14-32): the same
configuration vocabulary (``Conv``, ``Norm``, ``LIF``, ``LI``, ``SLI``,
``Synapse``, ``LSTM``, ``Pool``, ``Up``, ``Return``, ``Pass``,
``ReLU``, ``SiLU``, ``Tanh``; structural markers ``Residual`` /
``Dense``), but as *pure data*:

- a spec never holds modules or parameters — it is compiled once by
  :mod:`snn_for_object_detection_tpu_torch.models.compile` into
  ``nn.Module`` trees;
- "statefulness" is a static property of the spec class (``STATEFUL``)
  instead of runtime reflection (the reference's
  ``norse._is_module_stateful``, generator.py:21,142).

Configuration lists follow the reference semantics
(generator.py:35-80): a plain list is sequential; a ``Residual`` list
of branches sums branch outputs; a ``Dense`` list concatenates branch
outputs along channels; lists nest recursively.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union


class Residual(list):
    """Marker list type: branch outputs are summed (generator.py:145-146)."""


class Dense(list):
    """Marker list type: branch outputs are channel-concatenated
    (generator.py:157-158)."""


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Base class for all layer specs."""

    STATEFUL = False


@dataclasses.dataclass(frozen=True)
class Pass(LayerSpec):
    """Identity placeholder (layer_gen.py:96-103)."""


@dataclasses.dataclass(frozen=True)
class Conv(LayerSpec):
    """2D convolution; bias-free, auto padding ``k // 2``
    (layer_gen.py:106-136). ``out_channels=None`` keeps the input
    channel count.

    ``s2d=True`` (requires ``kernel_size=3, stride=2``, even input
    dims) selects the space-to-depth execution plan: the input is
    packed 2x2-block -> channels and the conv runs as kernel-2
    stride-1 over 4x the channels — bit-for-bit the same math and the
    SAME ``[3,3,Cin,Cout]`` params, but the MXU contraction is 16*Cin
    instead of 9*Cin, which matters for tiny-Cin stems (the raw GEN1
    frame has Cin=2; the MLPerf-TPU trick). Purely an execution plan:
    checkpoints, importers, quantization, and the megakernel all see
    the ordinary conv."""

    out_channels: Optional[int] = None
    kernel_size: int = 3
    stride: int = 1
    s2d: bool = False


@dataclasses.dataclass(frozen=True)
class Norm(LayerSpec):
    """BatchNorm over (B, H, W); learnable scale, optional bias
    (layer_gen.py:197-214). Running stats live in the ``stats``
    collection and are updated per time step."""

    bias: bool = False
    eps: float = 1e-5
    momentum: float = 0.1


@dataclasses.dataclass(frozen=True)
class Pool(LayerSpec):
    """Pooling: ``"A"`` average / ``"M"`` max / ``"S"`` sum
    (layer_gen.py:139-173)."""

    type: str = "A"
    kernel_size: int = 2
    stride: Optional[int] = None

    def __post_init__(self):
        if self.type not in ("A", "M", "S"):
            raise ValueError(f'Non-existent pool type "{self.type}"!')


@dataclasses.dataclass(frozen=True)
class Up(LayerSpec):
    """Upsampling (layer_gen.py:176-194): ``nearest`` / ``linear`` /
    ``bilinear`` / ``trilinear`` (all bilinear on a 2-D map) /
    ``bicubic``."""

    scale: int = 2
    mode: str = "nearest"


@dataclasses.dataclass(frozen=True)
class ReLU(LayerSpec):
    pass


@dataclasses.dataclass(frozen=True)
class SiLU(LayerSpec):
    pass


@dataclasses.dataclass(frozen=True)
class Tanh(LayerSpec):
    pass


@dataclasses.dataclass(frozen=True)
class LIF(LayerSpec):
    """Leaky integrate-and-fire spiking layer (layer_gen.py:217-235).

    ``state_storage=True`` records per-step neuron state/spikes when the
    forward pass is run in recording mode (the reference's
    ``StateStorage`` wrapper, common.py:86-123)."""

    STATEFUL = True
    state_storage: bool = False


@dataclasses.dataclass(frozen=True)
class LI(LayerSpec):
    """Non-spiking leaky integrator (layer_gen.py:238-254)."""

    STATEFUL = True
    state_storage: bool = False


@dataclasses.dataclass(frozen=True)
class PLIF(LayerSpec):
    """Parametric LIF: learnable per-channel time constants (beyond the
    reference's fixed-tau LIF; trainable via the surrogate gradient)."""

    STATEFUL = True
    state_storage: bool = False


@dataclasses.dataclass(frozen=True)
class ALIF(LayerSpec):
    """Adaptive-threshold LIF: spike-triggered threshold growth with
    decay (beyond-reference neuron family)."""

    STATEFUL = True
    state_storage: bool = False
    beta: float = 0.2
    tau_adapt_inv: float = 10.0


@dataclasses.dataclass(frozen=True)
class SLI(LayerSpec):
    """Saturable leaky integrator (layer_gen.py:331-347)."""

    STATEFUL = True
    state_storage: bool = False


@dataclasses.dataclass(frozen=True)
class Synapse(LayerSpec):
    """Synaptic-transmission cell (layer_gen.py:321-328)."""

    STATEFUL = True
    sigma_inhibition: float = 0.0


@dataclasses.dataclass(frozen=True)
class LSTM(LayerSpec):
    """Convolutional LSTM (layer_gen.py:287-302, conv_lstm.py)."""

    STATEFUL = True
    hidden_size: Optional[int] = None
    kernel_size: int = 1


@dataclasses.dataclass(frozen=True)
class Return(LayerSpec):
    """Tap marker: stores the running tensor as a pyramid output
    (layer_gen.py:305-318). The compiler collects tap channel counts in
    cfg order (the analogue of ``NeckGen.out_shape``,
    generator.py:315-338)."""


# A config list: specs and (possibly marked) nested lists.
ListGen = List[Union[LayerSpec, "ListGen"]]
