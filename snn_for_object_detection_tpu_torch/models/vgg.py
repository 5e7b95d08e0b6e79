"""VGG-style SNN detector family with selectable neuron models.

The port's counterpart of ``snn_for_object_detection_tpu/models/vgg.py``
with the same spec tree: the DSL example architecture of the reference's
``BlockGen`` docstring (conv + Norm + cell blocks with SumPool
downsampling) as a full detector, the neuron model chosen per instance.
``config/vgg.yaml`` builds it with ``neuron: plif``.
"""

from __future__ import annotations

from typing import Tuple

from snn_for_object_detection_tpu_torch.models.detector import SODa
from snn_for_object_detection_tpu_torch.models.spec import (
    ALIF,
    Conv,
    LI,
    LIF,
    ListGen,
    Norm,
    PLIF,
    Pool,
    Return,
    SLI,
    Tanh,
)

_NEURONS = {
    "lif": LIF,
    "plif": PLIF,
    "alif": ALIF,
    "sli": SLI,
}


class VggSNN(SODa):
    """VGG-style spiking detector.

    :param neuron: One of ``lif`` (default), ``plif`` (learnable time
        constants), ``alif`` (adaptive threshold), ``sli``.
    :param widths: Channel widths of the three pyramid stages.
    """

    def __init__(
        self,
        *args,
        neuron: str = "lif",
        widths: Tuple[int, int, int] = (64, 128, 256),
        **kwargs,
    ):
        if neuron not in _NEURONS:
            raise ValueError(
                f"neuron must be one of {sorted(_NEURONS)}, got {neuron!r}"
            )
        self.neuron = neuron
        self.widths = tuple(widths)
        super().__init__(*args, **kwargs)

    def _n(self):
        return _NEURONS[self.neuron](state_storage=self.state_storage)

    def _block(self, out_channels: int, kernel: int = 3):
        return (Conv(out_channels, kernel), Norm(), self._n())

    def backbone_cfgs(self) -> ListGen:
        w = self.widths
        return [
            *self._block(w[0] // 2),
            Pool("S"),
            *self._block(w[0]),
            Pool("S"),
        ]

    def neck_cfgs(self) -> ListGen:
        w = self.widths
        return [
            *self._block(w[0]),
            Pool("S"),
            *self._block(w[0]),
            Return(),
            *self._block(w[1]),
            Pool("S"),
            Return(),
            *self._block(w[2]),
            Pool("S"),
            Return(),
        ]

    def head_cfgs(self, box_out: int, cls_out: int) -> ListGen:
        return [
            [Conv(kernel_size=1), Norm(), LI(state_storage=self.state_storage),
             Tanh()],
            [Conv(box_out, 1)],
            [Conv(cls_out, 1)],
        ]
