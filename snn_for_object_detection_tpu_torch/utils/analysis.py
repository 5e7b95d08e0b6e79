"""Spiking-activity analysis over recorded neuron states.

The port's copy of ``snn_for_object_detection_tpu/utils/analysis.py``
(numpy only). The records come from ``SODa.forward_with_records``:
``{layer name: (state [T, ...], out [T, ...])}``; this module turns them
into what one inspects: firing rates, dead and always-on fractions,
membrane statistics. Tensors (on any device, in any float dtype) are
read as fp32 numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _f32(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch tensor: bf16 and fp8 widen first
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def spike_stats(records: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Summarize recorded (state, outputs) per layer.

    :param records: ``{layer_name: (state [T, ...], out [T, ...])}``
        from ``forward_with_records``.
    :return: per-layer dict with:
        - ``firing_rate``: mean output (for spiking layers the fraction
          of (neuron, step) pairs that spiked);
        - ``dead_fraction``: neurons that never fired in the window;
        - ``always_on_fraction``: neurons that fired every step;
        - ``v_mean`` / ``v_std``: membrane potential statistics (when
          the state has a ``v`` field).
    """
    out: Dict[str, Dict[str, float]] = {}
    for name, (state, spikes) in records.items():
        spikes = _f32(spikes)  # [T, ...]
        t = spikes.shape[0]
        per_neuron = spikes.reshape(t, -1).mean(axis=0)
        layer: Dict[str, float] = {
            "firing_rate": float(per_neuron.mean()),
            "dead_fraction": float((per_neuron == 0).mean()),
            "always_on_fraction": float((per_neuron == 1).mean()),
        }
        v = getattr(state, "v", None)
        if v is not None:
            v = _f32(v)
            layer["v_mean"] = float(v.mean())
            layer["v_std"] = float(v.std())
        out[name] = layer
    return out


def print_spike_report(records: Dict[str, Any]) -> None:
    stats = spike_stats(records)
    for name, s in stats.items():
        line = (
            f"{name:<40} rate={s['firing_rate']:.3f} "
            f"dead={s['dead_fraction']:.2f} on={s['always_on_fraction']:.2f}"
        )
        if "v_mean" in s:
            line += f" v={s['v_mean']:+.3f}±{s['v_std']:.3f}"
        print(line)
