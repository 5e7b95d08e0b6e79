"""optax factories written out in torch, from optax 0.2.6's own updates.

The trainer's optimizer chain (``loop.Optimizer``) runs ``adamax`` and
``sgd`` through ``torch.optim``, whose update is optax's for the options
they take. The factories below have no ``torch.optim`` class with
optax's update for every option optax gives them (adam's ``eps_root``
and ``nesterov``; torch's ``RMSprop`` and ``Adagrad`` add ``eps`` outside
the root, and its ``Adagrad`` starts the accumulator at 0, optax's at
0.1), so :class:`Rule` writes each out:

- ``adam`` / ``adamw`` / ``nadam`` (``scale_by_adam``, with ``eps_root``
  and ``nesterov``; ``adamw`` adds decayed weights);
- ``radam`` (``scale_by_radam``), ``adabelief`` (``scale_by_belief``);
- ``lion`` (``scale_by_lion`` and decayed weights);
- ``rmsprop`` (``scale_by_rms`` or, ``centered``, ``scale_by_stddev``,
  then ``trace`` for ``momentum``);
- ``adagrad`` (``scale_by_rss``).

Each update is ``-lr * (scaled + weight_decay * p)`` added to ``p``, as
``chain(scale_by_*, add_decayed_weights, scale_by_learning_rate)`` and
``apply_updates`` compute it. The scalar factors (bias corrections,
RAdam's rectification) are computed in float32 as optax computes them:
``decay ** count`` by binary exponentiation, as XLA does, so that RAdam's
``ro`` (a difference of two numbers near ``2 / (1 - b2)``) rounds alike.

Options that take a callable or a dtype (``mask``, ``mu_dtype``) raise
``NotImplementedError``; a keyword optax does not take raises
``TypeError``, as optax does.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from snn_for_object_detection_tpu_torch.roadmap import (
    OTHER_FACTORIES,
    not_ported,
)

_ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
         "nesterov": False}
# factory -> optax 0.2.6's keyword defaults (the scalar ones)
FACTORIES: Dict[str, Dict[str, Any]] = {
    "adam": _ADAM,
    "adamw": {**_ADAM, "weight_decay": 1e-4},
    "nadam": {**_ADAM, "nesterov": True},
    "radam": {**_ADAM, "threshold": 5.0},
    "adabelief": {"b1": 0.9, "b2": 0.999, "eps": 1e-16, "eps_root": 1e-16,
                  "nesterov": False},
    "lion": {"b1": 0.9, "b2": 0.99, "weight_decay": 1e-3},
    "rmsprop": {"decay": 0.9, "eps": 1e-8, "initial_scale": 0.0,
                "eps_in_sqrt": True, "centered": False, "momentum": None,
                "nesterov": False, "bias_correction": False},
    "adagrad": {"initial_accumulator_value": 0.1, "eps": 1e-7},
}
# optax options that take a callable or a dtype, for each factory above
NOT_TAKEN = {"adam": ("mu_dtype",), "adamw": ("mu_dtype", "mask"),
             "nadam": ("mu_dtype",), "lion": ("mu_dtype", "mask")}


def refuse_left_out(name: str, kwargs: Dict[str, Any],
                    table: Dict[str, Any] = NOT_TAKEN) -> None:
    """Raise on the options of ``name`` that ``table`` leaves out (those
    that take a callable or a dtype)."""
    left_out = sorted(set(kwargs) & set(table.get(name, ())))
    if left_out:
        raise not_ported(f"{name} options {left_out}", OTHER_FACTORIES)


def f32_pow(base: float, count: int) -> np.float32:
    """``base ** count`` in float32 by binary exponentiation (XLA's
    power of a float by an integer, bit for bit)."""
    acc, b = np.float32(1.0), np.float32(base)
    while count:
        if count & 1:
            acc = np.float32(acc * b)
        b = np.float32(b * b)
        count >>= 1
    return acc


def bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count``, in float32."""
    return float(np.float32(1.0) - f32_pow(decay, count))


def radam_ro(b2: float, count: int) -> np.float32:
    """RAdam's ``ro`` at ``count`` (float32, optax's order)."""
    f = np.float32
    ro_inf = f(2.0 / (1.0 - b2) - 1.0)
    b2t = f32_pow(b2, count)
    return f(ro_inf - f(f(f(2 * count) * b2t) / f(f(1.0) - b2t)))


def radam_r(b2: float, ro: np.float32) -> np.float32:
    f = np.float32
    ro_inf = f(2.0 / (1.0 - b2) - 1.0)
    return f(np.sqrt(f(f(f(f(ro - f(4.0)) * f(ro - f(2.0))) * ro_inf)
                       / f(f(f(ro_inf - f(4.0)) * f(ro_inf - f(2.0))) * ro))))


class Rule:
    """One optax factory's update on a list of parameters.

    :meth:`step` takes the gradients (already averaged and clipped by the
    chain) and the learning rate of this update, and updates the
    parameters in place. ``count`` is the factory's own update count
    (its bias corrections)."""

    def __init__(self, name: str, params: List[torch.Tensor],
                 kwargs: Dict[str, Any]):
        if name not in FACTORIES:
            raise not_ported(f"optimizer {name!r}", OTHER_FACTORIES)
        refuse_left_out(name, kwargs)
        unknown = sorted(set(kwargs) - set(FACTORIES[name]))
        if unknown:
            raise TypeError(f"{name}() got unexpected keyword arguments "
                            f"{unknown}")
        self.name = name
        self.opts = {**FACTORIES[name], **kwargs}
        self.count = 0
        zeros = [torch.zeros_like(p) for p in params]
        o = self.opts
        if name == "lion":
            self.state = {"mu": zeros}
        elif name == "adagrad":
            self.state = {"sum_of_squares": [
                torch.full_like(p, o["initial_accumulator_value"])
                for p in params]}
        elif name == "rmsprop":
            self.state = {"nu": [torch.full_like(p, o["initial_scale"])
                                 for p in params]}
            if o["centered"]:
                self.state["mu"] = zeros
            if o["momentum"] is not None:
                self.state["trace"] = [torch.zeros_like(p) for p in params]
        else:
            self.state = {"mu": zeros,
                          "nu": [torch.zeros_like(p) for p in params]}

    # ---- the scale_by_* transforms: gradient -> scaled update ----

    def _mu_hat(self, mu, g, count):
        b1 = self.opts["b1"]
        if self.opts["nesterov"]:
            return (b1 * (mu / bias_correction(b1, count + 1))
                    + (1 - b1) * (g / bias_correction(b1, count)))
        return mu / bias_correction(b1, count)

    def _scale(self, i: int, g: torch.Tensor, count: int) -> torch.Tensor:
        o, s = self.opts, self.state
        name = self.name
        if name == "lion":
            mu = s["mu"][i]
            u = torch.sign((1 - o["b1"]) * g + o["b1"] * mu)
            s["mu"][i] = (1 - o["b2"]) * g + o["b2"] * mu
            return u
        if name == "adagrad":
            ss = g * g + s["sum_of_squares"][i]
            s["sum_of_squares"][i] = ss
            return torch.where(ss > 0, torch.rsqrt(ss + o["eps"]),
                               torch.zeros_like(ss)) * g
        if name == "rmsprop":
            d = o["decay"]
            nu = (1 - d) * (g * g) + d * s["nu"][i]
            s["nu"][i] = nu
            if o["centered"]:
                mu = (1 - d) * g + d * s["mu"][i]
                s["mu"][i] = mu
            if o["bias_correction"]:
                nu = nu / bias_correction(d, count)
                if o["centered"]:
                    mu = mu / bias_correction(d, count)
            if o["centered"]:
                nu = nu - mu * mu
            if o["eps_in_sqrt"]:
                return torch.rsqrt(nu + o["eps"]) * g
            return (1 / (torch.sqrt(nu) + o["eps"])) * g
        b1, b2 = o["b1"], o["b2"]
        mu = (1 - b1) * g + b1 * s["mu"][i]
        s["mu"][i] = mu
        if name == "adabelief":
            err = g - mu
            nu = (1 - b2) * (err * err) + b2 * s["nu"][i] + o["eps_root"]
            s["nu"][i] = nu
            return self._mu_hat(mu, g, count) / (
                torch.sqrt(nu / bias_correction(b2, count)) + o["eps"])
        nu = (1 - b2) * (g * g) + b2 * s["nu"][i]
        s["nu"][i] = nu
        mu_hat = self._mu_hat(mu, g, count)
        nu_hat = nu / bias_correction(b2, count)
        if name == "radam":
            ro = radam_ro(b2, count)
            if ro < o["threshold"]:
                return mu_hat
            return float(radam_r(b2, ro)) * mu_hat / (
                torch.sqrt(nu_hat + o["eps_root"]) + o["eps"])
        return mu_hat / (torch.sqrt(nu_hat + o["eps_root"]) + o["eps"])

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             lr: float) -> None:
        o = self.opts
        count = self.count + 1
        wd = o.get("weight_decay", 0.0)
        momentum = o.get("momentum")
        for i, (p, g) in enumerate(zip(params, grads)):
            u = self._scale(i, g, count)
            if wd:
                u = u + wd * p
            u = u * -lr
            if momentum is not None:
                t = u + momentum * self.state["trace"][i]
                self.state["trace"][i] = t
                u = u + momentum * t if o["nesterov"] else t
            p.add_(u)
        self.count = count

    def tensors(self) -> List[torch.Tensor]:
        return [t for ts in self.state.values() for t in ts]

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "state": self.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for key, ts in state["state"].items():
            self.state[key] = [t.to(p.device) for t, p in
                               zip(ts, self.state[key])]
